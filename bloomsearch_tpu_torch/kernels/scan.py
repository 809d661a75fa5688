"""Stream byte scan (K2) in its dense and segment modes: wrappers and the
plain version.

The CUDA kernel (``csrc/scan.cu``) replaces the JAX package's Pallas kernel
``bloom/pallas_kernels.py::byte_scan_pallas_swar`` in stream mode and the
XLA code around it in ``rowcache.py::_device_scan_fn`` (``scan_all`` and
``scan_segments``, whose ``dynamic_slice`` + ``concatenate`` copy the kernel
replaces with a row mapping). It is compiled with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface at first use, and bound with
``ctypes``.

Each wrapper takes the row stream ``int32[rows, 128]`` (lowercased 512-byte
chunks, bytes packed little-endian 4 per word, 480 payload bytes each) on a
device, and the needles as host arrays ``int32[N <= 8, 32]`` of byte values
with their lengths ``int32[N]``:

- a CUDA tensor launches the kernel on the current stream, or raises;
- a CPU tensor runs the plain PyTorch version in this module.

Outputs are packed ``int32[n_real, chunks/32]`` words: bit i of word w of
row n is set iff needle n occurs at a start < 480 of logical chunk 32w+i
(the JAX package's ``pack_bitmap`` contract, read as uint32 on the host).
A needle of length 0 matches every chunk.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from . import build
from .probe import pack_bitmap_plain

SOURCE = os.path.join(build.CSRC_DIR, "scan.cu")
LIBRARY = os.path.join(build.BUILD_DIR, "libbs_scan.so")

CHUNK_BYTES = 512
STREAM_STRIDE = 480  # payload bytes per chunk: valid match starts are < 480
MAX_SCAN_WINDOW = 32  # longest needle the kernel takes (rowcache.MAX_NEEDLE)
MAX_SCAN_NEEDLES = 8  # needles per launch (callers chunk above this)
MAX_SEGMENTS = 4
# Word-loop buckets of the TPU kernel: a needle of length L spans at most
# ceil((L + 3) / 4) packed words. The CUDA kernel needs no bucket; callers
# still pass one, so launches keep the JAX package's shape keys.
SCAN_WORD_BUCKETS = (2, 4, 6, 9)


def scan_word_bucket(max_len: int) -> int:
    need = (max_len + 3 + 3) // 4
    for b in SCAN_WORD_BUCKETS:
        if need <= b:
            return b
    return SCAN_WORD_BUCKETS[-1]


_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_count_lock = threading.Lock()
_launches = {"stream": 0, "segments": 0}
# (mode, logical chunks G, n_real, n_segs, seg_chunks, word bucket) -> launches
_shapes: dict[tuple[str, int, int, int, int, int], int] = {}


def launch_counts() -> dict[str, int]:
    """Kernel launches per mode since the last reset."""
    with _count_lock:
        return dict(_launches)


def launch_shapes() -> dict[tuple[str, int, int, int, int, int], int]:
    """Kernel launches per (mode, logical chunks G, n_real, n_segs,
    seg_chunks, word bucket) since the last reset."""
    with _count_lock:
        return dict(_shapes)


def reset_launch_counts() -> None:
    with _count_lock:
        for name in _launches:
            _launches[name] = 0
        _shapes.clear()


def _count(mode: str, G: int, n_real: int, n_segs: int, seg_chunks: int,
           max_words: int) -> None:
    with _count_lock:
        _launches[mode] += 1
        key = (mode, G, n_real, n_segs, seg_chunks, max_words)
        _shapes[key] = _shapes.get(key, 0) + 1


# -- build and bind ---------------------------------------------------------


def build_library(force: bool = False) -> str:
    """Compile ``csrc/scan.cu`` unless the library is newer (``build.py``)."""
    return build.build_library(SOURCE, LIBRARY, force)


def library() -> ctypes.CDLL:
    """The kernel library, built at first use and bound with ctypes."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            build_library()
            lib = ctypes.CDLL(LIBRARY)
            p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            lib.bs_scan_launch.argtypes = [p, i64, i64, p, p, i32, p, i32, i64, p, p]
            lib.bs_scan_launch.restype = ctypes.c_int
            _lib = lib
    return _lib


# -- argument checks --------------------------------------------------------


def _check(rows32: torch.Tensor, needles: np.ndarray, lens: np.ndarray,
           n_real: int, max_words: int) -> tuple[np.ndarray, np.ndarray]:
    """-> (uint8[n_real, 32] needle bytes, int32[n_real] lengths)."""
    if (rows32.dim() != 2 or rows32.dtype != torch.int32
            or rows32.shape[1] != CHUNK_BYTES // 4 or not rows32.is_contiguous()):
        raise ValueError("rows32 must be a contiguous int32[rows, 128] tensor")
    needles = np.asarray(needles)
    lens = np.asarray(lens)
    N = needles.shape[0]
    if needles.shape != (N, MAX_SCAN_WINDOW) or lens.shape != (N,):
        raise ValueError(f"needles {needles.shape} / lens {lens.shape}: want [N, 32] / [N]")
    if not 1 <= n_real <= N <= MAX_SCAN_NEEDLES:
        raise ValueError(f"n_real={n_real} of N={N} needles (at most {MAX_SCAN_NEEDLES})")
    real = needles[:n_real]
    if real.min() < 0 or real.max() > 255:
        raise ValueError("needle values must be bytes (0..255)")
    lens = lens[:n_real].astype(np.int32)
    if lens.min() < 0 or lens.max() > min(MAX_SCAN_WINDOW, 4 * max_words - 3):
        raise ValueError(f"needle lengths {lens.tolist()} exceed the word bucket {max_words}")
    return np.ascontiguousarray(real, dtype=np.uint8), lens


def _clamp_starts(starts: Sequence[int], rows: int, seg_chunks: int) -> list[int]:
    """Segment starts clamped into the stream, as ``dynamic_slice`` does."""
    return [min(max(int(s), 0), rows - seg_chunks) for s in starts]


# -- the plain version (the CPU path and the kernel's reference) -------------


def byte_scan_plain(rows32: torch.Tensor, needles: np.ndarray, lens: np.ndarray,
                    n_real: int, seg_starts: Optional[Sequence[int]] = None,
                    seg_chunks: int = 0) -> torch.Tensor:
    """-> int32[n_real, G/32]: the sliding-window form of the JAX package's
    ``_scan_matrix`` over every logical chunk (``rows32``, or the
    ``seg_chunks``-long segments at ``seg_starts``, concatenated).

    Allocates bool[n_real, G, 480]: call it in pieces over a large stream.
    ``>>`` on int32 is arithmetic, but ``& 0xFF`` keeps exactly byte i, so
    bytes >= 0x80 in the top position read right."""
    if seg_starts is not None:
        starts = _clamp_starts(seg_starts, rows32.shape[0], seg_chunks)
        rows32 = torch.cat([rows32[s : s + seg_chunks] for s in starts])
    G = rows32.shape[0]
    dev = rows32.device
    rows2d = torch.stack(
        [(rows32 >> (8 * i)) & 0xFF for i in range(4)], dim=-1
    ).reshape(G, CHUNK_BYTES)
    nd = torch.as_tensor(np.asarray(needles[:n_real], dtype=np.int32), device=dev)
    ln = [int(v) for v in np.asarray(lens)[:n_real]]
    acc = torch.ones((n_real, G, STREAM_STRIDE), dtype=torch.bool, device=dev)
    for l in range(max(ln)):
        window = rows2d[:, l : l + STREAM_STRIDE]  # [G, 480]
        active = torch.tensor([l < v for v in ln], dtype=torch.bool, device=dev)
        acc &= (window[None] == nd[:, l, None, None]) | ~active[:, None, None]
    return pack_bitmap_plain(acc.any(dim=2))


# -- wrappers ---------------------------------------------------------------


def _launch(rows32: torch.Tensor, needle_bytes: np.ndarray, lens: np.ndarray,
            chunks: int, starts: Sequence[int], seg_chunks: int) -> torch.Tensor:
    if rows32.device.type != "cuda":
        raise ValueError(f"the scan kernel runs on CUDA tensors, got {rows32.device}")
    n_real = needle_bytes.shape[0]
    seg = np.ascontiguousarray(starts, dtype=np.int64).reshape(-1)
    lib = library()
    with torch.cuda.device(rows32.device):
        out = torch.empty((n_real, chunks // 32), dtype=torch.int32, device=rows32.device)
        stream = torch.cuda.current_stream(rows32.device).cuda_stream
        err = lib.bs_scan_launch(
            rows32.data_ptr(), rows32.shape[0], chunks,
            needle_bytes.ctypes.data, lens.ctypes.data, n_real,
            seg.ctypes.data if seg.size else None, seg.size, seg_chunks,
            out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"scan kernel launch failed: cudaError {err}")
    return out


def byte_scan_stream(rows32: torch.Tensor, needles: np.ndarray, lens: np.ndarray,
                     *, n_real: int, max_words: int) -> torch.Tensor:
    """Dense mode (``scan_all``): -> int32[n_real, rows/32] over every row."""
    needle_bytes, real_lens = _check(rows32, needles, lens, n_real, max_words)
    G = rows32.shape[0]
    if G == 0 or G % 32:
        raise ValueError(f"the stream's rows must be a positive multiple of 32, got {G}")
    if rows32.device.type == "cpu":
        return byte_scan_plain(rows32, needle_bytes, real_lens, n_real)
    out = _launch(rows32, needle_bytes, real_lens, G, (), 0)
    _count("stream", G, n_real, 0, 0, max_words)
    return out


def byte_scan_segments(rows32: torch.Tensor, seg_starts: Sequence[int],
                       needles: np.ndarray, lens: np.ndarray, *, n_real: int,
                       max_words: int, seg_chunks: int) -> torch.Tensor:
    """Segment mode (``scan_segments``): -> int32[n_real, n_segs*seg_chunks/32]
    over the ``seg_chunks``-long segments at ``seg_starts`` (clamped into
    the stream), in order."""
    needle_bytes, real_lens = _check(rows32, needles, lens, n_real, max_words)
    n_segs = len(seg_starts)
    if not 1 <= n_segs <= MAX_SEGMENTS:
        raise ValueError(f"{n_segs} segments: the kernel takes 1..{MAX_SEGMENTS}")
    if seg_chunks <= 0 or seg_chunks % 32 or seg_chunks > rows32.shape[0]:
        raise ValueError(f"seg_chunks={seg_chunks} for a stream of {rows32.shape[0]} rows")
    starts = _clamp_starts(seg_starts, rows32.shape[0], seg_chunks)
    if rows32.device.type == "cpu":
        return byte_scan_plain(rows32, needle_bytes, real_lens, n_real, starts, seg_chunks)
    out = _launch(rows32, needle_bytes, real_lens, n_segs * seg_chunks, starts, seg_chunks)
    _count("segments", n_segs * seg_chunks, n_real, n_segs, seg_chunks, max_words)
    return out
