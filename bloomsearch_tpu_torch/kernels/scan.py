"""Stream byte scan (K2) in its dense and segment modes: wrappers and the
plain version.

The CUDA kernel (``csrc/scan.cu``) replaces the JAX package's Pallas kernel
``bloom/pallas_kernels.py::byte_scan_pallas_swar`` in stream mode and the
XLA code around it in ``rowcache.py::_device_scan_fn`` (``scan_all`` and
``scan_segments``, whose ``dynamic_slice`` + ``concatenate`` copy the kernel
replaces with a row mapping over ranges that may differ in length). It is
compiled with ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface at first use, and bound with ``ctypes``.

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

``byte_scan_ranges_into`` is one segment-mode launch over up to
``MAX_SEGMENTS`` ranges of one card's stream tensors (each range has its
own base pointer), with its words stored at a given first word of each row
of an output that may be wider and may be page-locked host memory, which
the kernel then writes through its device address.
``byte_scan_plan_into`` is what the sharded scans (K3, ``parallel/mesh.py``)
and the row cache's scans on one card, sparse and dense, call: every launch
of one call (a plan of such launches, on one card or several) into one
page-locked joined bitmap, issued and waited for in one foreign call
(``csrc/scan.cu``'s ``bs_scan_plan``), which ctypes makes with the
interpreter lock released.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Mapping, Optional, Sequence, Union

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
TILE_CHUNKS = 32  # chunks of one kernel tile and one output word

# One launch of a plan: (first output word, [(stream tensor, first row,
# rows), ...] of up to MAX_SEGMENTS ranges on one device).
PlanLaunchArgs = tuple[int, Sequence[tuple[torch.Tensor, int, int]]]


class PlanLaunch(ctypes.Structure):
    """One launch record of ``bs_scan_plan``, the mirror of ``csrc/scan.cu``'s
    ``PlanLaunch`` (128 bytes without padding: device 0, n_ranges 4, stream
    8, base 16, start 48, chunks 80, rows_total 112, first_word 120;
    n_ranges 0 is dense mode over ``base[0]``'s ``rows_total`` rows).
    ``library()`` refuses a build whose record size differs."""

    _fields_ = [
        ("device", ctypes.c_int32),
        ("n_ranges", ctypes.c_int32),
        ("stream", ctypes.c_void_p),
        ("base", ctypes.c_void_p * MAX_SEGMENTS),
        ("start", ctypes.c_int64 * MAX_SEGMENTS),
        ("chunks", ctypes.c_int64 * MAX_SEGMENTS),
        ("rows_total", ctypes.c_int64),
        ("first_word", ctypes.c_int64),
    ]


_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_count_lock = threading.Lock()
_launches = {"stream": 0, "segments": 0}
# (mode, logical chunks G, n_real, n_segs, range chunk counts) -> launches;
# the range counts are () for a dense-mode launch (byte_scan_stream, or a
# plan's launch of one range over a whole base), else the ranges' rows.
_shapes: dict[tuple[str, int, int, int, tuple[int, ...]], int] = {}


def launch_counts() -> dict[str, int]:
    """Kernel launches per mode since the last reset."""
    with _count_lock:
        return dict(_launches)


def launch_shapes() -> dict[tuple[str, int, int, int, tuple[int, ...]], int]:
    """Kernel launches per (mode, logical chunks G, n_real, n_segs, range
    chunk counts as launched) since the last reset."""
    with _count_lock:
        return dict(_shapes)


def reset_launch_counts() -> None:
    with _count_lock:
        for name in _launches:
            _launches[name] = 0
        _shapes.clear()


def _count(mode: str, G: int, n_real: int, range_chunks: Sequence[int]) -> None:
    with _count_lock:
        _launches[mode] += 1
        key = (mode, G, n_real, len(range_chunks), tuple(range_chunks))
        _shapes[key] = _shapes.get(key, 0) + 1


# -- build and bind ---------------------------------------------------------


def build_library(force: bool = False) -> str:
    """Compile ``csrc/scan.cu`` unless the library is newer (``build.py``)."""
    return build.build_library(SOURCE, LIBRARY, force)


def library() -> ctypes.CDLL:
    """The kernel library, built at first use and bound with ctypes. Raises
    when its plan record is not the size of ``PlanLaunch`` (a launch would
    read its pointers from the wrong bytes)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            build_library()
            lib = ctypes.CDLL(LIBRARY)
            p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            lib.bs_scan_launch.argtypes = [p, i64, i64, p, p, i32, p, p, p, i32, p, i64, i64,
                                           i32, i32, p]
            lib.bs_scan_launch.restype = ctypes.c_int
            lib.bs_scan_plan.argtypes = [p, p, i32, p, i32, p, i64, p]
            lib.bs_scan_plan.restype = ctypes.c_int
            lib.bs_scan_plan_record_size.argtypes = []
            lib.bs_scan_plan_record_size.restype = ctypes.c_int
            size = lib.bs_scan_plan_record_size()
            if size != ctypes.sizeof(PlanLaunch):
                raise RuntimeError(f"{LIBRARY}: a plan record is {size} bytes, PlanLaunch "
                                   f"{ctypes.sizeof(PlanLaunch)}")
            _lib = lib
    return _lib


# -- argument checks --------------------------------------------------------


def _check(rows32: torch.Tensor, needles: np.ndarray, lens: np.ndarray,
           n_real: int) -> tuple[np.ndarray, np.ndarray]:
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
    # A value with any bit above the low byte (a negative one included) is
    # not a byte: one reduction finds it.
    if int(np.bitwise_or.reduce(real, axis=None)) & ~0xFF:
        raise ValueError("needle values must be bytes (0..255)")
    lens = lens[:n_real].astype(np.int32)
    short = lens.tolist()
    if min(short) < 0 or max(short) > MAX_SCAN_WINDOW:
        raise ValueError(f"needle lengths {short}: the kernel takes 0..{MAX_SCAN_WINDOW}")
    return real.astype(np.uint8), lens


def segment_layout(starts: Sequence[int], chunks: Union[int, Sequence[int]],
                   rows: int) -> tuple[list[int], list[int]]:
    """Requested ranges (first row, chunk count; one count for all, or one
    each) -> (the first row the kernel reads for each, each count rounded
    up to a multiple of 32). A rounded range is clamped into the stream as
    ``dynamic_slice`` clamps a segment, so one ending at the stream's end
    stays legal; range p's requested chunks then sit at logical chunk
    ``sum(rounded[:p]) + start - read_start`` of the output. Raises on what
    the kernel does not take."""
    n_segs = len(starts)
    counts = [chunks] * n_segs if isinstance(chunks, (int, np.integer)) else list(chunks)
    if not 1 <= n_segs <= MAX_SEGMENTS or len(counts) != n_segs:
        raise ValueError(f"{n_segs} ranges with {len(counts)} counts: the kernel takes "
                         f"1..{MAX_SEGMENTS}")
    rounded = [-(-int(n) // TILE_CHUNKS) * TILE_CHUNKS for n in counts]
    if min(counts) <= 0 or max(rounded) > rows:
        raise ValueError(f"range chunk counts {counts} for a stream of {rows} rows")
    return [min(max(int(s), 0), rows - n) for s, n in zip(starts, rounded)], rounded


# -- the plain version (the CPU path and the kernel's reference) -------------


def byte_scan_plain(rows32: torch.Tensor, needles: np.ndarray, lens: np.ndarray,
                    n_real: int, seg_starts: Optional[Sequence[int]] = None,
                    seg_chunks: Union[int, Sequence[int]] = 0) -> torch.Tensor:
    """-> int32[n_real, G/32]: the sliding-window form of the JAX package's
    ``_scan_matrix`` over every logical chunk (``rows32``, or the ranges at
    ``seg_starts`` of ``seg_chunks`` chunks, laid out by
    ``segment_layout`` and concatenated).

    Allocates bool[n_real, G, 480]: call it in pieces over a large stream.
    ``>>`` on int32 is arithmetic, but ``& 0xFF`` keeps exactly byte i, so
    bytes >= 0x80 in the top position read right."""
    if seg_starts is not None:
        starts, counts = segment_layout(seg_starts, seg_chunks, rows32.shape[0])
        rows32 = torch.cat([rows32[s : s + n] for s, n in zip(starts, counts)])
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
            chunks: int, starts: Sequence[int], range_chunks: Sequence[int],
            out: Optional[torch.Tensor] = None, first_word: int = 0,
            bases: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    """One launch on ``rows32``'s card: dense (no ranges) or over the
    ranges (each in its own base of ``bases``, else in ``rows32``), into
    ``out`` from ``first_word`` on (a new int32[n_real, chunks/32] on the
    card when None) -> ``out``. Counts nothing (the wrappers count)."""
    if rows32.device.type != "cuda":
        raise ValueError(f"the scan kernel runs on CUDA tensors, got {rows32.device}")
    n_real = needle_bytes.shape[0]
    seg = np.ascontiguousarray(starts, dtype=np.int64).reshape(-1)
    counts = np.ascontiguousarray(range_chunks, dtype=np.int64).reshape(-1)
    table = (ctypes.c_void_p * len(bases))(*[b.data_ptr() for b in bases]) if bases else None
    lib = library()
    with torch.cuda.device(rows32.device):
        if out is None:
            out = torch.empty((n_real, chunks // 32), dtype=torch.int32, device=rows32.device)
        stream = torch.cuda.current_stream(rows32.device).cuda_stream
        err = lib.bs_scan_launch(
            rows32.data_ptr(), rows32.shape[0], chunks,
            needle_bytes.ctypes.data, lens.ctypes.data, n_real, table,
            seg.ctypes.data if seg.size else None,
            counts.ctypes.data if counts.size else None, seg.size,
            out.data_ptr(), out.shape[1], first_word, out.device.type == "cpu",
            rows32.device.index, stream,
        )
    if err != 0:
        raise RuntimeError(f"scan kernel launch failed: cudaError {err}")
    return out


def byte_scan_stream(rows32: torch.Tensor, needles: np.ndarray, lens: np.ndarray,
                     *, n_real: int) -> torch.Tensor:
    """Dense mode (``scan_all``): -> int32[n_real, rows/32] over every row."""
    needle_bytes, real_lens = _check(rows32, needles, lens, n_real)
    G = rows32.shape[0]
    if G == 0 or G % 32:
        raise ValueError(f"the stream's rows must be a positive multiple of 32, got {G}")
    if rows32.device.type == "cpu":
        return byte_scan_plain(rows32, needle_bytes, real_lens, n_real)
    out = _launch(rows32, needle_bytes, real_lens, G, (), ())
    _count("stream", G, n_real, ())
    return out


def byte_scan_segments(rows32: torch.Tensor, seg_starts: Sequence[int],
                       needles: np.ndarray, lens: np.ndarray, *, n_real: int,
                       seg_chunks: Union[int, Sequence[int]]) -> torch.Tensor:
    """Segment mode (``scan_segments``): -> int32[n_real, sum(rounded)/32]
    over up to 4 ranges at ``seg_starts`` of ``seg_chunks`` chunks (one
    count for all, the JAX package's form, or one each), each rounded up
    to a multiple of 32 chunks and clamped into the stream
    (``segment_layout``), in order. The chunks added by rounding are read
    and scanned; callers ignore their bits."""
    needle_bytes, real_lens = _check(rows32, needles, lens, n_real)
    starts, counts = segment_layout(seg_starts, seg_chunks, rows32.shape[0])
    if rows32.device.type == "cpu":
        return byte_scan_plain(rows32, needle_bytes, real_lens, n_real, starts, counts)
    out = _launch(rows32, needle_bytes, real_lens, sum(counts), starts, counts)
    _count("segments", sum(counts), n_real, counts)
    return out


def byte_scan_ranges_into(out: torch.Tensor, first_word: int, bases: Sequence[torch.Tensor],
                          starts: Sequence[int], counts: Sequence[int], needles: np.ndarray,
                          lens: np.ndarray, *, n_real: int,
                          count_as: str = "segments") -> None:
    """Segment mode over up to ``MAX_SEGMENTS`` ranges in one launch:
    range r reads rows ``[starts[r], starts[r] + counts[r])`` of
    ``bases[r]`` (stream tensors ``int32[rows, 128]`` of one shape, type and
    device; each count a positive multiple of 32), and the ranges' packed
    words land one after another at ``out[:, first_word : first_word +
    sum(counts)/32]``, ``out`` being ``int32[n_real, >= that]``.

    On CUDA bases: one launch on their card, counted once as a
    ``count_as`` launch (its shape key holds the launch's chunk count and
    the range counts); ``out`` lies on that card or in page-locked host
    memory the card can address, else the launch raises. On CPU bases: the
    plain version, range by range, into the same slices (counted
    nowhere)."""
    n = len(bases)
    if not 1 <= n <= MAX_SEGMENTS or len(starts) != n or len(counts) != n:
        raise ValueError(f"{n} bases, {len(starts)} starts and {len(counts)} counts: one "
                         f"launch takes 1..{MAX_SEGMENTS} ranges")
    first = bases[0]
    needle_bytes, real_lens = _check(first, needles, lens, n_real)
    for b in bases:
        if b.shape != first.shape or b.dtype != first.dtype or b.device != first.device \
                or not b.is_contiguous():
            raise ValueError("the bases of one launch must be contiguous tensors of one "
                             "shape, type and device")
    rows = first.shape[0]
    starts, counts = [int(v) for v in starts], [int(v) for v in counts]
    for s, c in zip(starts, counts):
        if c <= 0 or c % TILE_CHUNKS or s < 0 or s + c > rows:
            raise ValueError(f"range [{s}, {s + c}) of a {rows}-row base: counts must be "
                             f"positive multiples of {TILE_CHUNKS} inside the base")
    chunks = sum(counts)
    if (out.dim() != 2 or out.dtype != torch.int32 or not out.is_contiguous()
            or out.shape[0] != n_real or first_word < 0
            or out.shape[1] < first_word + chunks // 32):
        raise ValueError(f"out must be a contiguous int32[{n_real}, >= "
                         f"{first_word + chunks // 32}] tensor")
    if first.device.type == "cpu":
        at = first_word
        for b, s, c in zip(bases, starts, counts):
            out[:, at : at + c // 32] = byte_scan_plain(b[s : s + c], needle_bytes, real_lens,
                                                        n_real)
            at += c // 32
        return
    if out.device.type != "cpu" and out.device != first.device:
        raise ValueError(f"out is on {out.device}, the bases on {first.device}")
    _launch(first, needle_bytes, real_lens, chunks, starts, counts, out, first_word, bases)
    _count(count_as, chunks, n_real, counts)


def _check_plan(out: torch.Tensor, plan: Sequence[PlanLaunchArgs],
                n_real: int) -> list[tuple[torch.device, int]]:
    """Refuse a plan the kernel does not take -> each launch's (device,
    chunks). Each distinct base is checked once (a plan's ranges share a
    few shards)."""
    if not plan:
        raise ValueError("an empty plan")
    first = plan[0][1][0][0]
    shape, dtype, kind = first.shape, first.dtype, first.device.type
    rows = shape[0]
    if (out.dim() != 2 or out.dtype != torch.int32 or not out.is_contiguous()
            or out.shape[0] != n_real):
        raise ValueError(f"out must be a contiguous int32[{n_real}, words] tensor")
    width = out.shape[1]
    devices: dict[int, torch.device] = {}  # id of a checked base -> its device
    launches = []
    for first_word, ranges in plan:
        if not 1 <= len(ranges) <= MAX_SEGMENTS:
            raise ValueError(f"a launch of {len(ranges)} ranges: it takes 1..{MAX_SEGMENTS}")
        device = None
        n = 0
        for base, s, c in ranges:
            at = devices.get(id(base))
            if at is None:
                if base.shape != shape or base.dtype != dtype or not base.is_contiguous() \
                        or base.device.type != kind:
                    raise ValueError("a plan's bases must be contiguous tensors of one shape "
                                     "and type")
                at = devices[id(base)] = base.device
            if device is None:
                device = at
            elif at != device:
                raise ValueError(f"a launch's ranges lie on {device} and {at}")
            if c <= 0 or c % TILE_CHUNKS or s < 0 or s + c > rows:
                raise ValueError(f"range [{s}, {s + c}) of a {rows}-row base: counts must be "
                                 f"positive multiples of {TILE_CHUNKS} inside the base")
            n += c
        if first_word < 0 or width < first_word + n // TILE_CHUNKS:
            raise ValueError(f"a launch of {n} chunks from word {first_word} of {width}")
        launches.append((device, n))
    return launches


def launched_ranges(ranges: Sequence[tuple[torch.Tensor, int, int]]) -> tuple[int, ...]:
    """A plan launch's range counts as ``bs_scan_plan`` launches them: ()
    for one range over the whole of its base, which is a dense-mode record
    (the same words, and dense mode is the faster loop), else each range's
    rows."""
    if len(ranges) == 1 and ranges[0][1] == 0 and ranges[0][2] == ranges[0][0].shape[0]:
        return ()
    return tuple(c for _, _, c in ranges)


def plan_records(plan: Sequence[PlanLaunchArgs], streams: Mapping) -> ctypes.Array:
    """``plan`` as ``bs_scan_plan``'s records, each launch on the stream
    handle ``streams`` gives for its device (-1 stands for the CPU's
    device index, which no card has); a launch of one range over a whole
    base is a dense-mode record (``launched_ranges``)."""
    records = (PlanLaunch * len(plan))()
    for rec, (first_word, ranges) in zip(records, plan):
        device = ranges[0][0].device
        rec.device = -1 if device.index is None else device.index
        rec.n_ranges = len(launched_ranges(ranges))
        rec.stream = streams[device]
        for r, (base, s, c) in enumerate(ranges):
            rec.base[r] = base.data_ptr()
            rec.start[r] = s
            rec.chunks[r] = c
        rec.rows_total = ranges[0][0].shape[0]
        rec.first_word = first_word
    return records


def plan_call(needle_bytes: np.ndarray, lens: np.ndarray, records: ctypes.Array,
              out: torch.Tensor, stamps: Optional[ctypes.Array] = None) -> None:
    """The one foreign call of a plan (``_check``'s needle arrays, the
    records, the page-locked output); ``stamps``, an int64[2] ctypes array,
    gets the monotonic ns at its entry and once it has issued everything."""
    err = library().bs_scan_plan(needle_bytes.ctypes.data, lens.ctypes.data,
                                 needle_bytes.shape[0], records, len(records), out.data_ptr(),
                                 out.shape[1], stamps)
    if err != 0:
        raise RuntimeError(f"scan plan failed: cudaError {err}")


def byte_scan_plan_into(out: torch.Tensor, plan: Sequence[PlanLaunchArgs], needles: np.ndarray,
                        lens: np.ndarray, *, n_real: int,
                        count_as: str = "segments") -> None:
    """Every launch of ``plan`` into ``out`` (``int32[n_real, words]``):
    launch ``(first_word, ranges)`` reads ranges ``(base, first row, rows)``
    of stream tensors ``int32[rows, 128]`` of one shape on one device (rows
    a positive multiple of 32), and its packed words land one after another
    at ``out[:, first_word:]``.

    On CUDA bases: ``out`` is page-locked host memory and the whole plan is
    one foreign call (``bs_scan_plan``): the needles checked and packed
    once, each launch issued on its card's current stream, every card's
    launches issued before any is waited for, and the call returns once
    every card is done (after a failure too, before it raises), the
    caller's current device unchanged. One range over a whole base
    launches in dense mode. Each launch counts once as a ``count_as``
    launch (its shape key: the launch's chunks and range counts as
    launched, ``launched_ranges``). On CPU bases: the plain version, range
    by range, into the same slices (counted nowhere)."""
    if not plan:
        raise ValueError("an empty plan")
    first = plan[0][1][0][0]
    needle_bytes, real_lens = _check(first, needles, lens, n_real)
    launches = _check_plan(out, plan, n_real)
    if first.device.type == "cpu":
        for first_word, ranges in plan:
            at = first_word
            for base, s, c in ranges:
                out[:, at : at + c // TILE_CHUNKS] = byte_scan_plain(
                    base[s : s + c], needle_bytes, real_lens, n_real)
                at += c // TILE_CHUNKS
        return
    if out.device.type != "cpu":
        raise ValueError(f"a plan writes page-locked host memory, not {out.device}")
    # Each card's current stream as its raw handle: the value of
    # torch.cuda.current_stream(device).cuda_stream, from the getter torch's
    # own generated kernels use, with no Stream object built for it.
    streams = {device: torch._C._cuda_getCurrentRawStream(device.index)
               for device in dict.fromkeys(device for device, _ in launches)}
    plan_call(needle_bytes, real_lens, plan_records(plan, streams), out)
    for (_, ranges), (_, n) in zip(plan, launches):
        _count(count_as, n, n_real, launched_ranges(ranges))
