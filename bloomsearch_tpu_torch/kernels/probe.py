"""Block-bloom probe (K1) with its fused epilogues: wrappers and plain versions.

The CUDA kernel (``csrc/probe.cu``) replaces the JAX package's Pallas probe
``bloom/pallas_kernels.py::probe_bank_pallas_tk`` and the three XLA epilogues
around it (``probe_and_pack``, ``probe_reduce_and_pack``,
``probe_clauses_pack``). It is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface at first use, and bound with
``ctypes``.

Each wrapper takes the bank ``int32[R, C]`` and the flat probe arrays
``row_idx``/``shift`` ``int32[T*K]`` on one device:

- a CUDA tensor launches the kernel on the current stream, or raises;
- a CPU tensor runs the plain PyTorch version in this module.

Outputs are packed ``int32[rows, C/32]`` words: bit i of word w is column
32w+i (the JAX package's ``pack_bitmap`` contract, read as uint32 on the
host). Clause and member masks are bit masks: bit t of ``clause_bits[i]``
puts term t in clause i, bit i of ``member_bits[m]`` puts clause i in
member m.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Sequence

import torch

from . import build

SOURCE = os.path.join(build.CSRC_DIR, "probe.cu")
LIBRARY = os.path.join(build.BUILD_DIR, "libbs_probe.so")

MODE_PACK, MODE_REDUCE, MODE_CLAUSES = 0, 1, 2
MAX_TERMS = 32  # the term results live in one 32-bit register per column
MAX_CLAUSES = 32
MAX_MEMBERS = 32
MAX_PROBES = 6144  # T*K row indices + shifts must fit 48 KB of shared memory

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_count_lock = threading.Lock()
_launches = {"pack": 0, "reduce_and": 0, "clauses": 0}
# (epilogue, C, T, output rows, clauses) -> kernel launches
_shapes: dict[tuple[str, int, int, int, int], int] = {}


def launch_counts() -> dict[str, int]:
    """Kernel launches per epilogue since the last reset."""
    with _count_lock:
        return dict(_launches)


def launch_shapes() -> dict[tuple[str, int, int, int, int], int]:
    """Kernel launches per (epilogue, columns C, terms T, output rows,
    clauses) since the last reset."""
    with _count_lock:
        return dict(_shapes)


def reset_launch_counts() -> None:
    with _count_lock:
        for name in _launches:
            _launches[name] = 0
        _shapes.clear()


def _count(name: str, C: int, T: int, rows: int, clauses: int = 0) -> None:
    with _count_lock:
        _launches[name] += 1
        key = (name, C, T, rows, clauses)
        _shapes[key] = _shapes.get(key, 0) + 1


# -- build and bind ---------------------------------------------------------


def build_library(force: bool = False) -> str:
    """Compile ``csrc/probe.cu`` unless the library is newer (``build.py``)."""
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
            p, i64, i32, u32 = (
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_uint32,
            )
            lib.bs_probe_launch.argtypes = [
                p, i64, i64, p, p, i32, i32, i32, u32, p, i32, p, i32, p, p,
            ]
            lib.bs_probe_launch.restype = ctypes.c_int
            _lib = lib
    return _lib


# -- argument checks --------------------------------------------------------


def _check(bank: torch.Tensor, row_idx: torch.Tensor, shift: torch.Tensor,
           T: int, K: int) -> None:
    if bank.dim() != 2 or bank.dtype != torch.int32 or not bank.is_contiguous():
        raise ValueError("bank must be a contiguous int32[R, C] tensor")
    if bank.shape[1] % 32:
        raise ValueError(f"bank columns must be a multiple of 32, got {bank.shape[1]}")
    for name, t in (("row_idx", row_idx), ("shift", shift)):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32[T*K] tensor")
        if t.device != bank.device:
            raise ValueError(f"{name} is on {t.device}, bank on {bank.device}")
        if t.shape[0] != T * K:
            raise ValueError(f"{name} has {t.shape[0]} entries, want T*K = {T * K}")
    if not 1 <= T <= MAX_TERMS or K < 1 or T * K > MAX_PROBES:
        raise ValueError(f"unsupported probe shape T={T} K={K}")


def _bits(values: Sequence[int], limit: int, what: str) -> tuple:
    values = [int(v) & 0xFFFFFFFF for v in values]
    if len(values) > limit:
        raise ValueError(f"{len(values)} {what} exceed the kernel's {limit}")
    return (ctypes.c_uint32 * max(len(values), 1))(*values), len(values)


def _launch(bank, row_idx, shift, T, K, mode, out_rows, and_bits=0,
            clause_bits=(), member_bits=()) -> torch.Tensor:
    if bank.device.type != "cuda":
        raise ValueError(f"the probe kernel runs on CUDA tensors, got {bank.device}")
    R, C = bank.shape
    clauses, n_clauses = _bits(clause_bits, MAX_CLAUSES, "clauses")
    members, n_members = _bits(member_bits, MAX_MEMBERS, "members")
    lib = library()
    with torch.cuda.device(bank.device):
        out = torch.empty((out_rows, C // 32), dtype=torch.int32, device=bank.device)
        stream = torch.cuda.current_stream(bank.device).cuda_stream
        err = lib.bs_probe_launch(
            bank.data_ptr(), R, C, row_idx.data_ptr(), shift.data_ptr(), T, K, mode,
            int(and_bits) & 0xFFFFFFFF, clauses, n_clauses, members, n_members,
            out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"probe kernel launch failed: cudaError {err}")
    return out


# -- plain versions (the CPU path and the kernel's reference) ----------------


def probe_plain(bank: torch.Tensor, row_idx: torch.Tensor, shift: torch.Tensor,
                T: int, K: int) -> torch.Tensor:
    """-> bool[T, C]: term t matches column c iff all K probed bits are set.

    ``>>`` on int32 is arithmetic, but ``& 1`` keeps exactly bit ``shift``,
    so shift 31 on a word with the top bit set still reads 1."""
    rows = bank.index_select(0, row_idx.long())  # [T*K, C]
    bits = (rows >> shift[:, None]) & 1
    return (bits != 0).view(T, K, -1).all(dim=1)


def pack_bitmap_plain(match: torch.Tensor) -> torch.Tensor:
    """bool[T, C] -> int32[T, C/32]; bit i of word w is column 32w+i."""
    T, C = match.shape
    weights = torch.ones(32, dtype=torch.int64, device=match.device) << torch.arange(
        32, device=match.device
    )
    words = (match.view(T, C // 32, 32).to(torch.int64) * weights).sum(dim=2)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def reduce_and_plain(match: torch.Tensor, and_bits: int) -> torch.Tensor:
    """bool[T, C] -> bool[1, C]: AND over the terms in ``and_bits``."""
    T = match.shape[0]
    active = torch.tensor(
        [(int(and_bits) >> t) & 1 for t in range(T)], dtype=torch.bool, device=match.device
    )
    return (match | ~active[:, None]).all(dim=0, keepdim=True)


def clauses_plain(match: torch.Tensor, clause_bits: Sequence[int],
                  member_bits: Sequence[int]) -> torch.Tensor:
    """bool[T, C] -> bool[M, C]: member m survives iff none of its clauses
    fails; clause i fails iff none of its terms match."""
    T = match.shape[0]
    clause = torch.tensor(
        [[(int(b) >> t) & 1 for t in range(T)] for b in clause_bits],
        dtype=torch.float32, device=match.device,
    ).reshape(len(clause_bits), T)
    member = torch.tensor(
        [[(int(b) >> i) & 1 for i in range(len(clause_bits))] for b in member_bits],
        dtype=torch.float32, device=match.device,
    ).reshape(len(member_bits), len(clause_bits))
    clause_false = (clause @ match.to(torch.float32)) < 0.5  # [Cl, C]
    return ~((member @ clause_false.to(torch.float32)) > 0.5)


# -- wrappers ---------------------------------------------------------------


def probe_and_pack(bank, row_idx, shift, T: int, K: int) -> torch.Tensor:
    """-> int32[T, C/32]: the packed match rows of the T terms."""
    _check(bank, row_idx, shift, T, K)
    if bank.device.type == "cpu":
        return pack_bitmap_plain(probe_plain(bank, row_idx, shift, T, K))
    out = _launch(bank, row_idx, shift, T, K, MODE_PACK, T)
    _count("pack", bank.shape[1], T, T)
    return out


def probe_reduce_and_pack(bank, row_idx, shift, T: int, K: int,
                          and_bits: int) -> torch.Tensor:
    """-> int32[1, C/32]: columns where every term in ``and_bits`` matches
    (terms outside it count as true)."""
    _check(bank, row_idx, shift, T, K)
    if bank.device.type == "cpu":
        match = probe_plain(bank, row_idx, shift, T, K)
        return pack_bitmap_plain(reduce_and_plain(match, and_bits))
    out = _launch(bank, row_idx, shift, T, K, MODE_REDUCE, 1, and_bits=and_bits)
    _count("reduce_and", bank.shape[1], T, 1)
    return out


def probe_clauses_pack(bank, row_idx, shift, T: int, K: int,
                       clause_bits: Sequence[int],
                       member_bits: Sequence[int]) -> torch.Tensor:
    """-> int32[M, C/32]: the CNF survivors of each of the M members."""
    _check(bank, row_idx, shift, T, K)
    if len(clause_bits) > MAX_CLAUSES or len(member_bits) > MAX_MEMBERS:
        raise ValueError("too many clauses or members for one launch")
    if bank.device.type == "cpu":
        match = probe_plain(bank, row_idx, shift, T, K)
        return pack_bitmap_plain(clauses_plain(match, clause_bits, member_bits))
    out = _launch(
        bank, row_idx, shift, T, K, MODE_CLAUSES, len(member_bits),
        clause_bits=clause_bits, member_bits=member_bits,
    )
    _count("clauses", bank.shape[1], T, len(member_bits), len(clause_bits))
    return out
