"""Block-bloom probe (K1) with its fused epilogues: wrappers and plain versions.

The CUDA kernel (``csrc/probe.cu``) replaces the JAX package's Pallas probe
``bloom/pallas_kernels.py::probe_bank_pallas_tk`` and the three XLA epilogues
around it (``probe_and_pack``, ``probe_reduce_and_pack``,
``probe_clauses_pack``). It is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface at first use, and bound with
``ctypes``. It runs one warp for each (term, 32-column word), with each
term's K loads in flight together, and blocks of at least 4 warps
(``BLOCK_WARPS`` in ``csrc/probe.cu``) where the bank is wide enough.

Each wrapper takes the bank ``int32[R, C]`` and the flat probe arrays
``row_idx``/``shift`` ``int32[T*K]``. The probe arrays are host data, numpy
arrays or CPU tensors, whatever the bank's device:

- a bank on CUDA launches the kernel on the current stream, with the probe
  arrays in the launch's parameters (no host-to-device copy), or raises;
- a bank on the CPU runs the plain PyTorch version in this module;
- a probe array on any other device raises ``ValueError`` (it is never
  copied back to the host behind the caller's back).

One launch takes at most ``MAX_TERMS`` (32) terms and ``MAX_PROBES`` (6,400)
probes T*K: the probes travel in one kernel parameter struct, and 6,400 of
them (four bytes of row and one of shift each, plus 16 spare) with the
epilogue masks and the shard table fill 32,480 of the 32,764 bytes that
CUDA 12.1 and later allow a launch's parameters. Rows are any int32; a row
outside [0, R) reads 0.

Outputs are packed ``int32[rows, C/32]`` words: bit i of word w is column
32w+i (the JAX package's ``pack_bitmap`` contract, read as uint32 on the
host). Clause and member masks are bit masks: bit t of ``clause_bits[i]``
puts term t in clause i, bit i of ``member_bits[m]`` puts clause i in
member m.

``probe_plan_into`` is what the sharded wrappers (K3, ``parallel/mesh.py``)
and the single-device combiner (``bloom/bank.py``) call, through
``probe_plan``: every launch of one probe (a plan of launches on one card
or several, each over up to ``MAX_SHARDS`` banks of one card, all ``[R,
C]``, as one bank of their columns side by side) into one output that may
be page-locked host memory, which the kernel then writes through its
device address, issued and waited for in one foreign call
(``csrc/probe.cu``'s ``bs_probe_plan``), which ctypes makes with the
interpreter lock released. The single-bank wrappers above launch into a
new device tensor and wait for nothing, so a CUDA graph can capture them.

``probe_floor`` (K1f) is the probe's access-pattern floor: K1's launch
shape (its warps and blocks, its by-value probes), loads and row check with
an OR in place of the bit math, written unpacked as ``int32[T, C]``. It
replaces the Pallas floor kernel of ``scripts/exp_kernel_floor.py`` and is
timed beside K1 by ``tools/exp_kernel_floor.py``.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Callable, Mapping, Optional, Sequence

import numpy as np
import torch

from . import build

SOURCE = os.path.join(build.CSRC_DIR, "probe.cu")
LIBRARY = os.path.join(build.BUILD_DIR, "libbs_probe.so")

MODE_PACK, MODE_REDUCE, MODE_CLAUSES = 0, 1, 2
MAX_TERMS = 32  # a block holds the warps of every term of its words: <= 32 warps
MAX_CLAUSES = 32
MAX_MEMBERS = 32
MAX_PROBES = 6400  # T*K: csrc/probe.cu CAP_MAX, the kernel's parameters (module doc)
MAX_SHARDS = 8  # banks one launch covers: csrc/probe.cu MAX_SHARDS
EPILOGUE_MODES = {"pack": MODE_PACK, "reduce_and": MODE_REDUCE, "clauses": MODE_CLAUSES}

# One launch of a plan: (first output word, up to MAX_SHARDS banks of one
# device, all of one shape).
PlanLaunchArgs = tuple[int, Sequence[torch.Tensor]]


class PlanLaunch(ctypes.Structure):
    """One launch record of ``bs_probe_plan``, the mirror of
    ``csrc/probe.cu``'s ``PlanLaunch`` (104 bytes without padding: device 0,
    n_shards 4, stream 8, shards 16, R 80, C 88, first_word 96). ``bind``
    refuses a build whose record size differs."""

    _fields_ = [
        ("device", ctypes.c_int32),
        ("n_shards", ctypes.c_int32),
        ("stream", ctypes.c_void_p),
        ("shards", ctypes.c_void_p * MAX_SHARDS),
        ("R", ctypes.c_int64),
        ("C", ctypes.c_int64),
        ("first_word", ctypes.c_int64),
    ]

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_count_lock = threading.Lock()
_launches = {"pack": 0, "reduce_and": 0, "clauses": 0, "floor": 0}
# (epilogue or "floor", C, T, output rows, clauses) -> kernel launches
_shapes: dict[tuple[str, int, int, int, int], int] = {}
# The launches noted by the capture in progress (``CapturedLaunches``), if any.
_capture: Optional[dict[tuple[str, int, int, int, int], int]] = None


def launch_counts() -> dict[str, int]:
    """Kernel launches per epilogue (and of the floor kernel) since the last
    reset."""
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


def _add(key: tuple[str, int, int, int, int], n: int) -> None:
    _launches[key[0]] += n
    _shapes[key] = _shapes.get(key, 0) + n


def _count(name: str, C: int, T: int, rows: int, clauses: int = 0) -> None:
    """One launch, counted where it runs. A launch into a stream that is
    being captured runs nothing: it is noted in the ``CapturedLaunches``
    that captures it, whose replays count it."""
    key = (name, C, T, rows, clauses)
    with _count_lock:
        if not torch.cuda.is_current_stream_capturing():
            _add(key, 1)
        elif _capture is None:
            raise RuntimeError("probe launches are captured through CapturedLaunches")
        else:
            _capture[key] = _capture.get(key, 0) + 1


class CapturedLaunches:
    """Probe launches captured once into a CUDA graph: ``record()`` makes
    them, on ``device``, and nothing runs until ``replay``, which runs the
    graph on the current stream and counts each launch it holds."""

    def __init__(self, record: Callable[[], object], device):
        global _capture
        self.graph = torch.cuda.CUDAGraph()
        self.launches: dict[tuple[str, int, int, int, int], int] = {}
        with _count_lock:
            if _capture is not None:
                raise RuntimeError("another capture of probe launches is in progress")
            _capture = self.launches
        try:
            with torch.cuda.device(device), torch.cuda.graph(self.graph):
                record()
        finally:
            with _count_lock:
                _capture = None

    def replay(self) -> None:
        self.graph.replay()
        with _count_lock:
            for key, n in self.launches.items():
                _add(key, n)


# -- build and bind ---------------------------------------------------------


def build_library(force: bool = False) -> str:
    """Compile ``csrc/probe.cu`` unless the library is newer (``build.py``)."""
    return build.build_library(SOURCE, LIBRARY, force)


def bind(path: str) -> ctypes.CDLL:
    """Load a library built from ``csrc/probe.cu`` and declare its C entry
    points. Raises when its plan record is not the size of ``PlanLaunch``
    (a launch would read its pointers from the wrong bytes)."""
    lib = ctypes.CDLL(path)
    p, i64, i32, u32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_uint32
    lib.bs_probe_launch.argtypes = [
        p, i32, i64, i64, p, p, i32, i32, i32, u32, p, i32, p, i32, p, i64, i64, i32, i32, p,
    ]
    lib.bs_probe_launch.restype = ctypes.c_int
    lib.bs_probe_floor_launch.argtypes = [p, i64, i64, p, p, i32, i32, p, p]
    lib.bs_probe_floor_launch.restype = ctypes.c_int
    lib.bs_probe_plan.argtypes = [p, p, i32, i32, i32, u32, p, i32, p, i32, p, i32, p, i64, i32,
                                  p]
    lib.bs_probe_plan.restype = ctypes.c_int
    lib.bs_probe_plan_record_size.argtypes = []
    lib.bs_probe_plan_record_size.restype = ctypes.c_int
    size = lib.bs_probe_plan_record_size()
    if size != ctypes.sizeof(PlanLaunch):
        raise RuntimeError(f"{path}: a plan record is {size} bytes, PlanLaunch "
                           f"{ctypes.sizeof(PlanLaunch)}")
    return lib


def library() -> ctypes.CDLL:
    """The kernel library, built at first use and bound with ctypes."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            build_library()
            _lib = bind(LIBRARY)
    return _lib


# -- argument checks --------------------------------------------------------


def _check(bank: torch.Tensor, row_idx, shift, T: int, K: int) -> tuple:
    """Check the arguments -> (row_idx, shift) as host int32[T*K] arrays
    (numpy views of CPU tensors, no copy)."""
    if bank.dim() != 2 or bank.dtype != torch.int32 or not bank.is_contiguous():
        raise ValueError("bank must be a contiguous int32[R, C] tensor")
    if bank.shape[1] % 32:
        raise ValueError(f"bank columns must be a multiple of 32, got {bank.shape[1]}")
    if not 1 <= T <= MAX_TERMS or K < 1 or T * K > MAX_PROBES:
        raise ValueError(f"unsupported probe shape T={T} K={K}: at most {MAX_TERMS} terms "
                         f"and {MAX_PROBES} probes T*K a launch")
    host = []
    for name, a in (("row_idx", row_idx), ("shift", shift)):
        if isinstance(a, torch.Tensor):
            if a.device.type != "cpu":
                raise ValueError(f"{name} is on {a.device}: the probe arrays are host data "
                                 "(numpy or CPU tensors), passed in the launch's parameters")
            if a.dtype != torch.int32:
                raise ValueError(f"{name} must be int32, got {a.dtype}")
            a = a.numpy()
        a = np.asarray(a)
        if a.dtype != np.int32 or a.ndim != 1:
            raise ValueError(f"{name} must be a host int32[T*K] array")
        if a.shape[0] != T * K:
            raise ValueError(f"{name} has {a.shape[0]} entries, want T*K = {T * K}")
        host.append(np.ascontiguousarray(a))
    return tuple(host)


def _bits(values: Sequence[int], limit: int, what: str) -> tuple:
    values = [int(v) & 0xFFFFFFFF for v in values]
    if len(values) > limit:
        raise ValueError(f"{len(values)} {what} exceed the kernel's {limit}")
    return (ctypes.c_uint32 * max(len(values), 1))(*values), len(values)


def _launch(bank: torch.Tensor, row_idx: np.ndarray, shift: np.ndarray, T, K, mode,
            out_rows: int, and_bits=0, clause_bits=(), member_bits=()) -> torch.Tensor:
    """One kernel launch over ``bank`` on its card's current stream, with
    the host probe arrays in its parameters, into a new int32[out_rows,
    C/32] on the card. Counts nothing (the wrappers count)."""
    if bank.device.type != "cuda":
        raise ValueError(f"the probe kernel runs on CUDA tensors, got {bank.device}")
    R, C = bank.shape
    clauses, n_clauses = _bits(clause_bits, MAX_CLAUSES, "clauses")
    members, n_members = _bits(member_bits, MAX_MEMBERS, "members")
    table = (ctypes.c_void_p * 1)(bank.data_ptr())
    lib = library()
    with torch.cuda.device(bank.device):
        out = torch.empty((out_rows, C // 32), dtype=torch.int32, device=bank.device)
        stream = torch.cuda.current_stream(bank.device).cuda_stream
        err = lib.bs_probe_launch(
            table, 1, R, C, row_idx.ctypes.data, shift.ctypes.data, T, K, mode,
            int(and_bits) & 0xFFFFFFFF, clauses, n_clauses, members, n_members,
            out.data_ptr(), C // 32, 0, 0, bank.device.index, stream,
        )
    if err != 0:
        raise RuntimeError(f"probe kernel launch failed: cudaError {err}")
    return out


# -- plain versions (the CPU path and the kernel's reference) ----------------


def _probed_words(bank: torch.Tensor, row_idx: torch.Tensor, row_mask: int) -> torch.Tensor:
    """-> int32[T*K, C]: row ``row_idx[p] & row_mask`` of the bank for each
    probe p, zeros for a row outside [0, R) (the kernel's row check)."""
    R = bank.shape[0]
    rows = row_idx.long()
    inside = (rows >= 0) & (rows < R)
    if R == 0:
        return bank.new_zeros((rows.shape[0], bank.shape[1]))
    words = bank.index_select(0, torch.where(inside, rows & row_mask, 0))
    return torch.where(inside[:, None], words, 0)


def probe_plain(bank: torch.Tensor, row_idx: torch.Tensor, shift: torch.Tensor,
                T: int, K: int) -> torch.Tensor:
    """-> bool[T, C]: term t matches column c iff all K probed bits are set
    (bit ``shift & 31``; a row outside the bank reads 0, as in the kernel).

    ``>>`` on int32 is arithmetic, but ``& 1`` keeps exactly bit ``shift``,
    so shift 31 on a word with the top bit set still reads 1."""
    rows = _probed_words(bank, row_idx, -1)  # [T*K, C]
    bits = (rows >> (shift & 31)[:, None]) & 1
    return (bits != 0).view(T, K, -1).all(dim=1)


def probe_floor_plain(bank: torch.Tensor, row_idx: torch.Tensor, T: int,
                      K: int) -> torch.Tensor:
    """-> int32[T, C]: the OR over j < K of row ``row_idx[t*K + j] & ~7``
    (row 0 of the probe's aligned 8-row group); a row outside the bank
    reads 0, as in the kernel."""
    words = _probed_words(bank, row_idx, ~7).view(T, K, -1)
    out = words[:, 0].clone()
    for j in range(1, K):
        out |= words[:, j]
    return out


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


def _plain_match(bank, row_idx, shift, T, K) -> torch.Tensor:
    return probe_plain(bank, torch.from_numpy(row_idx), torch.from_numpy(shift), T, K)


def probe_and_pack(bank, row_idx, shift, T: int, K: int) -> torch.Tensor:
    """-> int32[T, C/32]: the packed match rows of the T terms."""
    rows, shifts = _check(bank, row_idx, shift, T, K)
    if bank.device.type == "cpu":
        return pack_bitmap_plain(_plain_match(bank, rows, shifts, T, K))
    out = _launch(bank, rows, shifts, T, K, MODE_PACK, T)
    _count("pack", bank.shape[1], T, T)
    return out


def probe_reduce_and_pack(bank, row_idx, shift, T: int, K: int,
                          and_bits: int) -> torch.Tensor:
    """-> int32[1, C/32]: columns where every term in ``and_bits`` matches
    (terms outside it count as true)."""
    rows, shifts = _check(bank, row_idx, shift, T, K)
    if bank.device.type == "cpu":
        match = _plain_match(bank, rows, shifts, T, K)
        return pack_bitmap_plain(reduce_and_plain(match, and_bits))
    out = _launch(bank, rows, shifts, T, K, MODE_REDUCE, 1, and_bits=and_bits)
    _count("reduce_and", bank.shape[1], T, 1)
    return out


def probe_clauses_pack(bank, row_idx, shift, T: int, K: int,
                       clause_bits: Sequence[int],
                       member_bits: Sequence[int]) -> torch.Tensor:
    """-> int32[M, C/32]: the CNF survivors of each of the M members."""
    rows, shifts = _check(bank, row_idx, shift, T, K)
    if len(clause_bits) > MAX_CLAUSES or len(member_bits) > MAX_MEMBERS:
        raise ValueError("too many clauses or members for one launch")
    if bank.device.type == "cpu":
        match = _plain_match(bank, rows, shifts, T, K)
        return pack_bitmap_plain(clauses_plain(match, clause_bits, member_bits))
    out = _launch(
        bank, rows, shifts, T, K, MODE_CLAUSES, len(member_bits),
        clause_bits=clause_bits, member_bits=member_bits,
    )
    _count("clauses", bank.shape[1], T, len(member_bits), len(clause_bits))
    return out


def _plain_into(out: torch.Tensor, first_word: int, banks: Sequence[torch.Tensor],
                rows: np.ndarray, shifts: np.ndarray, T: int, K: int, epilogue: str,
                and_bits: int, clause_bits: Sequence[int], member_bits: Sequence[int]) -> None:
    """The plain version of one launch over CPU ``banks``, bank by bank,
    into the launch's slices of ``out``."""
    words = banks[0].shape[1] // 32
    for i, b in enumerate(banks):
        match = _plain_match(b, rows, shifts, T, K)
        if epilogue == "reduce_and":
            match = reduce_and_plain(match, and_bits)
        elif epilogue == "clauses":
            match = clauses_plain(match, clause_bits, member_bits)
        at = first_word + i * words
        out[:, at : at + words] = pack_bitmap_plain(match)


def output_rows(epilogue: str, T: int, member_bits: Sequence[int] = ()) -> int:
    """The rows of an epilogue's output: T packed terms, one AND, or M
    members."""
    return {"pack": T, "reduce_and": 1}.get(epilogue, len(member_bits))


def _check_plan(out: torch.Tensor, plan: Sequence[PlanLaunchArgs], out_rows: int) -> None:
    """Refuse a plan the kernel does not take: launches of 1..MAX_SHARDS
    banks of one device, every bank a contiguous tensor of one shape and
    type, each launch's words inside ``out`` (``int32[out_rows, words]``).
    Each distinct bank is checked once (a plan names few)."""
    first = plan[0][1][0]
    shape, dtype, kind = first.shape, first.dtype, first.device.type
    if (out.dim() != 2 or out.dtype != torch.int32 or not out.is_contiguous()
            or out.shape[0] != out_rows):
        raise ValueError(f"out must be a contiguous int32[{out_rows}, words] tensor")
    width, words = out.shape[1], shape[1] // 32
    devices: dict = {}  # id of a checked bank -> its device
    for first_word, banks in plan:
        if not 1 <= len(banks) <= MAX_SHARDS:
            raise ValueError(f"a launch of {len(banks)} banks: it takes 1..{MAX_SHARDS}")
        device = None
        for b in banks:
            at = devices.get(id(b))
            if at is None:
                at = b.device
                if b.shape != shape or b.dtype != dtype or not b.is_contiguous() \
                        or at.type != kind:
                    raise ValueError("a plan's banks must be contiguous tensors of one shape, "
                                     "type and kind of device")
                devices[id(b)] = at
            if device is None:
                device = at
            elif at != device:
                raise ValueError(f"a launch's banks lie on {device} and {at}")
        if first_word < 0 or width < first_word + len(banks) * words:
            raise ValueError(f"a launch of {len(banks)} banks of {words} words from word "
                             f"{first_word} of {width}")


def plan_records(plan: Sequence[PlanLaunchArgs], streams: Mapping) -> ctypes.Array:
    """``plan`` as ``bs_probe_plan``'s records, each launch on the stream
    handle ``streams`` gives for its device (-1 stands for the CPU's
    device index, which no card has)."""
    records = (PlanLaunch * len(plan))()
    for rec, (first_word, banks) in zip(records, plan):
        device = banks[0].device
        rec.device = -1 if device.index is None else device.index
        rec.n_shards = len(banks)
        rec.stream = streams[device]
        for i, b in enumerate(banks):
            rec.shards[i] = b.data_ptr()
        rec.R, rec.C = banks[0].shape
        rec.first_word = first_word
    return records


def plan_call(rows: np.ndarray, shifts: np.ndarray, T: int, K: int, epilogue: str,
              records: ctypes.Array, out: torch.Tensor, and_bits: int = 0,
              clause_bits: Sequence[int] = (), member_bits: Sequence[int] = (),
              stamps: Optional[ctypes.Array] = None) -> None:
    """The one foreign call of a plan (``_check``'s probe arrays, the
    records, the output: page-locked host memory, or a buffer on the one
    card of every record); ``stamps``, an int64[2] ctypes array, gets the
    monotonic ns at its entry and once it has issued everything."""
    clauses = members = None
    n_clauses = n_members = 0
    if epilogue == "clauses":
        clauses, n_clauses = _bits(clause_bits, MAX_CLAUSES, "clauses")
        members, n_members = _bits(member_bits, MAX_MEMBERS, "members")
    err = library().bs_probe_plan(
        rows.ctypes.data, shifts.ctypes.data, T, K, EPILOGUE_MODES[epilogue],
        int(and_bits) & 0xFFFFFFFF, clauses, n_clauses, members, n_members, records,
        len(records), out.data_ptr(), out.shape[1], out.device.type == "cpu", stamps)
    if err != 0:
        raise RuntimeError(f"probe plan failed: cudaError {err}")


def probe_plan_into(out: torch.Tensor, plan: Sequence[PlanLaunchArgs], row_idx, shift, T: int,
                    K: int, epilogue: str, and_bits: int = 0,
                    clause_bits: Sequence[int] = (),
                    member_bits: Sequence[int] = ()) -> None:
    """Every launch of ``plan`` into ``out`` (``int32[T or 1 or M,
    words]``, the rows of the epilogue of ``EPILOGUE_MODES``, its arguments
    as ``probe_reduce_and_pack`` and ``probe_clauses_pack`` take them):
    launch ``(first_word, banks)`` probes up to ``MAX_SHARDS`` banks
    ``int32[R, C]`` of one device as one bank of their columns in order,
    and its packed words land at ``out[:, first_word : first_word +
    len(banks)*C/32]``.

    On CUDA banks: ``out`` is page-locked host memory (or a buffer on the
    one card every launch names), and the whole plan is one foreign call
    (``bs_probe_plan``): the probe arrays checked and packed once, each
    launch issued on its card's current stream, every card's launches
    issued before any is waited for, and the call returns once every card
    is done (after a failure too, before it raises), the caller's current
    device unchanged. Each launch counts once under the epilogue at its
    width ``len(banks)*C`` (``launch_shapes``). On CPU banks: the plain
    version, bank by bank, into the same slices (counted nowhere)."""
    if epilogue not in EPILOGUE_MODES:
        raise ValueError(f"unknown epilogue {epilogue!r}: one of {sorted(EPILOGUE_MODES)}")
    if epilogue == "clauses" and (len(clause_bits) > MAX_CLAUSES
                                  or len(member_bits) > MAX_MEMBERS):
        raise ValueError("too many clauses or members for one launch")
    if not plan or not plan[0][1]:
        raise ValueError("an empty plan or launch")
    first = plan[0][1][0]
    rows, shifts = _check(first, row_idx, shift, T, K)
    out_rows = output_rows(epilogue, T, member_bits)
    _check_plan(out, plan, out_rows)
    if first.device.type == "cpu":
        for first_word, banks in plan:
            _plain_into(out, first_word, banks, rows, shifts, T, K, epilogue, and_bits,
                        clause_bits, member_bits)
        return
    if first.device.type != "cuda":
        raise ValueError(f"the probe kernel runs on CUDA tensors, got {first.device}")
    devices = dict.fromkeys(banks[0].device for _, banks in plan)
    if out.device.type != "cpu" and list(devices) != [out.device]:
        raise ValueError(f"out is on {out.device}, the plan's banks on {list(devices)}")
    # Each card's current stream as its raw handle: the value of
    # torch.cuda.current_stream(device).cuda_stream, from the getter torch's
    # own generated kernels use, with no Stream object built for it.
    streams = {d: torch._C._cuda_getCurrentRawStream(d.index) for d in devices}
    plan_call(rows, shifts, T, K, epilogue, plan_records(plan, streams), out, and_bits,
              clause_bits, member_bits)
    C, n_clauses = first.shape[1], len(clause_bits)
    with _count_lock:
        for _, banks in plan:
            _add((epilogue, len(banks) * C, T, out_rows, n_clauses), 1)


def probe_plan(plan: Sequence[PlanLaunchArgs], words: int, row_idx, shift, T: int, K: int,
               epilogue: str, **extra) -> torch.Tensor:
    """``probe_plan_into`` into a new int32[T or 1 or M, words] output
    (``extra``: its epilogue arguments): page-locked host memory for CUDA
    banks, which the plan's kernels write, so the caller reads it with no
    copy."""
    out = torch.empty((output_rows(epilogue, T, extra.get("member_bits", ())), words),
                      dtype=torch.int32, pin_memory=plan[0][1][0].device.type == "cuda")
    probe_plan_into(out, plan, row_idx, shift, T, K, epilogue, **extra)
    return out

def probe_floor(bank, row_idx, shift, T: int, K: int,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1f, the probe's access-pattern floor -> int32[T, C]
    (``probe_floor_plain``): K1's launch shape and loads with no probe math.

    It replaces the Pallas floor kernel of ``scripts/exp_kernel_floor.py``.
    ``shift`` travels in the parameters as K1's does and is never read.
    ``out``, an int32[T, C] tensor on the bank's device, is written and
    returned instead of a new tensor, so a chain of launches can share one
    output."""
    rows, shifts = _check(bank, row_idx, shift, T, K)
    R, C = bank.shape
    if out is not None and (out.dtype != torch.int32 or tuple(out.shape) != (T, C)
                            or not out.is_contiguous() or out.device != bank.device):
        raise ValueError(f"out must be a contiguous int32[{T}, {C}] tensor on {bank.device}")
    if bank.device.type == "cpu":
        result = probe_floor_plain(bank, torch.from_numpy(rows), T, K)
        return result if out is None else out.copy_(result)
    if bank.device.type != "cuda":
        raise ValueError(f"the probe kernel runs on CUDA tensors, got {bank.device}")
    lib = library()
    with torch.cuda.device(bank.device):
        if out is None:
            out = torch.empty((T, C), dtype=torch.int32, device=bank.device)
        stream = torch.cuda.current_stream(bank.device).cuda_stream
        err = lib.bs_probe_floor_launch(
            bank.data_ptr(), R, C, rows.ctypes.data, shifts.ctypes.data, T, K,
            out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"probe floor kernel launch failed: cudaError {err}")
    _count("floor", C, T, T)
    return out
