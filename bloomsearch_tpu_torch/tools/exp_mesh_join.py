"""Experiment: the sharded wrappers (K3) against their earlier per-shard
launch-and-join form, and the two ways to land a card's words in the
joined bitmap, with a breakdown of each call.

Four forms of each sharded call, all bit-identical:

- ``old``, the earlier per-shard form (kept here, not in the package):
  the single-device kernel once per shard, each into its own device output, each shard's
  bitmap copied into a new page-locked buffer, every card's whole current
  stream synchronised, the buffers joined on the host with ``torch.cat``;
- ``per_launch``, the earlier joined form (kept here, not in the
  package): one launch a card over all of its shards (``card_layout``),
  storing straight into one page-locked joined buffer through its device
  address, each launch its own foreign call, then one event a card waited
  for (``joined``);
- ``mapped``, the package's wrapper: the same launches issued and waited
  for in one foreign call (``kernels/probe.py::probe_plan_into`` for the
  probes, ``kernels/scan.py::byte_scan_plan_into`` for the dense scan);
- ``copy``: the same launches into a device buffer a launch, each copied
  to its offset of the page-locked joined buffer by one strided
  ``cudaMemcpy2DAsync`` (built here from a few lines of CUDA C into a
  temporary directory), then one event a card.

At the main path's shapes on a 4-shard mesh (the refscale bank, R =
1,347,900 rows of 4 x 128 columns; the refscale stream, 4 x 900,096 chunks)
each form's call is timed as a caller sees it (host clock between
synchronisations of every card), the forms in turns (``FORMS`` and back),
and the ``old``, ``per_launch`` and ``copy`` forms, whose launches the
host issues one by one, are each split into:

- ``issue_ms``: host time from the call's start until its last launch is
  enqueued, and ``issue_per_launch_ms`` over its launches;
- per card, ``span_ms`` from the first launch's start to the last one's end
  and ``busy_ms``, the sum of the launches' own spans (CUDA events; a
  launch the host has not yet issued leaves the stream idle inside them);
- per card, ``copy_ms`` of the copies to the host (CUDA events);
- ``copy_issue_ms``: host time spent taking buffers and queueing copies;
- ``wait_ms``: host time spent waiting for the cards;
- ``join_ms``: host time of the join.

Events around every launch cost host time, so the breakdown is taken in
calls of its own, not in the timed ones. For the probes, ``plan_split_us``
splits the package's call into the layout and pinned buffer before it,
the probe arrays' check, building the records, entering the foreign call,
issuing every launch and event in it and waiting (monotonic-clock stamps
the C entry takes).

The single-device combined probe (``combined_turns``): the one-card
engine's call of each epilogue, one launch on the unsharded bank, in two
forms timed in turns (``COMBINED_FORMS`` and back, ``COMBINED_ROUNDS``
times, with ``spread_verdict``'s reading of them): ``plan``, the
package's (``kernels/probe.py::probe_plan`` over a one-launch plan, as
``bloom/bank.py``'s combiner calls it with no mesh: one ``bs_probe_plan``
call into a page-locked buffer), and ``copy``, the earlier one (one
``bs_probe_launch`` into a new device tensor, then its copy to the host).

The sparse case (K3-e, ``sharded_scan_segments``): three requested chunk
ranges of a refscale block's size (one across a shard boundary, one inside
a shard, one ending at the stream's end; 8 needles, the main path's most
launched segment shape) read in place on the cards that hold them. Five
calls, their answers equal at every requested chunk, timed in turns
(``SPARSE_FORMS`` and back):

- ``per_launch``, the earlier form (kept here, not in the package): the
  same launches, one ``byte_scan_ranges_into`` foreign call each, then an
  event a card waited for (``joined``);
- ``sparse``, the package's: every launch issued and waited for in one
  foreign call (``byte_scan_plan_into``);
- ``one_card``: the single-device row cache's sparse call, the same entry
  over the stream joined on one card (one launch);
- ``single``: the earlier single-device sparse call, the segment launch
  into a device buffer and its copy to the host;
- ``dense``: the dense sharded call over every chunk (K3-d).

``host_us`` gives each step of the per-launch form, the whole calls, and
the package's call split into building its records, entering the foreign
call, issuing every launch and event, and waiting (monotonic-clock stamps
the C entry takes). Data is random, made on the card
from the seed; ``chip_smoke.py`` runs the same turns on the engine's
resident refscale state.

Usage::

    python -m bloomsearch_tpu_torch.tools.exp_mesh_join [--device cuda]
        [--shards 4] [--reps 25] [--out PATH]

With one card the shards all lie on it; with as many cards as shards the
tool also runs a mesh of distinct cards. There is no CPU form: the tool
raises when no card is visible.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import statistics
import tempfile
import time
from typing import Callable

import numpy as np
import torch

from ..kernels import build
from ..kernels import probe as pk
from ..kernels import scan as ks
from ..parallel import mesh as pm
from .timing import card, resolve_device

REFSCALE_ROWS = 1_347_900  # 3 keyspaces x 449,300 words
SHARD_COLUMNS = 128
SHARD_CHUNKS = 900_096  # the refscale stream (3,600,384 chunks) over 4 shards
K = 10
CLAUSES = [0b0011, 0b1100]  # the OR tree's two clauses of two terms, one member
MEMBERS = [0b11]
FORMS = ("old", "per_launch", "mapped", "copy")
TRACED_FORMS = ("old", "per_launch", "copy")
SPARSE_FORMS = ("per_launch", "sparse", "one_card", "single", "dense")
COMBINED_FORMS = ("plan", "copy")
COMBINED_ROUNDS = 5  # (plan, copy, copy, plan) rounds: ten turns a form
COPY_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
// rows rows of width bytes from a device buffer to host memory, on stream.
extern "C" int copy_rows_to_host(void* dst, int64_t dst_pitch, const void* src,
                                 int64_t src_pitch, int64_t width, int64_t rows,
                                 void* stream) {
  return (int)cudaMemcpy2DAsync(dst, dst_pitch, src, src_pitch, width, rows,
                                cudaMemcpyDeviceToHost, (cudaStream_t)stream);
}
"""


def log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


# -- the cases -------------------------------------------------------------------


@dataclasses.dataclass
class Case:
    """One sharded call: its shards (one tensor per mesh position), their
    sharded axis, the output rows, the launch table's capacity, the
    single-device kernel on one shard (the ``old`` form), one launch over a
    card's shards into an output (``into(out, first_word, shards)``) and the
    package's wrapper."""

    label: str
    shards: tuple
    axis: int
    out_rows: int
    capacity: int
    single: Callable
    into: Callable
    wrapper: Callable
    probe: dict | None = None  # a probe's arguments (row_idx, shift, T, K, epilogue, extra)


def probe_case(label: str, mesh, shards: tuple, epilogue: str, rows, shifts, T: int,
               k: int = K, clause_bits=CLAUSES, member_bits=MEMBERS) -> Case:
    """A sharded probe (``epilogue``: pack, reduce_and or clauses; reduce
    ANDs every term)."""
    and_bits = (1 << T) - 1
    extra = {"pack": {}, "reduce_and": {"and_bits": and_bits},
             "clauses": {"clause_bits": clause_bits, "member_bits": member_bits}}[epilogue]
    if epilogue == "pack":
        single = lambda b: pk.probe_and_pack(b, rows, shifts, T, k)  # noqa: E731
        wrapper = lambda: pm.sharded_probe_packed(mesh, shards, rows, shifts, T, k)  # noqa: E731
    elif epilogue == "reduce_and":
        single = lambda b: pk.probe_reduce_and_pack(b, rows, shifts, T, k, and_bits)  # noqa: E731
        wrapper = lambda: pm.sharded_query_step(  # noqa: E731
            mesh, shards, rows, shifts, and_bits, T, k)[0][None, :]
    else:
        single = lambda b: pk.probe_clauses_pack(  # noqa: E731
            b, rows, shifts, T, k, clause_bits, member_bits)
        wrapper = lambda: pm.sharded_probe_clauses(  # noqa: E731
            mesh, shards, rows, shifts, clause_bits, member_bits, T, k)
    out_rows = {"pack": T, "reduce_and": 1}.get(epilogue, len(member_bits))
    return Case(label, shards, 1, out_rows, pk.MAX_SHARDS, single,
                lambda o, w, b: probe_shards_into(o, w, b, rows, shifts, T, k, epilogue,
                                                  **extra), wrapper,
                {"row_idx": rows, "shift": shifts, "T": T, "K": k, "epilogue": epilogue,
                 "extra": extra})


def probe_shards_into(out: torch.Tensor, first_word: int, banks, row_idx, shift, T: int,
                      k: int, epilogue: str, and_bits: int = 0, clause_bits=(),
                      member_bits=()) -> None:
    """One launch of the earlier per-launch form (the package's until its
    one C call; kept here): ``bs_probe_launch`` over up to ``MAX_SHARDS``
    banks of one card as one bank of their columns, on the card's current
    stream, storing its words into ``out`` from ``first_word`` (page-locked
    host memory through its device address, or a buffer on the card), with
    the earlier form's checks and device guard; it waits for nothing and
    counts nothing. On CPU banks: the plain versions into the same slices,
    as the earlier form ran them."""
    rows, shifts = pk._check(banks[0], row_idx, shift, T, k)
    pk._check_plan(out, [(first_word, banks)], pk.output_rows(epilogue, T, member_bits))
    if banks[0].device.type == "cpu":
        pk._plain_into(out, first_word, banks, rows, shifts, T, k, epilogue, and_bits,
                       clause_bits, member_bits)
        return
    clauses, n_clauses = pk._bits(clause_bits, pk.MAX_CLAUSES, "clauses")
    members, n_members = pk._bits(member_bits, pk.MAX_MEMBERS, "members")
    bank = banks[0]
    R, C = bank.shape
    table = (ctypes.c_void_p * len(banks))(*[b.data_ptr() for b in banks])
    lib = pk.library()
    with torch.cuda.device(bank.device):
        err = lib.bs_probe_launch(
            table, len(banks), R, C, rows.ctypes.data, shifts.ctypes.data, T, k,
            pk.EPILOGUE_MODES[epilogue], int(and_bits) & 0xFFFFFFFF, clauses, n_clauses,
            members, n_members, out.data_ptr(), out.shape[1], first_word,
            out.device.type == "cpu", bank.device.index,
            torch.cuda.current_stream(bank.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"probe kernel launch failed: cudaError {err}")


def shards_into(out: torch.Tensor, first_word: int, shards, needles, lens, **kw) -> None:
    """One dense launch over whole stream shards of one card into ``out``
    from ``first_word`` (a ``stream`` launch, as the dense sharded scan
    counts its launches)."""
    ks.byte_scan_ranges_into(out, first_word, shards, [0] * len(shards),
                             [s.shape[0] for s in shards], needles, lens, count_as="stream", **kw)


def scan_case(label: str, mesh, shards: tuple, needles, lens, n_real: int) -> Case:
    """A sharded dense scan."""
    kw = dict(n_real=n_real)
    return Case(label, shards, 0, n_real, ks.MAX_SEGMENTS,
                lambda s: ks.byte_scan_stream(s, needles, lens, **kw),
                lambda o, w, s: shards_into(o, w, s, needles, lens, **kw),
                lambda: pm.sharded_scan_all_rows(mesh, shards, needles, lens, **kw))


# -- the three forms, with an optional trace ---------------------------------------


class Trace:
    """Host clock marks and CUDA event pairs of one call (``breakdown``)."""

    def __init__(self):
        self.t = {"start": time.perf_counter()}
        self.launches: list = []  # (device, start event, end event)
        self.copies: list = []

    def mark(self, name: str) -> None:
        self.t[name] = time.perf_counter()

    def span(self, kind: list, device, fn):
        with torch.cuda.device(device):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn()
            b.record()
        kind.append((device, a, b))
        return out


def _run(trace, kind: str, device, fn):
    return fn() if trace is None else trace.span(getattr(trace, kind), device, fn)


def _mark(trace, *names: str) -> None:
    if trace is not None:
        for name in names:
            trace.mark(name)


def _card_done(device: torch.device):
    """An event recorded on the card's current stream after its launches
    (None on the CPU, where the plain versions ran before they returned)."""
    return torch.cuda.current_stream(device).record_event() if device.type == "cuda" else None


def joined(shards: tuple, out_rows: int, words: int, plan: list, launch) -> torch.Tensor:
    """The earlier joined form (the package's until its one C call): the
    int32[out_rows, words] bitmap of ``launch(out, first_word, arg)`` over
    ``plan``, ``[(device, [(first word, arg), ...]), ...]``, page-locked on
    cards: every card's launches issued first, each its own foreign call,
    then one event a card waited for. A launch that raises part-way is
    re-raised only after every card that was reached has been waited
    for."""
    out = torch.empty((out_rows, words), dtype=torch.int32,
                      pin_memory=shards[0].device.type == "cuda")
    done = []
    try:
        for device, launches in plan:
            try:
                for first_word, arg in launches:
                    launch(out, first_word, arg)
            finally:
                done.append(_card_done(device))
    finally:
        for event in done:
            if event is not None:
                event.synchronize()
    return out


def old_call(case: Case, trace: Trace | None = None) -> torch.Tensor:
    """The earlier per-shard form (module doc)."""
    parts = [_run(trace, "launches", s.device, lambda s=s: case.single(s))
             for s in case.shards]
    _mark(trace, "issued")
    host = []
    for p in parts:
        def copy(p=p):
            h = torch.empty(p.shape, dtype=p.dtype, pin_memory=True)
            h.copy_(p, non_blocking=True)
            return h
        host.append(_run(trace, "copies", p.device, copy))
    _mark(trace, "copies")
    for dev in dict.fromkeys(p.device for p in parts):
        torch.cuda.current_stream(dev).synchronize()
    _mark(trace, "waited")
    out = torch.cat(host, dim=-1)
    _mark(trace, "joined")
    return out


def joined_call(case: Case, landing: str, copy_lib=None,
                trace: Trace | None = None) -> torch.Tensor:
    """One launch a card (``pm.card_layout``) landing in the page-locked
    joined buffer: ``mapped`` stores through its device address (what
    ``parallel/mesh.py`` does), ``copy`` into a device buffer a launch and
    one ``cudaMemcpy2DAsync`` each to its offset."""
    shards = case.shards
    words = pm.logical_size(shards, case.axis) // 32
    out = torch.empty((case.out_rows, words), dtype=torch.int32, pin_memory=True)
    done = []
    for cs in pm.card_layout(shards, case.axis, case.capacity):
        staged = []
        for run in cs.launches:
            first = cs.offsets[cs.shards.index(run[0])]
            part = [shards[i] for i in run]
            if landing == "mapped":
                _run(trace, "launches", cs.device, lambda part=part, first=first: case.into(
                    out, first, part))
                continue
            n = len(run) * (shards[0].shape[case.axis] // 32)
            with torch.cuda.device(cs.device):
                buf = torch.empty((case.out_rows, n), dtype=torch.int32, device=cs.device)
            _run(trace, "launches", cs.device, lambda part=part, buf=buf: case.into(buf, 0, part))
            staged.append((buf, first, n))
        for buf, first, n in staged:
            def copy(buf=buf, first=first, n=n):
                err = copy_lib.copy_rows_to_host(
                    out.data_ptr() + 4 * first, 4 * words, buf.data_ptr(), 4 * n, 4 * n,
                    case.out_rows, torch.cuda.current_stream(cs.device).cuda_stream)
                if err:
                    raise RuntimeError(f"cudaMemcpy2DAsync failed: cudaError {err}")
            _run(trace, "copies", cs.device, copy)
        done.append(torch.cuda.current_stream(cs.device).record_event())
    _mark(trace, "issued", "copies")
    for event in done:
        event.synchronize()
    _mark(trace, "waited", "joined")
    return out


def build_copy_lib(directory: str) -> ctypes.CDLL:
    """The strided copy of the ``copy`` form, built into ``directory``."""
    source = os.path.join(directory, "copy_rows.cu")
    with open(source, "w") as fh:
        fh.write(COPY_SOURCE)
    library = os.path.join(directory, "libcopy_rows.so")
    build.build_library(source, library, force=True)
    lib = ctypes.CDLL(library)
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.copy_rows_to_host.argtypes = [p, i64, p, i64, i64, i64, p]
    lib.copy_rows_to_host.restype = ctypes.c_int
    return lib


def form_call(case: Case, form: str, copy_lib=None) -> Callable[[], torch.Tensor]:
    """The timed call of ``form``: ``mapped`` is the package's wrapper."""
    if form == "old":
        return lambda: old_call(case)
    if form == "per_launch":
        return lambda: joined_call(case, "mapped")
    if form == "mapped":
        return case.wrapper
    return lambda: joined_call(case, "copy", copy_lib)


def breakdown(case: Case, form: str, copy_lib=None) -> dict:
    """One traced call of ``form`` (``TRACED_FORMS``) -> its breakdown
    (module doc)."""
    devices = list(dict.fromkeys(s.device for s in case.shards))
    for d in devices:
        torch.cuda.synchronize(d)
    trace = Trace()
    if form == "old":
        old_call(case, trace)
    else:
        joined_call(case, "mapped" if form == "per_launch" else form, copy_lib, trace)
    t = trace.t
    cards = {}
    for d in devices:
        mine = [(a, b) for dd, a, b in trace.launches if dd == d]
        cards[str(d)] = {
            "launches": len(mine),
            "span_ms": mine[0][0].elapsed_time(mine[-1][1]),
            "busy_ms": sum(a.elapsed_time(b) for a, b in mine),
            "copy_ms": sum(a.elapsed_time(b) for dd, a, b in trace.copies if dd == d),
        }
    n = len(trace.launches)
    return {
        "issue_ms": (t["issued"] - t["start"]) * 1e3,
        "issue_per_launch_ms": (t["issued"] - t["start"]) * 1e3 / n,
        "copy_issue_ms": (t["copies"] - t["issued"]) * 1e3,
        "wait_ms": (t["waited"] - t["copies"]) * 1e3,
        "join_ms": (t["joined"] - t["waited"]) * 1e3,
        "total_ms": (t["joined"] - t["start"]) * 1e3,
        "cards": cards,
    }


# -- timing -----------------------------------------------------------------------


def call_ms(fn, devices, reps: int) -> float:
    """Median host-clock ms of ``fn()`` between synchronisations of every
    card in ``devices`` (after one warm call)."""
    fn()
    times = []
    for _ in range(reps):
        for d in devices:
            torch.cuda.synchronize(d)
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def median_breakdown(samples: list) -> dict:
    """The median of each number over instrumented calls."""
    def med(values):
        first = values[0]
        if isinstance(first, dict):
            return {k: med([v[k] for v in values]) for k in first}
        return statistics.median(values)

    return med(samples)


def random_words(shape, gen: torch.Generator, device) -> torch.Tensor:
    words = torch.randint(0, 1 << 32, shape, generator=gen, device=device, dtype=torch.int64)
    return (words - (1 << 31)).to(torch.int32)


def mesh_state(devices: tuple, seed: int, rows: int, shard_cols: int,
               shard_chunks: int) -> tuple:
    """Random bank and stream shards on ``devices`` (one shard each), from
    one generator a card seeded with ``seed``."""
    gens = {d: torch.Generator(device=d).manual_seed(seed) for d in dict.fromkeys(devices)}
    bank = tuple(random_words((rows, shard_cols), gens[d], d) for d in devices)
    stream = tuple(random_words((shard_chunks, 128), gens[d], d) for d in devices)
    return bank, stream


def needles_of(n_real: int, rng: np.random.Generator) -> tuple:
    """``n_real`` lowercase needles of 4 to 12 bytes -> (int32[n, 32], int32[n])."""
    padded = np.zeros((n_real, 32), np.int32)
    lens = np.zeros(n_real, np.int32)
    for r in range(n_real):
        n = int(rng.integers(4, 13))
        padded[r, :n] = rng.integers(0x61, 0x7B, n)
        lens[r] = n
    return padded, lens


def make_cases(mesh, bank: tuple, stream: tuple, rng: np.random.Generator,
               rows: int) -> list:
    """Each wrapper at its most launched main-path shape on random data."""
    def probes(T):
        return (rng.integers(0, rows, T * K).astype(np.int32),
                rng.integers(0, 32, T * K).astype(np.int32))

    return [
        probe_case("K3-a pack, T = 4", mesh, bank, "pack", *probes(4), 4),
        probe_case("K3-b reduce, T = 1", mesh, bank, "reduce_and", *probes(1), 1),
        probe_case("K3-c clauses, T = 4, 2 clauses, 1 member", mesh, bank, "clauses",
                   *probes(4), 4),
        scan_case("K3-d scan, n_real = 1", mesh, stream, *needles_of(1, rng), 1),
        scan_case("K3-d scan, n_real = 8", mesh, stream, *needles_of(8, rng), 8),
    ]


@dataclasses.dataclass
class SparseCase:
    """A sparse sharded scan: the requested ranges (first chunk, chunks) of
    the sharded stream ``shards``, the same stream joined on one card
    (``full``, the single-device call's) and the needles."""

    label: str
    mesh: object
    shards: tuple
    full: torch.Tensor
    starts: list
    counts: list
    needles: np.ndarray
    lens: np.ndarray
    n_real: int

    def _kw(self) -> dict:
        return dict(n_real=self.n_real)

    def sharded(self) -> tuple:
        """The package's call -> (its words on the host, range_base)."""
        return pm.sharded_scan_segments(self.mesh, self.shards, self.starts, self.needles,
                                        self.lens, seg_chunks=self.counts, **self._kw())

    def per_launch(self) -> tuple:
        """The earlier form of the same call: the package's launches, one
        ``byte_scan_ranges_into`` each, then an event a card -> (words,
        range_base)."""
        plan, words, range_base = pm.segment_plan(self.shards, self.starts, self.counts)
        by_card: dict = {}
        for word, ranges in plan:
            by_card.setdefault(ranges[0][0].device, []).append((word, ranges))

        def launch(out, first_word, ranges):
            ks.byte_scan_ranges_into(out, first_word, [b for b, _, _ in ranges],
                                     [r for _, r, _ in ranges], [n for _, _, n in ranges],
                                     self.needles, self.lens, **self._kw())

        out = joined(self.shards, self.n_real, words, list(by_card.items()), launch)
        return out, range_base

    def one_card(self) -> tuple:
        """The single-device row cache's sparse call over ``full``."""
        return pm.sharded_scan_segments(None, self.full, self.starts, self.needles, self.lens,
                                        seg_chunks=self.counts, **self._kw())

    def dense(self) -> torch.Tensor:
        return pm.sharded_scan_all_rows(self.mesh, self.shards, self.needles, self.lens,
                                        **self._kw())

    def single(self) -> torch.Tensor:
        """The single-device segment launch and its copy to the host."""
        return ks.byte_scan_segments(self.full, self.starts, self.needles, self.lens,
                                     seg_chunks=self.counts, **self._kw()).cpu()

    def single_bases(self) -> list[int]:
        """Where each range's requested chunks sit in ``single()``'s words."""
        read, rounded = ks.segment_layout(self.starts, self.counts, self.full.shape[0])
        return [int(off) + s - r
                for off, s, r in zip(np.cumsum([0] + rounded[:-1]), self.starts, read)]


def requested_bits(words: torch.Tensor, firsts, counts) -> list[np.ndarray]:
    """Each range's bits, bool[rows, count], from its first logical chunk
    of a packed int32 bitmap on the host."""
    raw = np.unpackbits(np.ascontiguousarray(words.numpy()).view(np.uint8), axis=-1,
                        bitorder="little")
    return [raw[:, f : f + c].astype(bool) for f, c in zip(firsts, counts)]


def sparse_case(mesh, stream: tuple, full: torch.Tensor, rng: np.random.Generator,
                needles=None, block: int = 15_307) -> SparseCase:
    """Three ranges of ``block`` chunks (a refscale block; a quarter shard
    at most): one across the first shard boundary, one inside shard 1 and
    one ending at the stream's end; 8 random needles unless given as
    (int32[n, 32], int32[n])."""
    rows = stream[0].shape[0]
    total = rows * len(stream)
    block = min(block, rows // 4)
    starts = [rows - block // 2 - 5, rows + rows // 3, total - block]
    padded, lens = needles if needles is not None else needles_of(8, rng)
    return SparseCase(f"K3-e segments, 3 ranges, n_real = {len(lens)}", mesh, stream, full,
                      starts, [block] * 3, padded, lens, len(lens))


def check_sparse(case: SparseCase) -> list[np.ndarray]:
    """The five sparse forms agree at every requested chunk -> the
    requested bits."""
    words, bases = case.sharded()
    got = requested_bits(words, bases, case.counts)
    for label, other in (("per-launch", requested_bits(*case.per_launch(), case.counts)),
                         ("one-card", requested_bits(*case.one_card(), case.counts)),
                         ("dense sharded", requested_bits(case.dense(), case.starts,
                                                           case.counts)),
                         ("single-device", requested_bits(case.single(), case.single_bases(),
                                                          case.counts))):
        if not all(np.array_equal(a, b) for a, b in zip(got, other)):
            raise AssertionError(f"{case.label}: the sparse call differs from the {label} call")
    return got


def plan_split_us(case: SparseCase, reps: int = 200) -> dict:
    """Median host-clock us of the package's sparse call split into its
    steps, from the monotonic clock around them and the two stamps the C
    entry takes: building the records, entering the foreign call (ctypes),
    issuing every launch and event inside it, and waiting for the cards
    until it returns."""
    devices = list(dict.fromkeys(s.device for s in case.shards))
    plan, words, _ = pm.segment_plan(case.shards, case.starts, case.counts)
    needle_bytes, real_lens = ks._check(case.shards[0], case.needles, case.lens, case.n_real)
    out = torch.empty((case.n_real, words), dtype=torch.int32, pin_memory=True)
    streams = {d: torch.cuda.current_stream(d).cuda_stream for d in devices}
    stamps = (ctypes.c_int64 * 2)()
    samples: dict = {"plan: records": [], "plan: entering the foreign call": [],
                     "plan: issue in the call": [], "plan: wait in the call": []}
    for rep in range(reps + 1):
        for d in devices:
            torch.cuda.synchronize(d)
        t0 = time.monotonic_ns()
        records = ks.plan_records(plan, streams)
        t1 = time.monotonic_ns()
        ks.plan_call(needle_bytes, real_lens, records, out, stamps)
        t2 = time.monotonic_ns()
        if rep:  # the first call is a warm-up
            for name, ns in zip(samples, (t1 - t0, stamps[0] - t1, stamps[1] - stamps[0],
                                          t2 - stamps[1])):
                samples[name].append(ns / 1e3)
    return {name: statistics.median(v) for name, v in samples.items()}


def probe_plan_split_us(case: Case, reps: int = 200, layout=None) -> dict:
    """Median host-clock us of the package's probe call (``case.wrapper``,
    one ``probe_plan_into`` call) split into its steps, from the monotonic
    clock around them and the two stamps the C entry takes: the launch
    layout and the pinned buffer, the probe arrays' and the plan's checks,
    building the records, entering the foreign call (ctypes), issuing every
    launch and event inside it, and waiting for the cards until it
    returns; beside them the whole wrapper call. ``layout`` makes the plan
    from the shards (``pm.probe_launches``, the wrappers' layout, when
    None)."""
    a = case.probe
    T, k, epilogue, extra = a["T"], a["K"], a["epilogue"], a["extra"]
    devices = list(dict.fromkeys(s.device for s in case.shards))
    words = pm.logical_size(case.shards, case.axis) // 32
    stamps = (ctypes.c_int64 * 2)()
    names = ("plan: layout and pinned buffer", "plan: probe arrays and plan checks",
             "plan: records", "plan: entering the foreign call", "plan: issue in the call",
             "plan: wait in the call")
    samples: dict = {name: [] for name in names}
    for rep in range(reps + 1):
        for d in devices:
            torch.cuda.synchronize(d)
        t0 = time.monotonic_ns()
        plan = (layout or pm.probe_launches)(case.shards)
        out = torch.empty((case.out_rows, words), dtype=torch.int32, pin_memory=True)
        t1 = time.monotonic_ns()
        rows, shifts = pk._check(case.shards[0], a["row_idx"], a["shift"], T, k)
        pk._check_plan(out, plan, case.out_rows)
        t2 = time.monotonic_ns()
        records = pk.plan_records(plan, {d: torch._C._cuda_getCurrentRawStream(d.index)
                                         for d in devices})
        t3 = time.monotonic_ns()
        pk.plan_call(rows, shifts, T, k, epilogue, records, out, stamps=stamps, **extra)
        t4 = time.monotonic_ns()
        if rep:  # the first call is a warm-up
            for name, ns in zip(names, (t1 - t0, t2 - t1, t3 - t2, stamps[0] - t3,
                                        stamps[1] - stamps[0], t4 - stamps[1])):
                samples[name].append(ns / 1e3)
    result = {name: statistics.median(v) for name, v in samples.items()}
    result["call: the package's wrapper"] = call_ms(case.wrapper, devices, reps) * 1e3
    return result


def spread_verdict(plan: list, copy: list) -> str:
    """Where the plan form's turns lie against the copy form's: beyond both
    forms' spread (every turn of one slower than every turn of the other),
    or within them."""
    if min(plan) > max(copy):
        return "plan slower beyond both spreads"
    if max(plan) < min(copy):
        return "plan faster beyond both spreads"
    return "within the spreads"


def combined_turns(bank: torch.Tensor, row_idx, shift, T: int, k: int, epilogue: str,
                   extra: dict, reps: int = 200, label: str = "", log=log,
                   rounds: int = COMBINED_ROUNDS) -> dict:
    """The single-device combined probe of one epilogue on the unsharded
    ``bank`` (module doc): its two forms checked bit-identical, timed as a
    caller sees them in turns (``COMBINED_FORMS`` and back, ``rounds``
    times: each form's median of ``reps`` calls ``2 * rounds`` times), with
    the turns' verdict (``spread_verdict``) and the plan call's host split
    (``probe_plan_split_us`` on the one-launch plan)."""
    dev = bank.device
    single = {"pack": pk.probe_and_pack, "reduce_and": pk.probe_reduce_and_pack,
              "clauses": pk.probe_clauses_pack}[epilogue]

    def layout(shards):
        return [(0, [shards[0]])]

    def plan():  # bloom/bank.py::_probe with no mesh
        return pk.probe_plan(layout((bank,)), bank.shape[1] // 32, row_idx, shift, T, k,
                             epilogue, **extra)

    def copy():
        return single(bank, row_idx, shift, T, k, *extra.values()).cpu()

    if not torch.equal(plan(), copy()):
        raise AssertionError(f"{label}: the single-device plan call differs from the launch "
                             "and copy")
    calls = {"plan": plan, "copy": copy}
    times: dict = {form: [] for form in COMBINED_FORMS}
    for form in (COMBINED_FORMS + COMBINED_FORMS[::-1]) * rounds:
        times[form].append(call_ms(calls[form], [dev], reps))
    out_rows = pk.output_rows(epilogue, T, extra.get("member_bits", ()))
    case = Case(label, (bank,), 1, out_rows, pk.MAX_SHARDS, None, None, plan,
                {"row_idx": row_idx, "shift": shift, "T": T, "K": k, "epilogue": epilogue,
                 "extra": extra})
    result = {"call_ms": times, "median_ms": {f: statistics.median(t) for f, t in times.items()},
              "verdict": spread_verdict(times["plan"], times["copy"]),
              "plan_split_us": probe_plan_split_us(case, layout=layout)}
    log(f"{label} on {dev}: calls " + "; ".join(
        f"{f} " + "/".join(f"{v:.6f}" for v in t) for f, t in times.items())
        + " ms; medians " + ", ".join(f"{f} {v:.6f}" for f, v in result["median_ms"].items())
        + f"; {result['verdict']}; plan split us "
        + ", ".join(f"{n} {v:.2f}" for n, v in result["plan_split_us"].items()))
    return result


def sparse_host_us(case: SparseCase, reps: int = 200) -> dict:
    """Median host-clock us of each step of one sparse call (``host_costs``'
    rule: a launch is its issue alone; a step with a wait includes the
    card's turnaround) beside the whole calls: the per-launch form's steps,
    the package's call split (``plan_split_us``) and each form's call."""
    devices = list(dict.fromkeys(s.device for s in case.shards))
    rows = case.shards[0].shape[0]
    pieces, _ = pm.segment_pieces(case.starts, case.counts, rows, len(case.shards))
    plan, words, _ = pm.segment_plan(case.shards, case.starts, case.counts)
    pinned = torch.empty((case.n_real, words), dtype=torch.int32, pin_memory=True)
    first, ranges = plan[0]
    dev = ranges[0][0].device

    def us(fn) -> float:
        fn()
        times = []
        for _ in range(reps):
            for d in devices:
                torch.cuda.synchronize(d)
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e6)
        for d in devices:
            torch.cuda.synchronize(d)
        return statistics.median(times)

    def launch():
        ks.byte_scan_ranges_into(pinned, first, [b for b, _, _ in ranges],
                                 [r for _, r, _ in ranges], [n for _, _, n in ranges],
                                 case.needles, case.lens, n_real=case.n_real)

    steps = {
        "segment_pieces": lambda: pm.segment_pieces(case.starts, case.counts, rows,
                                                    len(case.shards)),
        "piece_launches": lambda: pm.piece_launches(pieces, [s.device for s in case.shards],
                                                    ks.MAX_SEGMENTS),
        "segment_plan": lambda: pm.segment_plan(case.shards, case.starts, case.counts),
        "pinned buffer": lambda: torch.empty((case.n_real, words), dtype=torch.int32,
                                             pin_memory=True),
        "needles check": lambda: ks._check(case.shards[0], case.needles, case.lens,
                                           case.n_real),
        "per_launch: a card's launch into the pinned buffer": launch,
        "per_launch: a card's launch, event wait": lambda: (
            launch(), torch.cuda.current_stream(dev).record_event().synchronize()),
    }
    result = {name: us(fn) for name, fn in steps.items()}
    result.update(plan_split_us(case, reps))
    calls = {"sparse": case.sharded, "per_launch": case.per_launch, "one_card": case.one_card,
             "single": case.single, "dense": case.dense}
    result.update({f"call: {name}": us(fn) for name, fn in calls.items()})
    return result


def sparse_turns(case: SparseCase, reps: int = 25, log=log) -> dict:
    """The sparse case (module doc): the five forms checked against one
    another, timed in turns (``SPARSE_FORMS`` and back), with the kernel
    launches one package call makes, the launches a card and ``host_us``."""
    devices = list(dict.fromkeys(s.device for s in case.shards))
    check_sparse(case)
    before = launch_counts()
    case.sharded()
    after = launch_counts()
    launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    pieces, _ = pm.segment_pieces(case.starts, case.counts, case.shards[0].shape[0],
                                  len(case.shards))
    plan = pm.piece_launches(pieces, [s.device for s in case.shards], ks.MAX_SEGMENTS)
    calls = {"per_launch": case.per_launch, "sparse": case.sharded, "one_card": case.one_card,
             "single": case.single, "dense": case.dense}
    times: dict = {name: [] for name in SPARSE_FORMS}
    for name in SPARSE_FORMS + SPARSE_FORMS[::-1]:
        times[name].append(call_ms(calls[name], devices, reps))
    result = {"call_ms": times, "kernel_launches_per_call": launched, "pieces": len(pieces),
              "launches_per_card": {str(d): len(ls) for d, ls in plan},
              "requested_chunks": sum(case.counts),
              "read_chunks": sum(n for _, _, n in pieces),
              "host_us": sparse_host_us(case)}
    log(f"{case.label} on {len(case.shards)} shards, {len(devices)} card(s): calls "
        + ", ".join(f"{f} {t[0]:.6f}/{t[1]:.6f}" for f, t in times.items())
        + f" ms; {len(pieces)} pieces, launches a card {result['launches_per_card']}, "
        f"kernel launches a call {launched}; host us a step "
        + ", ".join(f"{k} {v:.2f}" for k, v in result["host_us"].items()))
    return result


def launch_counts() -> dict:
    return {**{f"probe {k}": v for k, v in pk.launch_counts().items()},
            **{f"scan {k}": v for k, v in ks.launch_counts().items()}}


def turns(case: Case, copy_lib, reps: int = 25, log=log) -> dict:
    """The forms of one case: bit-identical to the earlier per-shard form,
    each timed as a caller sees it in turns (``FORMS`` and back), the
    median breakdown of each traced form, and the kernel launches one
    wrapper call makes."""
    devices = list(dict.fromkeys(s.device for s in case.shards))
    want = old_call(case)
    for form in FORMS[1:]:
        if not torch.equal(form_call(case, form, copy_lib)(), want):
            raise AssertionError(f"{case.label}: the {form} form differs from the per-shard form")
    before = launch_counts()
    case.wrapper()
    after = launch_counts()
    launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    times: dict = {form: [] for form in FORMS}
    for form in FORMS + FORMS[::-1]:
        times[form].append(call_ms(form_call(case, form, copy_lib), devices, reps))
    parts = {}
    for form in TRACED_FORMS:
        breakdown(case, form, copy_lib)
        parts[form] = median_breakdown([breakdown(case, form, copy_lib) for _ in range(reps)])
    layout = pm.card_layout(case.shards, case.axis, case.capacity)
    result = {"call_ms": times, "breakdown": parts, "kernel_launches_per_call": launched,
              "cards": len(layout), "layout_launches": sum(len(c.launches) for c in layout)}
    if case.probe is not None:
        result["plan_split_us"] = probe_plan_split_us(case)
        log(f"  mapped (one plan call): host us " + ", ".join(
            f"{n} {v:.2f}" for n, v in result["plan_split_us"].items()))
    log(f"{case.label} on {len(case.shards)} shards, {len(devices)} card(s): calls "
        + ", ".join(f"{f} {t[0]:.6f}/{t[1]:.6f}" for f, t in times.items())
        + f" ms; kernel launches a call {launched}")
    for form, b in parts.items():
        log(f"  {form}: issue {b['issue_ms']:.6f} ({b['issue_per_launch_ms']:.6f} a launch), "
            f"buffers and copies issued {b['copy_issue_ms']:.6f}, wait {b['wait_ms']:.6f}, "
            f"join {b['join_ms']:.6f}, total {b['total_ms']:.6f} ms; "
            + "; ".join(f"{d}: {c['launches']} launches, span {c['span_ms']:.6f} busy "
                        f"{c['busy_ms']:.6f} copy {c['copy_ms']:.6f}"
                        for d, c in b["cards"].items()))
    return result


def host_costs(mesh, bank: tuple, stream: tuple, reps: int = 200) -> dict:
    """Median host-clock us of each step of one sharded call on ``mesh``:
    a reduce-AND probe (T = 1) and a one-needle scan, each step run
    ``reps`` times after a synchronisation that is not timed (a launch is
    its issue alone; the steps with a wait include the card's turnaround),
    and the whole wrappers beside the single-device probe call."""
    dev = bank[0].device
    rows = np.zeros(K, np.int32)
    needles, lens = needles_of(1, np.random.default_rng(0))
    words = pm.logical_size(bank, 1) // 32
    scan_words = pm.logical_size(stream, 0) // 32
    pinned = torch.empty((1, words), dtype=torch.int32, pin_memory=True)
    scan_pinned = torch.empty((1, scan_words), dtype=torch.int32, pin_memory=True)
    on_card = torch.empty((1, words), dtype=torch.int32, device=dev)
    own = [bank[i] for i in pm.card_layout(bank, 1, pk.MAX_SHARDS)[0].launches[0]]
    own_scan = [stream[i] for i in pm.card_layout(stream, 0, ks.MAX_SEGMENTS)[0].launches[0]]

    def us(fn) -> float:
        fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e6)
        torch.cuda.synchronize(dev)
        return statistics.median(times)

    def event():
        torch.cuda.current_stream(dev).record_event().synchronize()

    def guard():
        with torch.cuda.device(dev):
            pass

    def launch_on_card():
        probe_shards_into(on_card, 0, own, rows, rows, 1, K, "reduce_and", and_bits=1)

    def launch_pinned():
        probe_shards_into(pinned, 0, own, rows, rows, 1, K, "reduce_and", and_bits=1)

    def scan_pinned_launch():
        shards_into(scan_pinned, 0, own_scan, needles, lens, n_real=1)

    steps = {
        "pinned buffer": lambda: torch.empty((1, words), dtype=torch.int32, pin_memory=True),
        "device buffer": lambda: torch.empty((1, words), dtype=torch.int32, device=dev),
        "record and wait on an event": event,
        "device guard": guard,
        "card_layout": lambda: pm.card_layout(bank, 1, pk.MAX_SHARDS),
        "probe arrays check": lambda: pk._check(bank[0], rows, rows, 1, K),
        "launch into a device buffer": launch_on_card,
        "launch into the pinned buffer": launch_pinned,
        "sharded_query_step": lambda: pm.sharded_query_step(mesh, bank, rows, rows, 1, 1, K),
        "single-device call and copy": lambda: pk.probe_reduce_and_pack(
            bank[0], rows, rows, 1, K, 1).cpu(),
        # Each with its wait: where a synchronised call's time goes.
        "launch into a device buffer, stream wait": lambda: (
            launch_on_card(), torch.cuda.current_stream(dev).synchronize()),
        "launch into a device buffer, copy to the host": lambda: (
            launch_on_card(), on_card.cpu()),
        "launch into the pinned buffer, stream wait": lambda: (
            launch_pinned(), torch.cuda.current_stream(dev).synchronize()),
        "launch into the pinned buffer, event wait": lambda: (launch_pinned(), event()),
        "an empty kernel, stream wait": lambda: (
            torch.cuda._sleep(1), torch.cuda.current_stream(dev).synchronize()),
        "scan: pinned buffer": lambda: torch.empty((1, scan_words), dtype=torch.int32,
                                                   pin_memory=True),
        "scan: needles check": lambda: ks._check(stream[0], needles, lens, 1),
        "scan: launch into the pinned buffer": scan_pinned_launch,
        "scan: launch into the pinned buffer, event wait": lambda: (
            scan_pinned_launch(), event()),
        "scan: sharded_scan_all_rows": lambda: pm.sharded_scan_all_rows(
            mesh, stream, needles, lens, n_real=1),
    }
    return {name: us(fn) for name, fn in steps.items()}


def measure(device="cuda", shards: int = 4, reps: int = 25, seed: int = 0, log=log) -> dict:
    """Every case on ``shards`` shards of one card and, with that many cards
    visible, on a mesh of distinct cards."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("the mesh join runs on the card only")
    device = torch.device("cuda", torch.cuda.current_device() if device.index is None
                          else device.index)
    log(f"device {torch.cuda.get_device_name(device)}; nvidia-smi: {card()}")
    meshes = {"one card": pm.Mesh((device,) * shards)}
    if torch.cuda.device_count() >= shards:
        meshes["distinct cards"] = pm.Mesh(tuple(torch.device("cuda", i) for i in range(shards)))
    result = {"card": card(), "shards": shards}
    with tempfile.TemporaryDirectory(prefix="bloomsearch-mesh-join-") as tmp:
        copy_lib = build_copy_lib(tmp)
        for name, mesh in meshes.items():
            bank, stream = mesh_state(mesh.devices, seed, REFSCALE_ROWS, SHARD_COLUMNS,
                                      SHARD_CHUNKS)
            log(f"{name}: {shards} bank shards of {tuple(bank[0].shape)}, stream shards of "
                f"{tuple(stream[0].shape)} on {[str(d) for d in mesh.devices]}")
            rng = np.random.default_rng(seed)
            result[name] = {case.label: turns(case, copy_lib, reps, log)
                            for case in make_cases(mesh, bank, stream, rng, REFSCALE_ROWS)}
            result[name]["host_us"] = host_costs(mesh, bank, stream)
            log(f"{name}: host us a step " + ", ".join(
                f"{k} {v:.2f}" for k, v in result[name]["host_us"].items()))
            full = torch.cat([s.to(device) for s in stream])
            case = sparse_case(mesh, stream, full, rng)
            result[name][case.label] = sparse_turns(case, reps, log)
            del bank, stream, full, case
            for d in mesh.distinct_devices():
                with torch.cuda.device(d):
                    torch.cuda.empty_cache()
    result["single-device combined"] = combined_cases(device, seed, log=log)
    return result


def combined_cases(device, seed: int, reps: int = 200, log=log) -> dict:
    """``combined_turns`` at each epilogue's most launched main-path shape
    on a random refscale bank of the one-card engine's width (C = 256)."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    bank = random_words((REFSCALE_ROWS, 2 * SHARD_COLUMNS), gen, device)
    rng = np.random.default_rng(seed + 1)
    result = {}
    for label, epilogue, T in (("pack, T = 4", "pack", 4), ("reduce, T = 1", "reduce_and", 1),
                               ("clauses, T = 4, 2 clauses, 1 member", "clauses", 4)):
        rows = rng.integers(0, REFSCALE_ROWS, T * K).astype(np.int32)
        shifts = rng.integers(0, 32, T * K).astype(np.int32)
        extra = {"pack": {}, "reduce_and": {"and_bits": (1 << T) - 1},
                 "clauses": {"clause_bits": CLAUSES, "member_bits": MEMBERS}}[epilogue]
        label = f"single-device combined {label}"
        result[label] = combined_turns(bank, rows, shifts, T, K, epilogue, extra, reps, label,
                                       log)
    return result


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="bloomsearch_tpu_torch.tools.exp_mesh_join")
    parser.add_argument("--device", default="cuda", help="a CUDA device (no CPU form)")
    parser.add_argument("--shards", type=int, default=4)
    parser.add_argument("--reps", type=int, default=25)
    parser.add_argument("--out", help="also write the JSON result to this path")
    args = parser.parse_args(argv)
    result = measure(args.device, args.shards, args.reps)
    text = json.dumps(result)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
