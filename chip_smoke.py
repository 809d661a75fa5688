#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

Usage, from the repository root:

    python3 chip_smoke.py [--target-mb 1600] [--seed 0] [--old-probe SOURCE]
                          [--old-scan SOURCE]

Phases, in order; any failure raises and the script exits non-zero:

1. device: the card's name and power limit (nvidia-smi), the torch device,
   and the port's native host library (g++ builds it at first use);
2. build: the probe and scan kernel libraries, compiled together (one nvcc
   each) for sm_90a, with nvcc's version and the register and
   shared-memory reports; the probe library's SASS (cuobjdump) must put
   16 global loads in flight before it uses the first;
3. kernel: the block-bloom probe kernel in its three epilogues against its
   plain PyTorch version on the card at the refscale bank's width for term
   counts T in {1, 2, 3, 4, 5, 8, 12, 16} and at the bench shape,
   bit-identical, the probe arrays on the host as the engine passes them,
   with CUDA-event times beside the memory bound;
4. scan kernel: the stream byte scan in dense and segment mode against its
   plain version, bit-identical: random bytes including >= 0x80, needles of
   10 lengths at every start alignment, the start-479/480 boundary, padding
   rows, ranges of unequal and unaligned lengths (one clamped at the
   stream's end, one ending there) and the uniform segments of the JAX
   package's form, a repeated-byte stream (the prefix filter's worst case,
   timed) and a lowercased-JSON stream;
5. engine: the refscale-shaped dataset (generated from the seed in a child
   process while phases 2-4 run, and cached under ~/.cache), a
   BloomSearchEngine on device="cuda" that warms every
   bank group onto the card, the needle queries, an OR tree, a common token
   under a partition prefilter and 16 threads of mixed queries, each result
   checked against a host-probe engine on the same files. The kernel launch
   counters are reset just before this phase and must show that the warm
   queries went through the kernel;
6. main-path shapes: the probe kernel against its plain version at every
   shape (C, T, members, clauses) the engine phase launched and phase 3 did
   not cover (here and in phase 3 the single-device combiner's plan call,
   ``bs_probe_plan`` with one launch into a page-locked buffer, must equal
   both); each epilogue's most launched shape is timed and reported (its
   ``ms``: the kernel storing into a page-locked buffer, as the plan call's
   launch does, ``pinned_launch_ms``; beside it the launch into a device
   tensor), and the engine's combined probe call at that shape is timed as
   a caller sees it in turns against the earlier launch into a device
   tensor and its copy (``combined_call_turns``: ten turns a form, their
   verdict and the plan call's host split);
   with ``--old-probe`` an earlier probe kernel (the probe arrays in its
   parameters; one bank a launch, or the later shard table called with
   one bank) against this one in turns at every phase-3 shape,
   each epilogue's most launched shape and the bench shape
   (``turns_against_old_probe``);
7. serving engine: the same dataset in serving mode (the row stream pinned
   on the card, a restart sidecar in a temporary directory), the same
   queries checked against the host-probe engine, the scan counters reset
   before it; every segment launch (the sparse scan's one plan call on the
   one stream tensor) checked to read just the requested block ranges
   with real needles only, and every dense launch (the dense scan's one
   plan call, a dense-mode record over the whole stream) to take n_real
   equal to its real needles, the 16-thread burst's dense launches counted
   by n_real; then the scan kernel against its plain version on the
   resident stream at every shape the engine launched (a segment launch
   timed after an L2 flush, its bound counted on the chunks the query
   asked for; a dense shape through the plan call too, its ``ms`` the
   plan's launch into a page-locked buffer), the most launched segment
   launch timed in turns against the same ranges with its first needle
   alone and against a one-tile launch (``segment_needle_turns``: needle
   issue or a fixed cost), dense at every n_real from 1 to 8 of the
   engine's needles, the kernel alone in turns at n_real 1 and 8 (dense
   mode into device memory and into a page-locked buffer, the plan's
   launch, against one range in segment mode: ``dense_mode_turns``), the
   one-card dense call against the earlier launch and ``.cpu()`` copy in
   turns at every n_real from 1 to 8 (``dense_call_turns``), the needle
   cache's copy of a row at refscale's width and at an 18M-bit row, with
   ``--old-scan`` an earlier scan kernel against this one in turns
   (``turns_against_old_scan``), and a restarted engine that loads every
   block from the sidecar and times every shape (needle cache off, as
   phase 8's mesh engine);
8. mesh (K3): (a) the serving engine's resident superbanks and stream
   placed with ``shard_bank`` and the row helpers onto a 4-shard mesh (four
   cards when four are visible, else cuda:0 four times), the needle
   queries' probe arrays and scan needles driven through the four dense
   sharded wrappers, each result bit-identical to the unsharded kernel on
   the same logical content and to the plain version; then each wrapper
   at its main-path shape in four forms timed in turns as a caller sees
   them (``tools/exp_mesh_join.py``: the package's wrapper, one launch a
   card into the page-locked joined bitmap, all of them issued and waited
   for in one foreign call, ``bs_probe_plan`` or ``bs_scan_plan``; the
   same launches each its own foreign call; the earlier launch, copy and
   host join a shard; and a device buffer with one strided copy a
   launch), the breakdown of each form the host issues launch by launch
   (issue, each card's launch spans, copies, wait, join), for the probes
   the plan call's host split (``plan_split_us``) and the
   kernel launches one sharded call makes, beside the single-device
   call and device times of the unsharded launch and of one launch over a
   card's shards; the sparse sharded scan (``sharded_scan_segments``, one
   plan call issuing every card's launches) and the single-device sparse
   call on the joined stream at every segment launch phase 7 recorded, at
   a range across a shard boundary and at one ending at the stream's end,
   each bit-identical at every requested chunk to the unsharded segment
   launch and the plain version, and phase 7's most launched segment shape
   timed in turns as a caller sees it (``tools/exp_mesh_join.
   sparse_turns``: the earlier per-launch form, the plan, the
   single-device sparse call, the earlier single-device segment call and
   copy, the dense sharded call; ``host_us`` splits the plan call into
   record building, the foreign call's issue and its wait), with its
   bound on the busiest card; (b) the main path:
   the serving engine restarted from phase 7's sidecar over a mesh (every
   card with its default ``mesh_devices=None`` when two or more are
   visible, else the four shards on cuda:0), every query shape and 16
   threads against the host-probe engine's rows, each shape's warm p50
   beside phase 7's restarted one-card engine's, the K3 and kernel
   counters set to 0 just
   before its queries and read just after; each shape must scan in the
   modes phase 7 did (sparse on a mesh: the sharded segment scan), each
   sparse call launch only on the cards that hold its pieces,
   ceil(pieces / 4) launches a card, and each dense sharded call make
   exactly one launch a card; with two or more cards also
   ``graft_entry.dryrun_multichip``; (c) ``graft_entry.entry()`` against
   the plain version;
9. beyond budget: the refscale dataset served with ``bank_cache_bytes``
   and ``row_cache_bytes`` below its banks and its stream (768 MiB and 640
   MiB at refscale, ``beyond_budgets``: one 128-column superbank unit and
   a group fit, its doubling does not; ~36% of the stream), needle cache
   off: ``warmup()``, every phase-5/7 query shape, the JAX bench's churn
   sweep of 80 uid lookups, the 16-thread burst alone and beside a churn
   sweep, every row set against the host-probe engine's. Bank evictions
   and compactions, row-cache evictions and compactions, sparse cold
   probes, completed background bank warms and pins (``BudgetCounters``,
   the row cache's stats) must each be above 0, degrades to host probing
   (``BankChurnError``) no more than the device probe calls, the probe
   and scan counters (set to 0 just before) must show K1e and K2/K2s
   launches, every probe and scan launch shape is re-run against its plain
   version (phases 6 and 7's helpers), and the peak device memory must
   stay within the bound ``memory_bound`` derives from the code; then the
   one-card combined probe at a 24.8 GB bank (C = 4,608; reduce-AND at T =
   1 and the widest clause output, T = 16 with 16 members) in turns, plan
   against launch and copy (``wide_bank_turns``);
10. tools: (a) the probe's access-pattern floor kernel (K1f,
   ``probe_floor``) against its plain version, bit-identical, at the bench
   shape (13,480 rows, C = 32,768, T = 4) and at the refscale bank's C =
   256, then ``tools/exp_kernel_floor.measure``: the stream floor (single
   reductions between CUDA events), K1f and K1 per launch by the event
   slope over CUDA-graph chains of 32 and 4,096 launches, each replay
   counting the launches it runs; the floor counter is set to 0 just
   before the tool and read just after; (b) the bench's T1 record
   (``bench.kernel_record`` of that measurement, event slope) and
   ``bench._timed_needle_queries`` on the refscale dataset through a
   probe-backend engine (host clock); (c) T2's warm start
   (``tools/exp_compile_cache.warm_start``: a child process loads the
   built libraries and launches, no nvcc; host clock to a synchronize);
   (d) ``cli`` load, search (token, field:token with a regex, ``--limit``)
   and merge on the card, the rows equal to the host probe's;
11. writes under serving: 4 of the refscale files (every sixth, counted
   back from the newest) hardlinked beside the dataset behind a
   ``MemoryMetaStore`` (a merge publishes atomically), the serving cell's
   settings with a sidecar, ``ttl_predicate`` expiring partition 00 and
   the needle cache on (the engine's default): ``warmup()`` and every
   phase-5/7 shape against the host probe; then a writer thread ingests
   1,000,000 rows in the refscale generator's shape through
   ``ingest_serialized`` (a partition a 10,000-row batch, a flush every
   100,000 rows, so warm-on-flush inserts grow the superbank), while 8
   query threads run the shapes, the live rows' needle and read-your-writes
   lookups of uids whose batch's ``done`` had resolved, a merge starts once
   half the batches are durable and another after ingest ends; every query
   is held to the invariants (no row twice; each base row outside 00 once,
   one of 00 at most once; each live row at most once and, outside 00,
   exactly once when durable before the query began; no row never
   written); at quiescence every shape and 200 sampled uids against the
   host probe, one more pin between two passes of the shapes (a needle
   cached before it misses after it), a restart from the sidecar, which
   must hold no tombstoned file, and the same checks; the counters
   (``WriteCounters``: warm-on-flush inserts, superbank growths, segment
   removals by tombstone, superbank and stream compactions, stream blocks
   a tombstone removed, tombstones deferred behind a query and applied by
   a draining one, needle-cache hits and version misses) must be > 0, and
   warm-on-flush failures, ERROR log records, uncaught thread exceptions,
   background pin failures and still-deferred tombstones 0; degrades to
   host probing no more than device probes; every probe and scan launch
   shape re-run against its plain version (the restart's too); the peak
   device memory under ``writes_memory_bound``. Then the same run on a
   4-shard mesh (four cards when four are visible, else cuda:0 four
   times) at a quarter of the rows over 2 files, each sharded scan shape
   re-run against the plain version on the mesh's logical stream;
12. scale-out over ``serve`` peers: (a) the 24 refscale files hardlinked
   under ``data/`` of a ``LocalDirObjectStore`` bucket beside their
   ``.etag`` sidecars (a put where a link fails), the manifest written by
   one ``ObjectStoreMetaStore.update`` from their footers; (b) peers started
   as children through the entry point, one per visible card
   (``CUDA_VISIBLE_DEVICES``) when two or more are visible, else two on the
   one card: each is this script in peer mode (``--peer RECORD`` and
   ``serve``'s arguments: ``--object-dir``, ``--registry``, ``--peer-id``,
   ``--capacity`` 2 then 1, ``--row-cache-mb 10240``, ``--probe-backend
   device``), which installs phase 6 and 7's launch recorders and phase 9's
   counters and calls ``bloomsearch_tpu_torch.serve.main``; a peer is cold
   (no warmup), so it sparse-probes through ranged reads of the bucket and
   warms and pins in the background, with the host shadow on; (c) through
   ``CapacityScatterCoordinator`` in this process: every phase-5/7 shape
   cold once, warm passes until one is no more than 10% faster than the
   last, 7 samples a shape, 16 threads x 8 mixed queries; (d) an in-process
   engine on the card takes the merge lease and merges two files (~1M rows)
   while 8 coordinator threads query; (e) SIGKILL to the last peer during
   a 16-thread burst, then every shape on the survivors; (f) two ``serve
   --dir`` peers over alternate files (shadow-free) behind
   ``ScatterGatherCoordinator``, every shape and 16 threads. Every row set
   is held to a host-probe engine's on the same bucket (for (f), on the 24
   files): a query returns exactly those rows, or surfaces an error with a
   subset of them and no row twice (counted by kind). Before its engine
   stops (SIGTERM) each peer writes its counters (launches, sparse cold
   probes, completed bank warms and pins, residency, bytes it still holds
   of merged-away files, peak device memory, ERROR log records and thread
   exceptions) and re-runs every probe and scan launch shape it made
   against the plain version; every surviving peer must show K1e launches,
   K2/K2s launches where it scanned, no ERROR record or thread exception,
   and a peak under ``peer_memory_bound``.
13. the query language and both bloom layouts: (a) while the dataset's
   child generates refscale and then its blocked-256 copy (after phase 4,
   before phase 5), the oracle fuzz's episodes
   (``bloomsearch_tpu_torch/tools/oracle_fuzz.py``, the JAX package's
   ``tests/test_oracle_fuzz.py`` as episodes) on ``device="cuda"``: the
   device and serving backends x the fs and in-memory object stores x
   both layouts x rows or the serialized mix x the codecs none, snappy and
   zstd where the host has it, the host backend as the control, both
   backends at both layouts and both ingests on a 4-shard mesh (four
   cards when four are visible, else cuda:0 four times), and the long
   variant (rows over one stream chunk, non-ASCII tokens, needles over 32
   bytes, an OR wider than one launch) on serving on one card and the
   mesh; every query exact against the oracle (the minmax subset rule),
   each episode's final queries again from 8 threads at once; every probe
   and scan call held against its plain version as it returns
   (``LaunchCheck``), the probe calls at blocked positions and the rows
   found through the always-candidate flags alone (``EscapeCounter``)
   counted and required, the launch counters set to 0 just before and
   read just after, every probe launch shape re-run (phase 6's helper), no
   ERROR record or thread exception; (b) after phase 12, the blocked copy
   (``blocked_dataset``: refscale's blocks decoded and re-ingested through
   ``ingest_serialized`` with their partitions by an engine with
   ``generate_fast``'s settings and ``bloom_layout="blocked256"``) under
   the probe cell's and the serving cell's settings: warmup, every
   phase-5/7 shape against the classic host probe's rows beside phases 5
   and 7's p50s, the candidate blocks of both layouts, 16 threads, a pass
   with every launch held against its plain version; the one-card
   combined probe at the blocked superbank's width at blocked and classic
   positions in turns, each with its bound from the distinct rows it
   touches; (c) the classic files at even places and the blocked copies
   of the odd ones behind a ``MemoryMetaStore``, served with both
   superbanks resident, every shape against the classic host probe's
   rows, then a merge of two files of each layout that must keep the
   layouts apart.

The line before the last is the kernels' JSON record, with phase 9's
numbers under ``beyond_budget``, phase 11's under ``writes``, phase 12's
under ``scale_out`` and phase 13's under ``query_language``; the last line
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
INT32_OPS_PER_S = 67e12  # H100 SXM non-tensor-core 32-bit rate
REFSCALE_ROWS = 1_347_900  # 3 keyspaces x 449,300 words (1M items, FPR 0.001)
BENCH_ROWS = 13_479  # 3 x 4,493 words (10,000 items, FPR 0.001)
K = 10
PROBE_SOURCE = "bloomsearch_tpu_torch/csrc/probe.cu"
PROBE_LOAD_GROUP = 16  # csrc/probe.cu LOAD_GROUP: loads a term has in flight at once
SCAN_SOURCE = "bloomsearch_tpu_torch/csrc/scan.cu"
PALLAS = "bloomsearch_tpu/bloom/pallas_kernels.py"
EPILOGUES = {
    # name: (launch counter, TPU function it replaces)
    "probe_and_pack": ("pack", f"{PALLAS}:153"),
    "probe_reduce_and_pack": ("reduce_and", f"{PALLAS}:177"),
    "probe_clauses_pack": ("clauses", f"{PALLAS}:205"),
}
SCAN_MODES = {
    # name: (launch counter, TPU function or XLA code it replaces)
    "byte_scan_stream": ("stream", f"{PALLAS}:376"),
    "byte_scan_segments": ("segments", "bloomsearch_tpu/rowcache.py:299"),
}
MESH_PY = "bloomsearch_tpu/parallel/mesh.py"
MESH_WRAPPERS = {
    # name: (source, the C entry that issues every launch of a call, TPU
    # function it replaces)
    "sharded_probe_packed": (PROBE_SOURCE, "bs_probe_plan", f"{MESH_PY}:121"),
    "sharded_query_step": (PROBE_SOURCE, "bs_probe_plan", f"{MESH_PY}:167"),
    "sharded_probe_clauses": (PROBE_SOURCE, "bs_probe_plan", f"{MESH_PY}:215"),
    "sharded_scan_all_rows": (SCAN_SOURCE, "bs_scan_plan", f"{MESH_PY}:330"),
    # The reference scans every shard in full on a mesh; this is its
    # single-device scan_segments over the shards.
    "sharded_scan_segments": (SCAN_SOURCE, "bs_scan_plan", "bloomsearch_tpu/rowcache.py:299"),
}
MESH_SHARDS = 4
PHASE3_T = (1, 2, 3, 4, 5, 8, 12, 16)  # K1's term counts at the refscale width
SCAN_LENGTHS = (1, 2, 3, 4, 5, 7, 8, 15, 31, 32)
SEG_CHUNKS = 16_384  # a refscale block is about 15,000 chunks
L2_FLUSH_BYTES = 128 << 20  # over twice the H100's 50 MB L2 cache
PLAIN_PIECE = 32_768  # chunks per plain-version call over a large stream


def log(msg: str) -> None:
    print(msg, flush=True)


# -- phase 1 and 2 ------------------------------------------------------------


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def phase_device() -> str:
    smi = card_line()
    log(smi)
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {name} "
        f"count {torch.cuda.device_count()}")
    from bloomsearch_tpu_torch import native

    if not native.available():
        result = subprocess.run(
            native_compile_command(), capture_output=True, text=True, timeout=300
        )
        raise RuntimeError(f"native host library did not load; g++ said:\n{result.stderr}")
    log("native host library: loaded")
    return name


def native_compile_command() -> list[str]:
    from bloomsearch_tpu_torch import native

    out = os.path.join(os.path.dirname(native._SO), "native_build_check.so")
    return ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", out, native._SRC]


def phase_build() -> None:
    """Both kernel libraries, one nvcc process each, started together;
    then the SASS check of K1's loads in flight."""
    from bloomsearch_tpu_torch.kernels import probe as pk
    from bloomsearch_tpu_torch.kernels import scan as ks

    log(f"build: {nvcc_version()}")
    results: dict[str, tuple] = {}

    def build(source: str, module) -> None:
        t0 = time.perf_counter()
        try:
            results[source] = (module.build_library(force=True), time.perf_counter() - t0)
        except BaseException as exc:  # re-raised below
            results[source] = (exc, time.perf_counter() - t0)

    threads = [threading.Thread(target=build, args=(src, mod))
               for src, mod in ((PROBE_SOURCE, pk), (SCAN_SOURCE, ks))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for source, (report, seconds) in results.items():
        if isinstance(report, BaseException):
            raise report
        regs = [line.strip() for line in report.splitlines() if "registers" in line]
        log(f"build: {source} with nvcc sm_90a in {seconds:.2f} s; {regs}")
    pk.library()
    ks.library()
    # K1's term loads must all be in flight before the first is used.
    in_flight = sass_loads_in_flight(pk.LIBRARY)
    log(f"build: {PROBE_SOURCE} SASS, global loads in flight before the first use of one "
        f"(cuobjdump -sass): {json.dumps(in_flight)}")
    for fn, n in in_flight.items():
        if n < PROBE_LOAD_GROUP:
            raise AssertionError(f"{fn}: only {n} loads in flight, want {PROBE_LOAD_GROUP}")


def nvcc_version() -> str:
    from bloomsearch_tpu_torch.kernels import build

    nvcc = build.nvcc_command("", "")[0]
    out = subprocess.run([nvcc, "--version"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[-1] if out.returncode == 0 else out.stderr.strip()


def sass_loads_in_flight(library: str) -> dict:
    """{kernel function: the most global loads (LDG) it sends before an
    instruction touches the register of one of them}, from ``cuobjdump
    -sass`` of ``library``."""
    import re

    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", library], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    out: dict = {}
    fn, pending, run = None, set(), 0
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn, pending, run = m.group(1), set(), 0
            out[fn] = 0
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)\s*([^;]*);", line)
        if fn is None or not m:
            continue
        op, operands = m.group(1), m.group(2)
        regs = set(re.findall(r"\bR\d+\b", operands))
        if op.startswith("LDG"):
            dst = re.match(r"\s*(R\d+)", operands)
            if regs & pending:
                pending, run = set(), 0
            if dst:
                pending.add(dst.group(1))
            run += 1
            out[fn] = max(out[fn], run)
        elif regs & pending:
            pending, run = set(), 0
    return {name: n for name, n in out.items() if "probe" in name}


# -- phase 3 ------------------------------------------------------------------


def random_bank(rows: int, cols: int, gen: torch.Generator, dev) -> torch.Tensor:
    words = torch.randint(0, 1 << 32, (rows, cols), generator=gen, device=dev, dtype=torch.int64)
    return (words - (1 << 31)).to(torch.int32)


def event_ms(fn, reps: int, hide_host: bool, before=None) -> float:
    """Median time of ``fn(i)`` over ``reps`` calls between CUDA events.

    ``hide_host``: a spin kernel first keeps the stream busy while the host
    enqueues the call, so the events bracket device time alone; without it
    they also hold the host's launch cost (what a waiting caller sees).
    ``before``, when given, runs ahead of each call outside the events (an
    L2 flush)."""
    fn(0)
    torch.cuda.synchronize()
    times = []
    for i in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if before is not None:
            before()
        if hide_host:
            torch.cuda._sleep(2_000_000)  # ~1 ms of spinning at H100 clocks
        start.record()
        fn(i)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


_flush_buffers: dict = {}


def flush_l2(dev) -> None:
    """Write a buffer larger than the card's 50 MB L2 cache, so the next
    launch reads its inputs from device memory, as a query does."""
    buf = _flush_buffers.get(dev)
    if buf is None:
        buf = _flush_buffers[dev] = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    buf.fill_(1)


def shape_key(name: str, C: int, T: int, clauses: int = 16, members: int = 16) -> tuple:
    """A case's key in the form of ``kernels.probe.launch_shapes()``:
    (launch counter, C, T, output rows, clauses)."""
    counter = EPILOGUES[name][0]
    rows = {"pack": T, "reduce_and": 1, "clauses": members}[counter]
    return (counter, C, T, rows, clauses if counter == "clauses" else 0)


def probe_sets(gen: torch.Generator, R: int, T: int, n: int, k: int = K) -> list[tuple]:
    """``n`` random probe sets (host int32[T*k] rows below R and shifts),
    drawn from the torch generator ``gen``; bit 31 among the shifts."""
    sets = []
    for _ in range(n):
        rows = torch.randint(0, R, (T * k,), generator=gen, device=gen.device,
                             dtype=torch.int32).cpu()
        shifts = torch.randint(0, 32, (T * k,), generator=gen, device=gen.device,
                               dtype=torch.int32).cpu()
        shifts[::5] = 31
        sets.append((rows, shifts))
    return sets


def epilogue_args(name: str, T: int, clauses: int = 16, members: int = 16) -> tuple:
    """The epilogue's arguments after (bank, rows, shifts, T, K): every term
    in the AND; ``clauses`` clauses of two terms, ``members`` members of two
    clauses."""
    clause_bits = [(1 << (i % T)) | (1 << ((i + 1) % T)) for i in range(clauses)]
    member_bits = [(1 << (m % clauses)) | (1 << ((m + 5) % clauses)) for m in range(members)]
    return {
        "probe_and_pack": (),
        "probe_reduce_and_pack": ((1 << T) - 1,),
        "probe_clauses_pack": (clause_bits, member_bits),
    }[name]


def plain_epilogue(pk, name: str, bank, rows, shifts, T: int, extra: tuple, k: int = K):
    """The plain version of epilogue ``name`` on the bank's device (the host
    probe arrays copied there)."""
    rows, shifts = (torch.as_tensor(a).to(bank.device) for a in (rows, shifts))
    match = pk.probe_plain(bank, rows, shifts, T, k)
    if name == "probe_reduce_and_pack":
        match = pk.reduce_and_plain(match, *extra)
    elif name == "probe_clauses_pack":
        match = pk.clauses_plain(match, *extra)
    return pk.pack_bitmap_plain(match)


def epilogue_kwargs(name: str, extra: tuple) -> dict:
    """``epilogue_args``' tuple for epilogue ``name`` as the plan entry's
    keyword arguments."""
    return dict(zip({"probe_reduce_and_pack": ("and_bits",),
                     "probe_clauses_pack": ("clause_bits", "member_bits")}.get(name, ()), extra))


def single_device_call(name: str, bank, rows, shifts, T: int, extra: tuple, k: int = K):
    """The single-device combiner's call of epilogue ``name``
    (``bloom/bank.py::_probe`` with no mesh: one launch through the plan
    entry into a page-locked buffer) -> its words on the host, as the
    kernel packs them."""
    from bloomsearch_tpu_torch.kernels import probe as pk

    return pk.probe_plan([(0, [bank])], bank.shape[1] // 32, rows, shifts, T, k,
                         EPILOGUES[name][0], **epilogue_kwargs(name, extra))


def pinned_launch_ms(bank, sets: list, T: int, name: str, extra: tuple, plain,
                     reps: int) -> float:
    """Device time of the main path's launch: the kernel storing its words
    into a page-locked host buffer through its device address, as the plan
    call's one launch does. The plan call waits inside itself, so an event
    after it would hold the host's wake-up too: the same kernel, the same
    instantiation and output, is launched here through the single-launch
    entry into that buffer (``tools/exp_mesh_join.probe_shards_into``)
    between CUDA events behind a spin kernel (``event_ms``). The last
    launch's words must equal the plain version's."""
    from bloomsearch_tpu_torch.kernels import probe as pk
    from bloomsearch_tpu_torch.tools import exp_mesh_join as mj

    counter = EPILOGUES[name][0]
    kw = epilogue_kwargs(name, extra)
    C = bank.shape[1]
    out = torch.empty((pk.output_rows(counter, T, kw.get("member_bits", ())), C // 32),
                      dtype=torch.int32, pin_memory=True)
    ms = event_ms(lambda i: mj.probe_shards_into(out, 0, [bank], *sets[i], T, K, counter, **kw),
                  reps, hide_host=True)
    if not torch.equal(out, plain(*sets[reps - 1]).cpu()):
        raise AssertionError(f"{name} T={T} C={C}: the launch into a page-locked buffer "
                             "disagrees with the plain version")
    return ms


def kernel_case(pk, bank, T: int, name: str, gen, dev, reps: int = 25,
                clauses: int = 16, members: int = 16, time_it: bool = True) -> dict:
    """Hold one epilogue against its plain version at one shape and time
    both (``time_it``); the single-device combiner's plan call
    (``single_device_call``) must equal them too. Each launch probes fresh
    random rows, so the rows come from device memory as a query's would,
    not from the L2 cache; the probe arrays are host arrays, as the engine
    passes them (the plain version takes copies on the card)."""
    R, C = bank.shape
    reps = reps if time_it else 3
    sets = probe_sets(gen, R, T, reps + 1)
    extra = epilogue_args(name, T, clauses, members)
    kernel = getattr(pk, name)

    def plain(rows, shifts):
        return plain_epilogue(pk, name, bank, rows, shifts, T, extra)

    max_err = 0
    for rows, shifts in sets[:4]:
        got = kernel(bank, rows, shifts, T, K, *extra)
        want = plain(rows, shifts)
        one = single_device_call(name, bank, rows, shifts, T, extra)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        if err or not torch.equal(got, want):
            raise AssertionError(f"{name} T={T} C={C}: kernel disagrees with plain version")
        if not torch.equal(one, want.cpu()):
            raise AssertionError(f"{name} T={T} C={C}: the single-device plan call disagrees "
                                 "with the plain version")
        max_err = max(max_err, err)
    key = shape_key(name, C, T, clauses, members)
    shape = f"{name} R={R} C={C} T={T} K={K}" + (
        f" clauses={clauses} members={members}" if name == "probe_clauses_pack" else "")
    if not time_it:
        log(f"kernel {shape}: bit-identical (the single launch and the plan call)")
        return {"key": key, "max_abs_err": max_err}
    ms = event_ms(lambda i: kernel(bank, *sets[i], T, K, *extra), reps, hide_host=True)
    call_ms = event_ms(lambda i: kernel(bank, *sets[i], T, K, *extra), reps, hide_host=False)
    pinned_ms = pinned_launch_ms(bank, sets, T, name, extra, plain, reps)
    on_card = [tuple(a.to(dev) for a in pair) for pair in sets]
    plain_ms = event_ms(lambda i: plain(*on_card[i]), reps, hide_host=True)
    out_rows = key[3]
    # Least work: the T*K probed rows (each read once), the probe arrays and
    # the packed output. About 3 integer operations per probed word.
    nbytes = T * K * C * 4 + T * K * 8 + out_rows * (C // 32) * 4
    ops = 3 * T * K * C
    bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) * 1e3
    bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / INT32_OPS_PER_S else "operations"
    log(f"kernel {shape}: kernel_ms={ms:.6f} pinned_ms={pinned_ms:.6f} call_ms={call_ms:.6f} "
        f"plain_ms={plain_ms:.6f} bound_ms={bound_ms:.6f} ({bound_by}) bytes={nbytes} "
        f"bit-identical (the single launch and the plan call)")
    return {"key": key, "ms": ms, "pinned_ms": pinned_ms, "call_ms": call_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": max_err,
            "bytes": nbytes}


def phase_kernel(dev, refscale_rows: int = REFSCALE_ROWS, bench_rows: int = BENCH_ROWS,
                 bench_cols: int = 32_768) -> dict:
    """Every epilogue at the refscale bank's C = 256 for term counts 1 to 16
    (the engine launches a batch's real term count, up to 16; ``PHASE3_T``
    holds odd ones), with 16 clauses and 16 members, and at the bench shape
    C = 32,768, T = 4."""
    from bloomsearch_tpu_torch.kernels import probe as pk

    gen = torch.Generator(device=dev).manual_seed(0)
    bank = random_bank(refscale_rows, 256, gen, dev)
    cases = {}
    for T in PHASE3_T:
        for name in EPILOGUES:
            case = kernel_case(pk, bank, T, name, gen, dev)
            cases[case["key"]] = case
    del bank
    bank = random_bank(bench_rows, bench_cols, gen, dev)
    for name in EPILOGUES:
        case = kernel_case(pk, bank, 4, name, gen, dev)
        cases[case["key"]] = case
    del bank
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return cases


def phase_main_shapes(dev, launched: dict, cases: dict,
                      refscale_rows: int = REFSCALE_ROWS) -> dict:
    """Hold the kernel against its plain version at every shape the main
    path launched that phase 3 did not cover, and time the most launched
    shape of each epilogue. Returns {launch counter: that shape's case}."""
    from bloomsearch_tpu_torch.kernels import probe as pk

    name_of = {counter: name for name, (counter, _) in EPILOGUES.items()}
    top = {}
    for key, n in launched.items():
        if n > launched.get(top.get(key[0]), 0):
            top[key[0]] = key
    gen = torch.Generator(device=dev).manual_seed(1)
    banks: dict[int, torch.Tensor] = {}
    for key in sorted(launched):
        counter, C, T, rows, clauses = key
        if key in cases and "ms" in cases[key]:
            continue
        if C not in banks:
            banks[C] = random_bank(refscale_rows, C, gen, dev)
        cases[key] = kernel_case(
            pk, banks[C], T, name_of[counter], gen, dev, clauses=max(clauses, 1),
            members=rows, time_it=key == top[counter],
        )
    banks.clear()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {counter: cases[key] for counter, key in top.items()}


def old_probe_launcher(source: str):
    """An earlier probe kernel, built from ``source``: a ``csrc/probe.cu``
    whose ``bs_probe_launch`` takes the host probe arrays in the launch's
    parameters and either one bank (the interface before the shard table)
    or a table of banks with an output stride (the later one, called here
    with one bank and its own stride), its output a new tensor. ->
    launch(bank, rows, shifts, T, k, name, extra) on the current stream,
    ``rows`` and ``shifts`` host int32 arrays."""
    import ctypes

    from bloomsearch_tpu_torch.kernels import build
    from bloomsearch_tpu_torch.kernels import probe as pk

    path = os.path.join(tempfile.mkdtemp(prefix="bloomsearch-old-probe-"), "libold_probe.so")
    report = build.build_library(source, path, force=True)
    log(f"old probe kernel built from {source}: "
        f"{[ln.strip() for ln in report.splitlines() if 'registers' in ln]}")
    lib = ctypes.CDLL(path)
    with open(source) as fh:
        table_form = "const int32_t* const* banks" in fh.read()
    p, i64, i32, u32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_uint32
    if table_form:
        lib.bs_probe_launch.argtypes = [p, i32, i64, i64, p, p, i32, i32, i32, u32, p, i32, p,
                                        i32, p, i64, i64, i32, i32, p]
    else:
        lib.bs_probe_launch.argtypes = [p, i64, i64, p, p, i32, i32, i32, u32, p, i32, p, i32,
                                        p, p]
    lib.bs_probe_launch.restype = ctypes.c_int
    modes = {"probe_and_pack": pk.MODE_PACK, "probe_reduce_and_pack": pk.MODE_REDUCE,
             "probe_clauses_pack": pk.MODE_CLAUSES}

    def launch(bank, rows, shifts, T, k, name, extra):
        and_bits = extra[0] if name == "probe_reduce_and_pack" else 0
        clause_bits, member_bits = extra if name == "probe_clauses_pack" else ((), ())
        out_rows = {"probe_and_pack": T, "probe_reduce_and_pack": 1}.get(name, len(member_bits))
        cb = (ctypes.c_uint32 * max(len(clause_bits), 1))(*clause_bits)
        mb = (ctypes.c_uint32 * max(len(member_bits), 1))(*member_bits)
        rows = np.ascontiguousarray(rows, dtype=np.int32)
        shifts = np.ascontiguousarray(shifts, dtype=np.int32)
        R, C = bank.shape
        out = torch.empty((out_rows, C // 32), dtype=torch.int32, device=bank.device)
        stream = torch.cuda.current_stream(bank.device).cuda_stream
        args = (rows.ctypes.data, shifts.ctypes.data, T, k, modes[name], and_bits, cb,
                len(clause_bits), mb, len(member_bits), out.data_ptr())
        if table_form:
            table = (ctypes.c_void_p * 1)(bank.data_ptr())
            err = lib.bs_probe_launch(table, 1, R, C, *args, C // 32, 0, 0, bank.device.index,
                                      stream)
        else:
            err = lib.bs_probe_launch(bank.data_ptr(), R, C, *args, stream)
        if err:
            raise RuntimeError(f"old probe kernel launch failed: cudaError {err}")
        return out

    return launch


def turns_against_old_probe(dev, source: str, main_cases: dict, reps: int = 25,
                            refscale_rows: int = REFSCALE_ROWS,
                            bench_rows: int = BENCH_ROWS) -> dict:
    """This probe kernel against an earlier one built from ``source``
    (``old_probe_launcher``) on the same card, timed in turns (old, new,
    new, old; device time behind a spin kernel, fresh random rows each
    launch, its own for each run): every phase-3 shape, each epilogue's
    most launched main-path shape (``main_cases``, phase 6) and the bench
    shape, beside an empty launch by the same clock. Both take the host
    probe arrays in their parameters; the caller's time of each
    (``call_ms``, the launch with its output) is timed once each. Both
    kernels must equal the plain version at every case."""
    from bloomsearch_tpu_torch.kernels import probe as pk

    old = old_probe_launcher(source)
    gen = torch.Generator(device=dev).manual_seed(6)
    # What an empty launch takes by the same clock: the least any kernel can.
    empty_ms = event_ms(lambda i: torch.cuda._sleep(1), reps, hide_host=True)
    log(f"turns: an empty launch (a 1-cycle spin kernel) takes {empty_ms:.6f} ms between "
        "CUDA events behind a spin kernel")
    shapes = [(refscale_rows, 256, T, name, 16, 16) for T in PHASE3_T for name in EPILOGUES]
    shapes += [(bench_rows, 32_768, 4, name, 16, 16) for name in EPILOGUES]
    name_of = {counter: name for name, (counter, _) in EPILOGUES.items()}
    for counter, case in sorted(main_cases.items()):
        _, C, T, rows, clauses = case["key"]
        shapes.append((refscale_rows, C, T, name_of[counter], max(clauses, 1), rows))
    banks: dict = {}
    result = {}
    for R, C, T, name, clauses, members in shapes:
        if (R, C) not in banks:
            banks.clear()
            banks[(R, C)] = random_bank(R, C, gen, dev)
        bank = banks[(R, C)]
        # Each timing run probes its own fresh rows (a run's rows would
        # otherwise sit in the L2 cache for the next).
        runs = 6
        sets = probe_sets(gen, R, T, runs * reps)
        on_card = [tuple(a.to(dev) for a in pair) for pair in sets]
        extra = epilogue_args(name, T, clauses, members)
        kernel = getattr(pk, name)
        old_fn = lambda i, o=0: old(bank, *sets[o + i], T, K, name, extra)  # noqa: E731
        new_fn = lambda i, o=0: kernel(bank, *sets[o + i], T, K, *extra)  # noqa: E731
        for i in range(3):
            want = plain_epilogue(pk, name, bank, *on_card[i], T, extra)
            if not (torch.equal(old_fn(i), want) and torch.equal(new_fn(i), want)):
                raise AssertionError(f"turns {name} C={C} T={T}: a kernel differs from the "
                                     "plain version")
        ms = [event_ms(lambda i, fn=fn, o=run * reps: fn(i, o), reps, hide_host=True)
              for run, fn in enumerate((old_fn, new_fn, new_fn, old_fn))]

        bound_ms, bound_by = probe_bound(T, C, {"probe_and_pack": T,
                                                "probe_reduce_and_pack": 1}.get(name, members))
        label = f"{name} R={R} C={C} T={T}" + (
            f" clauses={clauses} members={members}" if name == "probe_clauses_pack" else "")
        result[label] = {
            "old_ms": [ms[0], ms[3]], "new_ms": [ms[1], ms[2]],
            "old_call_ms": event_ms(lambda i: old_fn(i, 4 * reps), reps, hide_host=False),
            "new_call_ms": event_ms(lambda i: new_fn(i, 5 * reps), reps, hide_host=False),
            "bound_ms": bound_ms, "bound_by": bound_by}
        r = result[label]
        log(f"turns {label}: old {ms[0]:.6f}, new {ms[1]:.6f}, new {ms[2]:.6f}, old "
            f"{ms[3]:.6f} ms; calls old {r['old_call_ms']:.6f}, new {r['new_call_ms']:.6f} ms; "
            f"bound {bound_ms:.6f} ms ({bound_by}); both = plain version")
    banks.clear()
    torch.cuda.empty_cache()
    return {"turns": result, "empty_launch_ms": empty_ms}


# -- phase 4: the scan kernel -----------------------------------------------------


def scan_needles(lengths, rng) -> tuple[list[bytes], np.ndarray, np.ndarray]:
    """Needles of the given lengths from bytes 0x41..0xff (no zero byte,
    many >= 0x80) -> (needles, int32[8, 32] bytes, int32[8] lengths); rows
    past the needles are padding (length 0)."""
    needles = [bytes(rng.integers(0x41, 256, size=n, dtype=np.uint8)) for n in lengths]
    return (needles, *pack_rows(needles, 8))


def scan_oracle(chunks: np.ndarray, needle: bytes) -> np.ndarray:
    """bool[G]: the needle starts at a byte < 480 of the chunk."""
    window = 480 + len(needle) - 1
    return np.array([bytes(c[:window]).find(needle) >= 0 for c in chunks])


def popcounts(packed: torch.Tensor) -> list[int]:
    shifts = torch.arange(32, device=packed.device, dtype=torch.int32)
    return ((packed.unsqueeze(-1) >> shifts) & 1).sum(dim=(1, 2)).tolist()


def scan_bound(G: int, lens, hits) -> tuple[float, str]:
    """Least time for one scan of G logical chunks: its bytes (each chunk
    read once, the needles, the packed output) over the memory rate, or its
    byte compares over the 32-bit rate, whichever is larger. A chunk without
    a hit needs at least one compare per start (480) per real needle; a chunk
    that hits needs at least the needle's length. Padding rows need none."""
    nbytes = G * 512 + len(lens) * (36 + G // 8)
    ops = sum((G - h) * 480 + h * n for n, h in zip(lens, hits) if n > 0)
    byte_s, op_s = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return max(byte_s, op_s) * 1e3, "bytes" if byte_s >= op_s else "operations"


def plain_scan(ks, rows32, needles, lens, n_real, starts=None, seg_chunks=0):
    """The plain version over a stream of any size: in PLAIN_PIECE-chunk
    pieces (it holds bool[n_real, G, 480]); segments are scanned whole."""
    if starts is not None:
        return ks.byte_scan_plain(rows32, needles, lens, n_real, starts, seg_chunks)
    return torch.cat([
        ks.byte_scan_plain(rows32[lo : lo + PLAIN_PIECE], needles, lens, n_real)
        for lo in range(0, rows32.shape[0], PLAIN_PIECE)
    ], dim=1)


def one_range_into(ks, out: torch.Tensor, rows32, needles, lens, n_real: int) -> None:
    """One segment-mode launch of one range over the whole stream into
    ``out`` (what the one-card dense plan call launched before its
    dense-mode record)."""
    ks.byte_scan_ranges_into(out, 0, [rows32], [0], [rows32.shape[0]], needles, lens,
                             n_real=n_real, count_as="stream")


def dense_into(ks, out: torch.Tensor, rows32, needles, lens, n_real: int) -> None:
    """The one-card dense plan call's launch on its own: dense mode over the
    whole stream into ``out`` (a page-locked buffer, as the plan call
    passes it, or device memory), through the single-launch entry. The plan
    call waits inside itself, so an event after it would hold the host's
    wake-up too; this runs the same kernel and output between CUDA events
    (counting nothing)."""
    needle_bytes, real_lens = ks._check(rows32, needles, lens, n_real)
    ks._launch(rows32, needle_bytes, real_lens, rows32.shape[0], (), (), out)


def scan_case(ks, rows32, needles, lens, n_real, *, starts=None, seg_chunks=0,
              label="", time_it=True, reps=25, plain_reps=3, need_chunks=None,
              plan=False) -> dict:
    """Hold one scan launch against its plain version (bit-identical) and,
    with ``time_it``, time both between CUDA events; a segment launch is
    timed after an L2 flush, as a query finds its ranges. The bound counts
    ``need_chunks`` (the chunks a query asked for) when given, else every
    chunk scanned. With ``plan`` (a dense shape of the main path) the
    one-card dense call (``sharded_scan_all_rows`` with no mesh, one
    ``bs_scan_plan`` launch into page-locked memory) must give the same
    words too, and ``ms`` is its launch's device time (``dense_into`` a
    page-locked buffer), ``device_out_ms`` dense mode's into device
    memory."""
    from bloomsearch_tpu_torch.parallel import mesh as pm

    def kernel(_i=0):
        if starts is None:
            return ks.byte_scan_stream(rows32, needles, lens, n_real=n_real)
        return ks.byte_scan_segments(rows32, starts, needles, lens, n_real=n_real,
                                     seg_chunks=seg_chunks)

    got = kernel()
    want = plain_scan(ks, rows32, needles, lens, n_real, starts, seg_chunks)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"scan {label}: kernel disagrees with plain version")
    if plan and not torch.equal(pm.sharded_scan_all_rows(None, rows32, needles, lens,
                                                         n_real=n_real), want.cpu()):
        raise AssertionError(f"scan {label}: the one-card dense plan call disagrees with the "
                             "plain version")
    G = got.shape[1] * 32
    real_lens = [int(v) for v in lens[:n_real]]
    hits = popcounts(got)
    bound_ms, bound_by = scan_bound(need_chunks or G, real_lens, hits)
    case = {"G": G, "n_real": n_real, "max_abs_err": 0, "hits": hits,
            "bound_ms": bound_ms, "bound_by": bound_by, "out": got}
    if not time_it:
        log(f"scan {label} G={G} n_real={n_real}: bit-identical"
            + (" (the plan call too)" if plan else ""))
        return case
    flush = None if starts is None else (lambda: flush_l2(rows32.device))
    case["ms"] = event_ms(kernel, reps, hide_host=True, before=flush)
    if plan:
        pinned = torch.empty((n_real, G // 32), dtype=torch.int32, pin_memory=True)
        case["device_out_ms"] = case["ms"]
        case["ms"] = event_ms(lambda i: dense_into(ks, pinned, rows32, needles, lens, n_real),
                              reps, hide_host=True)
        if not torch.equal(pinned, want.cpu()):
            raise AssertionError(f"scan {label}: the launch into a page-locked buffer disagrees "
                                 "with the plain version")
    case["plain_ms"] = event_ms(
        lambda i: plain_scan(ks, rows32, needles, lens, n_real, starts, seg_chunks),
        plain_reps, hide_host=True, before=flush)
    log(f"scan {label} G={G} n_real={n_real} lens={real_lens}: kernel_ms={case['ms']:.6f} "
        + (f"(the plan's launch into a page-locked buffer; dense mode into device memory "
           f"{case['device_out_ms']:.6f}) " if plan else "")
        + f"plain_ms={case['plain_ms']:.6f} bound_ms={bound_ms:.6f} ({bound_by}, "
        f"{need_chunks or G} chunks) hits={hits} bit-identical")
    return case


def pack_rows(needles: list[bytes], n_rows: int) -> tuple[np.ndarray, np.ndarray]:
    """Needles -> (int32[n_rows, 32] bytes, int32[n_rows] lengths); rows
    past the needles are padding (length 0)."""
    padded = np.zeros((n_rows, 32), np.int32)
    lens = np.zeros(n_rows, np.int32)
    for r, nd in enumerate(needles):
        padded[r, : len(nd)] = np.frombuffer(nd, np.uint8)
        lens[r] = len(nd)
    return padded, lens


def repeated_byte_stream(G: int) -> tuple[np.ndarray, list[bytes]]:
    """A fixed-position anchor filter's worst cases: every byte 'a',
    needles of 'a' with another last byte (lengths 32, 31, 8, 5: every
    start is a candidate for an anchor on the first 4 bytes), another
    first byte (lengths 32, 5) or another 17th byte (length 32; both: every
    start is a candidate for an anchor on the last 4 bytes). This kernel
    anchors on a window that holds the odd byte. None hits but where
    planted, at starts 0, 201 and 479 (and at 480, which must not hit).
    -> (uint8[G, 512], needles)."""
    chunks = np.full((G, 512), ord("a"), np.uint8)
    needles = ([b"a" * (n - 1) + b"b" for n in (32, 31, 8, 5)]
               + [b"b" + b"a" * (n - 1) for n in (32, 5)] + [b"a" * 16 + b"b" + b"a" * 15])
    for r, nd in enumerate(needles):
        for j, s in enumerate((0, 201, 479, 480)):
            chunks[1000 * r + 7 * j + 3, s : s + len(nd)] = np.frombuffer(nd, np.uint8)
    return chunks, needles


def json_stream(G: int, rng) -> tuple[np.ndarray, list[bytes]]:
    """Lowercased compact JSON rows cut into the stream's chunks (480
    payload bytes, the next 32 repeated), with needles whose first bytes
    are common there ('"', 'e', ',') -> (uint8[G, 512], needles)."""
    words = ["error", "warn", "info", "debug", "user", "login", "timeout", "retry",
             "disk", "cache", "payment", "order", "shipped", "failed", "ok", "eu-west"]
    lines, size = [], 0
    while size < G * 480 + 32:
        rec = {"ts": int(rng.integers(1_600_000_000, 1_700_000_000)), "level": words[int(rng.integers(0, 4))],
               "svc": words[int(rng.integers(4, 16))], "uid": f"u{int(rng.integers(0, 100_000_000)):08d}",
               "msg": " ".join(words[int(i)] for i in rng.integers(0, 16, size=8))}
        line = json.dumps(rec, separators=(",", ":")).lower().encode() + b"\n"
        lines.append(line)
        size += len(line)
    buf = np.frombuffer(b"".join(lines)[: G * 480 + 32], np.uint8)
    chunks = np.lib.stride_tricks.as_strided(buf, shape=(G, 512), strides=(480, 1)).copy()
    needles = [b'"level":"error"', b'"msg":"', b'" ', b"eu-west", b'","uid":"u0000',
               b"e", b',"svc":"payment"', b'"timeout']
    return chunks, needles


def phase_scan_kernel(dev, G: int = 4096, seg_rows: int = 81_920,
                      worst_rows: int = 65_536, json_rows: int = 32_768) -> dict:
    """K2 against its plain version: dense at n_real in {1, 2, 4, 8} over G
    random chunks with planted needles, padding rows, the 479/480 boundary
    against a bytes oracle; segments over ranges of unequal, unaligned
    lengths (1, 2 and 4 of them) with one range clamped at the stream's end
    and one ending there, and the JAX package's uniform form; the
    repeated-byte stream (a fixed anchor's worst cases, timed) and a
    lowercased-JSON stream. -> {"repeated_byte": {"last" | "first" |
    "17th": the timed case of a 32-byte needle with that byte other than
    'a'}}."""
    from bloomsearch_tpu_torch.kernels import scan as ks

    rng = np.random.default_rng(4)
    chunks = rng.integers(0, 256, size=(G, 512), dtype=np.uint8)
    short, pad_s, lens_s = scan_needles(SCAN_LENGTHS[:8], rng)
    long_, pad_l, lens_l = scan_needles(SCAN_LENGTHS[8:], rng)
    # Each needle at every start alignment mod 4, near both ends and at 479.
    for r, nd in enumerate(short + long_):
        for j, s in enumerate((0, 1, 2, 3, 101, 222, 447 if len(nd) < 32 else 448, 479)):
            chunks[16 * r + j, s : s + len(nd)] = np.frombuffer(nd, np.uint8)
    rows = torch.from_numpy(chunks.view(np.int32).copy()).to(dev)
    for n_real in (1, 2, 4, 8):
        scan_case(ks, rows, pad_s, lens_s, n_real, label=f"dense short[:{n_real}]")
    # Two real rows (31, 32 bytes) and two padding rows, which match every
    # chunk and leave the real rows alone.
    case = scan_case(ks, rows, pad_l, lens_l, 4, label="dense long + 2 padding rows",
                     time_it=False)
    if case["hits"][2:] != [G, G]:
        raise AssertionError(f"padding rows hit {case['hits'][2:]} of {G} chunks")
    for r, nd in enumerate(short + long_):
        pad, lens, row = (pad_s, lens_s, r) if r < 8 else (pad_l, lens_l, r - 8)
        got = ks.byte_scan_stream(rows, pad, lens, n_real=8 if r < 8 else 4)
        bits = np.unpackbits(got[row].cpu().numpy().view(np.uint8), bitorder="little")
        if not np.array_equal(bits.astype(bool), scan_oracle(chunks, nd)):
            raise AssertionError(f"needle of {len(nd)} bytes: kernel differs from the oracle")

    # The boundary on a zero background: a start at 479 hits, 480 must not.
    edge = np.zeros((G, 512), np.uint8)
    for r, nd in enumerate(short + long_):
        edge[2 * r, 479 : 479 + len(nd)] = np.frombuffer(nd, np.uint8)
        edge[2 * r + 1, 480 : 480 + len(nd)] = np.frombuffer(nd, np.uint8)
    edge_rows = torch.from_numpy(edge.view(np.int32).copy()).to(dev)
    for pad, lens, group, n_real in ((pad_s, lens_s, short, 8), (pad_l, lens_l, long_, 2)):
        case = scan_case(ks, edge_rows, pad, lens, n_real, label="boundary", time_it=False)
        for row, nd in enumerate(group):
            bits = np.unpackbits(case["out"][row].cpu().numpy().view(np.uint8), bitorder="little")
            want = scan_oracle(edge, nd)
            r = (short + long_).index(nd)
            if not (bits[2 * r] and not bits[2 * r + 1]) or not np.array_equal(bits.astype(bool), want):
                raise AssertionError(f"needle of {len(nd)} bytes: wrong hits at starts 479/480")
    log(f"scan boundary: starts at 479 hit and at 480 do not, lengths {SCAN_LENGTHS}")

    # Ranges over a larger stream as the engine's sparse launch passes them
    # (first row, requested chunks): one real needle, and eight.
    big = torch.randint(-(1 << 31), 1 << 31, (seg_rows, 128), device=dev, dtype=torch.int64)
    big = big.to(torch.int32)
    ranges_by_n = {
        1: [(5_000, 15_023)],
        2: [(0, 14_500), (seg_rows - 15_100, 15_100)],  # rounds to 15,104: clamps
        4: [(3 * SEG_CHUNKS, 15_234), (100, 9_001), (seg_rows - 16_384, 16_384),
            (seg_rows, 12_000)],  # a start past the end clamps
    }
    for n_segs, ranges in ranges_by_n.items():
        starts, counts = [s for s, _ in ranges], [n for _, n in ranges]
        scan_case(ks, big, pad_s[7:8], lens_s[7:8], 1, starts=starts, seg_chunks=counts,
                  need_chunks=sum(counts),
                  label=f"segments n_segs={n_segs} 1 needle", time_it=n_segs == 4)
        scan_case(ks, big, pad_s, lens_s, 8, starts=starts, seg_chunks=counts,
                  label=f"segments n_segs={n_segs} 8 needles", time_it=False)
    one, lens_one = pack_rows([short[7]], 8)
    scan_case(ks, big, one, lens_one, 8, starts=[3 * SEG_CHUNKS, 100, 0, seg_rows],
              seg_chunks=SEG_CHUNKS, label="uniform segments (the JAX form), 1 needle + 7 "
              "padding rows", time_it=False)
    del big, rows, edge_rows

    # Fixed-anchor worst cases, timed, and lowercased JSON.
    worst, near = repeated_byte_stream(worst_rows)
    worst_t = torch.from_numpy(worst.view(np.int32).copy()).to(dev)
    timed_worst = {}
    for label, nd in (("last", near[0]), ("first", near[4]), ("17th", near[6])):
        pad_w, lens_w = pack_rows([nd], 1)
        timed_worst[label] = scan_case(
            ks, worst_t, pad_w, lens_w, 1, reps=10, plain_reps=1,
            label=f"repeated-byte stream, 32-byte needle, other {label} byte")
        timed_worst[label].pop("out")
    pad_w, lens_w = pack_rows(near + [b"aaaa"], 8)
    case = scan_case(ks, worst_t, pad_w, lens_w, 8, time_it=False,
                     label="repeated-byte stream, 7 near misses + 'aaaa'")
    for row, nd in enumerate(near + [b"aaaa"]):
        bits = np.unpackbits(case["out"][row].cpu().numpy().view(np.uint8), bitorder="little")
        if not np.array_equal(bits.astype(bool), scan_oracle(worst, nd)):
            raise AssertionError(f"repeated-byte needle of {len(nd)} bytes differs from the oracle")
    jchunks, jneedles = json_stream(json_rows, rng)
    json_t = torch.from_numpy(jchunks.view(np.int32).copy()).to(dev)
    pad_j, lens_j = pack_rows(jneedles, 8)
    case = scan_case(ks, json_t, pad_j, lens_j, 8, label="lowercased JSON, 8 needles",
                     reps=10, plain_reps=1)
    for row, nd in enumerate(jneedles):
        bits = np.unpackbits(case["out"][row].cpu().numpy().view(np.uint8), bitorder="little")
        if not np.array_equal(bits.astype(bool), scan_oracle(jchunks, nd)):
            raise AssertionError(f"JSON needle {nd!r}: kernel differs from the oracle")
    del worst_t, json_t
    torch.cuda.empty_cache()
    return {"repeated_byte": timed_worst}


# -- phase 5 ------------------------------------------------------------------


def refscale_dataset(target_mb: int, seed: int) -> str:
    from bloomsearch_tpu_torch import perf

    cache = os.path.expanduser(
        f"~/.cache/bloomsearch-torch-refscale/v1-snappy-{target_mb}mb-seed{seed}"
    )
    marker = os.path.join(cache, "GENERATION_COMPLETE")
    if not os.path.exists(marker):
        shutil.rmtree(cache, ignore_errors=True)
        os.makedirs(cache)
        gen = perf.generate_fast(cache, target_mb, seed=seed, compression="snappy", log=log)
        with open(marker, "w") as fh:
            json.dump(gen, fh)
        log(f"dataset generated in {gen['seconds']} s: {gen['rows']} rows")
    else:
        log(f"dataset cached at {cache}")
    return cache


def start_refscale_dataset(target_mb: int, seed: int, blocked: bool = False) -> subprocess.Popen:
    """Generate the dataset in a child process (host work), so the kernel
    phases run on the card meanwhile; ``refscale_dataset`` then finds it
    cached. With ``blocked`` the child then builds phase 13's blocked copy
    (``blocked_dataset``). The caller waits for the child, or kills it."""
    here = os.path.dirname(os.path.abspath(__file__))
    call = "blocked_dataset" if blocked else "refscale_dataset"
    code = (f"import sys; sys.path.insert(0, {here!r}); import chip_smoke; "
            f"chip_smoke.{call}({int(target_mb)}, {int(seed)})")
    return subprocess.Popen([sys.executable, "-c", code], cwd=here)


def timed(engine, query) -> tuple[float, list]:
    t0 = time.perf_counter()
    rows = engine.query_sync(query, timeout=600)
    return (time.perf_counter() - t0) * 1e3, rows


def rowset(rows) -> list[str]:
    return sorted(json.dumps(r, sort_keys=True) for r in rows)


def device_busy_share(engine, queries) -> float | None:
    """Share of the wall time of warm queries in which the card ran a
    kernel or a copy, from a torch.profiler trace; None if the profiler
    records no device activity."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for query in queries:
            engine.query_sync(query, timeout=600)
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    log(f"warm queries: {wall_us:.0f} us wall, device busy {busy_us:.1f} us; top {top}")
    return busy_us / wall_us if busy_us > 0 else None


def engine_config(**kw):
    import bloomsearch_tpu_torch as bt

    return bt.BloomSearchEngineConfig(
        row_data_compression="snappy", max_row_group_bytes=10 * 1024 * 1024,
        max_row_group_rows=1_000_000, max_query_concurrency=100, **kw,
    )


def needle_shapes() -> dict:
    """The planted needles as token, field, field:token and an OR tree."""
    import bloomsearch_tpu_torch as bt
    from bloomsearch_tpu_torch import perf

    q = bt.new_query
    return {
        "token": q().token(perf.NEEDLE_TOKEN).build(),
        "field": q().field(perf.NEEDLE_FIELD).build(),
        "field_token": q().field_token(perf.NEEDLE_FT_FIELD, perf.NEEDLE_FT_TOKEN).build(),
        "or_tree": q().match(bt.or_(
            bt.token(perf.NEEDLE_TOKEN),
            bt.and_(bt.field(perf.NEEDLE_FIELD), bt.token("absentword0q")),
            bt.field_token(perf.NEEDLE_FT_FIELD, perf.NEEDLE_FT_TOKEN),
        )).build(),
    }


def add_common_shapes(engine, shapes: dict, uid: str = "u00000000") -> None:
    """A common word under a partition prefilter (the words of one known
    row, ``uid``'s: every row carries a unique uid token) and an 18-term
    OR."""
    import bloomsearch_tpu_torch as bt
    from bloomsearch_tpu_torch import perf

    q = bt.new_query
    _, sample = timed(engine, q().token(uid).build())
    if len(sample) != 1:
        raise AssertionError(f"uid {uid} matched {len(sample)} rows")
    word = next(
        str(v).split()[0] for k, v in sample[0].items() if k not in ("uid", "part")
    )
    shapes["partition_common"] = (
        q().match_prefilter(bt.partition(bt.partition_equals(sample[0]["part"])))
        .token(word).build()
    )
    shapes["wide_or"] = q().match(bt.or_(
        bt.token(perf.NEEDLE_TOKEN), *[bt.token(f"absentword{i}q") for i in range(17)]
    )).build()


def check_shapes(engine, host, shapes: dict, reps: int, out: dict) -> dict:
    """Each shape ``reps`` times; its rows must equal the host-probe
    engine's and each needle shape's must be the 3 planted rows. Writes
    each warm p50 into ``out``; -> {shape: host rows}."""
    results = {}
    for name, query in shapes.items():
        times = []
        for _ in range(reps):
            ms, rows = timed(engine, query)
            times.append(ms)
        # The engine's own per-query host spans (stats()["last_query_timings"]):
        # probe (file and block filters), plan (from the query's start through
        # planning), prescan (the serving scan), blocks (read, decode and
        # verify), total.
        spans = engine.stats()["last_query_timings"][-reps:]
        split = {k[:-2]: round(statistics.median(t.get(k, 0.0) for t in spans) * 1e3, 3)
                 for k in ("probe_s", "plan_s", "prescan_s", "blocks_s", "total_s")}
        out[f"spans_ms_{name}"] = split
        log(f"query {name}: median engine spans (ms) {split}")
        want = rowset(host.query_sync(query, timeout=600))
        if rowset(rows) != want:
            raise AssertionError(f"{name}: rows differ from the host-probe engine's")
        if name != "partition_common" and len(rows) != 3:
            raise AssertionError(f"{name}: {len(rows)} rows, want the 3 planted needles")
        if name == "partition_common" and not rows:
            raise AssertionError("partition_common found no rows")
        results[name] = want
        out[f"warm_p50_ms_{name}"] = statistics.median(times)
        log(f"query {name}: {len(rows)} rows = host probe; warm p50 "
            f"{statistics.median(times):.3f} ms over {reps}")
    return results


def run_concurrent(engine, shapes: dict, results: dict, out: dict) -> None:
    """16 threads x 8 mixed queries (the cross-query launch combiners),
    each result checked; p50 and qps into ``out``."""
    names = list(shapes)
    lat: list[float] = []
    errors: list[BaseException] = []
    lock = threading.Lock()

    def worker(tid: int) -> None:
        try:
            for i in range(8):
                name = names[(tid + i) % len(names)]
                ms, rows = timed(engine, shapes[name])
                if rowset(rows) != results[name]:
                    raise AssertionError(f"concurrent {name}: wrong rows")
                with lock:
                    lat.append(ms)
        except BaseException as exc:  # re-raised on the main thread
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(16)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise AssertionError("concurrent queries did not finish")
    out["concurrent16_p50_ms"] = statistics.median(lat)
    out["concurrent16_qps"] = len(lat) / wall
    log(f"16 threads: {len(lat)} queries, p50 {out['concurrent16_p50_ms']:.3f} ms, "
        f"{out['concurrent16_qps']:.1f} qps")


def phase_engine(dev, target_mb: int, seed: int, reps: int = 7) -> dict:
    import bloomsearch_tpu_torch as bt
    from bloomsearch_tpu_torch.kernels import probe as pk

    cache = refscale_dataset(target_mb, seed)
    store = bt.FileSystemDataStore(cache)
    files = store.get_maybe_files_for_query(None)
    blocks = [b for mf in files for b in mf.metadata.data_blocks]
    log(f"dataset: {sum(b.rows for b in blocks)} rows, {len(files)} files, "
        f"{len(blocks)} blocks, target {target_mb} MB")
    config = engine_config

    host = bt.BloomSearchEngine(config(probe_backend="host"), store, store)
    host.start()
    out = {}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    pk.reset_launch_counts()
    engine = bt.BloomSearchEngine(
        # One card, whatever the machine has (None would shard over all).
        config(device=str(dev), probe_backend="device", bank_cache_bytes=6 << 30,
               mesh_devices=1),
        store, store,
    )
    engine.start()
    try:
        t0 = time.perf_counter()
        engine.warmup(block=True)
        out["warmup_s"] = time.perf_counter() - t0
        backend = engine._device_backend
        groups = 0
        for mf in files:
            for gi, group in enumerate(mf.metadata.bank_groups):
                mk = (group.m_bits, group.k, group.params.layout)
                if not backend.is_resident(mk, backend.segment_key(mf.pointer, gi)):
                    raise AssertionError(f"bank group {gi} of {mf.pointer!r} not resident")
                groups += 1
        after_warmup = pk.launch_counts()
        log(f"warmup: {out['warmup_s']:.3f} s, {groups} bank groups resident, "
            f"launches {after_warmup}")

        shapes = needle_shapes()
        out["first_query_ms"], first = timed(engine, shapes["token"])
        add_common_shapes(engine, shapes)
        results = check_shapes(engine, host, shapes, reps, out)
        out["device_busy_share"] = device_busy_share(
            engine, [shapes[n] for n in ("token", "field", "field_token", "or_tree")]
        )
        log(f"warm queries: device busy share {out['device_busy_share']} (torch.profiler)")
        if rowset(first) != results["token"]:
            raise AssertionError("first query differs from the warm token query")
        warm = pk.launch_counts()
        for counter in ("reduce_and", "clauses"):
            if warm[counter] <= after_warmup[counter]:
                raise AssertionError(f"warm queries launched no {counter} kernel: {warm}")
        run_concurrent(engine, shapes, results, out)
        stats = backend.stats()
        out["superbank_bytes"] = stats["superbank_bytes"]
        out["probe_launches"] = stats["probe_launches"]
        out["probe_requests"] = stats["probe_requests"]
        if dev.type == "cuda":
            out["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
        out["launches"] = pk.launch_counts()
        out["launch_shapes"] = pk.launch_shapes()
        log(f"backend {stats['probe_launches']} launches for {stats['probe_requests']} "
            f"requests; superbank {out['superbank_bytes']} bytes, max_memory_allocated "
            f"{out.get('max_memory_allocated')}, kernel launches {out['launches']}")
    finally:
        engine.stop(timeout=600)
        host.stop(timeout=600)
    return out


# -- phase 7: the serving engine -------------------------------------------------


class ScanRecorder:
    """Wraps the one-card row cache's two scan calls (the dense scan,
    ``sharded_scan_all_rows`` with no mesh, and the sparse scan,
    ``sharded_scan_segments`` with no mesh: one plan launch each) to keep,
    for each launch shape (the key of ``kernels.scan.launch_shapes()``),
    the arguments of its first launch (the first with a real needle, when
    one comes), so the shape can be re-checked on the resident stream with
    the engine's own needles and ranges; every distinct set of real
    needles the engine scanned for (``needle_sets``); every segment
    launch's requested ranges and needle lengths (``segment_launches``);
    and every dense launch's needle lengths (``dense_launches``)."""

    def __init__(self):
        import bloomsearch_tpu_torch.rowcache as rc
        from bloomsearch_tpu_torch.kernels import scan as ks

        self.rc, self.ks = rc, ks
        self.orig = {name: getattr(rc, name) for name in ("sharded_scan_all_rows",
                                                           "sharded_scan_segments")}
        self.args: dict[tuple, dict] = {}
        self.needle_sets: dict[bytes, dict] = {}
        self.segment_launches: list[tuple] = []
        self.dense_launches: list[tuple] = []
        self.lock = threading.Lock()

    def _keep(self, key: tuple, **args) -> None:
        kept = {k: np.array(v, copy=True) if isinstance(v, np.ndarray) else v
                for k, v in args.items()}
        real = bool(np.asarray(kept["lens"])[: kept["n_real"]].any())
        with self.lock:
            old = self.args.get(key)
            if old is None or (real and not np.asarray(old["lens"]).any()):
                self.args[key] = kept
            if real:
                self.needle_sets.setdefault(np.asarray(kept["needles"]).tobytes(), kept)

    def __enter__(self):
        orig = self.orig

        def dense(mesh, rows32, needles, lens, *, n_real):
            out = orig["sharded_scan_all_rows"](mesh, rows32, needles, lens, n_real=n_real)
            if mesh is not None:
                raise AssertionError("the one-card serving engine made a sharded scan")
            self._keep(("stream", rows32.shape[0], n_real, 0, ()), needles=needles, lens=lens,
                       n_real=n_real)
            with self.lock:
                self.dense_launches.append(tuple(int(v) for v in np.asarray(lens)))
            return out

        def segments(mesh, rows32, seg_starts, needles, lens, *, n_real, seg_chunks):
            out = orig["sharded_scan_segments"](mesh, rows32, seg_starts, needles, lens,
                                                n_real=n_real, seg_chunks=seg_chunks)
            if mesh is not None:
                raise AssertionError("the one-card serving engine made a sharded scan")
            _, counts = self.ks.segment_layout(seg_starts, seg_chunks, rows32.shape[0])
            key = ("segments", sum(counts), n_real, len(counts), tuple(counts))
            starts = [int(v) for v in seg_starts]
            requested = [int(v) for v in np.broadcast_to(seg_chunks, (len(starts),))]
            self._keep(key, starts=starts, needles=needles, lens=lens, n_real=n_real,
                       seg_chunks=requested)
            with self.lock:
                self.segment_launches.append((
                    tuple(zip(starts, requested)),
                    tuple(int(v) for v in np.asarray(lens)[:n_real])))
            return out

        self.rc.sharded_scan_all_rows, self.rc.sharded_scan_segments = dense, segments
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.rc, name, fn)


def recheck_scans(ks, matrix: torch.Tensor, launched: dict, recorded: dict,
                  grown: bool = False) -> dict:
    """The scan kernel against its plain version on the resident stream at
    every shape the serving engine launched, with that shape's first
    launch's needles and starts; each mode's most launched shape is timed.
    ``grown``: the stream had no reservation and grew after some launches,
    so a dense launch over fewer rows is re-run on the stream's first rows.
    Returns {launch counter: that shape's case}."""
    top = {}
    for key, n in launched.items():
        if n > launched.get(top.get(key[0]), 0):
            top[key[0]] = key
    reported = {}
    for key in sorted(launched):
        mode, G, n_real, n_segs, counts = key
        args = recorded[key]
        rows = matrix
        if mode == "stream" and grown and counts == () and G < matrix.shape[0]:
            rows = matrix[:G]
        if mode == "stream" and (G != rows.shape[0] or counts != ()):
            raise AssertionError(f"dense launch {key}: want dense mode over the stream's "
                                 f"{rows.shape[0]} rows")
        timed_shape = key == top[mode]
        segments = mode == "segments"
        case = scan_case(
            ks, rows, args["needles"], args["lens"], n_real,
            starts=args["starts"] if segments else None,
            seg_chunks=args["seg_chunks"] if segments else 0,
            need_chunks=sum(args["seg_chunks"]) if segments else None,
            time_it=timed_shape, plan=not segments,
            reps=25 if segments else 10, plain_reps=3 if segments else 1,
            label=f"main path {key} x{launched[key]}",
        )
        case.pop("out")
        if timed_shape:
            case["key"] = key
            if segments:
                case["args"] = args
            reported[mode] = case
    return reported


def check_segment_launches(launches: list[tuple], segments: dict) -> None:
    """Every segment launch of the serving engine's queries read just
    requested ranges (pinned blocks' chunk ranges, which the wrapper rounds
    up to 32 chunks) with real needles only (no padding row)."""
    pinned = set(segments.values())
    for ranges, lens in launches:
        if not set(ranges) <= pinned:
            raise AssertionError(f"a segment launch over {ranges}: not pinned blocks' ranges")
        if not all(lens):
            raise AssertionError(f"a segment launch with padding rows: lengths {lens}")
    log(f"serving: {len(launches)} query segment launches, each over requested block "
        f"ranges only, real needles only")


def check_dense_launches(launches: list[tuple], burst: list[tuple]) -> dict:
    """Every dense launch of the serving engine's queries (each its needle
    lengths) took its real needles only: n_real equals the count of real
    needles, no padding row. -> how many of the 16-thread burst's dense
    launches had each real-needle count."""
    for lens in launches:
        if not lens or not all(lens):
            raise AssertionError(f"a dense launch with padding rows: lengths {lens}")
    counts: dict = {}
    for lens in burst:
        counts[len(lens)] = counts.get(len(lens), 0) + 1
    log(f"serving: {len(launches)} query dense launches, each n_real = its real needles; the "
        f"16-thread burst's {len(burst)} dense launches by n_real: {dict(sorted(counts.items()))}")
    return dict(sorted(counts.items()))


def segment_needle_turns(ks, matrix: torch.Tensor, args: dict, reps: int = 25) -> dict:
    """The main path's most launched segment launch (``args``: its ranges
    and n_real real needles) timed in turns after an L2 flush against the
    same ranges with its first needle alone and against the least launch
    (one tile of 32 chunks, one needle): (n, 1, tile, tile, 1, n). If the
    n-needle launch's time is its needles' issue, one needle takes a
    fraction of it; if it is the launch's fixed cost (the ring filling
    before a few tiles a block), one needle takes nearly as long and the
    one-tile launch sets the floor. Each bit-identical to the plain
    version."""
    starts, counts, n_real = args["starts"], args["seg_chunks"], args["n_real"]
    forms = {f"n_real={n_real}": (starts, counts, n_real), "n_real=1": (starts, counts, 1),
             "one tile, n_real=1": ([starts[0]], [32], 1)}
    calls, bounds = {}, {}
    for name, (st, ct, n) in forms.items():
        padded, lens = args["needles"][:n], args["lens"][:n]

        def call(i, st=st, ct=ct, n=n, padded=padded, lens=lens):
            return ks.byte_scan_segments(matrix, st, padded, lens, n_real=n, seg_chunks=ct)

        got = call(0)
        if not torch.equal(got, plain_scan(ks, matrix, padded, lens, n, st, ct)):
            raise AssertionError(f"segment turns {name}: kernel disagrees with plain version")
        calls[name] = call
        bounds[name] = scan_bound(sum(ct), [int(v) for v in lens[:n]], popcounts(got))
    order = list(forms) + list(forms)[::-1]
    ms: dict = {name: [] for name in forms}
    for name in order:
        ms[name].append(event_ms(calls[name], reps, hide_host=True,
                                 before=lambda: flush_l2(matrix.device)))
    result = {name: {"ms": ms[name], "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                     "chunks": sum(forms[name][1])} for name in forms}
    log("segment turns (ms, in turns; bound): " + "; ".join(
        f"{name} {v['ms'][0]:.6f}/{v['ms'][1]:.6f} ({v['bound_ms']:.6f}, {v['chunks']} chunks)"
        for name, v in result.items()))
    return result


def engine_needles(needle_sets: list[dict]) -> list[bytes]:
    """The distinct real needles the engine scanned for, in order (at
    least 8)."""
    real: list[bytes] = []
    for args in needle_sets:
        for row, n in enumerate(np.asarray(args["lens"])[: args["n_real"]]):
            nd = bytes(np.asarray(args["needles"])[row, :n].astype(np.uint8))
            if n and nd not in real:
                real.append(nd)
    if len(real) < 8:
        raise AssertionError(f"the engine scanned for {len(real)} distinct needles, want 8")
    return real


def dense_sweep(ks, matrix: torch.Tensor, real: list[bytes]) -> dict:
    """Dense mode on the resident stream at every n_real from 1 to 8 with
    the engine's own needles, each bit-identical to the plain version (and
    the one-card plan call) and timed."""
    sweep = {}
    for n_real in range(1, ks.MAX_SCAN_NEEDLES + 1):
        padded, lens = pack_rows(real[:n_real], n_real)
        case = scan_case(ks, matrix, padded, lens, n_real, reps=10, plain_reps=1, plan=True,
                         label=f"dense sweep {[nd.decode('latin-1') for nd in real[:n_real]]}")
        case.pop("out")
        sweep[n_real] = case
    return sweep


DENSE_FORMS = ("dense", "segment", "dense_pinned")
DENSE_ROUNDS = 5  # (forms, then back) rounds: ten turns a form


def dense_mode_turns(ks, matrix: torch.Tensor, real: list[bytes], reps: int = 10,
                     rounds: int = DENSE_ROUNDS) -> dict:
    """The kernel alone, in turns (``DENSE_FORMS`` and back, ``rounds``
    times, each turn the median of ``reps`` launches between CUDA events):
    dense mode into device memory, the one-range segment mode over the
    whole stream into device memory (``one_range_into``), and dense mode
    into a page-locked buffer (the one-card dense plan call's launch,
    ``dense_into``), at n_real = 1 and 8 of the engine's needles. Each
    form's words equal dense mode's. The verdict compares the segment mode
    with dense mode (``exp_mesh_join.spread_verdict``: "plan slower" reads
    the segment mode slower): the reason the plan's record for one range
    over a whole base is a dense-mode one."""
    from bloomsearch_tpu_torch.tools import exp_mesh_join as mj

    G = matrix.shape[0]
    result = {}
    for n_real in (1, ks.MAX_SCAN_NEEDLES):
        padded, lens = pack_rows(real[:n_real], n_real)
        device_out = torch.empty((n_real, G // 32), dtype=torch.int32, device=matrix.device)
        pinned = torch.empty((n_real, G // 32), dtype=torch.int32, pin_memory=True)
        forms = {
            "dense": lambda i: ks.byte_scan_stream(matrix, padded, lens, n_real=n_real),
            "segment": lambda i: one_range_into(ks, device_out, matrix, padded, lens, n_real),
            "dense_pinned": lambda i: dense_into(ks, pinned, matrix, padded, lens, n_real),
        }
        want = forms["dense"](0)
        forms["segment"](0)
        forms["dense_pinned"](0)
        torch.cuda.synchronize()
        if not (torch.equal(device_out, want) and torch.equal(pinned, want.cpu())):
            raise AssertionError(f"dense mode turns n_real={n_real}: the forms disagree")
        times: dict = {form: [] for form in DENSE_FORMS}
        for form in (DENSE_FORMS + DENSE_FORMS[::-1]) * rounds:
            times[form].append(event_ms(forms[form], reps, hide_host=True))
        result[n_real] = {"ms": times,
                          "median_ms": {f: statistics.median(t) for f, t in times.items()},
                          "verdict": mj.spread_verdict(times["segment"], times["dense"])}
        log(f"dense mode turns n_real={n_real} (G={G}, device ms, {reps} launches a turn): "
            + "; ".join(f"{f} " + "/".join(f"{v:.6f}" for v in t) for f, t in times.items())
            + "; medians " + ", ".join(f"{f} {v:.6f}"
                                       for f, v in result[n_real]["median_ms"].items())
            + f"; segment against dense: {result[n_real]['verdict'].replace('plan', 'segment')}")
    return result


def dense_call_turns(ks, matrix: torch.Tensor, real: list[bytes], reps: int = 20,
                     rounds: int = DENSE_ROUNDS) -> dict:
    """The one-card dense scan as a caller sees it, at every n_real from 1
    to 8 of the engine's needles, in two forms timed in turns ((plan, copy,
    copy, plan) ``rounds`` times: ten turns a form, each the host-clock
    median of ``reps`` calls, ``exp_mesh_join.call_ms``): ``plan``, the
    package's (``sharded_scan_all_rows`` with no mesh: one ``bs_scan_plan``
    launch into page-locked memory), and ``copy``, the earlier one (dense
    mode into a device tensor, then ``.cpu()``); their words equal, with
    ``exp_mesh_join.spread_verdict``'s reading."""
    from bloomsearch_tpu_torch.parallel import mesh as pm
    from bloomsearch_tpu_torch.tools import exp_mesh_join as mj

    result = {}
    for n_real in range(1, ks.MAX_SCAN_NEEDLES + 1):
        padded, lens = pack_rows(real[:n_real], n_real)
        calls = {
            "plan": lambda: pm.sharded_scan_all_rows(None, matrix, padded, lens, n_real=n_real),
            "copy": lambda: ks.byte_scan_stream(matrix, padded, lens, n_real=n_real).cpu(),
        }
        if not torch.equal(calls["plan"](), calls["copy"]()):
            raise AssertionError(f"dense call n_real={n_real}: the plan call differs from the "
                                 "launch and copy")
        times: dict = {form: [] for form in calls}
        for form in ("plan", "copy", "copy", "plan") * rounds:
            times[form].append(mj.call_ms(calls[form], [matrix.device], reps))
        result[n_real] = {"call_ms": times,
                          "median_ms": {f: statistics.median(t) for f, t in times.items()},
                          "verdict": mj.spread_verdict(times["plan"], times["copy"])}
        log(f"dense call turns n_real={n_real}: " + "; ".join(
            f"{f} " + "/".join(f"{v:.6f}" for v in t) for f, t in times.items())
            + " ms; medians " + ", ".join(f"{f} {v:.6f}"
                                          for f, v in result[n_real]["median_ms"].items())
            + f"; {result[n_real]['verdict']}")
    return result


def needle_cache_copy_us(words_of: dict, reps: int = 200) -> dict:
    """What the needle cache's own copy of a row costs (host clock, median
    of ``reps``): ``row.copy()`` of a uint32 row of each size in
    ``words_of`` (label -> words), a row of a larger page-locked output, as
    a dense call returns it."""
    result = {}
    for label, words in words_of.items():
        out = torch.empty((2, words), dtype=torch.int32, pin_memory=True).fill_(7)
        row = out.numpy().view(np.uint32)[1]
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            kept = row.copy()
            times.append((time.perf_counter() - t0) * 1e6)
        if np.shares_memory(kept, row) or not kept.flags.owndata:
            raise AssertionError("the needle cache's copy shares the launch output's memory")
        result[label] = {"words": words, "bytes": words * 4, "us": statistics.median(times)}
    log("needle cache row copy (host clock, median of "
        f"{reps}): " + ", ".join(f"{k} ({v['bytes']} bytes) {v['us']:.2f} us"
                                 for k, v in result.items()))
    return result


def old_scan_launcher(source: str):
    """An earlier scan kernel, built from ``source``: a ``csrc/scan.cu``
    whose ``bs_scan_launch`` takes ranges in its one stream (first rows and
    chunk counts) and writes a new output (the interface before the
    per-range bases). -> launch(rows32, padded, lens, n_real, starts=(),
    counts=()) on the current stream: dense without ranges."""
    import ctypes

    from bloomsearch_tpu_torch.kernels import build

    path = os.path.join(tempfile.mkdtemp(prefix="bloomsearch-old-scan-"), "libold_scan.so")
    report = build.build_library(source, path, force=True)
    log(f"old scan kernel built from {source}: "
        f"{[ln.strip() for ln in report.splitlines() if 'registers' in ln]}")
    lib = ctypes.CDLL(path)
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.bs_scan_launch.argtypes = [p, i64, i64, p, p, i32, p, p, i32, p, p]
    lib.bs_scan_launch.restype = ctypes.c_int

    def launch(rows32, padded, lens, n_real, starts=(), counts=()):
        nb = np.ascontiguousarray(padded[:n_real], dtype=np.uint8)
        ln = np.ascontiguousarray(lens[:n_real], dtype=np.int32)
        st = np.ascontiguousarray(starts, dtype=np.int64)
        ct = np.ascontiguousarray(counts, dtype=np.int64)
        chunks = int(ct.sum()) if st.size else rows32.shape[0]
        out = torch.empty((n_real, chunks // 32), dtype=torch.int32, device=rows32.device)
        err = lib.bs_scan_launch(
            rows32.data_ptr(), rows32.shape[0], chunks, nb.ctypes.data, ln.ctypes.data,
            n_real, st.ctypes.data if st.size else None, ct.ctypes.data if ct.size else None,
            st.size, out.data_ptr(), torch.cuda.current_stream(rows32.device).cuda_stream)
        if err:
            raise RuntimeError(f"old scan kernel launch failed: cudaError {err}")
        return out

    return launch


def turns_against_old_scan(ks, source: str, matrix: torch.Tensor, real: list[bytes],
                           seg_args: dict, worst_rows: int = 65_536, reps: int = 10) -> dict:
    """This scan kernel against an earlier one built from ``source``
    (``old_scan_launcher``) on the same card, timed in turns (old, new,
    new, old): dense over the resident stream with 1 and with 8 of the
    engine's needles; the main path's most launched segment launch, both
    kernels over the same ranges, after an L2 flush; and the repeated-byte
    stream with a 32-byte needle whose last, first or 17th byte is the odd
    one (a fixed anchor's worst cases). The two kernels' words must be
    equal on every case."""
    old = old_scan_launcher(source)
    rows = matrix.shape[0]
    flush = lambda: flush_l2(matrix.device)  # noqa: E731
    cases = {}
    for n_real in (1, 8):
        padded, lens = pack_rows(real[:n_real], n_real)
        cases[f"dense n_real={n_real}"] = (
            lambda i, p=padded, ln=lens, n=n_real: old(matrix, p, ln, n),
            lambda i, p=padded, ln=lens, n=n_real: ks.byte_scan_stream(matrix, p, ln, n_real=n),
            None, scan_bound(rows, [int(v) for v in lens], [0] * n_real))
    starts, counts = seg_args["starts"], seg_args["seg_chunks"]
    n_real = seg_args["n_real"]
    read, rounded = ks.segment_layout(starts, counts, rows)
    cases["main-path segments"] = (
        lambda i: old(matrix, seg_args["needles"], seg_args["lens"], n_real, read, rounded),
        lambda i: ks.byte_scan_segments(matrix, starts, seg_args["needles"], seg_args["lens"],
                                        n_real=n_real, seg_chunks=counts),
        flush, scan_bound(sum(counts), [int(v) for v in seg_args["lens"][:n_real]],
                          [0] * n_real))
    worst, near = repeated_byte_stream(worst_rows)
    worst_t = torch.from_numpy(worst.view(np.int32).copy()).to(matrix.device)
    for which, nd in (("last", near[0]), ("first", near[4]), ("17th", near[6])):
        pad_w, lens_w = pack_rows([nd], 1)
        cases[f"repeated-byte stream, 32-byte needle, other {which} byte"] = (
            lambda i, p=pad_w, ln=lens_w: old(worst_t, p, ln, 1),
            lambda i, p=pad_w, ln=lens_w: ks.byte_scan_stream(worst_t, p, ln, n_real=1),
            None, scan_bound(worst_rows, [32], [0]))
    result = {}
    for label, (old_fn, new_fn, before, (bound_ms, bound_by)) in cases.items():
        a, b = old_fn(0), new_fn(0)
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"turns {label}: the two kernels disagree")
        ms = [event_ms(fn, reps, hide_host=True, before=before)
              for fn in (old_fn, new_fn, new_fn, old_fn)]
        result[label] = {"old_ms": [ms[0], ms[3]], "new_ms": [ms[1], ms[2]],
                         "bound_ms": bound_ms, "bound_by": bound_by}
        log(f"turns {label}: old {ms[0]:.6f}, new {ms[1]:.6f}, new {ms[2]:.6f}, "
            f"old {ms[3]:.6f} ms; bound {bound_ms:.6f} ms ({bound_by}); outputs agree")
    del worst_t
    return result


def phase_serving(dev, target_mb: int, seed: int, sidecar: str, reps: int = 7,
                  old_scan: str | None = None) -> dict:
    """Serving mode on the refscale dataset with bench.py's settings: every
    block pinned in the stream on the card, the needle cache off so warm
    queries scan; then the scan re-check on the resident stream and a
    restart that warms from the sidecar in the directory ``sidecar``,
    which the caller removes (phase 8 restarts from it too)."""
    import bloomsearch_tpu_torch as bt
    from bloomsearch_tpu_torch.kernels import scan as ks

    cache = refscale_dataset(target_mb, seed)
    store = bt.FileSystemDataStore(cache)
    files = store.get_maybe_files_for_query(None)
    n_blocks = sum(len(mf.metadata.data_blocks) for mf in files)
    serving = dict(device=str(dev), probe_backend="device", bank_cache_bytes=6 << 30,
                   mesh_devices=1,
                   row_cache_bytes=10 << 30, serving_cache_dir=sidecar)
    host = bt.BloomSearchEngine(engine_config(probe_backend="host"), store, store)
    host.start()
    out: dict = {}
    engine = None
    try:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        with ScanRecorder() as recorder:
            ks.reset_launch_counts()
            engine = bt.BloomSearchEngine(engine_config(**serving), store, store)
            engine.start()
            engine._row_cache.needle_cache_enabled = False
            t0 = time.perf_counter()
            engine.warmup(block=True)
            out["warmup_s"] = time.perf_counter() - t0
            rc_stats = engine.stats()["row_cache"]
            if rc_stats["pinned_blocks"] != n_blocks:
                raise AssertionError(f"{rc_stats['pinned_blocks']} of {n_blocks} blocks pinned")
            out["stream_device_bytes"] = rc_stats["device_bytes"]
            after_warmup = ks.launch_counts()
            warmup_segments = len(recorder.segment_launches)
            warmup_dense = len(recorder.dense_launches)
            log(f"serving warmup: {out['warmup_s']:.3f} s, {n_blocks} blocks pinned, stream "
                f"{rc_stats['device_bytes']} device bytes, scan launches {after_warmup}, "
                f"timeline {engine.stats().get('warmup')}")

            shapes = needle_shapes()
            out["first_query_ms"], first = timed(engine, shapes["token"])
            add_common_shapes(engine, shapes)
            results = check_shapes(engine, host, shapes, reps, out)
            if rowset(first) != results["token"]:
                raise AssertionError("first query differs from the warm token query")
            out["device_busy_share"] = device_busy_share(
                engine, [shapes[n] for n in ("token", "field", "field_token", "or_tree")]
            )
            log(f"serving warm queries: device busy share {out['device_busy_share']}")
            # Up to here the launches per mode follow from the queries alone;
            # the 16 threads' coalescing below depends on timing.
            out["launches_sequential"] = ks.launch_counts()
            log(f"serving sequential queries: scan launches {out['launches_sequential']}")
            burst_from = len(recorder.dense_launches)
            run_concurrent(engine, shapes, results, out)
            out["launches"] = ks.launch_counts()
            launched = ks.launch_shapes()
            burst_dense = recorder.dense_launches[burst_from:]
        for counter in ("stream", "segments"):
            if out["launches"][counter] <= after_warmup[counter]:
                raise AssertionError(f"warm queries launched no {counter} scan: {out['launches']}")
        if dev.type == "cuda":
            out["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
        out["row_cache"] = engine.stats()["row_cache"]
        log(f"serving: scan launches {out['launches']}, row cache {out['row_cache']}, "
            f"max_memory_allocated {out.get('max_memory_allocated')}")
        log("serving launches per (mode, G, n_real, n_segs, range chunks): "
            + json.dumps(sorted([list(k) + [n] for k, n in launched.items()])))
        with engine._row_cache._lock:
            matrix = engine._row_cache._bucket.matrix
            segments = dict(engine._row_cache._bucket.segments)
        check_segment_launches(recorder.segment_launches[warmup_segments:], segments)
        out["burst_dense_n_real"] = check_dense_launches(
            recorder.dense_launches[warmup_dense:], burst_dense)
        out["scan_cases"] = recheck_scans(ks, matrix, launched, recorder.args)
        out["segment_needle_turns"] = segment_needle_turns(
            ks, matrix, out["scan_cases"]["segments"]["args"])
        real = engine_needles(list(recorder.needle_sets.values()))
        out["dense_sweep"] = dense_sweep(ks, matrix, real)
        out["dense_mode_turns"] = dense_mode_turns(ks, matrix, real)
        out["dense_call_turns"] = dense_call_turns(ks, matrix, real)
        out["needle_cache_copy_us"] = needle_cache_copy_us(
            {"refscale row": matrix.shape[0] // 32, "18M-bit row (xlscale)": 18_000_000 // 32})
        if old_scan is not None:
            out["old_scan_turns"] = turns_against_old_scan(
                ks, old_scan, matrix, real, out["scan_cases"]["segments"]["args"])
        with engine._device_backend._lock:
            banks = [(sb.bank2d, sb.m_bits, sb.k, sb.layout, sb.num_words)
                     for sb in engine._device_backend._superbanks.values()]
        # The resident state, the needles the queries scanned for, every
        # segment launch shape they made (real needles only), the most
        # launched one and the engine's settings, for phase 8 (with the
        # restarted engine's warm p50 and scan launches a shape, below).
        out["resident"] = {
            "banks": banks, "matrix": matrix,
            "needles": list(recorder.needle_sets.values())[:6],
            "segment_args": [args for key, args in sorted(recorder.args.items())
                             if key[0] == "segments"
                             and np.asarray(args["lens"])[: args["n_real"]].all()],
            "top_segments": out["scan_cases"]["segments"]["args"],
            "shapes": shapes, "results": results, "store": store,
            "serving": serving, "n_blocks": n_blocks,
        }
        del matrix
        engine.stop(timeout=600)
        engine = None

        # Restart on the same sidecar: every block loads packed, no decode.
        engine = bt.BloomSearchEngine(engine_config(**serving), store, store)
        engine.start()
        t0 = time.perf_counter()
        engine.warmup(block=True)
        out["restart_warmup_s"] = time.perf_counter() - t0
        hits = engine.stats()["serving_cache"]["hits"]
        if hits != n_blocks:
            raise AssertionError(f"restart: {hits} sidecar hits, want {n_blocks}")
        # Every shape timed as phase 8's mesh engine is (restarted from the
        # same sidecar, needle cache off), with the scan launches per mode.
        engine._row_cache.needle_cache_enabled = False
        restart = {}
        for name, query in shapes.items():
            times = []
            before = ks.launch_counts()
            for _ in range(reps):
                ms, rows = timed(engine, query)
                if rowset(rows) != results[name]:
                    raise AssertionError(f"restart: {name} rows differ")
                times.append(ms)
            after = ks.launch_counts()
            restart[name] = (statistics.median(times), {k: after[k] - before[k] for k in after})
            out[f"restart_warm_p50_ms_{name}"] = restart[name][0]
        out["resident"]["one_card"] = restart
        log(f"restart: warmup {out['restart_warmup_s']:.3f} s, {hits} sidecar hits, rows "
            f"equal; warm p50 and scan launches a shape {restart}")
    finally:
        if engine is not None:
            engine.stop(timeout=600)
        host.stop(timeout=600)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


# -- phase 8: the mesh (K3) -------------------------------------------------------


def probe_bound(T: int, C: int, out_rows: int) -> tuple[float, str]:
    """K1's least work (kernel_case): the T*K probed rows, the probe arrays
    and the packed output over the memory rate, or 3 operations per probed
    word over the 32-bit rate."""
    nbytes = T * K * C * 4 + T * K * 8 + out_rows * (C // 32) * 4
    ops = 3 * T * K * C
    byte_s, op_s = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return max(byte_s, op_s) * 1e3, "bytes" if byte_s >= op_s else "operations"


def needle_probes(shapes: dict, banks: list) -> list[dict]:
    """Each needle query's probe arrays per superbank, as the engine builds
    them (host arrays, the real term count), with its flat-AND bits and CNF
    clause and member bits."""
    from bloomsearch_tpu_torch.bloom.probe import compile_bloom_terms, compile_cnf_clauses

    cases = []
    for name in ("token", "field", "field_token", "or_tree"):
        bloom = shapes[name].bloom
        terms = compile_bloom_terms(bloom)
        T = len(terms)
        mask = compile_cnf_clauses(bloom.expression, terms)
        clause_bits = [int(sum(1 << t for t in range(T) if row[t])) for row in np.asarray(mask)]
        for bi, (_, m_bits, k, layout, num_words) in enumerate(banks):
            word_idx, bit_idx = terms.positions_for(m_bits, k, layout)
            rows = (terms.ks_idx[:, None].astype(np.int32) * num_words + word_idx).reshape(-1)
            cases.append({
                "query": name, "bank": bi, "T": T, "K": k,
                "rows": rows.astype(np.int32),
                "shifts": bit_idx.reshape(-1).astype(np.int32),
                "and_bits": (1 << T) - 1, "clause_bits": clause_bits,
                "member_bits": [(1 << len(clause_bits)) - 1],
            })
    return cases


def mesh_probe_calls(pm, mesh, case: dict) -> dict:
    """The three sharded probe wrappers on one case -> {name: (the sharded
    call on a tuple of shards, the kernel's call on one bank tensor, the
    plain epilogue and pack of a match matrix)}."""
    from bloomsearch_tpu_torch.kernels import probe as pk

    T, Kc, rows, shifts = case["T"], case["K"], case["rows"], case["shifts"]
    cb, mb, ab = case["clause_bits"], case["member_bits"], case["and_bits"]
    return {
        "sharded_probe_packed": (
            lambda b: pm.sharded_probe_packed(mesh, b, rows, shifts, T, Kc),
            lambda b, r, s: pk.probe_and_pack(b, r, s, T, Kc),
            lambda m: pk.pack_bitmap_plain(m)),
        "sharded_query_step": (
            lambda b: pm.sharded_query_step(mesh, b, rows, shifts, ab, T, Kc)[0][None, :],
            lambda b, r, s: pk.probe_reduce_and_pack(b, r, s, T, Kc, ab),
            lambda m: pk.pack_bitmap_plain(pk.reduce_and_plain(m, ab))),
        "sharded_probe_clauses": (
            lambda b: pm.sharded_probe_clauses(mesh, b, rows, shifts, cb, mb, T, Kc),
            lambda b, r, s: pk.probe_clauses_pack(b, r, s, T, Kc, cb, mb),
            lambda m: pk.pack_bitmap_plain(pk.clauses_plain(m, cb, mb))),
    }


def phase_mesh(dev, resident: dict, reps: int = 15) -> tuple[dict, dict]:
    """K3 at refscale widths on a 4-shard mesh (step a: every wrapper against
    the unsharded kernel and the plain version, and its times), the serving
    engine over a mesh (step b: the main path, whose queries alone give the
    K3 launch counts) and the entry step (c). Returns ({wrapper name: its
    kernels-line entry}, the mesh engine's readings)."""
    import bloomsearch_tpu_torch as bt
    from bloomsearch_tpu_torch import graft_entry
    from bloomsearch_tpu_torch.kernels import probe as pk
    from bloomsearch_tpu_torch.kernels import scan as ks
    from bloomsearch_tpu_torch.parallel import mesh as pm
    from bloomsearch_tpu_torch.tools import exp_mesh_join as mj

    n_cards = torch.cuda.device_count()
    if n_cards >= MESH_SHARDS:
        mesh = pm.Mesh(tuple(torch.device("cuda", i) for i in range(MESH_SHARDS)))
        log(f"mesh: {MESH_SHARDS} shards on {MESH_SHARDS} distinct cards")
    else:
        mesh = pm.Mesh((dev,) * MESH_SHARDS)
        log(f"mesh: {MESH_SHARDS} shards on {dev} ({n_cards} card(s) visible)")
    banks, matrix = resident["banks"], resident["matrix"]

    # a. The resident state placed on the mesh with the mesh's own helpers.
    sharded = [pm.shard_bank(mesh, bank2d) for bank2d, *_ in banks]
    G = matrix.shape[0]
    G_pad = -(-G // (512 * MESH_SHARDS)) * (512 * MESH_SHARDS)
    stream = pm.sharded_update_rows(mesh, pm.sharded_zeros_rows(mesh, G_pad, device=dev), matrix, 0)
    torch.cuda.synchronize()
    for (bank2d, *_), shards in zip(banks, sharded):
        log(f"mesh: bank {tuple(bank2d.shape)} -> {MESH_SHARDS} shards of "
            f"{tuple(shards[0].shape)}")
    log(f"mesh: stream {tuple(matrix.shape)} -> {MESH_SHARDS} shards of {tuple(stream[0].shape)}")
    cases = needle_probes(resident["shapes"], banks)
    needle_sets = resident["needles"]
    if not needle_sets:
        raise AssertionError("phase 7 recorded no needle scan to drive")

    # Every needle query's probe arrays through the three probe wrappers and
    # every recorded needle set through the scan wrapper; each result against
    # the unsharded kernel on the same logical content (the shards joined)
    # and against the plain version.
    joined = [torch.cat([sh.to(dev) for sh in shards], dim=1) for shards in sharded]
    n_probes = 0
    for case in cases:
        bank = joined[case["bank"]]
        r, s_ = case["rows"], case["shifts"]  # host arrays, as the engine passes them
        r_dev, s_dev = torch.from_numpy(r).to(dev), torch.from_numpy(s_).to(dev)
        for name, (call, unsharded, plain) in mesh_probe_calls(pm, mesh, case).items():
            got = call(sharded[case["bank"]])
            want = unsharded(bank, r, s_).cpu()
            plain_out = plain(pk.probe_plain(bank, r_dev, s_dev, case["T"], case["K"])).cpu()
            if not (torch.equal(got, want) and torch.equal(got, plain_out)):
                raise AssertionError(f"{name} {case['query']}: sharded result differs")
            # The engine's own unsharded bank (C = its capacity) is the prefix.
            own = unsharded(banks[case["bank"]][0], r, s_).cpu()
            if not torch.equal(got[:, : own.shape[1]], own):
                raise AssertionError(f"{name} {case['query']}: differs from the engine's bank")
            if name == "sharded_query_step":
                _, total = pm.sharded_query_step(mesh, sharded[case["bank"]], case["rows"],
                                                 case["shifts"], case["and_bits"], case["T"],
                                                 case["K"])
                if total != int(np.unpackbits(got.numpy().view(np.uint8)).sum()):
                    raise AssertionError("survivor total differs from the bitmap's popcount")
            n_probes += 1
    log(f"mesh: {n_probes} sharded probes bit-identical to the unsharded kernel and "
        f"the plain version; survivor totals equal the popcount")
    scans = []
    for args in needle_sets:
        got = pm.sharded_scan_all_rows(mesh, stream, args["needles"], args["lens"],
                                       n_real=args["n_real"])
        want = ks.byte_scan_stream(matrix, args["needles"], args["lens"],
                                   n_real=args["n_real"]).cpu()
        words = G // 32
        pad = got[:, words:]
        real = torch.as_tensor([int(v) > 0 for v in args["lens"][: args["n_real"]]])
        if not torch.equal(got[:, :words], want) or not torch.equal(
                pad, torch.where(real[:, None], 0, -1).to(torch.int32).expand_as(pad)):
            raise AssertionError("sharded_scan_all_rows differs from the unsharded kernel")
        scans.append(got)
    args0 = needle_sets[0]
    plain_scan_out = plain_scan(ks, matrix, args0["needles"], args0["lens"], args0["n_real"]).cpu()
    if not torch.equal(scans[0][:, : G // 32], plain_scan_out):
        raise AssertionError("sharded_scan_all_rows differs from the plain version")
    log(f"mesh: {len(scans)} sharded scans bit-identical to the unsharded kernel "
        f"(G = {G}) and to the plain version; padding chunks as expected")

    # Times, on the main-path shapes of the resident state: each wrapper in
    # the package's form (one launch a card into the page-locked joined
    # bitmap), the earlier per-shard form (a launch, a copy and a host join
    # a shard) and
    # the copy landing (a device buffer and one strided copy a launch),
    # in turns as a caller sees them, with each form's breakdown and the
    # kernel launches one sharded call makes (tools/exp_mesh_join.py);
    # beside them the single-device engine's call (the launch with the
    # host probe arrays, its copy to the host) and the device time of the
    # unsharded launch and of one launch over the first card's shards
    # (behind a spin kernel). Bounds are per card: the most any one card
    # of the mesh must read and compute.
    copy_lib = mj.build_copy_lib(tempfile.mkdtemp(prefix="bloomsearch-mesh-join-"))
    entries = {}
    rep_case = {"sharded_probe_packed": ("or_tree", "pack"),
                "sharded_query_step": ("token", "reduce_and"),
                "sharded_probe_clauses": ("or_tree", "clauses")}
    layout = pm.card_layout(sharded[0], 1, pk.MAX_SHARDS)
    for name, (query, epilogue) in rep_case.items():
        case = next(c for c in cases if c["query"] == query and c["bank"] == 0)
        _, unsharded, plain = mesh_probe_calls(pm, mesh, case)[name]
        shards, own = sharded[0], banks[0][0]
        r, s_ = case["rows"], case["shifts"]
        r_dev, s_dev = torch.from_numpy(r).to(dev), torch.from_numpy(s_).to(dev)
        form = mj.probe_case(name, mesh, shards, epilogue, r, s_, case["T"], case["K"],
                             case["clause_bits"], case["member_bits"])
        out_rows = {"pack": case["T"], "reduce_and": 1}.get(epilogue, len(case["member_bits"]))
        card_cols = max(len(c.shards) for c in layout) * shards[0].shape[1]
        entries[name] = time_mesh_case(
            f"{name} ({query}, T={case['T']}, {MESH_SHARDS} shards of {tuple(shards[0].shape)}, "
            f"unsharded {tuple(own.shape)})", form, copy_lib,
            lambda i, unsharded=unsharded, r=r, s_=s_, own=own: unsharded(own, r, s_).cpu(),
            lambda sh, unsharded=unsharded, r=r, s_=s_: unsharded(sh, r, s_), joined[0],
            lambda i, plain=plain, case=case, r=r_dev, s_=s_dev: plain(
                pk.probe_plain(joined[0], r, s_, case["T"], case["K"])),
            probe_bound(case["T"], card_cols, out_rows), reps)
    args = needle_sets[0]
    kw = dict(n_real=args["n_real"])
    real_lens = [int(v) for v in args["lens"][: args["n_real"]]]
    w = stream[0].shape[0] // 32
    scan_bounds = [
        scan_bound(len(c.shards) * stream[0].shape[0], real_lens, popcounts(torch.cat(
            [scans[0][:, i * w : (i + 1) * w] for i in c.shards], dim=1).to(dev)))
        for c in pm.card_layout(stream, 0, ks.MAX_SEGMENTS)
    ]
    entries["sharded_scan_all_rows"] = time_mesh_case(
        f"sharded_scan_all_rows (lens {real_lens}, {MESH_SHARDS} shards of "
        f"{tuple(stream[0].shape)}, unsharded {tuple(matrix.shape)})",
        mj.scan_case("sharded_scan_all_rows", mesh, stream, args["needles"], args["lens"], **kw),
        copy_lib,
        lambda i: pm.sharded_scan_all_rows(None, matrix, args["needles"], args["lens"], **kw),
        lambda sh: ks.byte_scan_stream(sh, args["needles"], args["lens"], **kw), matrix,
        lambda i: plain_scan(ks, matrix, args["needles"], args["lens"], args["n_real"]),
        max(scan_bounds), 5, plain_reps=1)
    entries["sharded_scan_segments"] = mesh_segment_scans(dev, mesh, stream, matrix, resident,
                                                          reps)
    del sharded, joined, stream
    torch.cuda.empty_cache()

    # b. The main path: the serving engine over a mesh.
    engine = engine_over_mesh(bt, pm, ks, mesh, n_cards, resident)
    if n_cards >= 2:
        graft_entry.dryrun_multichip(n_cards)
        log(f"graft_entry.dryrun_multichip({n_cards}): ok")
    else:
        log("mesh: an engine over a mesh of distinct cards and dryrun_multichip need two or "
            f"more cards; {n_cards} visible, so they were not run")

    # c. The entry step on the card against its plain version.
    fn, (bank2d, row_idx, shift) = graft_entry.entry()
    got = fn(bank2d, row_idx, shift)
    want = pk.pack_bitmap_plain(pk.probe_plain(bank2d, row_idx.to(dev), shift.to(dev), 4,
                                               row_idx.shape[0] // 4))
    torch.cuda.synchronize()
    if bank2d.device.type != "cuda" or not torch.equal(got, want):
        raise AssertionError("graft_entry.entry() differs from probe_and_pack's plain version")
    log(f"entry: probe_and_pack {tuple(got.shape)} on {bank2d.device} = plain version")

    for name, entry in entries.items():
        entry.update({"launches": engine["launches"][name], "max_abs_err": 0})
    return entries, engine


def busiest_card_bound(mesh, shard_rows: int, starts, counts, bits, real_lens) -> tuple:
    """The scan bound of the card that holds the most requested chunks:
    those chunks (each read once), the needles and their bits over the
    memory rate, or their compares over the 32-bit rate (``scan_bound``,
    the hits counted from ``bits``, each range's bool[n_real, count])."""
    per: dict = {}
    for s, n, b in zip(starts, counts, bits):
        for i, d in enumerate(mesh.devices):
            lo, hi = max(s, i * shard_rows), min(s + n, (i + 1) * shard_rows)
            if lo < hi:
                chunks, hits = per.get(d, (0, np.zeros(len(real_lens), np.int64)))
                per[d] = (chunks + hi - lo, hits + b[: len(real_lens), lo - s : hi - s].sum(axis=1))
    return max(scan_bound(c, real_lens, h.tolist()) for c, h in per.values())


def mesh_segment_scans(dev, mesh, stream: tuple, matrix: torch.Tensor, resident: dict,
                       reps: int) -> dict:
    """Step a for the sparse sharded scan (K3-e): ``sharded_scan_segments``
    at every segment launch shape phase 7 recorded and at two synthesised
    ranges of a refscale block's size, one across the first shard boundary
    and one ending at the stream's end; each answer, at every requested
    chunk, bit-identical to the unsharded segment launch and the plain
    version on the mesh's logical stream. Then phase 7's most launched
    segment shape timed in turns as a caller sees it
    (``tools/exp_mesh_join.sparse_turns``: the dense sharded call, the
    sparse call, the single-device segment call and copy), with the launches
    a call makes a card, ``host_us`` and the busiest card's bound -> its
    kernels-line entry."""
    from bloomsearch_tpu_torch.kernels import scan as ks
    from bloomsearch_tpu_torch.parallel import mesh as pm
    from bloomsearch_tpu_torch.tools import exp_mesh_join as mj

    rows = stream[0].shape[0]
    total = rows * len(stream)
    flat = torch.cat([sh.to(dev) for sh in stream])  # the logical stream on one card
    top = resident["top_segments"]
    block = SEG_CHUNKS - 1_000
    cases = [(args["starts"], args["seg_chunks"], args) for args in resident["segment_args"]]
    cases.append(([rows - block // 2 - 3, total - block], [block, block], top))
    for starts, counts, args in cases:
        kw = dict(n_real=args["n_real"])
        got, base = pm.sharded_scan_segments(mesh, stream, starts, args["needles"], args["lens"],
                                             seg_chunks=counts, **kw)
        one, one_base = pm.sharded_scan_segments(None, flat, starts, args["needles"],
                                                 args["lens"], seg_chunks=counts, **kw)
        single = ks.byte_scan_segments(flat, starts, args["needles"], args["lens"],
                                       seg_chunks=counts, **kw).cpu()
        plain = plain_scan(ks, flat, args["needles"], args["lens"], args["n_real"], starts,
                           counts).cpu()
        read, rounded = ks.segment_layout(starts, counts, total)
        single_base = [int(o) + st - r for o, st, r in zip(np.cumsum([0] + rounded[:-1]), starts,
                                                             read)]
        if one_base != single_base or not torch.equal(one, single):
            raise AssertionError(f"the single-device sparse call over "
                                 f"{list(zip(starts, counts))} differs from the segment launch")
        mine = mj.requested_bits(got, base, counts)
        for label, other in (("unsharded segment launch", single), ("plain version", plain)):
            theirs = mj.requested_bits(other, single_base, counts)
            if not all(np.array_equal(a, b) for a, b in zip(mine, theirs)):
                raise AssertionError(f"sharded_scan_segments over {list(zip(starts, counts))} "
                                     f"differs from the {label}")
        pieces, _ = pm.segment_pieces(starts, counts, rows, len(stream))
        log(f"mesh: sharded_scan_segments over {list(zip(starts, counts))} (n_real "
            f"{args['n_real']}): {len(pieces)} pieces on shards {[i for i, _, _ in pieces]}, "
            f"bit-identical to the unsharded segment launch and the plain version at every "
            f"requested chunk; the single-device sparse call equal to the segment launch")
    del flat

    starts, counts = top["starts"], top["seg_chunks"]
    case = mj.SparseCase(f"K3-e main path ({len(starts)} ranges, n_real = {top['n_real']})",
                         mesh, stream, matrix, starts, counts, top["needles"], top["lens"],
                         top["n_real"])
    turns = mj.sparse_turns(case, reps, log=log)
    real_lens = [int(v) for v in top["lens"][: top["n_real"]]]
    words, base = case.sharded()
    bound = busiest_card_bound(mesh, rows, starts, counts,
                               mj.requested_bits(words, base, counts), real_lens)
    entry = {
        "ms": statistics.mean(turns["call_ms"]["sparse"]),
        "sparse_ms": turns["call_ms"]["sparse"], "dense_call_ms": turns["call_ms"]["dense"],
        "per_launch_ms": turns["call_ms"]["per_launch"],
        "one_card_call_ms": turns["call_ms"]["one_card"],
        "single_device_call_ms": turns["call_ms"]["single"],
        "plain_ms": event_ms(lambda i: plain_scan(ks, matrix, top["needles"], top["lens"],
                                                  top["n_real"], starts, counts),
                             3, hide_host=True),
        "bound_ms": bound[0], "bound_by": bound[1],
        "cards": len(turns["launches_per_card"]),
        "kernel_launches_per_call": turns["kernel_launches_per_call"],
        "pieces": turns["pieces"], "launches_per_card": turns["launches_per_card"],
        "host_us": turns["host_us"],
    }
    log(f"mesh {case.label}: " + " ".join(
        f"{k}={v:.6f}" if isinstance(v, float) else f"{k}={v}" for k, v in entry.items()))
    return entry


def time_mesh_case(label: str, form, copy_lib, unsharded_call, kernel, full, plain, bound,
                   reps: int, plain_reps: int = 3) -> dict:
    """Times of one K3 wrapper at one shape (phase 8): the four forms in
    turns with their breakdowns (``tools/exp_mesh_join.turns``; ``ms`` is
    the package's form, the mean of its two turns), the single-device
    engine's call (``unsharded_call``, CUDA events around it), and device
    times behind a spin kernel: ``kernel`` on the unsharded tensor
    ``full``, one launch over the first card's shards (``form.into``) and
    the plain version."""
    from bloomsearch_tpu_torch.parallel import mesh as pm
    from bloomsearch_tpu_torch.tools import exp_mesh_join as mj

    turns = mj.turns(form, copy_lib, reps, log=log)
    first = pm.card_layout(form.shards, form.axis, form.capacity)[0]
    run = [form.shards[i] for i in first.launches[0]]
    words = pm.logical_size(form.shards, form.axis) // 32
    with torch.cuda.device(run[0].device):
        out = torch.empty((form.out_rows, words), dtype=torch.int32, device=run[0].device)
        card_launch_ms = event_ms(lambda i: form.into(out, 0, run), reps, hide_host=True)
    case = {
        "ms": statistics.mean(turns["call_ms"]["mapped"]),
        "old_ms": turns["call_ms"]["old"], "copy_landing_ms": turns["call_ms"]["copy"],
        "mapped_ms": turns["call_ms"]["mapped"], "per_launch_ms": turns["call_ms"]["per_launch"],
        "unsharded_call_ms": event_ms(unsharded_call, reps, hide_host=False),
        "card_launch_ms": card_launch_ms, "card_launch_shards": len(run),
        "unsharded_ms": event_ms(lambda i: kernel(full), reps, hide_host=True),
        "plain_ms": event_ms(plain, plain_reps, hide_host=True),
        "bound_ms": bound[0], "bound_by": bound[1],
        "cards": turns["cards"], "kernel_launches_per_call": turns["kernel_launches_per_call"],
        "breakdown": turns["breakdown"],
    }
    if "plan_split_us" in turns:
        case["plan_split_us"] = turns["plan_split_us"]
    log(f"mesh {label}: " + " ".join(
        f"{k}={v:.6f}" if isinstance(v, float) else f"{k}={v}" for k, v in case.items()
        if k not in ("breakdown", "plan_split_us")))
    return case


def engine_over_mesh(bt, pm, ks, mesh, n_cards: int, resident: dict, reps: int = 7) -> dict:
    """Step b, K3's main path: phase 7's serving engine restarted from its
    sidecar with its superbanks and row stream sharded, every shape ``reps``
    times and 16 threads of mixed queries, each result against the
    host-probe engine's rows. With two or more cards the engine runs with
    ``mesh_devices=None``, its default, which shards over every card. On one
    card ``mesh_devices=4`` resolves to ``mesh``, four shards on the card:
    the engine never builds a mesh with a repeated device itself, so the two
    modules that resolve ``mesh_devices`` are handed ``mesh`` while the
    engine is built. The K3 and scan counters are set to 0 just before the
    queries and read just after. Each shape must launch the scan modes
    phase 7's restarted one-card engine launched for it (sparse: the
    sharded segment scan), and its warm p50 is logged beside that
    engine's; each sparse call may launch only on the cards that hold its
    pieces, ceil(their pieces / 4) launches a card, and each dense call
    one launch a card."""
    from unittest import mock

    import bloomsearch_tpu_torch.bloom.bank as bank_mod
    import bloomsearch_tpu_torch.rowcache as rc_mod
    from bloomsearch_tpu_torch.kernels import probe as pk

    store = resident["store"]
    config = engine_config(**{**resident["serving"],
                              "mesh_devices": None if n_cards >= 2 else mesh.size})
    if n_cards >= 2:
        engine = bt.BloomSearchEngine(config, store, store)
    else:
        def resolve(mesh_devices, device):
            return mesh

        with mock.patch.object(bank_mod, "mesh_for", resolve), \
                mock.patch.object(rc_mod, "mesh_for", resolve):
            engine = bt.BloomSearchEngine(config, store, store)
    used = engine._device_backend.mesh
    out: dict = {"shards": used.size, "cards": len(used.distinct_devices()),
                 "mesh_devices": config.mesh_devices}
    engine.start()
    try:
        engine._row_cache.needle_cache_enabled = False
        t0 = time.perf_counter()
        engine.warmup(block=True)
        out["warmup_s"] = time.perf_counter() - t0
        stats = engine.stats()
        hits = stats["serving_cache"]["hits"]
        if stats["row_cache"]["pinned_blocks"] != resident["n_blocks"] or hits != resident["n_blocks"]:
            raise AssertionError(f"mesh engine: {stats['row_cache']['pinned_blocks']} blocks "
                                 f"pinned, {hits} sidecar hits, want {resident['n_blocks']}")
        for sb in engine._device_backend._superbanks.values():
            if tuple(s.device for s in sb.bank2d) != used.devices:
                raise AssertionError("a superbank is not sharded over the mesh")
        rc = engine._row_cache
        if rc.mesh != used or tuple(s.device for s in rc._bucket.matrix) != used.devices:
            raise AssertionError("the row stream is not sharded over the mesh")
        log(f"mesh engine ({used.size} shards on {out['cards']} card(s), mesh_devices="
            f"{config.mesh_devices}): warmup {out['warmup_s']:.3f} s from the sidecar "
            f"({hits} hits); superbanks and stream sharded")

        shapes, results = resident["shapes"], resident["results"]
        pm.reset_launch_counts()
        pk.reset_launch_counts()
        ks.reset_launch_counts()
        with SparseCallRecorder(pm, rc_mod) as sparse_calls:
            for name, query in shapes.items():
                times = []
                before = pm.launch_counts()
                for _ in range(reps):
                    ms, rows = timed(engine, query)
                    if rowset(rows) != results[name]:
                        raise AssertionError(f"mesh engine: {name} rows differ from the host "
                                             f"probe")
                    times.append(ms)
                after = pm.launch_counts()
                out[f"warm_p50_ms_{name}"] = statistics.median(times)
                one_ms, one_scans = resident["one_card"][name]
                modes = {"sparse": after["sharded_scan_segments"]
                         - before["sharded_scan_segments"],
                         "dense": after["sharded_scan_all_rows"] - before["sharded_scan_all_rows"]}
                out[f"scan_calls_{name}"] = modes
                out[f"one_card_warm_p50_ms_{name}"] = one_ms
                log(f"mesh engine query {name}: {len(rows)} rows = host probe; warm p50 "
                    f"{out[f'warm_p50_ms_{name}']:.3f} ms over {reps} (the one-card engine "
                    f"restarted from the same sidecar, phase 7: {one_ms:.3f} ms); scan calls "
                    f"{modes} (one card: {one_scans})")
                if (modes["sparse"] > 0, modes["dense"] > 0) != (one_scans["segments"] > 0,
                                                                  one_scans["stream"] > 0):
                    raise AssertionError(f"mesh engine: {name} scanned {modes}, the one-card "
                                         f"engine {one_scans}")
            run_concurrent(engine, shapes, results, out)
            out["launches"] = pm.launch_counts()
            probes = pk.launch_counts()
            scans = ks.launch_counts()
    finally:
        engine.stop(timeout=600)
    # A sparse call launches only on the cards that hold its pieces,
    # ceil(a card's pieces / 4) launches there.
    for starts, counts, shard_rows, launched in sparse_calls.calls:
        pieces, _ = pm.segment_pieces(starts, counts, shard_rows, used.size)
        held: dict = {}
        for i, _, _ in pieces:
            held[used.devices[i]] = held.get(used.devices[i], 0) + 1
        per_card = {d: launched.count(d) for d in set(launched)}
        want = {d: -(-n // ks.MAX_SEGMENTS) for d, n in held.items()}
        if per_card != want:
            raise AssertionError(f"a sparse call over {list(zip(starts, counts))} launched "
                                 f"{per_card}, want {want} ({len(pieces)} pieces)")
    sparse_launches = sum(len(launched) for *_, launched in sparse_calls.calls)
    if len(sparse_calls.calls) != out["launches"]["sharded_scan_segments"] \
            or scans["segments"] != sparse_launches or not sparse_launches:
        raise AssertionError(f"{len(sparse_calls.calls)} sparse calls recorded, "
                             f"{out['launches']['sharded_scan_segments']} counted; "
                             f"{sparse_launches} launches recorded, {scans['segments']} counted")
    out["sparse_launches_per_card"] = [{str(d): launched.count(d) for d in dict.fromkeys(launched)}
                                       for *_, launched in sparse_calls.calls[:8]]
    # One launch a card (per launch table) for each dense sharded call.
    calls = out["launches"]
    per_probe = sum(-(-used.devices.count(d) // pk.MAX_SHARDS) for d in used.distinct_devices())
    per_scan = sum(-(-used.devices.count(d) // ks.MAX_SEGMENTS) for d in used.distinct_devices())
    want = {"probe": per_probe * (calls["sharded_probe_packed"] + calls["sharded_query_step"]
                                  + calls["sharded_probe_clauses"]),
            "scan": per_scan * calls["sharded_scan_all_rows"]}
    got = {"probe": probes["pack"] + probes["reduce_and"] + probes["clauses"],
           "scan": scans["stream"]}
    if got != want:
        raise AssertionError(f"kernel launches {got} on the mesh, want {want} "
                             f"({per_probe} probe and {per_scan} scan launches a call)")
    out["kernel_launches"] = {"probe": probes, "scan": scans,
                              "per_sharded_call": {"probe": per_probe, "scan": per_scan}}
    log(f"mesh engine: sharded calls on the main path {calls}; kernel launches: probe "
        f"{probes}, scan {scans}: {per_probe} probe and {per_scan} dense scan launch(es) a "
        f"call over {len(used.distinct_devices())} card(s); {len(sparse_calls.calls)} sparse "
        f"calls made {sparse_launches} launches, only on cards that hold pieces "
        f"(launches a card, first calls: {out['sparse_launches_per_card']})")
    return out


class SparseCallRecorder:
    """Records each ``sharded_scan_segments`` call the row cache makes: its
    requested ranges, its stream's shard rows and the device of each
    launch its plan made (the plan calls of a thread's current call)."""

    def __init__(self, pm, rc_mod):
        self.pm, self.rc = pm, rc_mod
        self.orig_call = rc_mod.sharded_scan_segments
        self.orig_launch = pm.byte_scan_plan_into
        self.calls: list = []
        self.local = threading.local()
        self.lock = threading.Lock()

    def __enter__(self):
        def call(mesh, rows32, seg_starts, *a, seg_chunks, **kw):
            self.local.launched = []
            try:
                return self.orig_call(mesh, rows32, seg_starts, *a, seg_chunks=seg_chunks, **kw)
            finally:
                with self.lock:
                    self.calls.append((list(seg_starts), list(seg_chunks), rows32[0].shape[0],
                                       self.local.launched))
                self.local.launched = None

        def launch(out, plan, *a, **kw):
            self.orig_launch(out, plan, *a, **kw)
            if getattr(self.local, "launched", None) is not None:
                self.local.launched.extend(ranges[0][0].device for _, ranges in plan)

        self.rc.sharded_scan_segments, self.pm.byte_scan_plan_into = call, launch
        return self

    def __exit__(self, *exc):
        self.rc.sharded_scan_segments = self.orig_call
        self.pm.byte_scan_plan_into = self.orig_launch


# -- phase 9: beyond budget -------------------------------------------------------

# The budgets at refscale (240 block columns of 5,391,600 bytes, a packed
# stream of 3,598,848 chunks); other dataset sizes scale them by their own
# bytes (``beyond_budgets``). 768 MiB holds one 128-column superbank
# capacity unit (690 MB) and a group's headroom but not the next doubling
# (1.38 GB); 640 MiB is ~36% of the 1.84 GB stream, the JAX bench's
# xlscale residency.
BEYOND_BANK_BYTES = 768 << 20
BEYOND_ROW_BYTES = 640 << 20
REFSCALE_COLUMN_BYTES = 5_391_600
REFSCALE_STREAM_BYTES = 3_598_848 * 512
CHURN_LOOKUPS = 80  # the JAX bench's xlscale churn sweep
WIDE_BANK_COLS = 4_608  # 24.8 GB at refscale's rows: xxlscale's banks fully resident


class BudgetCounters:
    """What serving beyond both budgets does, counted by wrapping (the
    engine has no option for it): ``Superbank.remove`` (nothing is
    tombstoned in the phase, so every removal is an eviction: segments and
    their columns), ``Superbank.maybe_compact`` (a compaction when it
    clears the dead columns), the engine's sparse cold probes
    (``bloom.probe.probe_rows_sparse``, which it imports at call time), and
    on the engine's backend (``attach``) ``_ensure_resident`` called with a
    yield gate once ``after_warmup`` is set (a background bank warm:
    completed, and those that inserted a group) and ``probe_groups`` (a
    query that reached the device probe, or a ``BankChurnError``, which the
    engine degrades to host probing)."""

    KEYS = ("bank_segment_evictions", "bank_column_evictions", "superbank_compactions",
            "sparse_cold_probes", "bank_warms_completed", "bank_warm_inserts",
            "device_probe_calls", "bank_churn_errors")

    def __init__(self):
        from bloomsearch_tpu_torch.bloom import bank, probe

        self.bank, self.probe = bank, probe
        self.counts = dict.fromkeys(self.KEYS, 0)
        self.lock = threading.Lock()
        self.after_warmup = False

    def add(self, key: str, n: int = 1) -> None:
        with self.lock:
            self.counts[key] += n

    def snapshot(self) -> dict:
        with self.lock:
            return dict(self.counts)

    def __enter__(self):
        bank, probe = self.bank, self.probe
        self.orig = (bank.Superbank.remove, bank.Superbank.maybe_compact,
                     probe.probe_rows_sparse)
        remove, compact, sparse = self.orig
        counters = self

        def counted_remove(sb, key):
            seg = sb.segments.get(key)
            if seg is not None:
                counters.add("bank_segment_evictions")
                counters.add("bank_column_evictions", seg[1])
            return remove(sb, key)

        def counted_compact(sb, force=False):
            dead = sb.dead
            compact(sb, force)
            if dead and not sb.dead:
                counters.add("superbank_compactions")

        def counted_sparse(*args, **kwargs):
            counters.add("sparse_cold_probes")
            return sparse(*args, **kwargs)

        bank.Superbank.remove, bank.Superbank.maybe_compact = counted_remove, counted_compact
        probe.probe_rows_sparse = counted_sparse
        return self

    def __exit__(self, *exc):
        bank, probe = self.bank, self.probe
        bank.Superbank.remove, bank.Superbank.maybe_compact, probe.probe_rows_sparse = self.orig

    def attach(self, backend) -> None:
        ensure, probe_groups = backend._ensure_resident, backend.probe_groups
        counters = self

        def counted_ensure(pointer, mk, seg_key, loader, yield_to=None):
            before = backend.is_resident(mk, seg_key)
            sb = ensure(pointer, mk, seg_key, loader, yield_to=yield_to)
            if counters.after_warmup and yield_to is not None:
                counters.add("bank_warms_completed")
                if not before:
                    counters.add("bank_warm_inserts")
            return sb

        def counted_probe(*args, **kwargs):
            from bloomsearch_tpu_torch.bloom.bank import BankChurnError

            try:
                out = probe_groups(*args, **kwargs)
            except BankChurnError:
                counters.add("bank_churn_errors")
                raise
            counters.add("device_probe_calls")
            return out

        backend._ensure_resident, backend.probe_groups = counted_ensure, counted_probe


def beyond_budgets(files) -> dict:
    """The phase's budgets from the dataset's own bytes: 768 MiB and 640
    MiB at refscale, scaled by its column bytes and packed stream bytes
    otherwise; checked to be below the data and at least one capacity
    unit."""
    from bloomsearch_tpu_torch.rowcache import CHUNK_BYTES, STREAM_STRIDE

    groups = [g for mf in files for g in mf.metadata.bank_groups]
    column = 3 * ((groups[0].m_bits + 31) // 32) * 4
    columns = sum(g.num_blocks for g in groups)
    stream = sum(-(-max(b.uncompressed_size, 1) // STREAM_STRIDE)
                 for mf in files for b in mf.metadata.data_blocks) * CHUNK_BYTES
    bank = round(BEYOND_BANK_BYTES * column / REFSCALE_COLUMN_BYTES)
    row = round(BEYOND_ROW_BYTES * stream / REFSCALE_STREAM_BYTES)
    group = max(g.num_blocks for g in groups) * column
    if not 128 * column + group <= bank < min(256, columns) * column:
        raise AssertionError(f"bank budget {bank} does not hold one 128-column unit and a "
                             f"group ({128 * column} + {group}) below its doubling and the data")
    if not row < stream:
        raise AssertionError(f"row budget {row} is not below the {stream}-byte stream")
    out = {"bank_cache_bytes": bank, "row_cache_bytes": row, "column_bytes": column,
           "columns": columns, "bank_bytes": columns * column, "stream_bytes": stream,
           "group_bytes": group}
    log(f"beyond budget: bank_cache_bytes {bank} ({bank / (columns * column):.3f} of "
        f"{columns} columns x {column} bytes; a 128-column unit {128 * column}, its doubling "
        f"{256 * column}); row_cache_bytes {row} ({row / stream:.3f} of the {stream}-byte "
        f"stream)")
    return out


def memory_bound(budgets: dict, reserved_chunks: int, max_block_chunks: int,
                 baseline: int, bank_columns: int = 128 + 256 + 128) -> dict:
    """The most device memory the phase may allocate, from the code:

    - superbank (``bloom/bank.py``): the budget holds one 128-column unit,
      and an insert past it grows the bank to 256 columns (a new tensor
      beside the old, ``Superbank._grow``), evicts and compacts it back to
      128 (a new tensor beside the 256, ``maybe_compact``), all under the
      backend lock; a probe snapshot may still hold the bank from before
      the growth. So at most 128 + 256 + 128 columns at once, and one
      staged group (``Superbank.stage``, a warm at a time);
    - stream (``rowcache.py``): the reservation fixes the matrix
      (``reserve``, ``reserved_chunks``); a compaction gathers into a new
      matrix beside it with an int64 index of its chunks
      (``_maybe_compact``), and a scan snapshot may still hold the one
      before, so three matrices at once; one upload piece (a pow2 of at
      most a block's chunks, ``pin``);
    - what was allocated before the phase (``baseline``).

    ``bank_columns``: a peer's bank (phase 12) has its own growth bound."""
    from bloomsearch_tpu_torch.rowcache import CHUNK_BYTES

    column = budgets["column_bytes"]
    piece = 1 << max(max_block_chunks, 512).bit_length()
    terms = {
        "superbank": bank_columns * column,
        "staged_group": budgets["group_bytes"],
        "stream": 3 * reserved_chunks * CHUNK_BYTES,
        "compaction_index": 8 * reserved_chunks,
        "upload_piece": piece * CHUNK_BYTES,
        "baseline": baseline,
    }
    terms["bound"] = sum(terms.values())
    return terms


def churn_sweep(engine, rows_total: int) -> list[tuple]:
    """The JAX bench's churn sweep: ``CHURN_LOOKUPS`` uid point lookups
    spread across the dataset -> [(uid token, ms, rows)]."""
    import bloomsearch_tpu_torch as bt

    out = []
    n = CHURN_LOOKUPS
    for i in range(n):
        token = f"u{int((rows_total - 10) * (i / n)):08x}"
        ms, rows = timed(engine, bt.new_query().token(token).build())
        out.append((token, ms, rows))
    return out


def check_churn(host, sweep: list[tuple], label: str) -> dict:
    """Each lookup's rows against the host-probe engine's (one row each)
    -> its p50 and p95 (ms)."""
    import bloomsearch_tpu_torch as bt

    for token, _, rows in sweep:
        want = rowset(host.query_sync(bt.new_query().token(token).build(), timeout=600))
        if rowset(rows) != want or len(rows) != 1:
            raise AssertionError(f"{label} {token}: {len(rows)} rows, differ from the host "
                                 "probe's")
    walls = sorted(ms for _, ms, _ in sweep)
    return {"p50_ms": statistics.median(walls),
            "p95_ms": walls[min(len(walls) - 1, int(0.95 * len(walls)))], "n": len(walls)}


def phase_beyond_budget(dev, target_mb: int, seed: int, reps: int = 7) -> dict:
    """Serving beyond both budgets on one card: banks and row stream above
    ``bank_cache_bytes`` and ``row_cache_bytes``, so every query mixes
    device-probed resident groups with sparse cold probes, background bank
    warms evict from and compact the superbank, and background pins evict
    in place from and compact the stream. Every query's rows equal the
    host-probe engine's; the churn counters, the device launches, every
    launch shape against its plain version and the peak device memory
    against its bound are checked."""
    import bloomsearch_tpu_torch as bt
    from bloomsearch_tpu_torch.kernels import probe as pk
    from bloomsearch_tpu_torch.kernels import scan as ks

    store = bt.FileSystemDataStore(refscale_dataset(target_mb, seed))
    files = store.get_maybe_files_for_query(None)
    blocks = [b for mf in files for b in mf.metadata.data_blocks]
    rows_total = sum(b.rows for b in blocks)
    log(f"beyond budget on {card_line()}")
    budgets = beyond_budgets(files)
    serving = dict(device=str(dev), probe_backend="device", mesh_devices=1,
                   bank_cache_bytes=budgets["bank_cache_bytes"],
                   row_cache_bytes=budgets["row_cache_bytes"])
    out: dict = {"budgets": budgets}
    host = bt.BloomSearchEngine(engine_config(probe_backend="host"), store, store)
    host.start()
    engine = None
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    baseline = torch.cuda.memory_allocated(dev)
    t_phase = time.perf_counter()
    try:
        pk.reset_launch_counts()
        ks.reset_launch_counts()
        with BudgetCounters() as counters, ScanRecorder() as recorder:
            engine = bt.BloomSearchEngine(engine_config(**serving), store, store)
            engine.start()
            engine._row_cache.needle_cache_enabled = False
            counters.attach(engine._device_backend)
            t0 = time.perf_counter()
            engine.warmup(block=True)
            out["warmup_s"] = time.perf_counter() - t0
            counters.after_warmup = True
            out["after_warmup"] = {"counters": counters.snapshot(),
                                   "row_cache": engine.stats()["row_cache"],
                                   "timeline": engine.stats().get("warmup")}
            warm_segments = len(recorder.segment_launches)
            warm_dense = len(recorder.dense_launches)
            log(f"beyond budget warmup: {out['warmup_s']:.3f} s; {out['after_warmup']}")

            shapes = needle_shapes()
            add_common_shapes(engine, shapes)
            shape_out: dict = {}
            results = check_shapes(engine, host, shapes, reps, shape_out)
            out["warm_p50_ms"] = {k[len("warm_p50_ms_"):]: v for k, v in shape_out.items()
                                  if k.startswith("warm_p50_ms_")}
            out["spans_ms"] = {k[len("spans_ms_"):]: v for k, v in shape_out.items()
                               if k.startswith("spans_ms_")}
            out["churn"] = check_churn(host, churn_sweep(engine, rows_total), "churn")
            log(f"beyond budget churn sweep: {out['churn']}")
            alone: dict = {}
            run_concurrent(engine, shapes, results, alone)
            swept: list = []
            sweeper = threading.Thread(target=lambda: swept.extend(
                churn_sweep(engine, rows_total)))
            under: dict = {}
            sweeper.start()
            try:
                run_concurrent(engine, shapes, results, under)
            finally:
                sweeper.join(timeout=900)
            if sweeper.is_alive() or len(swept) != CHURN_LOOKUPS:
                raise AssertionError(f"the churn sweep beside the burst made {len(swept)} "
                                     f"of {CHURN_LOOKUPS} lookups")
            out["burst"] = {"alone": alone, "under_churn": under,
                            "churn_beside": check_churn(host, swept, "churn beside the burst")}
            log(f"beyond budget burst: {out['burst']}")
            engine.drain_background_pins(timeout=600)
            stats = engine.stats()
            backend = engine._device_backend
            with backend._lock:
                resident = sum(sb.used - sb.dead for sb in backend._superbanks.values())
            with engine._row_cache._lock:
                matrix = engine._row_cache._bucket.matrix
            out["counters"] = counters.snapshot()
            segment_launches = recorder.segment_launches[warm_segments:]
            dense_launches = recorder.dense_launches[warm_dense:]
        out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        out["seconds"] = time.perf_counter() - t_phase
        rc, warm_rc = stats["row_cache"], out["after_warmup"]["row_cache"]
        c = out["counters"]
        out["row_cache"] = rc
        out["queries_row_cache"] = {k: rc[k] - warm_rc[k] for k in
                                    ("pins", "evictions", "compactions", "scan_launches")}
        out["residency"] = {"blocks_pinned": rc["pinned_blocks"], "blocks": len(blocks),
                            "columns_resident": resident, "columns": budgets["columns"]}
        out["launches"] = {"probe": pk.launch_counts(), "scan": ks.launch_counts()}
        bound = memory_bound(budgets, engine.stats()["warmup"]["reserved_chunks"],
                             max(-(-b.uncompressed_size // 480) for b in blocks), baseline)
        out["memory_bound"] = bound
        log(f"beyond budget counters {c}; row cache {rc}; residency {out['residency']}; "
            f"launches {out['launches']}; background pin failures "
            f"{stats['background_pin_failures']}, churn skipped pins "
            f"{stats['background_pins_churn_skipped']} warms {stats['bank_warms_churn_skipped']}")
        log(f"beyond budget peak device memory {out['peak_bytes']} bytes against the bound "
            f"{bound['bound']} ({bound})")
        queries = out["queries_row_cache"]
        for name, n in (("bank column evictions", c["bank_column_evictions"]),
                        ("superbank compactions", c["superbank_compactions"]),
                        ("row-cache evictions", rc["evictions"]),
                        ("row-cache compactions", rc["compactions"]),
                        ("sparse cold probes", c["sparse_cold_probes"]),
                        ("completed background bank warms", c["bank_warms_completed"]),
                        ("completed background pins", queries["pins"])):
            if n <= 0:
                raise AssertionError(f"beyond budget: no {name}")
        degrades = c["bank_churn_errors"]
        log(f"beyond budget: {degrades} degrades to host probing (BankChurnError) against "
            f"{c['device_probe_calls']} device probe calls")
        if degrades > c["device_probe_calls"]:
            raise AssertionError("beyond budget: more degrades to host probing than device probes")
        if stats["background_pin_failures"]:
            raise AssertionError("beyond budget: a background pin failed on the device")
        for counter in ("reduce_and", "clauses"):
            if out["launches"]["probe"][counter] < 1:
                raise AssertionError(f"beyond budget: no {counter} probe launch")
        for counter in ("stream", "segments"):
            if out["launches"]["scan"][counter] < 1:
                raise AssertionError(f"beyond budget: no {counter} scan launch")
        if any(not lens or not all(lens) for lens in dense_launches) or any(
                not all(lens) for _, lens in segment_launches):
            raise AssertionError("beyond budget: a query scan launched padding needles")
        if out["peak_bytes"] > bound["bound"]:
            raise AssertionError(f"beyond budget: peak device memory {out['peak_bytes']} "
                                 f"exceeds the bound {bound['bound']}")

        # Every launch shape of the phase against its plain version.
        probe_shapes, scan_shapes = pk.launch_shapes(), ks.launch_shapes()
        out["probe_shapes"] = len(probe_shapes)
        out["scan_shapes"] = len(scan_shapes)
        out["probe_cases"] = phase_main_shapes(dev, probe_shapes, {})
        out["scan_cases"] = recheck_scans(ks, matrix, scan_shapes, recorder.args)
        del matrix
        log(f"beyond budget: {len(probe_shapes)} probe and {len(scan_shapes)} scan launch "
            "shapes re-run against their plain versions, bit-identical")
    finally:
        if engine is not None:
            engine.stop(timeout=600)
        host.stop(timeout=600)
        torch.cuda.empty_cache()
    out["wide_bank"] = wide_bank_turns(dev)
    return out


def beyond_budget_record(out: dict) -> dict:
    """The phase's numbers for the kernels line: budgets, per shape p50 and
    engine spans, churn p50/p95, burst qps alone and under churn,
    residency, counters (and warmup's share),
    launches, the peak against its bound, the re-checked shapes, the wide
    bank's turns and the card."""
    burst = out["burst"]
    return {
        "card": card_line(), "budgets": out["budgets"], "warmup_s": out["warmup_s"],
        "seconds": out["seconds"], "warm_p50_ms": out["warm_p50_ms"],
        "spans_ms": out["spans_ms"], "churn": out["churn"],
        "burst_alone": burst["alone"], "burst_under_churn": burst["under_churn"],
        "churn_beside_burst": burst["churn_beside"], "residency": out["residency"],
        "counters": out["counters"], "after_warmup": out["after_warmup"]["counters"],
        "row_cache": out["row_cache"],
        "queries_row_cache": out["queries_row_cache"], "launches": out["launches"],
        "peak_bytes": out["peak_bytes"], "memory_bound": out["memory_bound"],
        "rechecked": {"probe_shapes": out["probe_shapes"], "scan_shapes": out["scan_shapes"],
                      "probe": {c: {k: v for k, v in case.items() if k != "key"}
                                for c, case in out["probe_cases"].items()},
                      "scan": {m: {k: v for k, v in case.items() if k not in ("key", "args")}
                               for m, case in out["scan_cases"].items()}},
        "wide_bank": out["wide_bank"],
    }


def wide_bank_turns(dev, rows: int = REFSCALE_ROWS, cols: int = WIDE_BANK_COLS) -> dict:
    """The one-card combined probe at a wide bank (``cols`` columns of
    refscale's rows, random words made in pieces): reduce-AND at T = 1, and
    the widest output a launch writes (clauses at T = 16, 16 clauses and 16
    members), each as the plan call into page-locked memory against the
    launch into device memory and one ``.cpu()`` copy, ten turns a form,
    with phase 6's verdict (``exp_mesh_join.combined_turns``) -> {launch
    counter: turns}."""
    from bloomsearch_tpu_torch.tools import exp_mesh_join as mj

    gen = torch.Generator(device=dev).manual_seed(12)
    bank = torch.empty((rows, cols), dtype=torch.int32, device=dev)
    step = 65_536
    for r0 in range(0, rows, step):
        bank[r0:r0 + step] = random_bank(min(step, rows - r0), cols, gen, dev)
    clause_bits, member_bits = epilogue_args("probe_clauses_pack", 16, 16, 16)
    out = {}
    for counter, T, extra in (("reduce_and", 1, {"and_bits": 1}),
                              ("clauses", 16, {"clause_bits": clause_bits,
                                               "member_bits": member_bits})):
        r, s = (a.numpy() for a in probe_sets(gen, rows, T, 1)[0])
        turns = mj.combined_turns(bank, r, s, T, K, counter, extra, 200,
                                  f"wide bank {counter} R={rows} C={cols} "
                                  f"({bank.numel() * 4} bytes) T={T}", log)
        out[counter] = {"T": T, "median_ms": turns["median_ms"], "verdict": turns["verdict"],
                        "call_ms": turns["call_ms"]}
    del bank
    torch.cuda.empty_cache()
    return {"C": cols, "bytes": rows * cols * 4, **out}


# -- phase 10: the tools --------------------------------------------------------


def floor_case(pk, bank: torch.Tensor, gen, dev, label: str, T: int = 4,
               time_it: bool = False) -> dict:
    """K1f against its plain version on four random probe sets (rows at
    both ends of an 8-row group among them), bit-identical; with
    ``time_it`` the plain version's single-call time and the kernel's single
    launch (device time behind a spin kernel)."""
    R, C = bank.shape
    sets = probe_sets(gen, R, T, 4)
    for rows, _ in sets:
        rows[0::3] = rows[0::3] & ~7
        rows[1::3] = torch.clamp(rows[1::3] | 7, max=R - 1)
    on_card = [rows.to(dev) for rows, _ in sets]
    for (rows, shifts), rows_dev in zip(sets, on_card):
        got = pk.probe_floor(bank, rows, shifts, T, K)
        want = pk.probe_floor_plain(bank, rows_dev, T, K)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"probe_floor {label}: kernel disagrees with plain version")
    case = {"max_abs_err": 0}
    if time_it:
        case["launch_ms"] = event_ms(lambda i: pk.probe_floor(bank, *sets[i % 4], T, K), 25,
                                     hide_host=True)
        case["plain_ms"] = event_ms(lambda i: pk.probe_floor_plain(bank, on_card[i % 4], T, K),
                                    25, hide_host=True)
    log(f"probe_floor {label} R={R} C={C} T={T} K={K}: bit-identical"
        + (f"; single launch {case['launch_ms']:.6f} ms, plain {case['plain_ms']:.6f} ms "
           "(CUDA events behind a spin kernel)" if time_it else ""))
    return case


def cli_rows(cli, argv: list[str]) -> list[str]:
    """Run ``cli.main(argv)`` and return the JSON rows it printed."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return [line for line in buf.getvalue().splitlines() if line.startswith("{")]


def phase_cli(dev) -> None:
    """(d) ``cli`` load, search and merge on the card against the host
    probe, on a small JSON-lines file."""
    from bloomsearch_tpu_torch import cli

    with tempfile.TemporaryDirectory(prefix="bloomsearch-cli-") as tmp:
        src = os.path.join(tmp, "logs.jsonl")
        with open(src, "w") as fh:
            for i in range(5_000):
                fh.write(json.dumps({"n": i, "svc": ["auth", "pay", "sched"][i % 3],
                                     "msg": f"req{i} took {i % 97} ms status {i % 5}"}) + "\n")
        data = os.path.join(tmp, "data")
        where = ["--dir", data, "--device", str(dev)]
        cli_rows(cli, ["load", *where, src])
        searches = {
            "token": ["--token", "req4242"],
            "field:token + regex": ["--field-token", "svc:pay", "--regex",
                                    r"msg=took 1\d ms status 3"],
            "limit": ["--token", "status", "--limit", "7"],
        }
        for step in ("loaded", "merged"):
            for name, argv in searches.items():
                got = cli_rows(cli, ["search", *where, *argv])
                host = cli_rows(cli, ["search", *where, "--probe-backend", "host",
                                      *[a for a in argv if a not in ("--limit", "7")]])
                if name == "limit":
                    ok = len(got) == 7 and set(got) <= set(host)
                else:
                    ok = sorted(got) == sorted(host) and got
                if not ok:
                    raise AssertionError(f"cli search {name} ({step}): rows differ from the "
                                         "host probe's")
                log(f"cli search {name} ({step}) on {dev}: {len(got)} rows = host probe")
            if step == "loaded":
                cli_rows(cli, ["merge", *where])


def phase_tools(dev, target_mb: int, seed: int) -> dict:
    """Phase 10: (a) K1f against its plain version at the bench shape and at
    the refscale bank's C = 256, then the floor tool, whose chains alone
    give K1f's launch count; (b) the bench's T1 record of that reading and
    its needle timing on the refscale dataset through a probe-backend
    engine; (c) T2's warm start in a child process; (d) the CLI. -> K1f's
    kernels-line entry."""
    import bloomsearch_tpu_torch as bt
    from bloomsearch_tpu_torch import bench
    from bloomsearch_tpu_torch.kernels import probe as pk
    from bloomsearch_tpu_torch.tools import exp_compile_cache
    from bloomsearch_tpu_torch.tools import exp_kernel_floor as floor

    # a. K1f against its plain version, then the floor tool.
    gen = torch.Generator(device=dev).manual_seed(9)
    rows, _, k = floor.bench_shape()
    bank = random_bank(rows, 32_768, gen, dev)
    case = floor_case(pk, bank, gen, dev, "bench shape", time_it=True)
    del bank
    floor_case(pk, random_bank(REFSCALE_ROWS, 256, gen, dev), gen, dev, "refscale width")
    torch.cuda.empty_cache()
    pk.reset_launch_counts()
    m = floor.measure(dev, log=log)
    launches = pk.launch_counts()["floor"]
    log(f"floor tool (event slope over CUDA-graph chains of {m['floor_slope']['n_small']} and "
        f"{m['floor_slope']['n_large']} launches; stream floor from single reductions): "
        f"stream {m['stream_gbps']:.1f} GB/s, K1f {m['floor_ms']:.6f} ms/launch, K1 "
        f"{m['probe_ms']:.6f} ms/launch, K1/K1f {m['probe_over_floor']:.3f}; K1f launches "
        f"{launches}")

    # b. The bench's T1 record, from the floor tool's reading above (the
    # bench's kernel phase runs the same measure at the same shape), then
    # its needle timing at refscale.
    t1 = bench.kernel_record(m)
    log(f"bench T1 (event slope, the floor tool's chains): {json.dumps(t1)}")
    store = bt.FileSystemDataStore(refscale_dataset(target_mb, seed))
    engine = bt.BloomSearchEngine(
        engine_config(device=str(dev), probe_backend="device", bank_cache_bytes=6 << 30,
                      mesh_devices=1), store, store)
    engine.start()
    try:
        needle = bench._timed_needle_queries(engine, store)
    finally:
        engine.stop(timeout=600)
    if needle["backend"] != "device" or needle["rows"] <= 0:
        raise AssertionError(f"bench needle timing: {needle}")
    log(f"bench needle queries (host clock, probe engine on {dev}): {json.dumps(needle)}")

    # c. T2: a restart loads the built libraries and launches, no nvcc.
    warm = exp_compile_cache.warm_start(log)

    # d. The CLI on the card.
    phase_cli(dev)
    torch.cuda.empty_cache()
    return {
        "entry": {
            "name": "probe_floor", "route": "cuda", "source": PROBE_SOURCE,
            "replaces": "scripts/exp_kernel_floor.py:165", "launches": launches,
            "max_abs_err": case["max_abs_err"], "ms": m["floor_ms"],
            "plain_ms": case["plain_ms"], "bound_ms": m["floor_bound_ms"],
            "bound_by": "bytes", "library_ms": None,
        },
        "floor": {key: v for key, v in m.items() if not key.endswith("_slope")},
        "floor_launch_ms": case["launch_ms"], "t1": t1, "needle": needle, "t2_warm": warm,
    }


def probe_phases(dev, args, cases: dict, done) -> tuple[list[dict], dict]:
    """Phases 5 and 6: the probe engine and the main-path shapes -> the
    K1 epilogues' entries of the kernels line, and phase 5's readings."""
    engine = phase_engine(dev, args.target_mb, args.seed)
    done("engine")
    launched = engine.pop("launch_shapes")
    log(json.dumps({"engine": engine}))
    log("main-path launches per (epilogue, C, T, output rows, clauses): "
        + json.dumps(sorted([list(k) + [n] for k, n in launched.items()])))
    main_cases = phase_main_shapes(dev, launched, cases)
    done("main-path shapes")
    combined = combined_call_turns(dev, main_cases)
    done("combined calls")
    if args.old_probe:
        log(json.dumps({"old_probe": turns_against_old_probe(dev, args.old_probe, main_cases)}))
        done("probe turns")
    kernels = []
    for name, (counter, replaces) in EPILOGUES.items():
        if counter not in main_cases:
            raise AssertionError(f"{name} was not launched on the main path")
        case = main_cases[counter]
        log(f"{name}: main-path shape {case['key']} reported")
        turns = combined[counter]
        kernels.append({
            "name": name, "route": "cuda", "source": PROBE_SOURCE, "entry": "bs_probe_plan",
            "replaces": replaces,
            "launches": engine["launches"][counter], "max_abs_err": case["max_abs_err"],
            "ms": case["pinned_ms"], "device_out_ms": case["ms"],
            "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"], "library_ms": None,
            "combined_call_ms": turns["call_ms"]["plan"],
            "combined_copy_ms": turns["call_ms"]["copy"],
            "combined_verdict": turns["verdict"],
            "combined_plan_split_us": turns["plan_split_us"],
        })
    return kernels, engine


def combined_call_turns(dev, main_cases: dict, refscale_rows: int = REFSCALE_ROWS,
                        reps: int = 200) -> dict:
    """The single-device engine's combined probe call as a caller sees it,
    at each epilogue's most launched main-path shape (``main_cases``) on a
    random refscale bank: the package's plan call into a page-locked
    buffer against the earlier launch into a device tensor and its copy,
    bit-identical, in turns with the plan call's host split
    (``tools/exp_mesh_join.combined_turns``) -> {launch counter: turns}."""
    from bloomsearch_tpu_torch.tools import exp_mesh_join as mj

    name_of = {counter: name for name, (counter, _) in EPILOGUES.items()}
    gen = torch.Generator(device=dev).manual_seed(2)
    banks: dict = {}
    result = {}
    for counter, case in sorted(main_cases.items()):
        _, C, T, rows, clauses = case["key"]
        if C not in banks:
            banks[C] = random_bank(refscale_rows, C, gen, dev)
        name = name_of[counter]
        extra = epilogue_args(name, T, max(clauses, 1), rows)
        kw = {"probe_reduce_and_pack": lambda: {"and_bits": extra[0]},
              "probe_clauses_pack": lambda: {"clause_bits": extra[0], "member_bits": extra[1]},
              }.get(name, dict)()
        r, s = (a.numpy() for a in probe_sets(gen, refscale_rows, T, 1)[0])
        result[counter] = mj.combined_turns(
            banks[C], r, s, T, K, counter, kw, reps,
            f"combined {name} C={C} T={T}" + (f" clauses={clauses} members={rows}"
                                              if counter == "clauses" else ""), log)
    banks.clear()
    torch.cuda.empty_cache()
    return result


# -- phase 11: writes under serving ------------------------------------------------

WRITE_FILES = 4  # of refscale's 24: every sixth, counted back from the newest
WRITE_ROWS = 1_000_000
WRITE_BATCH = 10_000  # rows an ingest_serialized call (one partition)
WRITE_FLUSH_ROWS = 100_000  # max_buffered_rows: a flush every 10 batches
WRITE_THREADS = 8
WRITE_NEEDLE = "writeneedle7k2q"
WRITE_NEEDLE_EVERY = 2_000  # live rows that carry the phase's needle
WRITE_SAMPLED_UIDS = 200
WRITE_MESH_FILES = 2
REFSCALE_UIDS = 12_220_000  # refscale's uids run 0 .. 12,219,999 (the needles have none)
EXPIRED_PART = "00"


class CountingNeedleCache(dict):
    """The row cache's needle cache as a dict that records, on the thread
    that looks entries up, each lookup (``pop(needle, None)``,
    ``rowcache.py``'s lookup; an eviction pops without a default) with the
    stream version its needle was last cached at, if it was: a stream
    mutation bumps the version and clears the cache, so a needle cached
    before it misses."""

    def __init__(self, entries, local):
        super().__init__(entries)
        self.local = local
        self.cached_at: dict[bytes, int] = {key: ent[0] for key, ent in entries.items()}

    def __setitem__(self, key, ent):
        self.cached_at[key] = ent[0]
        dict.__setitem__(self, key, ent)

    def pop(self, key, *default):
        ent = dict.pop(self, key, *default)
        looked = getattr(self.local, "looked", None)
        if not default:
            self.cached_at.pop(key, None)  # evicted for room, not by a version
        elif looked is not None:
            looked.append((ent, self.cached_at.get(key)))
        return ent


class WriteCounters:
    """What the write path does on the device, counted by wrapping (the
    engine has no option for it): superbank growths (``Superbank._grow`` of
    a bank that held columns) and the largest capacity, segment removals
    (``Superbank.remove``) and those a tombstone made
    (``DeviceProbeBackend.invalidate(..., tombstoned=True)``), superbank
    compactions, stream blocks a tombstone removed
    (``DeviceRowCache.invalidate_file``), needle-cache lookups by outcome
    (``_launch_bucket_scan`` over a ``CountingNeedleCache``: a hit, a miss
    of a needle cached at an older stream version, or a cold miss), and on
    one engine
    (``attach``) warm-on-flush files and the groups they inserted
    (``_on_file_written``), tombstones deferred behind a query in flight
    (``_tombstone_or_defer``, with the largest ``stats()["deferred_tombstones"]``
    seen) and those a draining query applied (``_tombstone_everywhere`` on
    a query thread), device probe calls and ``BankChurnError``s
    (``probe_groups``); ERROR records of the package's loggers (the
    warm-on-flush failure among them) and exceptions any thread left
    uncaught."""

    KEYS = ("warm_on_flush_files", "warm_on_flush_inserts", "superbank_growths",
            "max_capacity", "bank_segment_removals", "bank_tombstone_segments",
            "superbank_compactions", "stream_tombstone_blocks", "needle_cache_hits",
            "needle_cache_version_misses", "needle_cache_misses", "tombstones_deferred",
            "max_deferred_tombstones", "tombstones_applied", "tombstones_applied_by_queries",
            "device_probe_calls", "bank_churn_errors", "warm_on_flush_failures",
            "error_logs", "thread_exceptions")

    def __init__(self):
        import logging

        from bloomsearch_tpu_torch import rowcache
        from bloomsearch_tpu_torch.bloom import bank

        self.bank, self.rowcache = bank, rowcache
        self.counts = dict.fromkeys(self.KEYS, 0)
        self.lock = threading.Lock()
        self.local = threading.local()
        self.errors: list[str] = []
        counters = self

        class Handler(logging.Handler):
            def emit(self, record):
                msg = record.getMessage()
                counters.add("error_logs")
                if msg.startswith("bank warm-on-flush failed"):
                    counters.add("warm_on_flush_failures")
                with counters.lock:
                    counters.errors.append(f"{record.name}: {msg}")

        self.handler = Handler(level=logging.ERROR)

    def add(self, key: str, n: int = 1) -> None:
        with self.lock:
            self.counts[key] += n

    def peak(self, key: str, n: int) -> None:
        with self.lock:
            self.counts[key] = max(self.counts[key], n)

    def snapshot(self) -> dict:
        with self.lock:
            return dict(self.counts)

    def __enter__(self):
        import logging

        bank, rc = self.bank, self.rowcache
        sb, backend, cache = bank.Superbank, bank.DeviceProbeBackend, rc.DeviceRowCache
        self.orig = [(sb, "_grow", sb._grow), (sb, "remove", sb.remove),
                     (sb, "maybe_compact", sb.maybe_compact),
                     (backend, "invalidate", backend.invalidate),
                     (cache, "invalidate_file", cache.invalidate_file),
                     (cache, "_launch_bucket_scan", cache._launch_bucket_scan)]
        grow, remove, compact, invalidate, invalidate_file, launch = (o for *_, o in self.orig)
        counters = self

        def counted_grow(bank_, min_capacity):
            grew = bank_.capacity > 0
            grow(bank_, min_capacity)
            counters.peak("max_capacity", bank_.capacity)
            if grew:
                counters.add("superbank_growths")

        def counted_remove(bank_, key):
            if key in bank_.segments:
                counters.add("bank_segment_removals")
            return remove(bank_, key)

        def counted_compact(bank_, force=False):
            dead = bank_.dead
            compact(bank_, force)
            if dead and not bank_.dead:
                counters.add("superbank_compactions")

        def counted_invalidate(backend_, pointer, tombstoned=False):
            with backend_._lock:
                segments = len(backend_._by_file.get(pointer, ()))
                invalidate(backend_, pointer, tombstoned)
            if tombstoned:
                counters.add("bank_tombstone_segments", segments)

        def counted_invalidate_file(cache_, pointer):
            with cache_._lock:
                blocks = sum(1 for key in cache_._blocks if key[0] == pointer)
            invalidate_file(cache_, pointer)
            counters.add("stream_tombstone_blocks", blocks)

        def counted_launch(cache_, bucket, matrix, version, batch):
            counters.local.looked = []
            try:
                return launch(cache_, bucket, matrix, version, batch)
            finally:
                looked, counters.local.looked = counters.local.looked, None
                for ent, cached_at in looked:
                    if ent is not None and ent[0] == version:
                        counters.add("needle_cache_hits")
                    elif cached_at is not None and cached_at != version:
                        counters.add("needle_cache_version_misses")
                    else:
                        counters.add("needle_cache_misses")

        sb._grow, sb.remove, sb.maybe_compact = counted_grow, counted_remove, counted_compact
        backend.invalidate = counted_invalidate
        cache.invalidate_file, cache._launch_bucket_scan = counted_invalidate_file, counted_launch
        logging.getLogger("bloomsearch_tpu_torch").addHandler(self.handler)
        self.excepthook = threading.excepthook

        def hook(args):
            counters.add("thread_exceptions")
            with counters.lock:
                counters.errors.append(f"thread {args.thread.name}: {args.exc_value!r}")
            self.excepthook(args)

        threading.excepthook = hook
        return self

    def __exit__(self, *exc):
        import logging

        for owner, name, fn in self.orig:
            setattr(owner, name, fn)
        logging.getLogger("bloomsearch_tpu_torch").removeHandler(self.handler)
        threading.excepthook = self.excepthook

    def attach(self, engine) -> None:
        """Wrap one engine's write-path methods and its backend's probe
        entry, and give its row cache a counting needle cache."""
        from bloomsearch_tpu_torch.bloom.bank import BankChurnError

        counters = self
        written, defer = engine._on_file_written, engine._tombstone_or_defer
        everywhere = engine._tombstone_everywhere
        backend = engine._device_backend
        probe_groups = backend.probe_groups

        def counted_written(pointer, metadata, bank_arrays=None):
            written(pointer, metadata, bank_arrays)
            with backend._lock:
                inserted = len(backend._by_file.get(pointer, ()))
            counters.add("warm_on_flush_files")
            counters.add("warm_on_flush_inserts", inserted)

        def counted_defer(pointer):
            with engine._query_track_lock:
                before = len(engine._deferred_tombstones)
            defer(pointer)
            with engine._query_track_lock:
                deferred = len(engine._deferred_tombstones) > before
            if deferred:
                counters.add("tombstones_deferred")
                counters.peak("max_deferred_tombstones", engine.stats()["deferred_tombstones"])

        def counted_everywhere(pointer):
            everywhere(pointer)
            counters.add("tombstones_applied")
            if threading.current_thread().name == "bloomsearch-query":
                counters.add("tombstones_applied_by_queries")

        def counted_probe(*args, **kwargs):
            try:
                out = probe_groups(*args, **kwargs)
            except BankChurnError:
                counters.add("bank_churn_errors")
                raise
            counters.add("device_probe_calls")
            return out

        engine._on_file_written, engine._tombstone_or_defer = counted_written, counted_defer
        engine._tombstone_everywhere, backend.probe_groups = counted_everywhere, counted_probe
        bucket = engine._row_cache._bucket
        with engine._row_cache._lock:
            bucket.needle_cache = CountingNeedleCache(bucket.needle_cache, self.local)


def newest_spread(files: list, n: int) -> list:
    """``n`` files spread evenly over the dataset's, counted back from the
    newest (the generator plants its needle rows in its last flush)."""
    by_age = sorted(files, key=lambda mf: os.stat(mf.pointer.decode()).st_mtime_ns, reverse=True)
    return by_age[::len(by_age) // n][:n]


def writes_store(src: str, n_files: int, directory: str):
    """Hardlinks of ``n_files`` of the dataset's files in ``directory`` (the
    files are immutable and a merge only unlinks its links), and a
    ``MemoryMetaStore`` that lists them: a merge then publishes its output
    and drops its inputs in one step, which a ``FileSystemDataStore``
    serving as its own MetaStore does not (its docstring: a query may then
    plan both, or neither) -> (data store, meta store, the files)."""
    import bloomsearch_tpu_torch as bt

    picked = newest_spread(bt.FileSystemDataStore(src).get_maybe_files_for_query(None),
                                n_files)
    for mf in picked:
        name = os.path.basename(mf.pointer.decode())
        os.link(mf.pointer.decode(), os.path.join(directory, name))
    store = bt.FileSystemDataStore(directory)
    meta = bt.MemoryMetaStore()
    files = store.get_maybe_files_for_query(None)
    meta.update([bt.WriteOperation(mf.metadata, mf.pointer, file_size=mf.size) for mf in files],
                [])
    return store, meta, files


def block_rows(store, mf, blk) -> list[bytes]:
    from bloomsearch_tpu_torch.compression import decompress_block
    from bloomsearch_tpu_torch.file_format import read_block_rows_compressed
    from bloomsearch_tpu_torch.scan import split_rows_arrays

    with store.open_file(mf.pointer) as fh:
        data = decompress_block(read_block_rows_compressed(fh, blk), blk.compression,
                                blk.uncompressed_size)
    _, offsets, lengths = split_rows_arrays(data)
    return [data[o:o + n] for o, n in zip(offsets.tolist(), lengths.tolist())]


def base_uids(store, files, per_block: int = 10) -> list[str]:
    """Uids of the first rows of every base block."""
    out = []
    for mf in files:
        for blk in mf.metadata.data_blocks:
            for row in block_rows(store, mf, blk)[:per_block]:
                uid = json.loads(row).get("uid")
                if uid:
                    out.append(uid)
    return out


def write_rows(n: int, uid0: int, seed: int = 2) -> tuple[list[bytes], list[str]]:
    """``n`` rows in the refscale generator's shape (``perf.generate_fast``:
    1-5 random keys with 1-5-word values from its key and word pools, a
    unique ``u%08x`` uid and the partition), uids from ``uid0``; each
    ``WRITE_NEEDLE_EVERY``-th row carries ``WRITE_NEEDLE``. Batch b of
    ``WRITE_BATCH`` rows goes to partition b mod 10 -> (rows, each batch's
    partition)."""
    import random
    import string

    rng = random.Random(seed)
    np_rng = np.random.default_rng(seed)
    keys = ["".join(rng.choices(string.ascii_lowercase, k=rng.randrange(4, 10)))
            for _ in range(1 << 14)]
    words = ["".join(rng.choices(string.ascii_lowercase + string.digits, k=rng.randrange(3, 12)))
             for _ in range(1 << 15)]
    pool = []
    for _ in range(1 << 16):
        pool.append("".join(
            f'"{keys[rng.randrange(len(keys))]}":"'
            + " ".join(words[rng.randrange(len(words))] for _ in range(rng.randrange(1, 6)))
            + '",' for _ in range(rng.randrange(1, 6))))
    parts = [f"{b % 10:02d}" for b in range(-(-n // WRITE_BATCH))]
    draws = np_rng.integers(0, len(pool), size=n).tolist()
    rows = []
    for i, t in enumerate(draws):
        needle = f'"wnote":"alpha {WRITE_NEEDLE} omega",' if i % WRITE_NEEDLE_EVERY == 0 else ""
        rows.append(("{" + pool[t] + needle
                     + f'"uid":"u{uid0 + i:08x}","part":"{parts[i // WRITE_BATCH]}"}}').encode())
    return rows, parts


def row_ident(row: dict) -> str:
    return row.get("uid") or json.dumps(row, sort_keys=True)


class WriteRun:
    """One run of the write path (steps 2-5): a writer thread ingests
    ``rows`` through ``ingest_serialized`` a batch at a time, each with a
    ``done`` future whose resolution time is kept; ``WRITE_THREADS`` query
    threads run the shapes, the needle of the live rows and read-your-writes
    lookups of uids whose batch was durable when issued; a merge starts
    once half the rows are durable and another after ingest ends; every
    query's rows and start time are kept for ``check``."""

    def __init__(self, engine, shapes: dict, rows: list[bytes], parts: list[str], uid0: int):
        import bloomsearch_tpu_torch as bt

        self.engine, self.rows, self.parts, self.uid0 = engine, rows, parts, uid0
        self.shapes = dict(shapes)
        self.shapes["write_needle"] = bt.new_query().token(WRITE_NEEDLE).build()
        self.durable_at: dict[int, float] = {}  # batch -> when its done resolved
        self.queries: list[tuple] = []  # (shape, start, end, idents)
        self.lookups: list[tuple] = []  # (uid index, start, end, idents)
        self.errors: list[BaseException] = []
        self.lock = threading.Lock()
        self.stop = threading.Event()
        self.merges: list[dict] = []

    def writer(self) -> None:
        from concurrent.futures import Future

        try:
            self.t_ingest0 = time.perf_counter()
            for b, start in enumerate(range(0, len(self.rows), WRITE_BATCH)):
                done = Future()
                done.add_done_callback(lambda f, b=b: self._durable(b, f))
                self.engine.ingest_serialized(self.rows[start:start + WRITE_BATCH], done=done,
                                              timeout=600, partition_id=self.parts[b])
            self.engine.flush(timeout=600)
            self.t_ingest1 = time.perf_counter()
        except BaseException as exc:
            self.errors.append(exc)

    def _durable(self, b: int, fut) -> None:
        if fut.exception() is not None:
            self.errors.append(fut.exception())
            return
        with self.lock:
            self.durable_at[b] = time.perf_counter()

    def merge(self, label: str) -> None:
        try:
            t0 = time.perf_counter()
            stats = self.engine.merge()
            self.merges.append({"label": label, "start": t0, "end": time.perf_counter(),
                                "files": stats.files_processed, "rows": stats.rows_processed,
                                "rows_per_s": stats.rows_per_second,
                                "seconds": stats.duration})
        except BaseException as exc:
            self.errors.append(exc)

    def querier(self, tid: int) -> None:
        import random

        import bloomsearch_tpu_torch as bt

        rng = random.Random(tid)
        names = list(self.shapes)
        try:
            i = tid
            while not self.stop.is_set():
                name = names[i % len(names)]
                i += 1
                t0 = time.perf_counter()
                got = self.engine.query_sync(self.shapes[name], timeout=600)
                with self.lock:
                    self.queries.append((name, t0, time.perf_counter(),
                                         [row_ident(r) for r in got]))
                with self.lock:
                    durable = list(self.durable_at)
                if durable:
                    b = durable[rng.randrange(len(durable))]
                    k = b * WRITE_BATCH + rng.randrange(min(WRITE_BATCH, len(self.rows)
                                                            - b * WRITE_BATCH))
                    t0 = time.perf_counter()
                    got = self.engine.query_sync(
                        bt.new_query().token(f"u{self.uid0 + k:08x}").build(), timeout=600)
                    with self.lock:
                        self.lookups.append((k, t0, time.perf_counter(),
                                             [row_ident(r) for r in got]))
        except BaseException as exc:
            self.errors.append(exc)

    def run(self) -> None:
        writer = threading.Thread(target=self.writer, name="phase11-writer")
        queriers = [threading.Thread(target=self.querier, args=(t,), name=f"phase11-q{t}")
                    for t in range(WRITE_THREADS)]
        self.t0 = time.perf_counter()
        writer.start()
        for t in queriers:
            t.start()
        try:
            half = len(self.parts) // 2
            while writer.is_alive() and len(self.durable_at) < half and not self.errors:
                time.sleep(0.02)
            merger = threading.Thread(target=self.merge, args=("during ingest",),
                                      name="phase11-merge")
            merger.start()
            writer.join(timeout=900)
            merger.join(timeout=900)
            self.merge("after ingest")
        finally:
            self.stop.set()
            writer.join(timeout=900)
            for t in queriers:
                t.join(timeout=900)
        if writer.is_alive() or any(t.is_alive() for t in queriers):
            raise AssertionError("phase 11 threads did not finish")
        if self.errors:
            raise self.errors[0]
        if len(self.durable_at) != len(self.parts):
            raise AssertionError(f"{len(self.durable_at)} of {len(self.parts)} batches durable")
        self.t1 = time.perf_counter()

    def live_part(self, k: int) -> str:
        return self.parts[k // WRITE_BATCH]

    def check(self, base: dict, final: dict) -> dict:
        """Every query of the run against the invariants: no row twice;
        every base row it should match (``base``: shape -> {ident: part})
        outside partition 00 exactly once and one of 00 at most once; no
        base row it should not match; every live row a member of the
        shape's final rows (``final``: shape -> set of idents, after both
        merges: no partition-00 row is left) or a partition-00 row the
        writer wrote; every live row outside 00 whose batch was durable
        before the query started there. A lookup finds its uid's one row
        (at most that row in 00). -> counts."""
        uid_of = {f"u{self.uid0 + k:08x}": k for k in range(len(self.rows))}
        checked = {"queries": 0, "lookups": 0, "rows": 0}
        live_final = {name: {uid_of[i] for i in idents if i in uid_of}
                      for name, idents in final.items()}
        for name, t0, _, idents in self.queries:
            got = set(idents)
            if len(got) != len(idents):
                raise AssertionError(f"{name}: a row twice")
            want = base.get(name, {})
            for ident in got:
                k = uid_of.get(ident)
                if k is None:
                    if ident not in want:
                        raise AssertionError(f"{name}: a base row it does not match ({ident})")
                elif k not in live_final[name] and self.live_part(k) != EXPIRED_PART:
                    raise AssertionError(f"{name}: live row {ident} is not one of its rows")
            missing = [i for i, part in want.items() if part != EXPIRED_PART and i not in got]
            durable = {b for b, t in self.durable_at.items() if t < t0}
            missing += [k for k in live_final[name] if k // WRITE_BATCH in durable
                        and f"u{self.uid0 + k:08x}" not in got]
            if missing:
                raise AssertionError(f"{name}: {len(missing)} rows missing, e.g. {missing[:3]}")
            checked["queries"] += 1
            checked["rows"] += len(idents)
        for k, t0, _, idents in self.lookups:
            uid = f"u{self.uid0 + k:08x}"
            if idents != [uid] and not (self.live_part(k) == EXPIRED_PART and not idents):
                raise AssertionError(f"lookup {uid} (partition {self.live_part(k)}, durable "
                                     f"before it): rows {idents}")
            checked["lookups"] += 1
        return checked

    def timings(self) -> dict:
        """p50/p95 (ms) a shape before, during and after the merge that ran
        under ingest; queries a second while the writer ran; ingest rows a
        second (first ingest call to the last batch durable)."""
        m = self.merges[0]
        out: dict = {}
        for name in list(self.shapes) + ["lookup"]:
            spans = ([(t0, t1) for n, t0, t1, _ in self.queries if n == name] if name != "lookup"
                     else [(t0, t1) for _, t0, t1, _ in self.lookups])
            for when, keep in (("before", lambda t: t < m["start"]),
                               ("during", lambda t: m["start"] <= t < m["end"]),
                               ("after", lambda t: t >= m["end"])):
                ms = sorted((t1 - t0) * 1e3 for t0, t1 in spans if keep(t0))
                if ms:
                    out.setdefault(name, {})[when] = {
                        "n": len(ms), "p50_ms": statistics.median(ms),
                        "p95_ms": ms[min(len(ms) - 1, int(0.95 * len(ms)))]}
        end = max(self.durable_at.values())
        during = [t0 for _, t0, t1, _ in self.queries + self.lookups
                  if self.t_ingest0 <= t0 and t1 <= end]
        return {"shapes": out, "ingest_rows_per_s": len(self.rows) / (end - self.t_ingest0),
                "ingest_s": end - self.t_ingest0,
                "qps_during_writes": len(during) / (end - self.t_ingest0),
                "queries": len(self.queries), "lookups": len(self.lookups),
                "merges": [{k: v for k, v in mg.items() if k not in ("start", "end")}
                           | {"wall_s": mg["end"] - mg["start"]} for mg in self.merges],
                "seconds": self.t1 - self.t0}


def host_rows(host, shapes: dict) -> dict:
    """Each shape's rows on the host-probe engine -> {shape: {ident: part}}."""
    return {name: {row_ident(r): r.get("part") for r in host.query_sync(q, timeout=600)}
            for name, q in shapes.items()}


def quiescent_check(engine, host, shapes: dict, uids: list[str], label: str,
                    want: dict | None = None) -> dict:
    """Every shape and every uid lookup on the engine against the host-probe
    engine's rows (``want``: the host's rows from an earlier check of the
    same store state), each lookup one row -> the host's rows."""
    import bloomsearch_tpu_torch as bt

    queries = dict(shapes)
    queries.update({f"uid {u}": bt.new_query().token(u).build() for u in uids})
    if want is None:
        want = {name: rowset(host.query_sync(q, timeout=600)) for name, q in queries.items()}
    for name, q in queries.items():
        got = rowset(engine.query_sync(q, timeout=600))
        if got != want[name]:
            raise AssertionError(f"{label}: {name} rows differ from the host probe's")
        if name.startswith("uid ") and len(got) > 1:
            raise AssertionError(f"{label}: {name}: {len(got)} rows")
    log(f"{label}: {len(shapes)} shapes and {len(uids)} uid lookups equal the host probe's")
    return want


def stream_version_bump(engine, shapes: dict, want: dict, label: str) -> dict:
    """One more stream mutation between two passes of the shapes, so
    needles the first pass cached are looked up at a newer stream version:
    a small batch (rows that match no shape), flushed; a query of it, whose
    block the engine pins in the background; then every shape again,
    against the host probe's rows (``want``)."""
    import bloomsearch_tpu_torch as bt

    cache = engine._row_cache
    settle_writes(engine)
    with cache._lock:
        before = cache._bucket.version
    engine.ingest_serialized([f'{{"note":"versionbump","uid":"w{i:08x}","part":"01"}}'.encode()
                              for i in range(1_000)], timeout=600, partition_id="01")
    engine.flush(timeout=600)
    if len(engine.query_sync(bt.new_query().token("versionbump").build(), timeout=600)) != 1_000:
        raise AssertionError(f"{label}: the version-bump batch is not 1,000 rows")
    settle_writes(engine)
    with cache._lock:
        after = cache._bucket.version
    for name, q in shapes.items():
        if rowset(engine.query_sync(q, timeout=600)) != want[name]:
            raise AssertionError(f"{label} after the version bump: {name} rows differ from the "
                                 "host probe's")
    settle_writes(engine)
    log(f"{label}: stream version {before} -> {after} around one more pin; every shape again "
        "equal to the host probe's")
    return {"before": before, "after": after}


def settle_writes(engine, timeout: float = 600) -> None:
    """Wait for the background pins and bank warms queries scheduled."""
    engine.drain_background_pins(timeout=timeout)
    deadline = time.monotonic() + timeout
    while True:
        with engine._warm_lock:
            if not engine._warming:
                return
        if time.monotonic() > deadline:
            raise AssertionError("background bank warms did not finish")
        time.sleep(0.01)


def writes_memory_bound(columns_published: int, col_unit: int, column: int, group: int,
                        reserved_chunks: int, max_block_chunks: int, baseline: int) -> dict:
    """The most device memory a write run may allocate, from the code:

    - superbank (``bloom/bank.py``): no column is evicted (the bank budget
      holds every column published), so its capacity is at most ``K``, the
      least ``col_unit`` x 2^k holding every column the run published (base,
      flushed and merged files: dead columns count until a compaction). A
      growth allocates the doubled bank beside the old (``_grow``), which a
      probe snapshot may still hold, and a compaction allocates a new bank
      beside that (``maybe_compact``): K/2 + K + K columns;
    - staged groups (``Superbank.stage``): one a loader, at most the query
      threads, the flush worker and the warm worker at once;
    - stream (``rowcache.py``): the reservation fixes the matrix and pins
      past it evict in place, so as phase 9: three matrices (the stream, a
      compaction's copy, a scan's snapshot), the compaction's int64 index
      and one upload piece;
    - what was allocated before the run."""
    from bloomsearch_tpu_torch.rowcache import CHUNK_BYTES

    K = col_unit
    while K < columns_published:
        K *= 2
    piece = 1 << max(max_block_chunks, 512).bit_length()
    terms = {
        "superbank": (K // 2 + 2 * K) * column,
        "staged_groups": (WRITE_THREADS + 2) * group,
        "stream": 3 * reserved_chunks * CHUNK_BYTES,
        "compaction_index": 8 * reserved_chunks,
        "upload_piece": piece * CHUNK_BYTES,
        "baseline": baseline,
    }
    terms["bound"] = sum(terms.values())
    terms["K"] = K
    return terms


class PublishedColumns:
    """Wraps a MetaStore's ``update`` to count the bank columns of every
    file it publishes."""

    def __init__(self, meta, files):
        self.columns = sum(g.num_blocks for mf in files for g in mf.metadata.bank_groups)
        self.group = max(g.size for mf in files for g in mf.metadata.bank_groups)
        update = meta.update

        def counted(writes, deletes):
            for op in writes:
                groups = op.file_metadata.bank_groups
                self.columns += sum(g.num_blocks for g in groups)
                self.group = max([self.group] + [g.size for g in groups])
            return update(writes, deletes)

        meta.update = counted


class MeshScanRecorder:
    """Keeps, for each shape of the sharded scans a mesh row cache makes
    (``sharded_scan_all_rows`` and ``sharded_scan_segments`` with a mesh),
    its first call's arguments, to re-run it at the end."""

    def __init__(self):
        import bloomsearch_tpu_torch.rowcache as rc

        self.rc = rc
        self.orig = {name: getattr(rc, name) for name in ("sharded_scan_all_rows",
                                                           "sharded_scan_segments")}
        self.args: dict[tuple, dict] = {}
        self.lock = threading.Lock()

    def __enter__(self):
        orig = self.orig

        def keep(key, **args):
            with self.lock:
                self.args.setdefault(key, {k: np.array(v, copy=True)
                                           if isinstance(v, np.ndarray) else v
                                           for k, v in args.items()})

        def dense(mesh, rows32, needles, lens, *, n_real):
            keep(("stream", n_real), needles=needles, lens=lens, n_real=n_real)
            return orig["sharded_scan_all_rows"](mesh, rows32, needles, lens, n_real=n_real)

        def segments(mesh, rows32, seg_starts, needles, lens, *, n_real, seg_chunks):
            counts = [int(v) for v in np.broadcast_to(seg_chunks, (len(seg_starts),))]
            keep(("segments", n_real, tuple(counts)), starts=[int(v) for v in seg_starts],
                 needles=needles, lens=lens, n_real=n_real, seg_chunks=counts)
            return orig["sharded_scan_segments"](mesh, rows32, seg_starts, needles, lens,
                                                 n_real=n_real, seg_chunks=seg_chunks)

        self.rc.sharded_scan_all_rows, self.rc.sharded_scan_segments = dense, segments
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.rc, name, fn)


def plain_requested_bits(flat: torch.Tensor, needles, lens, n_real: int, starts: list,
                         counts: list) -> list[np.ndarray]:
    """The plain version's bits of each requested range, bool[n_real,
    count], over the logical stream ``flat``."""
    from bloomsearch_tpu_torch.kernels import scan as ks
    from bloomsearch_tpu_torch.tools import exp_mesh_join as mj

    plain = plain_scan(ks, flat, needles, lens, n_real, starts, counts).cpu()
    read, rounded = ks.segment_layout(starts, counts, flat.shape[0])
    base = [int(o) + st - r for o, st, r in zip(np.cumsum([0] + rounded[:-1]), starts, read)]
    return mj.requested_bits(plain, base, counts)


def recheck_mesh_scans(dev, mesh, stream: tuple, recorded: dict) -> int:
    """Each recorded sharded scan shape re-run on the mesh's final stream
    against the plain version on its logical stream (every requested chunk
    of a sparse call, every word of a dense one), bit-identical -> shapes."""
    from bloomsearch_tpu_torch.kernels import scan as ks
    from bloomsearch_tpu_torch.parallel import mesh as pm
    from bloomsearch_tpu_torch.tools import exp_mesh_join as mj

    flat = torch.cat([sh.to(dev) for sh in stream])
    for key, a in sorted(recorded.items(), key=str):
        if key[0] == "stream":
            got = pm.sharded_scan_all_rows(mesh, stream, a["needles"], a["lens"],
                                           n_real=a["n_real"])
            want = plain_scan(ks, flat, a["needles"], a["lens"], a["n_real"]).cpu()
            if not torch.equal(got, want):
                raise AssertionError(f"mesh dense scan {key} differs from the plain version")
            continue
        starts, counts = a["starts"], a["seg_chunks"]
        got, base = pm.sharded_scan_segments(mesh, stream, starts, a["needles"], a["lens"],
                                             n_real=a["n_real"], seg_chunks=counts)
        mine = mj.requested_bits(got, base, counts)
        theirs = plain_requested_bits(flat, a["needles"], a["lens"], a["n_real"], starts, counts)
        if not all(np.array_equal(x, y) for x, y in zip(mine, theirs)):
            raise AssertionError(f"mesh sparse scan {key} differs from the plain version")
    del flat
    return len(recorded)


def write_engine(bt, store, meta, settings: dict, mesh=None):
    """The phase's serving engine; with ``mesh`` the two modules that
    resolve ``mesh_devices`` are handed it while the engine is built (as
    phase 8 does on one card)."""
    from unittest import mock

    import bloomsearch_tpu_torch.bloom.bank as bank_mod
    import bloomsearch_tpu_torch.rowcache as rc_mod

    config = engine_config(**settings)
    if mesh is None:
        return bt.BloomSearchEngine(config, meta, store)

    def resolve(mesh_devices, device):
        return mesh

    with mock.patch.object(bank_mod, "mesh_for", resolve), \
            mock.patch.object(rc_mod, "mesh_for", resolve):
        return bt.BloomSearchEngine(config, meta, store)


def write_part(dev, label: str, src: str, n_files: int, n_rows: int, mesh=None) -> dict:
    """Steps 1-6 (one card) or 2-5 (``mesh``) of the phase on ``n_files``
    of the dataset's files and ``n_rows`` live rows -> its readings."""
    import bloomsearch_tpu_torch as bt
    from bloomsearch_tpu_torch.kernels import probe as pk
    from bloomsearch_tpu_torch.kernels import scan as ks
    from bloomsearch_tpu_torch.parallel import mesh as pm

    out: dict = {"label": label, "files": n_files, "rows": n_rows}
    # Beside the dataset: hardlinks need one file system.
    directory = tempfile.mkdtemp(prefix="bloomsearch-writes-", dir=os.path.dirname(src))
    sidecar = tempfile.mkdtemp(prefix="bloomsearch-writes-sidecar-")
    engine = host = None
    try:
        store, meta, files = writes_store(src, n_files, directory)
        published = PublishedColumns(meta, files)
        blocks = [b for mf in files for b in mf.metadata.data_blocks]
        out["base_rows"] = sum(b.rows for b in blocks)
        out["base_columns"] = published.columns
        rows, parts = write_rows(n_rows, REFSCALE_UIDS)
        settings = dict(
            device=str(dev), probe_backend="device",
            mesh_devices=1 if mesh is None else mesh.size, bank_cache_bytes=6 << 30,
            row_cache_bytes=10 << 30, serving_cache_dir=sidecar,
            ttl_predicate=bt.prefilter_expiry(bt.partition(bt.partition_equals(EXPIRED_PART))),
            max_buffered_rows=WRITE_FLUSH_ROWS, max_buffered_bytes=512 << 20,
            max_buffered_time=3600.0)
        host = bt.BloomSearchEngine(engine_config(probe_backend="host"), meta, store)
        host.start()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        baseline = torch.cuda.memory_allocated(dev)
        pk.reset_launch_counts()
        ks.reset_launch_counts()
        pm.reset_launch_counts()
        recorder = ScanRecorder() if mesh is None else MeshScanRecorder()
        with WriteCounters() as counters, recorder:
            engine = write_engine(bt, store, meta, settings, mesh)
            engine.start()
            counters.attach(engine)
            if not engine._row_cache.needle_cache_enabled:
                raise AssertionError("the needle cache is off by default")
            t0 = time.perf_counter()
            engine.warmup(block=True)
            out["warmup_s"] = time.perf_counter() - t0
            bases = base_uids(store, files)  # before a merge replaces the files
            shapes = needle_shapes()
            add_common_shapes(engine, shapes, bases[0])
            base = host_rows(host, shapes)
            out["base_shape_rows"] = {name: len(r) for name, r in base.items()}
            quiet: dict = {}
            check_shapes(engine, host, shapes, 3 if mesh is not None else 5, quiet)
            out["quiet_p50_ms"] = {k[len("warm_p50_ms_"):]: v for k, v in quiet.items()
                                   if k.startswith("warm_p50_ms_")}
            log(f"{label}: warmup {out['warmup_s']:.3f} s; base rows a shape "
                f"{out['base_shape_rows']}; quiet warm p50 {out['quiet_p50_ms']}")

            run = WriteRun(engine, shapes, rows, parts, REFSCALE_UIDS)
            run.run()
            out["run"] = run.timings()
            log(f"{label}: run {out['run']}")

            engine.flush(timeout=600)
            settle_writes(engine)
            final_shapes = dict(run.shapes)
            final = {name: set(r) for name, r in host_rows(host, final_shapes).items()}
            out["checked"] = run.check(base, final)
            log(f"{label}: every query of the run held: {out['checked']}")
            rng = np.random.default_rng(3)
            uids = [f"u{REFSCALE_UIDS + int(k):08x}" for k in
                    rng.choice(n_rows, WRITE_SAMPLED_UIDS // 2, replace=False)]
            uids += [bases[int(i)] for i in rng.choice(
                len(bases), min(WRITE_SAMPLED_UIDS - len(uids), len(bases)), replace=False)]
            want = quiescent_check(engine, host, final_shapes, uids, f"{label} quiescent")
            out["version_bump"] = stream_version_bump(engine, final_shapes, want, label)
            stats = engine.stats()
            out["counters"] = counters.snapshot()
            out["stats"] = {"deferred_tombstones": stats["deferred_tombstones"],
                            "background_pin_failures": stats["background_pin_failures"],
                            "row_cache": stats["row_cache"],
                            "superbanks": stats["device"]["superbanks"],
                            "serving_cache": stats["serving_cache"]}
            with engine._row_cache._lock:
                matrix = engine._row_cache._bucket.matrix
            out["launches"] = {"probe": pk.launch_counts(), "scan": ks.launch_counts(),
                               "sharded_calls": pm.launch_counts()}
            probe_shapes, scan_shapes = pk.launch_shapes(), ks.launch_shapes()
            reserved = engine.stats()["warmup"]["reserved_chunks"]
            col_unit = 128 * (1 if mesh is None else mesh.size)
            out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
            out["memory_bound"] = writes_memory_bound(
                published.columns, col_unit, REFSCALE_COLUMN_BYTES, published.group, reserved,
                max(-(-b.uncompressed_size // 480) for b in blocks), baseline)
            out["errors"] = list(counters.errors)
            if mesh is None:
                engine.stop(timeout=600)
                engine = None
                out["restart"] = write_restart(dev, bt, store, meta, settings, sidecar, host,
                                               final_shapes, uids, want, counters, label)
        check_write_counters(out, label, mesh is not None)
        out["probe_shapes"] = len(probe_shapes)
        out["probe_cases"] = phase_main_shapes(dev, probe_shapes, {})
        if mesh is None:
            out["scan_shapes"] = len(scan_shapes)
            out["scan_cases"] = recheck_scans(ks, matrix, scan_shapes, recorder.args)
        else:
            out["scan_shapes"] = recheck_mesh_scans(dev, mesh, matrix, recorder.args)
        del matrix
        log(f"{label}: {out['probe_shapes']} probe and {out['scan_shapes']} scan launch shapes "
            "re-run against their plain versions, bit-identical")
    finally:
        if engine is not None:
            engine.stop(timeout=600)
        if host is not None:
            host.stop(timeout=600)
        shutil.rmtree(directory, ignore_errors=True)
        shutil.rmtree(sidecar, ignore_errors=True)
        torch.cuda.empty_cache()
    return out


def write_restart(dev, bt, store, meta, settings, sidecar, host, shapes, uids, want,
                  counters, label) -> dict:
    """Step 6: the sidecar holds no tombstoned file; an engine restarted
    from it warms every pinned block from it and answers as before."""
    out: dict = {"stale_sidecar_entries": sidecar_stale_files(meta, sidecar)}
    if out["stale_sidecar_entries"]:
        raise AssertionError(f"{label}: the sidecar holds tombstoned files' entries "
                             f"{out['stale_sidecar_entries'][:3]}")
    from bloomsearch_tpu_torch.kernels import probe as pk
    from bloomsearch_tpu_torch.kernels import scan as ks

    pk.reset_launch_counts()
    ks.reset_launch_counts()
    engine = write_engine(bt, store, meta, settings)
    engine.start()
    try:
        with ScanRecorder() as recorder:
            counters.attach(engine)
            t0 = time.perf_counter()
            engine.warmup(block=True)
            out["warmup_s"] = time.perf_counter() - t0
            out["sidecar_hits"] = engine.stats()["serving_cache"]["hits"]
            if not out["sidecar_hits"]:
                raise AssertionError(f"{label} restart: no block loaded from the sidecar")
            quiescent_check(engine, host, shapes, uids, f"{label} restart", want)
            settle_writes(engine)
            out["launches"] = {"probe": pk.launch_counts(), "scan": ks.launch_counts()}
            probe_shapes, scan_shapes = pk.launch_shapes(), ks.launch_shapes()
            with engine._row_cache._lock:
                matrix = engine._row_cache._bucket.matrix
        out["stale_after"] = sidecar_stale_files(meta, sidecar)
        if out["stale_after"]:
            raise AssertionError(f"{label} restart: stale sidecar entries {out['stale_after']}")
        out["probe_shapes"] = len(probe_shapes)
        phase_main_shapes(dev, probe_shapes, {})
        out["scan_shapes"] = len(scan_shapes)
        recheck_scans(ks, matrix, scan_shapes, recorder.args)
        del matrix
    finally:
        engine.stop(timeout=600)
    log(f"{label} restart: {out}; its {out['probe_shapes']} probe and {out['scan_shapes']} scan "
        "launch shapes re-run against their plain versions, bit-identical")
    return out


def sidecar_stale_files(meta, sidecar: str) -> list[str]:
    """Sidecar entries of files the MetaStore no longer lists."""
    from bloomsearch_tpu_torch.servingcache import ServingStateCache

    prefix = ServingStateCache(sidecar)._prefix
    live = {prefix(mf.pointer) for mf in meta.get_maybe_files_for_query(None)}
    return sorted(n for n in os.listdir(sidecar) if n.endswith(".srv")
                  and n.split("-")[0] not in live)


def check_write_counters(out: dict, label: str, mesh: bool) -> None:
    c, stats = out["counters"], out["stats"]
    log(f"{label}: counters {c}; stats {stats}; launches {out['launches']}; peak device "
        f"memory {out['peak_bytes']} against the bound {out['memory_bound']['bound']} "
        f"({out['memory_bound']})")
    rc = stats["row_cache"]
    # A mesh's capacity unit (128 columns a shard) holds its part's columns:
    # its superbank never grows; the one-card part's does.
    must = {"warm-on-flush inserts": c["warm_on_flush_inserts"],
            "superbank growths": 1 if mesh else c["superbank_growths"],
            "segment removals by tombstone": c["bank_tombstone_segments"],
            "superbank compactions": c["superbank_compactions"],
            "row-cache invalidate_file removals": c["stream_tombstone_blocks"],
            "stream compactions": rc["compactions"],
            "deferred tombstones applied by a draining query":
                min(c["tombstones_deferred"], c["tombstones_applied_by_queries"],
                    c["max_deferred_tombstones"]),
            "needle-cache hits": c["needle_cache_hits"],
            "needle-cache version misses": c["needle_cache_version_misses"]}
    for name, n in must.items():
        if n <= 0:
            raise AssertionError(f"{label}: no {name}")
    for name, n in (("logged warm-on-flush failures", c["warm_on_flush_failures"]),
                    ("ERROR log records", c["error_logs"]),
                    ("uncaught thread exceptions", c["thread_exceptions"]),
                    ("background pin failures", stats["background_pin_failures"]),
                    ("tombstones still deferred", stats["deferred_tombstones"])):
        if n:
            raise AssertionError(f"{label}: {n} {name}: {out['errors'][:3]}")
    if c["bank_churn_errors"] > c["device_probe_calls"]:
        raise AssertionError(f"{label}: more degrades to host probing than device probes")
    for counter in ("reduce_and", "clauses"):
        if out["launches"]["probe"][counter] < 1:
            raise AssertionError(f"{label}: no {counter} probe launch")
    if out["launches"]["scan"]["stream"] + out["launches"]["scan"]["segments"] < 1:
        raise AssertionError(f"{label}: no scan launch")
    if out["peak_bytes"] > out["memory_bound"]["bound"]:
        raise AssertionError(f"{label}: peak device memory {out['peak_bytes']} exceeds the "
                             f"bound {out['memory_bound']['bound']}")


def phase_writes(dev, target_mb: int, seed: int) -> dict:
    """Writes under serving: live ingest with warm-on-flush inserts, merges
    with TTL expiry and deferred tombstones, stream invalidation and the
    default needle cache, under queries, on one card (``WRITE_FILES`` of
    the refscale files, ``WRITE_ROWS`` live rows, then a restart from the
    sidecar) and on a 4-shard mesh (a quarter of the rows over
    ``WRITE_MESH_FILES`` files)."""
    from bloomsearch_tpu_torch.parallel import mesh as pm

    src = refscale_dataset(target_mb, seed)
    log(f"writes under serving on {card_line()}")
    one = write_part(dev, "writes", src, WRITE_FILES, WRITE_ROWS)
    n_cards = torch.cuda.device_count()
    if n_cards >= MESH_SHARDS:
        mesh = pm.Mesh(tuple(torch.device("cuda", i) for i in range(MESH_SHARDS)))
    else:
        mesh = pm.Mesh((dev,) * MESH_SHARDS)
    sharded = write_part(dev, f"writes on a {MESH_SHARDS}-shard mesh over "
                         f"{len(mesh.distinct_devices())} card(s)", src, WRITE_MESH_FILES,
                         WRITE_ROWS // 4, mesh=mesh)
    return {"one_card": one, "mesh": sharded}


def writes_record(out: dict) -> dict:
    """The phase's numbers for the kernels line."""
    def part(p: dict) -> dict:
        keep = ("files", "rows", "base_rows", "base_columns", "warmup_s", "quiet_p50_ms", "run",
                "checked", "counters", "launches", "peak_bytes", "memory_bound",
                "probe_shapes", "scan_shapes", "restart")
        rec = {k: p[k] for k in keep if k in p}
        rec["row_cache"] = p["stats"]["row_cache"]
        rec["background_pin_failures"] = p["stats"]["background_pin_failures"]
        return rec

    return {"card": card_line(), "one_card": part(out["one_card"]), "mesh": part(out["mesh"])}


# -- phase 12: the scale-out over serve peers --------------------------------------

SCALE_OUT_ROW_CACHE_MB = 10240  # the serving cell's row_cache_bytes
SCALE_OUT_THREADS = 16
SCALE_OUT_MERGE_FILES = 2  # about 1M rows: two refscale files
SCALE_OUT_MERGE_THREADS = 8
SCALE_OUT_WARM_PASSES = 10
PEER_START_S = 300.0
PEER_STOP_S = 600.0


class ListingView:
    """A MetaStore that lists only ``pointers`` and publishes to ``meta``, so
    the merging engine merges just those files; the lease is ``meta``'s."""

    def __init__(self, meta, pointers):
        self.meta, self.pointers = meta, set(pointers)

    def get_maybe_files_for_query(self, prefilter):
        return [mf for mf in self.meta.get_maybe_files_for_query(prefilter)
                if mf.pointer in self.pointers]

    def update(self, writes, deletes):
        self.meta.update(writes, deletes)

    def __getattr__(self, name):  # the lease, where ``meta`` has one
        return getattr(self.meta, name)


class PeerWatch:
    """ERROR records of the package's loggers and exceptions any thread left
    uncaught, counted in a peer process."""

    def __init__(self):
        import logging

        watch = self
        self.errors: list[str] = []
        self.lock = threading.Lock()

        class Handler(logging.Handler):
            def emit(self, record):
                with watch.lock:
                    watch.errors.append(f"log {record.name}: {record.getMessage()}")

        self.handler = Handler(level=logging.ERROR)

    def __enter__(self):
        import logging

        logging.getLogger("bloomsearch_tpu_torch").addHandler(self.handler)
        self.excepthook = threading.excepthook

        def hook(args):
            with self.lock:
                self.errors.append(f"thread {args.thread.name}: {args.exc_value!r}")
            self.excepthook(args)

        threading.excepthook = hook
        return self

    def __exit__(self, *exc):
        import logging

        logging.getLogger("bloomsearch_tpu_torch").removeHandler(self.handler)
        threading.excepthook = self.excepthook


def peer_main(record: str, serve_argv: list[str]) -> int:
    """Phase 12's child: one ``serve`` peer on the card. The launch recorders
    of phases 6 and 7 (``kernels.probe.launch_shapes``, ``ScanRecorder``) and
    phase 9's counters are installed, then ``bloomsearch_tpu_torch.serve.main``
    runs with ``serve_argv``; before its engine stops (SIGTERM) the peer
    writes its counters to ``record`` and re-runs every launch shape it made
    against the plain version (``peer_record``)."""
    if not torch.cuda.is_available():
        log("peer: no CUDA device visible")
        return 2
    import traceback

    import bloomsearch_tpu_torch.engine as em
    from bloomsearch_tpu_torch import serve
    from bloomsearch_tpu_torch.kernels import probe as pk
    from bloomsearch_tpu_torch.kernels import scan as ks

    dev = torch.device("cuda", 0)
    torch.empty(1, device=dev)  # the allocator's statistics exist from its first allocation
    pk.reset_launch_counts()
    ks.reset_launch_counts()
    with PeerWatch() as watch, BudgetCounters() as budget, ScanRecorder() as recorder:
        budget.after_warmup = True  # a peer never warms up: each yielding warm is a background one

        class PeerEngine(em.BloomSearchEngine):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                budget.attach(self._device_backend)
                torch.cuda.reset_peak_memory_stats(dev)
                self.smoke_baseline = torch.cuda.memory_allocated(dev)

            def stop(self, timeout=None):
                try:
                    out = peer_record(self, dev, budget, recorder, watch)
                except BaseException as exc:
                    out = {"error": f"{exc!r}\n{traceback.format_exc()}"}
                with open(record, "w") as fh:
                    json.dump(out, fh)
                return super().stop(timeout=timeout)

        serve.BloomSearchEngine = PeerEngine
        serve.main(serve_argv)
    return 0


def peer_record(engine, dev, budget, recorder, watch) -> dict:
    """A peer's counters, read first (its launches, sparse cold probes,
    completed bank warms and pins, residency, the bytes it still holds of
    files no longer listed, its peak device memory), then every probe and
    scan launch shape it made re-run against the plain version."""
    from bloomsearch_tpu_torch.kernels import probe as pk
    from bloomsearch_tpu_torch.kernels import scan as ks

    peak = torch.cuda.max_memory_allocated(dev)
    stats = engine.stats()
    backend, cache = engine._device_backend, engine._row_cache
    listed = {mf.pointer for mf in engine.meta_store.get_maybe_files_for_query(None)}
    with backend._lock:
        superbank_bytes = sum(sb.nbytes for sb in backend._superbanks.values())
        stale_bytes = 0
        for pointer, segs in backend._by_file.items():
            if pointer not in listed:
                for mk, seg_key in segs:
                    sb = backend._superbanks[mk]
                    stale_bytes += sb.segments[seg_key][1] * sb.num_rows * 4
    out = {
        "peak_bytes": peak, "baseline_bytes": engine.smoke_baseline,
        "bank_cache_bytes": engine.config.bank_cache_bytes,
        "row_cache_bytes": engine.config.row_cache_bytes,
        "launches": {"probe": pk.launch_counts(), "scan": ks.launch_counts()},
        "budget": budget.snapshot(), "superbank_bytes": superbank_bytes,
        "stale_superbank_bytes": stale_bytes,
        "background_pin_failures": stats["background_pin_failures"],
        "errors": list(watch.errors),
        # The engine's own host spans (ms), median over its last queries.
        "spans_ms": {k[:-2]: round(statistics.median(t.get(k, 0.0) for t in
                                                     stats["last_query_timings"]) * 1e3, 3)
                     for k in ("plan_s", "prescan_s", "blocks_s", "total_s")}
        if stats["last_query_timings"] else {},
    }
    matrix = None
    if cache is not None:
        from bloomsearch_tpu_torch.rowcache import CHUNK_BYTES

        with cache._lock:
            matrix = cache._bucket.matrix
            stale = [blk for key, blk in cache._blocks.items() if key[0] not in listed]
        out["host_shadow"] = cache.host_shadow
        out["row_cache"] = stats["row_cache"]
        out["stale_stream_bytes"] = sum(blk.num_chunks for blk in stale) * CHUNK_BYTES
        out["stale_shadow_bytes"] = sum(blk.host_nbytes for blk in stale)
    probe_shapes, scan_shapes = pk.launch_shapes(), ks.launch_shapes()
    out["rechecked"] = {"probe_shapes": len(probe_shapes), "scan_shapes": len(scan_shapes)}
    phase_main_shapes(dev, probe_shapes, {})
    if scan_shapes:
        recheck_scans(ks, matrix, scan_shapes, recorder.args, grown=True)
    log(f"peer: {len(probe_shapes)} probe and {len(scan_shapes)} scan launch shapes re-run "
        "against their plain versions, bit-identical")
    return out


def scale_out_bucket(cache: str, directory: str) -> tuple:
    """(a) the refscale files as objects under ``data/`` of a LocalDirObjectStore
    (hardlinks beside their ``.etag`` sidecars; a put where linking fails), the
    manifest written with one ``ObjectStoreMetaStore.update`` from the files'
    footers -> (client, files, hardlinked count)."""
    import uuid

    import bloomsearch_tpu_torch as bt
    from bloomsearch_tpu_torch.stores import WriteOperation

    files = bt.FileSystemDataStore(cache).get_maybe_files_for_query(None)
    client = bt.LocalDirObjectStore(directory)
    writes, linked = [], 0
    for mf in files:
        path = mf.pointer.decode("utf-8")
        key = f"data/{os.path.basename(path)}"
        dest = os.path.join(directory, key)
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        try:
            os.link(path, dest)
        except OSError:
            with open(path, "rb") as fh:
                client.put(key, fh.read())
        else:
            with open(dest + ".etag", "w") as fh:  # the data first, its etag last
                fh.write(uuid.uuid4().hex)
            linked += 1
        writes.append(WriteOperation(file_metadata=mf.metadata, file_pointer=key.encode(),
                                     file_size=mf.size))
    bt.ObjectStoreMetaStore(client).update(writes, [])
    return client, files, linked


def start_peer(root: str, name: str, serve_argv: list[str], card) -> dict:
    """A ``chip_smoke.py --peer`` child (``card``: its one visible card, or
    None to share the card the parent sees) -> its handle."""
    here = os.path.dirname(os.path.abspath(__file__))
    record = os.path.join(root, f"{name}.json")
    log_path = os.path.join(root, f"{name}.log")
    env = dict(os.environ)
    if card is not None:
        env["CUDA_VISIBLE_DEVICES"] = str(card)
    with open(log_path, "w") as fh:
        proc = subprocess.Popen(
            [sys.executable, os.path.join(here, "chip_smoke.py"), "--peer", record, *serve_argv],
            cwd=here, stdout=fh, stderr=subprocess.STDOUT, env=env)
    return {"name": name, "proc": proc, "record": record, "log": log_path, "card": card}


def peer_log_tail(peer: dict, n: int = 30) -> str:
    with open(peer["log"], errors="replace") as fh:
        return "".join(fh.readlines()[-n:])


def wait_serving(peers: list[dict]) -> None:
    """Each peer's ``serving queries on HOST:PORT`` line, into ``peer["address"]``."""
    deadline = time.monotonic() + PEER_START_S
    for peer in peers:
        while "address" not in peer:
            with open(peer["log"], errors="replace") as fh:
                for line in fh:
                    if line.startswith("serving queries on "):
                        host, port = line.strip().rsplit(" ", 1)[1].rsplit(":", 1)
                        peer["address"] = (host, int(port))
            if "address" in peer:
                break
            if peer["proc"].poll() is not None or time.monotonic() > deadline:
                raise AssertionError(f"peer {peer['name']} failed to start "
                                     f"(exit {peer['proc'].poll()}):\n{peer_log_tail(peer)}")
            time.sleep(0.2)
    log(f"scale-out: peers serving at {[p['address'] for p in peers]}")


def stop_peers(peers: list[dict]) -> dict:
    """SIGTERM each live peer, wait, and read its record -> {name: record}."""
    for peer in peers:
        if peer["proc"].poll() is None:
            peer["proc"].send_signal(signal.SIGTERM)
    records = {}
    for peer in peers:
        try:
            peer["proc"].wait(timeout=PEER_STOP_S)
        except subprocess.TimeoutExpired:
            peer["proc"].kill()
            peer["proc"].wait()
            raise AssertionError(f"peer {peer['name']} did not stop:\n{peer_log_tail(peer)}")
        if peer.get("killed"):
            continue
        if peer["proc"].returncode != 0 or not os.path.exists(peer["record"]):
            raise AssertionError(f"peer {peer['name']} exited {peer['proc'].returncode} "
                                 f"without its record:\n{peer_log_tail(peer)}")
        with open(peer["record"]) as fh:
            records[peer["name"]] = json.load(fh)
        if "error" in records[peer["name"]]:
            raise AssertionError(f"peer {peer['name']}: {records[peer['name']]['error']}")
    return records


def collect(coord, query, timeout: float = 600) -> tuple[list, list]:
    """One coordinator query -> (rows, errors)."""
    import queue

    result_q, error_q = queue.Queue(), queue.Queue()
    coord.query(query, result_q, error_q)
    rows, deadline = [], time.monotonic() + timeout
    while True:
        item = result_q.get(timeout=max(0.0, deadline - time.monotonic()))
        if item is None:
            break
        rows.append(item)
    errors = []
    while not error_q.empty():
        errors.append(error_q.get_nowait())
    return rows, errors


def error_kind(exc: BaseException) -> str:
    """An error's type, and for a peer's error the type it reported."""
    import re

    inner = re.search(r": (\w+(?:Error|Exception))\(", str(exc))
    return type(exc).__name__ + (f"/{inner.group(1)}" if inner else "")


def held(rows: list, errors: list, want: list[str], label: str) -> str:
    """The coordinator's contract for one query: no row twice, no row the
    host probe does not return; with no error exactly the host probe's rows.
    -> "exact", or the first error's kind."""
    got = rowset(rows)
    if len(set(got)) != len(got):
        raise AssertionError(f"{label}: a row delivered twice")
    if not errors:
        if got != want:
            raise AssertionError(f"{label}: {len(got)} rows and no error, the host probe "
                                 f"returns {len(want)}")
        return "exact"
    if not set(got) <= set(want):
        raise AssertionError(f"{label}: a row the host probe does not return")
    return error_kind(errors[0])


class AttemptCounter:
    """Counts a CapacityScatterCoordinator's snapshot attempts: one per query
    plus one per stale-snapshot retry."""

    def __init__(self, coord):
        self.n = 0
        self.lock = threading.Lock()
        attempt = coord._query_attempt

        def counted(*args, **kwargs):
            with self.lock:
                self.n += 1
            return attempt(*args, **kwargs)

        coord._query_attempt = counted


def scale_out_burst(coord, shapes: dict, want: dict, threads: int, label: str,
                    per_thread: int = 8, until=None, on_start=None) -> dict:
    """``threads`` coordinator threads of mixed shapes, ``per_thread`` each (or,
    with ``until``, until it is set), each held to ``held`` -> outcomes by
    kind, p50 of the exact queries and qps."""
    names = list(shapes)
    outcomes: dict[str, int] = {}
    lat: list[float] = []
    errors: list[BaseException] = []
    lock = threading.Lock()
    started = threading.Event()

    def worker(tid: int) -> None:
        try:
            i = 0
            while i < per_thread if until is None else i == 0 or not until.is_set():
                name = names[(tid + i) % len(names)]
                started.set()
                t0 = time.perf_counter()
                rows, errs = collect(coord, shapes[name])
                ms = (time.perf_counter() - t0) * 1e3
                kind = held(rows, errs, want[name], f"{label} {name}")
                with lock:
                    outcomes[kind] = outcomes.get(kind, 0) + 1
                    if kind == "exact":
                        lat.append(ms)
                i += 1
        except BaseException as exc:  # re-raised on the main thread
            errors.append(exc)

    pool = [threading.Thread(target=worker, args=(t,)) for t in range(threads)]
    t0 = time.perf_counter()
    for t in pool:
        t.start()
    if on_start is not None:
        started.wait(60)
        on_start()
    for t in pool:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in pool):
        raise AssertionError(f"{label}: queries did not finish")
    n = sum(outcomes.values())
    out = {"queries": n, "outcomes": outcomes, "qps": n / wall,
           "p50_ms": statistics.median(lat) if lat else None}
    log(f"scale-out {label}: {out}")
    return out


def check_every_shape(coord, shapes: dict, want: dict, label: str) -> dict:
    """Each shape once, its rows equal to the host probe's -> ms a shape."""
    out = {}
    for name, query in shapes.items():
        t0 = time.perf_counter()
        rows, errors = collect(coord, query)
        out[name] = (time.perf_counter() - t0) * 1e3
        if errors or rowset(rows) != want[name]:
            raise AssertionError(f"{label} {name}: {len(rows)} rows, errors {errors}; the "
                                 f"host probe returns {len(want[name])}")
    return out


def peer_memory_bound(record: dict, files: list) -> dict:
    """``memory_bound`` for one peer, from the code, over every file the peer
    could have loaded (the bucket's listings over the phase; a peer never
    tombstones, so a merged-away file stays until evicted):

    - superbank: its bank doubles from 128 columns to the least 128 x 2^k
      holding every listed group (below the 2 GiB ``bank_cache_bytes``
      default at refscale, so nothing is evicted); the growth copy beside the
      old bank and a probe snapshot of the one before it;
    - one staged group: a group is larger than ``engine.SPARSE_BANK_BYTES``,
      so queries sparse-probe it and only the one warm thread loads it;
    - stream: a peer never warms up, so ``reserve`` never fixes it; a pin
      grows the matrix to at most twice what it needs and never past
      the byte budget left by the host shadow (``pin``), and holds no dead
      chunk (nothing is tombstoned or evicted under the budget): at most
      twice every listed block's chunks, three matrices at once (the
      growth copy, a scan snapshot);
    - what the peer had allocated when its engine was built."""
    from bloomsearch_tpu_torch.rowcache import CHUNK_BYTES, STREAM_STRIDE

    groups = [g for mf in files for g in mf.metadata.bank_groups]
    column = 3 * ((groups[0].m_bits + 31) // 32) * 4
    columns = sum(g.num_blocks for g in groups)
    cap = 128
    while cap < columns:
        cap *= 2
    blocks = [-(-max(b.uncompressed_size, 1) // STREAM_STRIDE)
              for mf in files for b in mf.metadata.data_blocks]
    chunks = min(2 * (sum(blocks) + max(blocks) + 512),
                 record["row_cache_bytes"] // CHUNK_BYTES)
    budgets = {"column_bytes": column,
               "group_bytes": max(g.num_blocks for g in groups) * column}
    return memory_bound(budgets, chunks, max(blocks), record["baseline_bytes"],
                        bank_columns=cap // 2 + cap + cap // 2)


def check_peer_records(records: dict, files: list, killed: set) -> dict:
    """(g) for each peer that was not killed: K1e launched, K2/K2s where it
    scanned, no ERROR log or thread exception, no background pin failure,
    the peak under its bound -> each peer's summary."""
    out = {}
    for name, rec in records.items():
        if name in killed:
            continue
        probe, scan = rec["launches"]["probe"], rec["launches"]["scan"]
        k1e = probe["pack"] + probe["reduce_and"] + probe["clauses"]
        if k1e < 1:
            raise AssertionError(f"peer {name}: no K1e launch")
        scanned = rec.get("row_cache", {}).get("scan_launches", 0)
        if scanned and scan["stream"] + scan["segments"] < 1:
            raise AssertionError(f"peer {name}: scanned with no K2/K2s launch")
        if rec["errors"]:
            raise AssertionError(f"peer {name}: {rec['errors']}")
        if rec["background_pin_failures"]:
            raise AssertionError(f"peer {name}: a background pin failed")
        bound = peer_memory_bound(rec, files)
        if rec["peak_bytes"] > bound["bound"]:
            raise AssertionError(f"peer {name}: peak device memory {rec['peak_bytes']} exceeds "
                                 f"the bound {bound['bound']} ({bound})")
        out[name] = {k: rec[k] for k in rec if k not in ("errors",)}
        out[name]["memory_bound"] = bound["bound"]
        log(f"peer {name}: launches {rec['launches']}, budget counters {rec['budget']}, "
            f"row cache {rec.get('row_cache')}, host_shadow {rec.get('host_shadow')}, "
            f"stale superbank {rec['stale_superbank_bytes']} bytes, stale stream "
            f"{rec.get('stale_stream_bytes')} bytes, peak {rec['peak_bytes']} under "
            f"{bound['bound']}; shapes re-run bit-identical {rec['rechecked']}")
    return out


def serve_argv(source: list[str], peer_id=None, capacity=None) -> list[str]:
    argv = [*source, "--port", "0", "--row-cache-mb", str(SCALE_OUT_ROW_CACHE_MB),
            "--probe-backend", "device"]
    if peer_id is not None:
        argv += ["--registry", "--peer-id", peer_id, "--capacity", str(capacity)]
    return argv


def phase_scale_out(dev, target_mb: int, seed: int, serving_p50: dict | None = None) -> dict:
    """Phase 12: ``serve`` peers on the card behind both coordinators, every
    row held to a host-probe engine's (module docstring)."""
    import bloomsearch_tpu_torch as bt
    import bloomsearch_tpu_torch.parallel as tpar

    cache = refscale_dataset(target_mb, seed)
    root = tempfile.mkdtemp(prefix="bloomsearch-scaleout-", dir=os.path.dirname(cache))
    n_cards = torch.cuda.device_count()
    n_peers = n_cards if n_cards >= 2 else 2
    out: dict = {"card": card_line(), "peers": n_peers, "cards": n_cards}
    peers: list[dict] = []
    host = merger = None
    t_phase = time.perf_counter()
    try:
        # (a) the bucket
        client, files, linked = scale_out_bucket(cache, os.path.join(root, "bucket"))
        meta = bt.ObjectStoreMetaStore(client)
        listings = []
        for _ in range(11):
            t0 = time.perf_counter()
            meta.get_maybe_files_for_query(None)
            listings.append((time.perf_counter() - t0) * 1e3)
        # What every coordinator query and every peer's plan reads and parses.
        out["bucket"] = {"files": len(files), "hardlinked": linked,
                         "manifest_bytes": client.head("meta/manifest.json")[0],
                         "listing_ms": statistics.median(listings[1:])}
        log(f"scale-out: bucket {out['bucket']}")
        host = bt.BloomSearchEngine(engine_config(probe_backend="host"), meta,
                                    bt.ObjectStoreDataStore(client))
        host.start()

        # (b) the peers, through the entry point
        bucket = os.path.join(root, "bucket")
        for i in range(n_peers):
            peers.append(start_peer(root, f"p{i}", serve_argv(
                ["--object-dir", bucket], f"p{i}", 2 if i == 0 else 1),
                i if n_cards >= 2 else None))
        wait_serving(peers)
        registry = tpar.PeerRegistry(client)
        deadline = time.monotonic() + PEER_START_S
        while len({p.peer_id for p in registry.live_peers()}) < n_peers:
            if time.monotonic() > deadline:
                raise AssertionError("peers never all registered")
            time.sleep(0.1)
        out["start_s"] = time.perf_counter() - t_phase
        coord = tpar.CapacityScatterCoordinator(bt.ObjectStoreMetaStore(client), registry)
        attempts = AttemptCounter(coord)

        # (c) queries: cold, warm, 16 threads
        shapes = needle_shapes()
        add_common_shapes(host, shapes)
        want = {name: rowset(host.query_sync(q, timeout=600)) for name, q in shapes.items()}
        out["cold_ms"] = check_every_shape(coord, shapes, want, "cold")
        log(f"scale-out cold first query a shape (ms): {out['cold_ms']}")
        passes, prev = [], None
        for _ in range(SCALE_OUT_WARM_PASSES):
            t0 = time.perf_counter()
            check_every_shape(coord, shapes, want, "warm pass")
            passes.append(time.perf_counter() - t0)
            if prev is not None and passes[-1] >= 0.9 * prev:
                break  # no pass 10% faster than the one before: the warms have landed
            prev = passes[-1]
        out["warm_passes_s"] = passes
        samples = {name: [] for name in shapes}
        for _ in range(7):
            for name, ms in check_every_shape(coord, shapes, want, "warm").items():
                samples[name].append(ms)
        out["warm_p50_ms"] = {name: statistics.median(v) for name, v in samples.items()}
        log(f"scale-out warm p50 a shape (ms) {out['warm_p50_ms']}; phase 7's one-card "
            f"serving p50 {serving_p50}")
        out["burst"] = scale_out_burst(coord, shapes, want, SCALE_OUT_THREADS, "16 threads")
        if out["burst"]["outcomes"] != {"exact": out["burst"]["queries"]}:
            raise AssertionError(f"16 threads: {out['burst']['outcomes']}")

        # (d) a merge under the coordinator
        listing = sorted(meta.get_maybe_files_for_query(None), key=lambda mf: mf.pointer)
        merged = [mf.pointer for mf in listing[:SCALE_OUT_MERGE_FILES]]
        # Two refscale blocks of a partition merge only within 32 MB row groups.
        merger = bt.BloomSearchEngine(
            dataclasses.replace(engine_config(device=str(dev), probe_backend="device",
                                              mesh_devices=1),
                                max_row_group_bytes=32 * 1024 * 1024),
            ListingView(meta, merged), bt.ObjectStoreDataStore(client))
        merger.start()
        before = attempts.n
        merge_done = threading.Event()
        merge_out: dict = {}

        def run_merge():
            try:
                time.sleep(1.0)  # the burst is under way
                t0 = time.perf_counter()
                stats = merger.merge()
                merge_out.update(files=stats.files_processed, rows=stats.rows_processed,
                                 rows_per_s=stats.rows_per_second,
                                 wall_s=time.perf_counter() - t0)
            except BaseException as exc:
                merge_out["error"] = exc
            finally:
                merge_done.set()

        merge_thread = threading.Thread(target=run_merge)
        merge_thread.start()
        during = scale_out_burst(coord, shapes, want, SCALE_OUT_MERGE_THREADS,
                                 "during the merge", until=merge_done)
        merge_thread.join()
        if "error" in merge_out:
            raise merge_out.pop("error")
        if merge_out["files"] != SCALE_OUT_MERGE_FILES:
            raise AssertionError(f"the merge rewrote {merge_out['files']} files")
        after_merge = check_every_shape(coord, shapes, want, "after the merge")
        out["merge"] = {**merge_out, "during": during, "after_ms": after_merge,
                        "stale_retries": attempts.n - before - during["queries"] - len(shapes)}
        log(f"scale-out merge: {out['merge']}")
        files_seen = listing + [mf for mf in meta.get_maybe_files_for_query(None)
                                if mf.pointer not in {f.pointer for f in listing}]

        # (e) a killed peer
        victim = peers[-1]

        def kill():
            time.sleep(0.5)
            victim["proc"].kill()
            victim["killed"] = True
            log(f"scale-out: SIGKILL to peer {victim['name']}")

        out["kill"] = {"peer": victim["name"], "burst": scale_out_burst(
            coord, shapes, want, SCALE_OUT_THREADS, "16 threads, a peer killed",
            on_start=kill)}
        victim["proc"].wait(timeout=60)
        out["kill"]["survivors_ms"] = check_every_shape(coord, shapes, want, "survivors")
        records = stop_peers(peers)
        out["object_peers"] = check_peer_records(records, files_seen, {victim["name"]})
        peers = []

        # (f) the data-partitioned form through --dir
        halves = [os.path.join(root, f"half{h}") for h in range(2)]
        for h, directory in enumerate(halves):
            os.makedirs(directory)
            for mf in files[h::2]:
                path = mf.pointer.decode("utf-8")
                os.link(path, os.path.join(directory, os.path.basename(path)))
        for h, directory in enumerate(halves):
            peers.append(start_peer(root, f"d{h}", serve_argv(["--dir", directory]),
                                    h if n_cards >= 2 else None))
        wait_serving(peers)
        gather = tpar.ScatterGatherCoordinator(
            [tpar.RemoteQueryPeer(*p["address"]) for p in peers])
        store = bt.FileSystemDataStore(cache)
        dir_host = bt.BloomSearchEngine(engine_config(probe_backend="host"), store, store)
        dir_host.start()
        try:
            dir_want = {name: rowset(dir_host.query_sync(q, timeout=600))
                        for name, q in shapes.items()}
        finally:
            dir_host.stop(timeout=600)
        out["dir"] = {"cold_ms": check_every_shape(gather, shapes, dir_want, "dir cold"),
                      "warm_ms": check_every_shape(gather, shapes, dir_want, "dir warm"),
                      "burst": scale_out_burst(gather, shapes, dir_want, SCALE_OUT_THREADS,
                                               "dir, 16 threads")}
        if out["dir"]["burst"]["outcomes"] != {"exact": out["dir"]["burst"]["queries"]}:
            raise AssertionError(f"dir, 16 threads: {out['dir']['burst']['outcomes']}")
        records = stop_peers(peers)
        peers = []
        out["dir_peers"] = check_peer_records(records, files, set())
        for name, rec in out["dir_peers"].items():
            if rec.get("host_shadow") is not False:
                raise AssertionError(f"--dir peer {name}: the host shadow is on")
        for name, rec in out["object_peers"].items():
            if rec.get("host_shadow") is not True:
                raise AssertionError(f"object-store peer {name}: the host shadow is off")
    finally:
        for peer in peers:
            if peer["proc"].poll() is None:
                peer["proc"].kill()
                peer["proc"].wait()
        for engine in (merger, host):
            if engine is not None:
                engine.stop(timeout=600)
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"scale-out: phase 12 took {out['seconds']:.1f} s")
    return out


def scale_out_record(out: dict) -> dict:
    """Phase 12's numbers for the kernels line: per coordinator step its
    times, qps and outcomes; the merge; the killed peer; each surviving
    peer's launches, cold probes, warms, pins, stale bytes and peak."""
    def peer(rec: dict) -> dict:
        rc = rec.get("row_cache", {})
        return {"launches": rec["launches"], "sparse_cold_probes":
                rec["budget"]["sparse_cold_probes"], "bank_warms_completed":
                rec["budget"]["bank_warms_completed"], "pins": rc.get("pins"),
                "pinned_blocks": rc.get("pinned_blocks"), "host_shadow": rec.get("host_shadow"),
                "superbank_bytes": rec["superbank_bytes"],
                "stale_superbank_bytes": rec["stale_superbank_bytes"],
                "stale_stream_bytes": rec.get("stale_stream_bytes"),
                "peak_bytes": rec["peak_bytes"], "memory_bound": rec["memory_bound"],
                "rechecked": rec["rechecked"], "spans_ms": rec["spans_ms"]}

    return {
        "card": out["card"], "seconds": out["seconds"], "peers": out["peers"],
        "bucket": out["bucket"],
        "start_s": out["start_s"], "cold_ms": out["cold_ms"], "warm_p50_ms": out["warm_p50_ms"],
        "warm_passes_s": out["warm_passes_s"], "burst": out["burst"], "merge": out["merge"],
        "kill": out["kill"], "dir": out["dir"],
        "object_peers": {k: peer(v) for k, v in out["object_peers"].items()},
        "dir_peers": {k: peer(v) for k, v in out["dir_peers"].items()},
    }


# -- phase 13: the query language and both bloom layouts ---------------------------

BLOCKED = "blocked256"
LAYOUTS = ("classic", BLOCKED)
QL_SEED = 13_000
QL_MESH_SEED = 13_500
QL_LONG_SEED = 13_900
QL_HOST_EPISODES = 4
QL_THREADS = 8  # each episode's final queries again from 8 threads at once
MIXED_MERGE_BYTES = 32 * 1024 * 1024  # two refscale blocks of a partition merge within this
LAYOUT_TURNS = 5  # (blocked, classic, classic, blocked) rounds: ten turns a form


def joined(x, axis: int, dev) -> torch.Tensor:
    """A tensor or a mesh's tuple of shards as one tensor on ``dev``."""
    return x if isinstance(x, torch.Tensor) else torch.cat([s.to(dev) for s in x], dim=axis)


def blocked_positions(rows, T: int, k: int) -> bool:
    """Whether every term's k probe rows lie in one aligned 8-row group: the
    blocked-256 layout's positions (its m is whole 256-bit blocks, so each
    keyspace starts on a multiple of 8 rows). Classic positions of k = 10
    probes do so with a chance below (8 / W)^9 at W >= 4,493 words."""
    groups = np.asarray(rows, dtype=np.int64).reshape(T, k) // 8
    return bool((groups == groups[:, :1]).all())


class LaunchCheck:
    """Every probe call of the combiner (``bloom/bank.py::_probe``: the plan
    call on one card, ``sharded_probe`` on a mesh) and every scan call of
    the row cache (``sharded_scan_all_rows`` and ``sharded_scan_segments``)
    held, as it returns, against the plain version on the same inputs (a
    mesh's shards joined on ``dev``): every word of a probe and of a dense
    scan, every requested chunk of a sparse one, bit-identical; a
    disagreement raises inside the query, which fails. Counts the probe
    calls by epilogue and those at blocked positions, the scan calls by
    mode, and the distinct launch shapes."""

    def __init__(self, dev):
        import bloomsearch_tpu_torch.bloom.bank as bank_mod
        import bloomsearch_tpu_torch.rowcache as rc

        self.dev, self.bank_mod, self.rc = dev, bank_mod, rc
        self.orig = {"_probe": bank_mod._probe,
                     "sharded_scan_all_rows": rc.sharded_scan_all_rows,
                     "sharded_scan_segments": rc.sharded_scan_segments}
        self.probes: dict[str, int] = {}
        self.blocked: dict[str, int] = {}
        self.scans = {"stream": 0, "segments": 0}
        self.shapes: set = set()
        self.lock = threading.Lock()

    def _probe(self, mesh, bank2d, row_idx, shift, T, K, epilogue, **extra):
        from bloomsearch_tpu_torch.kernels import probe as pk

        out = self.orig["_probe"](mesh, bank2d, row_idx, shift, T, K, epilogue, **extra)
        bank = joined(bank2d, 1, self.dev)
        rows, shifts = (torch.as_tensor(np.asarray(a, dtype=np.int32)).to(self.dev)
                        for a in (row_idx, shift))
        match = pk.probe_plain(bank, rows, shifts, T, K)
        if epilogue == "reduce_and":
            match = pk.reduce_and_plain(match, extra["and_bits"])
        elif epilogue == "clauses":
            match = pk.clauses_plain(match, extra["clause_bits"], extra["member_bits"])
        if not torch.equal(out, pk.pack_bitmap_plain(match).cpu()):
            raise AssertionError(f"probe {epilogue} T={T} C={bank.shape[1]} differs from the "
                                 "plain version")
        blocked = blocked_positions(row_idx, T, K)
        with self.lock:
            self.probes[epilogue] = self.probes.get(epilogue, 0) + 1
            if blocked:
                self.blocked[epilogue] = self.blocked.get(epilogue, 0) + 1
            self.shapes.add(("probe", epilogue, bank.shape[1], T, out.shape[0],
                             mesh is not None, blocked))
        return out

    def _dense(self, mesh, rows32, needles, lens, *, n_real):
        from bloomsearch_tpu_torch.kernels import scan as ks

        out = self.orig["sharded_scan_all_rows"](mesh, rows32, needles, lens, n_real=n_real)
        flat = joined(rows32, 0, self.dev)
        if not torch.equal(out, plain_scan(ks, flat, needles, lens, n_real).cpu()):
            raise AssertionError(f"dense scan G={flat.shape[0]} n_real={n_real} differs from "
                                 "the plain version")
        with self.lock:
            self.scans["stream"] += 1
            self.shapes.add(("stream", flat.shape[0], n_real, mesh is not None))
        return out

    def _segments(self, mesh, rows32, seg_starts, needles, lens, *, n_real, seg_chunks):
        from bloomsearch_tpu_torch.tools import exp_mesh_join as mj

        got, base = self.orig["sharded_scan_segments"](mesh, rows32, seg_starts, needles, lens,
                                                       n_real=n_real, seg_chunks=seg_chunks)
        starts = [int(v) for v in seg_starts]
        counts = [int(v) for v in np.broadcast_to(seg_chunks, (len(starts),))]
        mine = mj.requested_bits(got, base, counts)
        theirs = plain_requested_bits(joined(rows32, 0, self.dev), needles, lens, n_real, starts,
                                      counts)
        if not all(np.array_equal(a, b) for a, b in zip(mine, theirs)):
            raise AssertionError(f"sparse scan over {list(zip(starts, counts))} n_real={n_real} "
                                 "differs from the plain version")
        with self.lock:
            self.scans["segments"] += 1
            self.shapes.add(("segments", n_real, tuple(counts), mesh is not None))
        return got, base

    def __enter__(self):
        self.bank_mod._probe = self._probe
        self.rc.sharded_scan_all_rows = self._dense
        self.rc.sharded_scan_segments = self._segments
        return self

    def __exit__(self, *exc):
        self.bank_mod._probe = self.orig["_probe"]
        for name in ("sharded_scan_all_rows", "sharded_scan_segments"):
            setattr(self.rc, name, self.orig[name])


def ql_mesh(dev):
    from bloomsearch_tpu_torch.parallel import mesh as pm

    if torch.cuda.device_count() >= MESH_SHARDS:
        return pm.Mesh(tuple(torch.device("cuda", i) for i in range(MESH_SHARDS)))
    return pm.Mesh((dev,) * MESH_SHARDS)


def ql_episodes(dev, codecs: tuple) -> list[dict]:
    """The grid: on one card, the device and serving backends x the fs and
    in-memory object stores x both layouts x rows or the serialized mix x
    ``codecs``; the host backend as the control; on a 4-shard mesh, both
    backends x both layouts x both ingests; and the long-row / long-needle /
    non-ASCII variant on serving at both layouts on one card and on the
    mesh. Each episode's seed is its own."""
    out = []
    for backend in ("device", "serving"):
        for store in ("fs", "object"):
            for layout in LAYOUTS:
                for frac in (0.0, 0.6):
                    for codec in codecs:
                        out.append(dict(backend=backend, store=store, layout=layout, frac=frac,
                                        codec=codec, mesh=False, variant="reference"))
    for i in range(QL_HOST_EPISODES):
        out.append(dict(backend="host", store=("fs", "object")[i % 2], layout=LAYOUTS[i // 2],
                        frac=(0.0, 0.6)[i % 2], codec="snappy", mesh=False,
                        variant="reference"))
    for backend in ("device", "serving"):
        for layout in LAYOUTS:
            for frac in (0.0, 0.6):
                out.append(dict(backend=backend, store=("fs", "object")[int(frac > 0)],
                                layout=layout, frac=frac, codec="snappy", mesh=True,
                                variant="reference"))
    for mesh in (False, True):
        for layout in LAYOUTS:
            out.append(dict(backend="serving", store="fs", layout=layout, frac=0.6,
                            codec="snappy", mesh=mesh, variant="long"))
    for i, ep in enumerate(out):
        base = QL_LONG_SEED if ep["variant"] == "long" else QL_MESH_SEED if ep["mesh"] else QL_SEED
        ep["seed"] = base + i
    return out


def run_ql_episode(dev, ep: dict, check: LaunchCheck) -> dict:
    """One episode on the card; -> its counts, with its escapes on serving."""
    from unittest import mock

    import bloomsearch_tpu_torch as bt
    import bloomsearch_tpu_torch.bloom.bank as bank_mod
    import bloomsearch_tpu_torch.rowcache as rc_mod
    from bloomsearch_tpu_torch.tools import oracle_fuzz as of

    episode = of.plan_episode(ep["seed"], ep["frac"], variant=ep["variant"])
    settings = of.EpisodeSettings(
        backend=ep["backend"], store=ep["store"], compression=ep["codec"], layout=ep["layout"],
        extra=(("device", str(dev)), ("mesh_devices", MESH_SHARDS if ep["mesh"] else 1)))
    directory = tempfile.mkdtemp(prefix="bloomsearch-ql-")
    try:
        if ep["mesh"]:
            mesh = ql_mesh(dev)
            with mock.patch.object(bank_mod, "mesh_for", lambda n, d: mesh), \
                    mock.patch.object(rc_mod, "mesh_for", lambda n, d: mesh):
                engine = of.open_engine(bt, episode, settings, directory)
        else:
            engine = of.open_engine(bt, episode, settings, directory)
        serving = ep["backend"] == "serving"
        probes_before = sum(check.probes.values())
        blocked_before = sum(check.blocked.values())
        try:
            if serving:
                with of.EscapeCounter(engine) as escapes:
                    counts = of.run_episode(
                        [of.Target("port", bt, engine, True)], episode,
                        on_query=lambda spec, q, rows, all_rows: escapes.after_query(rows["port"]),
                        threads=QL_THREADS)
                counts.update(flag_only=escapes.flag_only, escapes=escapes.accepted)
            else:
                counts = of.run_episode([of.Target("port", bt, engine)], episode,
                                        threads=QL_THREADS)
            stats = engine.stats()
        finally:
            engine.stop(timeout=600)
        if ep["backend"] != "host":
            layouts = {k.rsplit(",", 1)[1] for k in stats["device"]["superbanks"]}
            if layouts != {ep["layout"]}:
                raise AssertionError(f"episode {ep}: superbanks {sorted(layouts)}")
            probes = sum(check.probes.values()) - probes_before
            blocked = sum(check.blocked.values()) - blocked_before
            # Every probe of a blocked episode at blocked positions, none of a classic one.
            if probes == 0 or blocked != (probes if ep["layout"] == BLOCKED else 0):
                raise AssertionError(f"episode {ep}: {blocked} of {probes} probe calls at "
                                     "blocked positions")
        elif sum(check.probes.values()) != probes_before:
            raise AssertionError(f"episode {ep}: the host backend probed on the card")
        return counts
    finally:
        shutil.rmtree(directory, ignore_errors=True)


def phase_query_language(dev) -> dict:
    """Step a: the oracle episodes on the card (``ql_episodes``), every
    query exact against the oracle, every probe and scan call held against
    the plain version as it returns (``LaunchCheck``); the launch counters
    set to 0 just before and read just after; then every probe launch shape
    re-run on a refscale-sized random bank (phase 6's helper)."""
    from bloomsearch_tpu_torch.compression import compression_available
    from bloomsearch_tpu_torch.kernels import probe as pk
    from bloomsearch_tpu_torch.kernels import scan as ks
    from bloomsearch_tpu_torch.parallel import mesh as pm

    codecs = ("none", "snappy")
    if compression_available("zstd"):
        codecs += ("zstd",)
        log("query language: zstd is available on this host; its episodes run")
    else:
        log("query language: zstd is not available on this host (compression_available); "
            "its episodes are skipped")
    grid = ql_episodes(dev, codecs)
    log(f"query language: {len(grid)} episodes on {card_line()}")
    totals: dict = {"episodes": 0, "mesh_episodes": 0, "queries": 0, "minmax_queries": 0,
                    "concurrent_queries": 0, "rows": 0, "merges": 0, "flushes": 0, "flag_only": 0, "escapes": 0,
                    "by_backend": {}, "codecs": list(codecs)}
    t0 = time.perf_counter()
    pk.reset_launch_counts()
    ks.reset_launch_counts()
    pm.reset_launch_counts()
    with PeerWatch() as watch, LaunchCheck(dev) as check:
        for ep in grid:
            counts = run_ql_episode(dev, ep, check)
            for key in ("queries", "minmax_queries", "concurrent_queries", "rows", "merges",
                        "flushes", "flag_only", "escapes"):
                totals[key] += counts.get(key, 0)
            totals["episodes"] += 1
            totals["mesh_episodes"] += int(ep["mesh"])
            label = ep["backend"] + (" mesh" if ep["mesh"] else "")
            totals["by_backend"][label] = totals["by_backend"].get(label, 0) + 1
            if ep["variant"] == "long":
                log(f"query language: long variant {ep}: {counts}")
    totals["launches"] = pk.launch_counts()
    totals["scan_launches"] = ks.launch_counts()
    totals["mesh_launches"] = pm.launch_counts()
    launched = pk.launch_shapes()
    totals["seconds"] = time.perf_counter() - t0
    totals["checked_probe_calls"] = dict(check.probes)
    totals["blocked_probe_calls"] = dict(check.blocked)
    totals["checked_scan_calls"] = dict(check.scans)
    totals["checked_shapes"] = len(check.shapes)
    totals["errors"] = list(watch.errors)
    log(f"query language: {totals}")
    one_card = totals["episodes"] - totals["mesh_episodes"]
    if one_card < 32 or totals["mesh_episodes"] < 8:
        raise AssertionError(f"{one_card} one-card and {totals['mesh_episodes']} mesh episodes")
    if totals["escapes"] < 1:
        raise AssertionError("no row was found through the always-candidate flags alone")
    if sum(check.blocked.values()) < 1:
        raise AssertionError("no probe launch at blocked positions")
    for counter in ("pack", "reduce_and", "clauses"):
        if totals["launches"][counter] < 1:
            raise AssertionError(f"the episodes launched no {counter} probe")
    for counter in ("stream", "segments"):
        if totals["scan_launches"][counter] < 1:
            raise AssertionError(f"the episodes launched no {counter} scan")
    if watch.errors:
        raise AssertionError(f"query language: {watch.errors[:5]}")
    phase_main_shapes(dev, launched, {})
    totals["probe_shapes_rerun"] = len(launched)
    return totals


BLOCKED_COPY_PROCS = 4  # child processes that build the blocked copy, a share of files each


def blocked_dataset(target_mb: int, seed: int) -> str:
    """The refscale rows in the blocked-256 layout, cached under ~/.cache
    beside refscale (keyed by seed, size and layout), built by
    ``BLOCKED_COPY_PROCS`` child processes (``copy_blocked``), each over
    every n-th refscale file by age into a directory of its own, whose
    files are then moved into the cache. ``COPIES.json`` maps each refscale
    file's name to the copy files its rows went into."""
    import bloomsearch_tpu_torch as bt

    src = refscale_dataset(target_mb, seed)
    cache = os.path.expanduser(
        f"~/.cache/bloomsearch-torch-refscale/v1-snappy-{target_mb}mb-seed{seed}-{BLOCKED}")
    marker = os.path.join(cache, "COPIES.json")
    if os.path.exists(marker):
        log(f"blocked copy cached at {cache}")
        return cache
    shutil.rmtree(cache, ignore_errors=True)
    os.makedirs(cache)
    t0 = time.perf_counter()
    names = [os.path.basename(mf.pointer.decode()) for mf in sorted(
        bt.FileSystemDataStore(src).get_maybe_files_for_query(None),
        key=lambda mf: os.stat(mf.pointer.decode()).st_mtime_ns)]
    here = os.path.dirname(os.path.abspath(__file__))
    parts = [os.path.join(cache, f"part{i}") for i in range(BLOCKED_COPY_PROCS)]
    children = [subprocess.Popen([sys.executable, "-c", (
        f"import sys; sys.path.insert(0, {here!r}); import chip_smoke; "
        f"chip_smoke.copy_blocked({src!r}, {part!r}, {names[i::BLOCKED_COPY_PROCS]!r})")],
        cwd=here) for i, part in enumerate(parts)]
    try:
        codes = [child.wait() for child in children]
    finally:
        for child in children:
            if child.poll() is None:
                child.kill()
                child.wait()
    if any(codes):
        raise RuntimeError(f"blocked copy children exited with {codes}")
    copies: dict = {}
    rows = 0
    for part in parts:
        with open(os.path.join(part, "COPIES.json")) as fh:
            built = json.load(fh)
        rows += built["rows"]
        copies.update(built["copies"])
        for name in (n for files in built["copies"].values() for n in files):
            os.rename(os.path.join(part, name), os.path.join(cache, name))
        shutil.rmtree(part)
    with open(marker, "w") as fh:
        json.dump({"rows": rows, "seconds": time.perf_counter() - t0, "copies": copies}, fh)
    log(f"blocked copy built in {time.perf_counter() - t0:.1f} s by {BLOCKED_COPY_PROCS} "
        f"processes: {rows} rows, {sum(len(v) for v in copies.values())} files")
    return cache


def copy_blocked(src: str, out_dir: str, names: list[str]) -> None:
    """The refscale files ``names`` (in this order) copied into ``out_dir``
    in the blocked-256 layout: each file's blocks decoded and their rows
    ingested through ``ingest_serialized`` with the block's partition, by
    an engine with ``perf.generate_fast``'s settings and
    ``bloom_layout="blocked256"``, a flush after each file; writes
    ``COPIES.json`` (each name's copy files, the rows)."""
    import bloomsearch_tpu_torch as bt
    from bloomsearch_tpu_torch import native
    from bloomsearch_tpu_torch.file_format import read_block_rows_compressed

    os.makedirs(out_dir)
    store = bt.FileSystemDataStore(src)
    by_name = {os.path.basename(mf.pointer.decode()): mf
               for mf in store.get_maybe_files_for_query(None)}
    out = bt.FileSystemDataStore(out_dir)
    engine = bt.BloomSearchEngine(bt.BloomSearchEngineConfig(
        row_data_compression="snappy", probe_backend="host", max_row_group_bytes=10 * 1024 * 1024,
        max_row_group_rows=1_000_000, max_buffered_rows=2_000_000,
        max_buffered_bytes=200 * 1024 * 1024, max_buffered_time=3600.0,
        max_file_size=100 * 1024 * 1024, bloom_layout=BLOCKED), out, out)
    engine.start()
    copies: dict = {}
    seen: set = set()
    rows = 0
    try:
        for name in names:
            mf = by_name[name]
            with store.open_file(mf.pointer) as fh:
                for blk in mf.metadata.data_blocks:
                    processed = native.process_block(
                        read_block_rows_compressed(fh, blk, verify=False), blk.compression,
                        blk.row_data_hash, blk.uncompressed_size, [])
                    if processed is None:
                        raise RuntimeError("decoding the refscale blocks needs the native "
                                           "host library")
                    data, offsets, lengths, _ = processed
                    buf = bytes(data)
                    payload = [buf[o:o + n] for o, n in zip(offsets.tolist(), lengths.tolist())]
                    for lo in range(0, len(payload), 10_000):
                        engine.ingest_serialized(payload[lo:lo + 10_000], timeout=600,
                                                 partition_id=blk.partition_id)
                    rows += len(payload)
            engine.flush(timeout=600)
            new = [m.pointer for m in out.get_maybe_files_for_query(None) if m.pointer not in seen]
            seen.update(new)
            copies[name] = [os.path.basename(p.decode()) for p in new]
    finally:
        engine.stop(timeout=600)
    with open(os.path.join(out_dir, "COPIES.json"), "w") as fh:
        json.dump({"rows": rows, "copies": copies}, fh)


def candidate_blocks(engine, query) -> int:
    """The blocks a query's probe left for the block stage (its ``jobs``)."""
    engine.query_sync(query, timeout=600)
    return engine.stats()["last_query_timings"][-1]["jobs"]


def checked_pass(dev, engine, shapes: dict, results: dict, label: str) -> dict:
    """Every shape once more under ``LaunchCheck``: its launches held
    against the plain version as they return, its rows against ``results``."""
    with LaunchCheck(dev) as check:
        for name, query in shapes.items():
            if rowset(engine.query_sync(query, timeout=600)) != results[name]:
                raise AssertionError(f"{label} {name}: rows differ in the checked pass")
    out = {"probe_calls": dict(check.probes), "blocked_probe_calls": dict(check.blocked),
           "scan_calls": dict(check.scans), "shapes": len(check.shapes)}
    log(f"{label}: checked pass {out}")
    return out


def layout_probe_case(query, epilogue: str, m_bits: int, k: int, num_words: int,
                      layout: str) -> dict:
    """A query's probe arrays on a superbank of ``num_words`` words a
    keyspace at ``layout``'s positions, as the engine builds them, with its
    epilogue's arguments."""
    from bloomsearch_tpu_torch.bloom.probe import compile_bloom_terms, compile_cnf_clauses

    terms = compile_bloom_terms(query.bloom)
    T = len(terms)
    word_idx, bit_idx = terms.positions_for(m_bits, k, layout)
    rows = (terms.ks_idx[:, None].astype(np.int32) * num_words + word_idx).reshape(-1)
    if epilogue == "reduce_and":
        kw = {"and_bits": (1 << T) - 1}
    elif epilogue == "clauses":
        mask = np.asarray(compile_cnf_clauses(query.bloom.expression, terms))
        clause_bits = [int(sum(1 << t for t in range(T) if row[t])) for row in mask]
        kw = {"clause_bits": clause_bits, "member_bits": [(1 << len(clause_bits)) - 1]}
    else:
        kw = {}
    return {"T": T, "rows": rows.astype(np.int32), "shifts": bit_idx.reshape(-1).astype(np.int32),
            "kw": kw}


def layout_probe_turns(dev, bank: torch.Tensor, shapes: dict, m_bits: int, k: int,
                       num_words: int, reps: int = 25) -> dict:
    """The one-card combined probe on the blocked superbank at its own width,
    at blocked and at classic positions of the same terms (the token query
    reduced with AND, the OR tree through its clauses, and an OR of 16
    tokens packed), in turns: the kernel into a page-locked buffer between
    CUDA events and the plan call as a caller sees it, each checked against
    the plain version; each form's bound from the distinct rows its probes
    touch, read once, beside the probe arrays and the output."""
    import bloomsearch_tpu_torch as bt
    from bloomsearch_tpu_torch.kernels import probe as pk
    from bloomsearch_tpu_torch.tools import exp_mesh_join as mj

    C = bank.shape[1]
    wide = bt.new_query().match(bt.or_(*[bt.token(f"layoutterm{i}q") for i in range(16)])).build()
    plain_name = {"pack": "probe_and_pack", "reduce_and": "probe_reduce_and_pack",
                  "clauses": "probe_clauses_pack"}
    result = {}
    for label, query, epilogue in (("token", shapes["token"], "reduce_and"),
                                   ("or_tree", shapes["or_tree"], "clauses"),
                                   ("or_16_tokens", wide, "pack")):
        forms = {}
        for layout in (BLOCKED, "classic"):
            c = layout_probe_case(query, epilogue, m_bits, k, num_words, layout)
            out_rows = pk.output_rows(epilogue, c["T"], c["kw"].get("member_bits", ()))
            distinct = len(set(c["rows"].tolist()))
            nbytes = distinct * C * 4 + c["rows"].size * 8 + out_rows * (C // 32) * 4
            c.update(distinct=distinct, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, ms=[],
                     call_ms=[], want=plain_epilogue(pk, plain_name[epilogue], bank, c["rows"],
                                                     c["shifts"], c["T"],
                                                     tuple(c["kw"].values()), k).cpu(),
                     buf=torch.empty((out_rows, C // 32), dtype=torch.int32, pin_memory=True))
            forms[layout] = c
        for layout in (BLOCKED, "classic", "classic", BLOCKED) * LAYOUT_TURNS:
            c = forms[layout]
            c["ms"].append(event_ms(lambda i: mj.probe_shards_into(
                c["buf"], 0, [bank], c["rows"], c["shifts"], c["T"], k, epilogue, **c["kw"]),
                reps, hide_host=True))
            c["call_ms"].append(mj.call_ms(lambda: pk.probe_plan(
                [(0, [bank])], C // 32, c["rows"], c["shifts"], c["T"], k, epilogue, **c["kw"]),
                [dev], reps))
        for layout, c in forms.items():
            plan = pk.probe_plan([(0, [bank])], C // 32, c["rows"], c["shifts"], c["T"], k,
                                 epilogue, **c["kw"])
            if not torch.equal(c["buf"], c["want"]) or not torch.equal(plan, c["want"]):
                raise AssertionError(f"{label} at {layout} positions differs from the plain "
                                     "version")
        result[label] = {layout: {
            "epilogue": epilogue, "T": c["T"], "C": C, "distinct_rows": c["distinct"],
            "median_ms": statistics.median(c["ms"]), "ms": c["ms"],
            "call_median_ms": statistics.median(c["call_ms"]), "call_ms": c["call_ms"],
            "bound_ms": c["bound_ms"], "bound_by": "bytes"} for layout, c in forms.items()}
        log(f"combined probe at the blocked superbank's width C={C}, {label} ({epilogue}): "
            + "; ".join(f"{layout} {r['distinct_rows']} rows, kernel {r['median_ms']:.6f} ms, "
                        f"call {r['call_median_ms']:.6f} ms, bound {r['bound_ms']:.6f} ms"
                        for layout, r in result[label].items()))
    return result


def serve_layout_cell(dev, label: str, store, meta, shapes: dict, results: dict, settings: dict,
                      reps: int, superbank_layouts: set) -> tuple[dict, object]:
    """One engine over ``store``: warmup, every shape ``reps`` times against
    ``results`` (the classic host probe's rows), 16 threads, then the
    checked pass; -> (its readings, the engine, still running)."""
    import bloomsearch_tpu_torch as bt

    from bloomsearch_tpu_torch.kernels import probe as pk

    out: dict = {}
    engine = bt.BloomSearchEngine(engine_config(**settings), meta, store)
    engine.start()
    if engine._row_cache is not None:
        engine._row_cache.needle_cache_enabled = False
    t0 = time.perf_counter()
    engine.warmup(block=True)
    out["warmup_s"] = time.perf_counter() - t0
    layouts = {k.rsplit(",", 1)[1] for k in engine.stats()["device"]["superbanks"]}
    if layouts != superbank_layouts:
        raise AssertionError(f"{label}: superbanks {sorted(layouts)}")
    pk.reset_launch_counts()

    class Host:  # check_shapes' host engine: the classic host probe's rows
        def query_sync(self, query, timeout=None):
            name = next(n for n, q in shapes.items() if q is query)
            return [json.loads(r) for r in results[name]]

    check_shapes(engine, Host(), shapes, reps, out)
    out["launches"] = pk.launch_counts()
    out["candidate_blocks"] = {name: candidate_blocks(engine, q) for name, q in shapes.items()}
    run_concurrent(engine, shapes, results, out)
    out["checked"] = checked = checked_pass(dev, engine, shapes, results, label)
    calls, blocked = (sum(checked[k].values()) for k in ("probe_calls", "blocked_probe_calls"))
    # Every probe of a blocked superbank at blocked positions; a mixed set
    # probes both superbanks.
    if not (0 < blocked == calls if superbank_layouts == {BLOCKED} else 0 < blocked < calls):
        raise AssertionError(f"{label}: {blocked} of {calls} probe calls at blocked positions")
    log(f"{label}: warmup {out['warmup_s']:.3f} s, candidate blocks {out['candidate_blocks']}, "
        f"launches {out['launches']}")
    return out, engine


def phase_blocked_refscale(dev, target_mb: int, seed: int, classic_p50: dict,
                           reps: int = 7) -> dict:
    """Step b: the blocked copy of refscale under the probe cell's and the
    serving cell's settings, each shape's rows equal to the classic host
    probe's, beside phases 5 and 7's p50s; the candidate blocks of both
    layouts; the combined probe at blocked and classic positions. Step c:
    ``phase_mixed_layouts``."""
    import bloomsearch_tpu_torch as bt

    src = refscale_dataset(target_mb, seed)
    blocked = blocked_dataset(target_mb, seed)
    classic_store = bt.FileSystemDataStore(src)
    store = bt.FileSystemDataStore(blocked)
    files = store.get_maybe_files_for_query(None)
    if any(g.params.layout != BLOCKED for mf in files for g in mf.metadata.bank_groups):
        raise AssertionError("the blocked copy holds a classic bank group")
    with open(os.path.join(blocked, "COPIES.json")) as fh:
        built = json.load(fh)
    out: dict = {"rows": built["rows"], "files": len(files), "build_s": built["seconds"],
                 "blocks": sum(len(mf.metadata.data_blocks) for mf in files)}
    log(f"blocked refscale on {card_line()}: {out}")
    host = bt.BloomSearchEngine(engine_config(probe_backend="host"), classic_store, classic_store)
    host.start()
    sidecar = tempfile.mkdtemp(prefix="bloomsearch-ql-sidecar-")
    try:
        shapes = needle_shapes()
        add_common_shapes(host, shapes)  # phases 5 and 7's shapes, from the classic rows
        results = {name: rowset(host.query_sync(q, timeout=600)) for name, q in shapes.items()}
        out["classic_candidate_blocks"] = {name: candidate_blocks(host, q)
                                           for name, q in shapes.items()}
        probe = dict(device=str(dev), probe_backend="device", bank_cache_bytes=6 << 30,
                     mesh_devices=1)
        with PeerWatch() as watch:
            out["probe"], engine = serve_layout_cell(dev, "blocked probe cell", store, store,
                                                     shapes, results, probe, reps, {BLOCKED})
            try:
                (mk, sb), = engine._device_backend._superbanks.items()
                out["superbank"] = {"m_bits": sb.m_bits, "k": sb.k, "num_words": sb.num_words,
                                    "columns": sb.bank2d.shape[1], "rows": sb.bank2d.shape[0]}
                out["layout_turns"] = layout_probe_turns(dev, sb.bank2d, shapes, sb.m_bits, sb.k,
                                                         sb.num_words)
            finally:
                engine.stop(timeout=600)
            out["serving"], engine = serve_layout_cell(
                dev, "blocked serving cell", store, store, shapes, results,
                dict(probe, row_cache_bytes=10 << 30, serving_cache_dir=sidecar), reps, {BLOCKED})
            engine.stop(timeout=600)
            out["mixed"] = phase_mixed_layouts(dev, src, blocked, built["copies"], shapes,
                                               results, reps)
        if watch.errors:
            raise AssertionError(f"blocked refscale: {watch.errors[:5]}")
    finally:
        host.stop(timeout=600)
        shutil.rmtree(sidecar, ignore_errors=True)
    out["classic_p50_ms"] = classic_p50
    for cell in ("probe", "serving"):
        log(f"blocked {cell} cell warm p50 (ms): " + ", ".join(
            f"{name} {out[cell][f'warm_p50_ms_{name}']:.3f} (classic "
            f"{classic_p50.get(cell, {}).get(name)})" for name in shapes)
            + "; candidate blocks blocked/classic " + ", ".join(
            f"{name} {out[cell]['candidate_blocks'][name]}/{out['classic_candidate_blocks'][name]}"
            for name in shapes))
    return out


def mergeable_pair(files: list, config) -> list:
    """The first two of ``files`` (by name) that hold two blocks the merge
    may join (one partition, within ``config``'s row-group caps)."""
    files = sorted(files, key=lambda mf: mf.pointer)
    for i, a in enumerate(files):
        for b in files[i + 1:]:
            if any(x.partition_id == y.partition_id and x.rows + y.rows <= config.max_row_group_rows
                   and x.uncompressed_size + y.uncompressed_size <= config.max_row_group_bytes
                   for x in a.metadata.data_blocks for y in b.metadata.data_blocks):
                return [a.pointer, b.pointer]
    raise AssertionError("no two files of one layout hold blocks the merge may join")


def phase_mixed_layouts(dev, src: str, blocked: str, copies: dict, shapes: dict, results: dict,
                        reps: int) -> dict:
    """Step c: the classic refscale files at even places (by age) and the
    blocked copies of those at odd places, hardlinked behind a
    ``MemoryMetaStore`` (the same rows as refscale), served with both
    superbanks resident under the serving cell's settings, every shape
    equal to the classic host probe's rows; then an engine that sees two
    files of each layout (``mergeable_pair``) merges them, and every output
    file must hold one layout, the classic pair's rows in a classic file
    and the blocked pair's in a blocked one, and every shape must still
    hold."""
    import bloomsearch_tpu_torch as bt

    by_age = sorted(bt.FileSystemDataStore(src).get_maybe_files_for_query(None),
                    key=lambda mf: os.stat(mf.pointer.decode()).st_mtime_ns)
    directory = tempfile.mkdtemp(prefix="bloomsearch-mixed-", dir=os.path.dirname(src))
    sidecar = tempfile.mkdtemp(prefix="bloomsearch-mixed-sidecar-")
    out: dict = {}
    try:
        for i, mf in enumerate(by_age):
            name = os.path.basename(mf.pointer.decode())
            if i % 2 == 0:
                os.link(mf.pointer.decode(), os.path.join(directory, name))
            else:
                for copy in copies[name]:
                    os.link(os.path.join(blocked, copy), os.path.join(directory, copy))
        store = bt.FileSystemDataStore(directory)
        meta = bt.MemoryMetaStore()
        files = store.get_maybe_files_for_query(None)
        meta.update([bt.WriteOperation(mf.metadata, mf.pointer, file_size=mf.size)
                     for mf in files], [])
        layout_of = {mf.pointer: mf.metadata.bloom_filters.field.layout for mf in files}
        out["files"] = {layout: sum(v == layout for v in layout_of.values()) for layout in LAYOUTS}
        settings = dict(device=str(dev), probe_backend="device", bank_cache_bytes=6 << 30,
                        mesh_devices=1, row_cache_bytes=10 << 30, serving_cache_dir=sidecar)
        cell, engine = serve_layout_cell(dev, "mixed-layout cell", store, meta, shapes, results,
                                         settings, reps, set(LAYOUTS))
        out.update(cell)
        try:
            merge_config = dataclasses.replace(engine_config(probe_backend="host"),
                                               max_row_group_bytes=MIXED_MERGE_BYTES)
            pick = [p for layout in LAYOUTS
                    for p in mergeable_pair([mf for mf in files if layout_of[mf.pointer] == layout],
                                            merge_config)]
            merger = bt.BloomSearchEngine(merge_config, ListingView(meta, pick), store)
            merger.start()
            try:
                t0 = time.perf_counter()
                stats = merger.merge()
                out["merge"] = {"files": stats.files_processed, "rows": stats.rows_processed,
                                "wall_s": time.perf_counter() - t0}
            finally:
                merger.stop(timeout=600)
            after = meta.get_maybe_files_for_query(None)
            new = [mf for mf in after if mf.pointer not in layout_of]
            for mf in new:
                block_layouts = {b.bloom_layout for b in mf.metadata.data_blocks}
                if block_layouts != {mf.metadata.bloom_filters.field.layout}:
                    raise AssertionError(f"merged file {mf.pointer!r} mixes layouts "
                                         f"{sorted(block_layouts)}")
            merged_rows = {layout: sum(b.rows for mf in new for b in mf.metadata.data_blocks
                                       if mf.metadata.bloom_filters.field.layout == layout)
                           for layout in LAYOUTS}
            picked = {mf.pointer: mf for mf in files if mf.pointer in pick}
            want_rows = {layout: sum(b.rows for p, mf in picked.items()
                                     if layout_of[p] == layout for b in mf.metadata.data_blocks)
                         for layout in LAYOUTS}
            if out["merge"]["files"] != len(pick) or merged_rows != want_rows:
                raise AssertionError(f"the merge of {pick}: {out['merge']}, rows by layout "
                                     f"{merged_rows}, want {want_rows}")
            out["merge"]["rows_by_layout"] = merged_rows
            out["merge"]["new_files"] = len(new)
            for name, query in shapes.items():
                if rowset(engine.query_sync(query, timeout=600)) != results[name]:
                    raise AssertionError(f"mixed-layout {name}: rows differ after the merge")
            log(f"mixed-layout merge: {out['merge']}; every shape still equal")
        finally:
            engine.stop(timeout=600)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
        shutil.rmtree(sidecar, ignore_errors=True)
    return out


def query_language_record(ql: dict, blocked: dict) -> dict:
    """Phase 13's numbers for the kernels line."""
    def cell(c: dict) -> dict:
        return {k: v for k, v in c.items() if k.startswith(("warm_p50_ms_", "concurrent16"))
                or k in ("warmup_s", "launches", "candidate_blocks", "checked", "files", "merge")}

    return {
        "episodes": {k: ql[k] for k in ("episodes", "mesh_episodes", "queries", "minmax_queries",
                                        "concurrent_queries", "escapes", "flag_only", "launches", "scan_launches",
                                        "mesh_launches", "blocked_probe_calls",
                                        "checked_probe_calls", "checked_scan_calls",
                                        "checked_shapes", "probe_shapes_rerun", "codecs",
                                        "seconds")},
        "blocked_refscale": {
            **{k: blocked[k] for k in ("rows", "files", "blocks", "build_s", "superbank",
                                       "classic_candidate_blocks", "classic_p50_ms",
                                       "layout_turns")},
            "probe": cell(blocked["probe"]), "serving": cell(blocked["serving"]),
            "mixed": cell(blocked["mixed"])},
    }


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--peer"]:  # phase 12's child: --peer RECORD SERVE-ARGUMENTS...
        return peer_main(argv[1], argv[2:])
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--target-mb", type=int, default=1600,
                        help="refscale dataset size (the reference's 1.6 GB)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--old-probe", metavar="SOURCE",
                        help="also time an earlier probe kernel source (a csrc/probe.cu with "
                             "one bank a launch) against this one, in turns")
    parser.add_argument("--old-scan", metavar="SOURCE",
                        help="also time an earlier scan kernel source (a csrc/scan.cu whose "
                             "ranges lie in one stream) against this one, in turns")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        log("no CUDA device visible: this script measures the card and has no CPU mode")
        return 2
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    def done(phase: str) -> None:
        log(f"phase {phase} done at {time.perf_counter() - t_start:.1f} s")

    kind = phase_device()
    dataset = start_refscale_dataset(args.target_mb, args.seed, blocked=True)
    try:
        phase_build()
        done("build")
        cases = phase_kernel(dev)
        done("kernel")
        log(json.dumps({"scan_kernel": phase_scan_kernel(dev)}))
        done("scan kernel")
        # Phase 13a needs no dataset: its episodes run while the child
        # generates refscale and then its blocked copy.
        query_language = phase_query_language(dev)
        done("query language episodes")
        if dataset.wait() != 0:
            raise RuntimeError(f"dataset generation exited with {dataset.returncode}")
        done("dataset")
    finally:
        if dataset.poll() is None:
            dataset.kill()
            dataset.wait()
    kernels, engine = probe_phases(dev, args, cases, done)
    sidecar = tempfile.mkdtemp(prefix="bloomsearch-sidecar-")
    try:
        serving = phase_serving(dev, args.target_mb, args.seed, sidecar,
                                old_scan=args.old_scan)
        done("serving engine")
        scan_cases = serving.pop("scan_cases")
        resident = serving.pop("resident")
        log(json.dumps({"serving": serving}))
        mesh_entries, mesh_engine = phase_mesh(dev, resident)
        del resident
        done("mesh")
        log(json.dumps({"mesh_engine": mesh_engine}))
    finally:
        shutil.rmtree(sidecar, ignore_errors=True)
    beyond = beyond_budget_record(phase_beyond_budget(dev, args.target_mb, args.seed))
    done("beyond budget")
    log(json.dumps({"beyond_budget": beyond}))
    tools = phase_tools(dev, args.target_mb, args.seed)
    done("tools")
    log(json.dumps({"tools": {k: v for k, v in tools.items() if k != "entry"}}))
    writes = writes_record(phase_writes(dev, args.target_mb, args.seed))
    done("writes")
    log(json.dumps({"writes": writes}))
    scale_out = phase_scale_out(dev, args.target_mb, args.seed, serving_p50={
        k[len("warm_p50_ms_"):]: v for k, v in serving.items() if k.startswith("warm_p50_ms_")})
    done("scale-out")
    log(json.dumps({"scale_out": scale_out}))
    blocked = phase_blocked_refscale(dev, args.target_mb, args.seed, classic_p50={
        cell: {k[len("warm_p50_ms_"):]: v for k, v in readings.items()
               if k.startswith("warm_p50_ms_")}
        for cell, readings in (("probe", engine), ("serving", serving))})
    done("blocked and mixed layouts")
    query_language = query_language_record(query_language, blocked)
    log(json.dumps({"query_language": query_language}))
    for name, (counter, replaces) in SCAN_MODES.items():
        if counter not in scan_cases:
            raise AssertionError(f"{name} was not launched on the serving path")
        case = scan_cases[counter]
        log(f"{name}: main-path shape {case['key']} reported")
        entry = {
            "name": name, "route": "cuda", "source": SCAN_SOURCE, "entry": "bs_scan_plan",
            "replaces": replaces,
            "launches": serving["launches"][counter], "max_abs_err": case["max_abs_err"],
            "ms": case["ms"], "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"], "library_ms": None,
        }
        if counter == "stream":
            turns = serving["dense_call_turns"][case["n_real"]]
            entry.update({"device_out_ms": case["device_out_ms"],
                          "call_ms": turns["median_ms"]["plan"],
                          "copy_call_ms": turns["median_ms"]["copy"],
                          "call_verdict": turns["verdict"]})
        kernels.append(entry)
    for name, (source, entry, replaces) in MESH_WRAPPERS.items():
        case = mesh_entries[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "entry": entry,
            "replaces": replaces,
            "launches": case["launches"], "max_abs_err": case["max_abs_err"],
            "ms": case["ms"], "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"], "library_ms": None, "shards": MESH_SHARDS,
            **{k: case[k] for k in ("old_ms", "mapped_ms", "copy_landing_ms", "unsharded_ms",
                                    "unsharded_call_ms", "card_launch_ms", "sparse_ms",
                                    "dense_call_ms", "per_launch_ms", "one_card_call_ms",
                                    "single_device_call_ms", "pieces", "plan_split_us",
                                    "launches_per_card", "cards", "kernel_launches_per_call")
               if k in case},
        })
    kernels.append(tools["entry"])
    for k in kernels:
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']} was not launched on the main path")
    log(json.dumps({"kernels": kernels, "beyond_budget": beyond, "writes": writes,
                    "scale_out": scale_out_record(scale_out),
                    "query_language": query_language}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
