#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

Usage, from the repository root:

    python3 chip_smoke.py [--target-mb 1600] [--seed 0]

Phases, in order; any failure raises and the script exits non-zero:

1. device: the card's name and power limit (nvidia-smi), the torch device,
   and the port's native host library (g++ builds it at first use);
2. build: the probe and scan kernel libraries, compiled together (one nvcc
   each) for sm_90a, with their register and shared-memory reports;
3. kernel: the block-bloom probe kernel in its three epilogues against its
   plain PyTorch version on the card at the refscale bank's width for every
   padded term count T in {1, 2, 4, 8, 16}, bit-identical, with CUDA-event
   times beside the memory bound;
4. scan kernel: the stream byte scan in dense and segment mode against its
   plain version, bit-identical: random bytes including >= 0x80, needles of
   10 lengths at every start alignment, the start-479/480 boundary, padding
   rows, clamped segments;
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
   not cover; each epilogue's most launched shape is timed and reported;
7. serving engine: the same dataset in serving mode (the row stream pinned
   on the card, a restart sidecar in a temporary directory), the same
   queries checked against the host-probe engine, the scan counters reset
   before it; then the scan kernel against its plain version on the
   resident stream at every shape the engine launched, and a restarted
   engine that loads every block from the sidecar.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
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
SCAN_LENGTHS = (1, 2, 3, 4, 5, 7, 8, 15, 31, 32)
SEG_CHUNKS = 16_384  # a refscale block is about 15,000 chunks
PLAIN_PIECE = 32_768  # chunks per plain-version call over a large stream


def log(msg: str) -> None:
    print(msg, flush=True)


# -- phase 1 and 2 ------------------------------------------------------------


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
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
    """Both kernel libraries, one nvcc process each, started together."""
    from bloomsearch_tpu_torch.kernels import probe as pk
    from bloomsearch_tpu_torch.kernels import scan as ks

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


# -- phase 3 ------------------------------------------------------------------


def random_bank(rows: int, cols: int, gen: torch.Generator, dev) -> torch.Tensor:
    words = torch.randint(0, 1 << 32, (rows, cols), generator=gen, device=dev, dtype=torch.int64)
    return (words - (1 << 31)).to(torch.int32)


def event_ms(fn, reps: int, hide_host: bool) -> float:
    """Median time of ``fn(i)`` over ``reps`` calls between CUDA events.

    ``hide_host``: a spin kernel first keeps the stream busy while the host
    enqueues the call, so the events bracket device time alone; without it
    they also hold the host's launch cost (what a waiting caller sees)."""
    fn(0)
    torch.cuda.synchronize()
    times = []
    for i in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if hide_host:
            torch.cuda._sleep(2_000_000)  # ~1 ms of spinning at H100 clocks
        start.record()
        fn(i)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def shape_key(name: str, C: int, T: int, clauses: int = 16, members: int = 16) -> tuple:
    """A case's key in the form of ``kernels.probe.launch_shapes()``:
    (launch counter, C, T, output rows, clauses)."""
    counter = EPILOGUES[name][0]
    rows = {"pack": T, "reduce_and": 1, "clauses": members}[counter]
    return (counter, C, T, rows, clauses if counter == "clauses" else 0)


def kernel_case(pk, bank, T: int, name: str, gen, dev, reps: int = 25,
                clauses: int = 16, members: int = 16, time_it: bool = True) -> dict:
    """Hold one epilogue against its plain version at one shape and time
    both (``time_it``). Each launch probes fresh random rows, so the rows
    come from device memory as a query's would, not from the L2 cache."""
    R, C = bank.shape
    reps = reps if time_it else 3
    sets = [
        (
            torch.randint(0, R, (T * K,), generator=gen, device=dev, dtype=torch.int32),
            torch.randint(0, 32, (T * K,), generator=gen, device=dev, dtype=torch.int32),
        )
        for _ in range(reps + 1)
    ]
    clause_bits = [(1 << (i % T)) | (1 << ((i + 1) % T)) for i in range(clauses)]
    member_bits = [(1 << (m % clauses)) | (1 << ((m + 5) % clauses)) for m in range(members)]
    extra = {
        "probe_and_pack": (),
        "probe_reduce_and_pack": ((1 << T) - 1,),
        "probe_clauses_pack": (clause_bits, member_bits),
    }[name]
    kernel = getattr(pk, name)

    def plain(rows, shifts):
        match = pk.probe_plain(bank, rows, shifts, T, K)
        if name == "probe_reduce_and_pack":
            match = pk.reduce_and_plain(match, *extra)
        elif name == "probe_clauses_pack":
            match = pk.clauses_plain(match, *extra)
        return pk.pack_bitmap_plain(match)

    max_err = 0
    for rows, shifts in sets[:4]:
        got = kernel(bank, rows, shifts, T, K, *extra)
        want = plain(rows, shifts)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        if err or not torch.equal(got, want):
            raise AssertionError(f"{name} T={T} C={C}: kernel disagrees with plain version")
        max_err = max(max_err, err)
    key = shape_key(name, C, T, clauses, members)
    shape = f"{name} R={R} C={C} T={T} K={K}" + (
        f" clauses={clauses} members={members}" if name == "probe_clauses_pack" else "")
    if not time_it:
        log(f"kernel {shape}: bit-identical")
        return {"key": key, "max_abs_err": max_err}
    ms = event_ms(lambda i: kernel(bank, *sets[i], T, K, *extra), reps, hide_host=True)
    call_ms = event_ms(lambda i: kernel(bank, *sets[i], T, K, *extra), reps, hide_host=False)
    plain_ms = event_ms(lambda i: plain(*sets[i]), reps, hide_host=True)
    out_rows = key[3]
    # Least work: the T*K probed rows (each read once), the probe arrays and
    # the packed output. About 3 integer operations per probed word.
    nbytes = T * K * C * 4 + T * K * 8 + out_rows * (C // 32) * 4
    ops = 3 * T * K * C
    bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) * 1e3
    bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / INT32_OPS_PER_S else "operations"
    log(f"kernel {shape}: kernel_ms={ms:.6f} call_ms={call_ms:.6f} "
        f"plain_ms={plain_ms:.6f} bound_ms={bound_ms:.6f} ({bound_by}) bytes={nbytes} "
        f"bit-identical")
    return {"key": key, "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": max_err,
            "bytes": nbytes}


def phase_kernel(dev, refscale_rows: int = REFSCALE_ROWS, bench_rows: int = BENCH_ROWS,
                 bench_cols: int = 32_768) -> dict:
    """Every epilogue at the refscale bank's C = 256 for every term count
    the engine launches (T is padded to a power of two up to 16), with 16
    clauses and 16 members, and at the bench shape C = 32,768, T = 4."""
    from bloomsearch_tpu_torch.kernels import probe as pk

    gen = torch.Generator(device=dev).manual_seed(0)
    bank = random_bank(refscale_rows, 256, gen, dev)
    cases = {}
    for T in (1, 2, 4, 8, 16):
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


# -- phase 4: the scan kernel -----------------------------------------------------


def scan_needles(lengths, rng) -> tuple[list[bytes], np.ndarray, np.ndarray]:
    """Needles of the given lengths from bytes 0x41..0xff (no zero byte,
    many >= 0x80) -> (needles, int32[8, 32] bytes, int32[8] lengths); rows
    past the needles are padding (length 0)."""
    needles = [bytes(rng.integers(0x41, 256, size=n, dtype=np.uint8)) for n in lengths]
    padded = np.zeros((8, 32), np.int32)
    lens = np.zeros(8, np.int32)
    for r, nd in enumerate(needles):
        padded[r, : len(nd)] = np.frombuffer(nd, np.uint8)
        lens[r] = len(nd)
    return needles, padded, lens


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


def scan_case(ks, rows32, needles, lens, n_real, *, starts=None, seg_chunks=0,
              max_words=9, label="", time_it=True, reps=25, plain_reps=3) -> dict:
    """Hold one scan launch against its plain version (bit-identical) and,
    with ``time_it``, time both between CUDA events."""
    def kernel(_i=0):
        if starts is None:
            return ks.byte_scan_stream(rows32, needles, lens, n_real=n_real, max_words=max_words)
        return ks.byte_scan_segments(rows32, starts, needles, lens, n_real=n_real,
                                     max_words=max_words, seg_chunks=seg_chunks)

    got = kernel()
    want = plain_scan(ks, rows32, needles, lens, n_real, starts, seg_chunks)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"scan {label}: kernel disagrees with plain version")
    G = got.shape[1] * 32
    real_lens = [int(v) for v in lens[:n_real]]
    hits = popcounts(got)
    bound_ms, bound_by = scan_bound(G, real_lens, hits)
    case = {"G": G, "n_real": n_real, "max_abs_err": 0, "hits": hits,
            "bound_ms": bound_ms, "bound_by": bound_by, "out": got}
    if not time_it:
        log(f"scan {label} G={G} n_real={n_real}: bit-identical")
        return case
    case["ms"] = event_ms(kernel, reps, hide_host=True)
    case["plain_ms"] = event_ms(
        lambda i: plain_scan(ks, rows32, needles, lens, n_real, starts, seg_chunks),
        plain_reps, hide_host=True)
    log(f"scan {label} G={G} n_real={n_real} lens={real_lens}: kernel_ms={case['ms']:.6f} "
        f"plain_ms={case['plain_ms']:.6f} bound_ms={bound_ms:.6f} ({bound_by}) "
        f"hits={hits} bit-identical")
    return case


def phase_scan_kernel(dev, G: int = 4096, seg_rows: int = 81_920) -> None:
    """K2 against its plain version: dense at n_real in {1, 2, 4, 8} over G
    random chunks with planted needles, padding rows, the 479/480 boundary
    against a bytes oracle, and segments at n_segs in {1, 2, 4} with a
    clamped last segment and one ending at the stream's end."""
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
        scan_case(ks, rows, pad_s, lens_s, n_real, label=f"dense short[:{n_real}]",
                  max_words=ks.scan_word_bucket(int(lens_s[:n_real].max())))
    # Two real rows (31, 32 bytes) and two padding rows, which match every
    # chunk and leave the real rows alone.
    case = scan_case(ks, rows, pad_l, lens_l, 4, label="dense long + 2 padding rows",
                     time_it=False)
    if case["hits"][2:] != [G, G]:
        raise AssertionError(f"padding rows hit {case['hits'][2:]} of {G} chunks")
    for r, nd in enumerate(short + long_):
        pad, lens, row = (pad_s, lens_s, r) if r < 8 else (pad_l, lens_l, r - 8)
        got = ks.byte_scan_stream(rows, pad, lens, n_real=8 if r < 8 else 4, max_words=9)
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

    # Segments of SEG_CHUNKS over a larger stream: the 15-byte needle with
    # seven padding rows (the engine's sparse launch) and eight needles.
    big = torch.randint(-(1 << 31), 1 << 31, (seg_rows, 128), device=dev, dtype=torch.int64)
    big = big.to(torch.int32)
    starts_by_n = {1: [5_000], 2: [0, seg_rows - 1_000],  # the second one clamps
                   4: [3 * SEG_CHUNKS, 100, seg_rows - SEG_CHUNKS, seg_rows]}
    one = np.zeros_like(pad_s)
    one[0] = pad_s[7]
    lens_one = np.array([lens_s[7]] + [0] * 7, np.int32)
    for n_segs, starts in starts_by_n.items():
        scan_case(ks, big, one, lens_one, 8, starts=starts, seg_chunks=SEG_CHUNKS,
                  max_words=ks.scan_word_bucket(int(lens_s[7])),
                  label=f"segments n_segs={n_segs} 1 needle + 7 padding",
                  time_it=n_segs == 4)
        scan_case(ks, big, pad_s, lens_s, 8, starts=starts, seg_chunks=SEG_CHUNKS,
                  label=f"segments n_segs={n_segs} 8 needles", time_it=False)
    del big, rows, edge_rows
    torch.cuda.empty_cache()


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


def start_refscale_dataset(target_mb: int, seed: int) -> subprocess.Popen:
    """Generate the dataset in a child process (host work), so the kernel
    phases run on the card meanwhile; ``refscale_dataset`` then finds it
    cached. The caller waits for the child, or kills it."""
    here = os.path.dirname(os.path.abspath(__file__))
    code = (f"import sys; sys.path.insert(0, {here!r}); import chip_smoke; "
            f"chip_smoke.refscale_dataset({int(target_mb)}, {int(seed)})")
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


def add_common_shapes(engine, shapes: dict) -> None:
    """A common word under a partition prefilter (the words of one known
    row: every row carries a unique uid token) and an 18-term OR."""
    import bloomsearch_tpu_torch as bt
    from bloomsearch_tpu_torch import perf

    q = bt.new_query
    _, sample = timed(engine, q().token("u00000000").build())
    if len(sample) != 1:
        raise AssertionError(f"uid u00000000 matched {len(sample)} rows")
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
        config(device=str(dev), probe_backend="device", bank_cache_bytes=6 << 30),
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
    """Wraps the row cache's two scan wrappers to keep, for each launch
    shape (the key of ``kernels.scan.launch_shapes()``), the arguments of
    its first launch, so the shape can be re-checked on the resident
    stream with the engine's own needles and segment starts."""

    def __init__(self):
        import bloomsearch_tpu_torch.rowcache as rc

        self.rc = rc
        self.orig = {name: getattr(rc, name) for name in SCAN_MODES}
        self.args: dict[tuple, dict] = {}
        self.lock = threading.Lock()

    def _keep(self, key: tuple, **args) -> None:
        with self.lock:
            if key not in self.args:
                self.args[key] = {k: np.array(v, copy=True) if isinstance(v, (np.ndarray, list))
                                  else v for k, v in args.items()}

    def __enter__(self):
        orig = self.orig

        def stream(rows32, needles, lens, *, n_real, max_words):
            out = orig["byte_scan_stream"](rows32, needles, lens, n_real=n_real,
                                           max_words=max_words)
            self._keep(("stream", rows32.shape[0], n_real, 0, 0, max_words),
                       needles=needles, lens=lens, n_real=n_real, max_words=max_words)
            return out

        def segments(rows32, seg_starts, needles, lens, *, n_real, max_words, seg_chunks):
            out = orig["byte_scan_segments"](rows32, seg_starts, needles, lens, n_real=n_real,
                                             max_words=max_words, seg_chunks=seg_chunks)
            key = ("segments", len(seg_starts) * seg_chunks, n_real, len(seg_starts),
                   seg_chunks, max_words)
            self._keep(key, starts=list(seg_starts), needles=needles, lens=lens,
                       n_real=n_real, max_words=max_words, seg_chunks=seg_chunks)
            return out

        self.rc.byte_scan_stream, self.rc.byte_scan_segments = stream, segments
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.rc, name, fn)


def recheck_scans(ks, matrix: torch.Tensor, launched: dict, recorded: dict) -> dict:
    """The scan kernel against its plain version on the resident stream at
    every shape the serving engine launched, with that shape's first
    launch's needles and starts; each mode's most launched shape is timed.
    Returns {launch counter: that shape's case}."""
    top = {}
    for key, n in launched.items():
        if n > launched.get(top.get(key[0]), 0):
            top[key[0]] = key
    reported = {}
    for key in sorted(launched):
        mode, G, n_real, n_segs, seg_chunks, max_words = key
        args = recorded[key]
        if mode == "stream" and G != matrix.shape[0]:
            raise AssertionError(f"dense launch over {G} rows; the stream now has "
                                 f"{matrix.shape[0]}")
        timed_shape = key == top[mode]
        case = scan_case(
            ks, matrix, args["needles"], args["lens"], n_real,
            starts=[int(s) for s in args["starts"]] if mode == "segments" else None,
            seg_chunks=seg_chunks, max_words=max_words, time_it=timed_shape,
            reps=25 if mode == "segments" else 10, plain_reps=3 if mode == "segments" else 1,
            label=f"main path {key} x{launched[key]}",
        )
        case.pop("out")
        if timed_shape:
            case["key"] = key
            reported[mode] = case
    return reported


def phase_serving(dev, target_mb: int, seed: int, reps: int = 7) -> dict:
    """Serving mode on the refscale dataset with bench.py's settings: every
    block pinned in the stream on the card, the needle cache off so warm
    queries scan; then the scan re-check on the resident stream and a
    restart that warms from the sidecar."""
    import bloomsearch_tpu_torch as bt
    from bloomsearch_tpu_torch.kernels import scan as ks

    cache = refscale_dataset(target_mb, seed)
    store = bt.FileSystemDataStore(cache)
    files = store.get_maybe_files_for_query(None)
    n_blocks = sum(len(mf.metadata.data_blocks) for mf in files)
    sidecar = tempfile.mkdtemp(prefix="bloomsearch-sidecar-")
    serving = dict(device=str(dev), probe_backend="device", bank_cache_bytes=6 << 30,
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
            run_concurrent(engine, shapes, results, out)
            out["launches"] = ks.launch_counts()
            launched = ks.launch_shapes()
        for counter in ("stream", "segments"):
            if out["launches"][counter] <= after_warmup[counter]:
                raise AssertionError(f"warm queries launched no {counter} scan: {out['launches']}")
        if dev.type == "cuda":
            out["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
        out["row_cache"] = engine.stats()["row_cache"]
        log(f"serving: scan launches {out['launches']}, row cache {out['row_cache']}, "
            f"max_memory_allocated {out.get('max_memory_allocated')}")
        log("serving launches per (mode, G, n_real, n_segs, seg_chunks, word bucket): "
            + json.dumps(sorted([list(k) + [n] for k, n in launched.items()])))
        with engine._row_cache._lock:
            matrix = engine._row_cache._bucket.matrix
        out["scan_cases"] = recheck_scans(ks, matrix, launched, recorder.args)
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
        for name in ("token", "field", "field_token", "or_tree"):
            if rowset(engine.query_sync(shapes[name], timeout=600)) != results[name]:
                raise AssertionError(f"restart: {name} rows differ")
        log(f"restart: warmup {out['restart_warmup_s']:.3f} s, {hits} sidecar hits, "
            f"needle rows equal")
    finally:
        if engine is not None:
            engine.stop(timeout=600)
        host.stop(timeout=600)
        shutil.rmtree(sidecar, ignore_errors=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--target-mb", type=int, default=1600,
                        help="refscale dataset size (the reference's 1.6 GB)")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        log("no CUDA device visible: this script measures the card and has no CPU mode")
        return 2
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    def done(phase: str) -> None:
        log(f"phase {phase} done at {time.perf_counter() - t_start:.1f} s")

    kind = phase_device()
    dataset = start_refscale_dataset(args.target_mb, args.seed)
    try:
        phase_build()
        done("build")
        cases = phase_kernel(dev)
        done("kernel")
        phase_scan_kernel(dev)
        done("scan kernel")
        if dataset.wait() != 0:
            raise RuntimeError(f"dataset generation exited with {dataset.returncode}")
        done("dataset")
    finally:
        if dataset.poll() is None:
            dataset.kill()
            dataset.wait()
    engine = phase_engine(dev, args.target_mb, args.seed)
    done("engine")
    launched = engine.pop("launch_shapes")
    log(json.dumps({"engine": engine}))
    log("main-path launches per (epilogue, C, T, output rows, clauses): "
        + json.dumps(sorted([list(k) + [n] for k, n in launched.items()])))
    main_cases = phase_main_shapes(dev, launched, cases)
    done("main-path shapes")
    kernels = []
    for name, (counter, replaces) in EPILOGUES.items():
        if counter not in main_cases:
            raise AssertionError(f"{name} was not launched on the main path")
        case = main_cases[counter]
        log(f"{name}: main-path shape {case['key']} reported")
        kernels.append({
            "name": name, "route": "cuda", "source": PROBE_SOURCE, "replaces": replaces,
            "launches": engine["launches"][counter], "max_abs_err": case["max_abs_err"],
            "ms": case["ms"], "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"], "library_ms": None,
        })
    serving = phase_serving(dev, args.target_mb, args.seed)
    done("serving engine")
    scan_cases = serving.pop("scan_cases")
    log(json.dumps({"serving": serving}))
    for name, (counter, replaces) in SCAN_MODES.items():
        if counter not in scan_cases:
            raise AssertionError(f"{name} was not launched on the serving path")
        case = scan_cases[counter]
        log(f"{name}: main-path shape {case['key']} reported")
        kernels.append({
            "name": name, "route": "cuda", "source": SCAN_SOURCE, "replaces": replaces,
            "launches": serving["launches"][counter], "max_abs_err": case["max_abs_err"],
            "ms": case["ms"], "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"], "library_ms": None,
        })
    for k in kernels:
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']} was not launched on the main path")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
