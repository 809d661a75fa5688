#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

Usage, from the repository root:

    python3 chip_smoke.py [--target-mb 1600] [--seed 0]

Phases, in order; any failure raises and the script exits non-zero:

1. device: the card's name and power limit (nvidia-smi), the torch device,
   and the port's native host library (g++ builds it at first use);
2. build: the probe kernel library, compiled with nvcc for sm_90a;
3. kernel: the block-bloom probe kernel in its three epilogues against its
   plain PyTorch version on the card at the refscale bank's width for every
   padded term count T in {1, 2, 4, 8, 16}, bit-identical, with CUDA-event
   times beside the memory bound;
4. engine: the refscale-shaped dataset (generated from the seed and cached
   under ~/.cache), a BloomSearchEngine on device="cuda" that warms every
   bank group onto the card, the needle queries, an OR tree, a common token
   under a partition prefilter and 16 threads of mixed queries, each result
   checked against a host-probe engine on the same files. The kernel launch
   counters are reset just before this phase and must show that the warm
   queries went through the kernel;
5. main-path shapes: the kernel against its plain version at every shape
   (C, T, members, clauses) the engine phase launched and phase 3 did not
   cover; each epilogue's most launched shape is timed and reported.

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
import threading
import time

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
INT32_OPS_PER_S = 67e12  # H100 SXM non-tensor-core 32-bit rate
REFSCALE_ROWS = 1_347_900  # 3 keyspaces x 449,300 words (1M items, FPR 0.001)
BENCH_ROWS = 13_479  # 3 x 4,493 words (10,000 items, FPR 0.001)
K = 10
PROBE_SOURCE = "bloomsearch_tpu_torch/csrc/probe.cu"
PALLAS = "bloomsearch_tpu/bloom/pallas_kernels.py"
EPILOGUES = {
    # name: (launch counter, TPU function it replaces)
    "probe_and_pack": ("pack", f"{PALLAS}:153"),
    "probe_reduce_and_pack": ("reduce_and", f"{PALLAS}:177"),
    "probe_clauses_pack": ("clauses", f"{PALLAS}:205"),
}


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
    from bloomsearch_tpu_torch.kernels import probe as pk

    t0 = time.perf_counter()
    report = pk.build_library(force=True)
    seconds = time.perf_counter() - t0
    pk.library()
    regs = [line.strip() for line in report.splitlines() if "registers" in line]
    log(f"build: {PROBE_SOURCE} with nvcc sm_90a in {seconds:.2f} s; {regs}")


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


# -- phase 4 ------------------------------------------------------------------


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


def phase_engine(dev, target_mb: int, seed: int, reps: int = 7) -> dict:
    import bloomsearch_tpu_torch as bt
    from bloomsearch_tpu_torch import perf
    from bloomsearch_tpu_torch.kernels import probe as pk

    cache = refscale_dataset(target_mb, seed)
    store = bt.FileSystemDataStore(cache)
    files = store.get_maybe_files_for_query(None)
    blocks = [b for mf in files for b in mf.metadata.data_blocks]
    log(f"dataset: {sum(b.rows for b in blocks)} rows, {len(files)} files, "
        f"{len(blocks)} blocks, target {target_mb} MB")

    def config(**kw):
        return bt.BloomSearchEngineConfig(
            row_data_compression="snappy", max_row_group_bytes=10 * 1024 * 1024,
            max_row_group_rows=1_000_000, max_query_concurrency=100, **kw,
        )

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

        q = bt.new_query
        shapes = {
            "token": q().token(perf.NEEDLE_TOKEN).build(),
            "field": q().field(perf.NEEDLE_FIELD).build(),
            "field_token": q().field_token(perf.NEEDLE_FT_FIELD, perf.NEEDLE_FT_TOKEN).build(),
            "or_tree": q().match(bt.or_(
                bt.token(perf.NEEDLE_TOKEN),
                bt.and_(bt.field(perf.NEEDLE_FIELD), bt.token("absentword0q")),
                bt.field_token(perf.NEEDLE_FT_FIELD, perf.NEEDLE_FT_TOKEN),
            )).build(),
        }
        out["first_query_ms"], first = timed(engine, shapes["token"])
        # A common word under a partition prefilter: take the words of one
        # known row (every row carries a unique uid token).
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

        results = {}
        for name, query in shapes.items():
            times = []
            for _ in range(reps):
                ms, rows = timed(engine, query)
                times.append(ms)
            want = rowset(host.query_sync(query, timeout=600))
            if rowset(rows) != want:
                raise AssertionError(f"{name}: device-probe rows differ from host-probe rows")
            if name != "partition_common" and len(rows) != 3:
                raise AssertionError(f"{name}: {len(rows)} rows, want the 3 planted needles")
            if name == "partition_common" and not rows:
                raise AssertionError(f"partition_common ({word!r}) found no rows")
            results[name] = want
            out[f"warm_p50_ms_{name}"] = statistics.median(times)
            log(f"query {name}: {len(rows)} rows = host probe; warm p50 "
                f"{statistics.median(times):.3f} ms over {reps}")
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

        # 16 threads of mixed queries: the cross-query launch combiner.
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
        stats = backend.stats()
        out["superbank_bytes"] = stats["superbank_bytes"]
        out["probe_launches"] = stats["probe_launches"]
        out["probe_requests"] = stats["probe_requests"]
        if dev.type == "cuda":
            out["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
        out["launches"] = pk.launch_counts()
        out["launch_shapes"] = pk.launch_shapes()
        log(f"16 threads: {len(lat)} queries, p50 {out['concurrent16_p50_ms']:.3f} ms, "
            f"{out['concurrent16_qps']:.1f} qps; backend {stats['probe_launches']} launches "
            f"for {stats['probe_requests']} requests")
        log(f"superbank {out['superbank_bytes']} bytes, max_memory_allocated "
            f"{out.get('max_memory_allocated')}, kernel launches {out['launches']}")
    finally:
        engine.stop(timeout=600)
        host.stop(timeout=600)
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
    kind = phase_device()
    phase_build()
    cases = phase_kernel(dev)
    engine = phase_engine(dev, args.target_mb, args.seed)
    launched = engine.pop("launch_shapes")
    log(json.dumps({"engine": engine}))
    log("main-path launches per (epilogue, C, T, output rows, clauses): "
        + json.dumps(sorted([list(k) + [n] for k, n in launched.items()])))
    main_cases = phase_main_shapes(dev, launched, cases)
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
    for k in kernels:
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']} was not launched on the main path")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
