"""Experiment: the probe kernel's (K1) two build-time choices, each timed on
the card against its alternatives.

1. ``BLOCK_WARPS`` (``csrc/probe.cu``): the least number of warps a block
   holds where C allows. A block holds the T warps of ceil(BLOCK_WARPS / T)
   column words, so the choice moves small T only. Variants 1, 2, 4, 8, 16
   and 32; the source's is 4.
2. The parameter struct's capacities: the source launches T*K <= 256 probes
   with a 256-probe struct and larger ones with the 6,400-probe struct (32
   KB of parameters). The variant sets ``CAP_SMALL`` to ``CAP_MAX``: one 32
   KB struct for every launch.

Each variant is ``csrc/probe.cu`` with one ``#define`` rewritten, built by
``nvcc`` into a temporary directory (one process a variant, all at once),
and bound like the kernel library (``kernels.probe.bind``). At four shapes
(pack at the bench shape, R = 13,479, C = 32,768, T = 4; reduce-AND at T =
1, clauses at T = 3 and pack at T = 16 on the refscale bank, R = 1,347,900,
C = 256; k = 10) every variant's output must equal the plain version's.
Each launch is timed between CUDA events behind a spin kernel (device time
alone), the median of ``reps`` launches, each launch with fresh random rows
so they come from device memory; the variants run in turns, in their order
and then in reverse, so each has two times.

There is no CPU form: the tool raises when no card is visible.

Usage::

    python -m bloomsearch_tpu_torch.tools.exp_probe_variants [--reps 25]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..kernels import build
from ..kernels import probe as pk
from .timing import card, resolve_device

BLOCK_WARPS = (1, 2, 4, 8, 16, 32)
K = 10
SHAPES = (
    # (label, R, C, T, mode)
    ("pack, bench shape", 13_479, 32_768, 4, pk.MODE_PACK),
    ("reduce-AND, C = 256", 1_347_900, 256, 1, pk.MODE_REDUCE),
    ("clauses, C = 256", 1_347_900, 256, 3, pk.MODE_CLAUSES),
    ("pack, C = 256", 1_347_900, 256, 16, pk.MODE_PACK),
)
CLAUSES = [0b011, 0b110]  # two clauses of two terms; one member of both
MEMBERS = [0b11]


def log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def variant_sources() -> dict[str, str]:
    """{variant name: the text of csrc/probe.cu with one #define rewritten}."""
    with open(pk.SOURCE) as fh:
        text = fh.read()

    def rewrite(pattern: str, value: str) -> str:
        out, n = re.subn(rf"#define {pattern} \S+", f"#define {pattern} {value}", text)
        if n != 1:
            raise RuntimeError(f"csrc/probe.cu has no single #define {pattern}")
        return out

    sources = {f"block_warps={bw}": rewrite("BLOCK_WARPS", str(bw)) for bw in BLOCK_WARPS}
    sources["one 32 KB struct"] = rewrite("CAP_SMALL", "CAP_MAX")
    return sources


def build_variants(directory: str) -> dict:
    """Build every variant at once -> {name: bound library}."""
    sources = variant_sources()

    def one(i_name):
        i, name = i_name
        source = os.path.join(directory, f"probe{i}.cu")
        with open(source, "w") as fh:
            fh.write(sources[name])
        library = os.path.join(directory, f"libprobe{i}.so")
        build.build_library(source, library, force=True)
        return name, pk.bind(library)

    with ThreadPoolExecutor(len(sources)) as pool:
        return dict(pool.map(one, enumerate(sources)))


def launch(lib, bank: torch.Tensor, rows: np.ndarray, shifts: np.ndarray, T: int,
           mode: int) -> torch.Tensor:
    """One launch of a variant on the current stream: every term in the AND,
    or the clauses ``CLAUSES`` and members ``MEMBERS``."""
    R, C = bank.shape
    out_rows = {pk.MODE_PACK: T, pk.MODE_REDUCE: 1}.get(mode, len(MEMBERS))
    clauses = (ctypes.c_uint32 * len(CLAUSES))(*CLAUSES)
    members = (ctypes.c_uint32 * len(MEMBERS))(*MEMBERS)
    n_clauses, n_members = (len(CLAUSES), len(MEMBERS)) if mode == pk.MODE_CLAUSES else (0, 0)
    out = torch.empty((out_rows, C // 32), dtype=torch.int32, device=bank.device)
    table = (ctypes.c_void_p * 1)(bank.data_ptr())
    err = lib.bs_probe_launch(
        table, 1, R, C, rows.ctypes.data, shifts.ctypes.data, T, K, mode,
        (1 << T) - 1, clauses, n_clauses, members, n_members, out.data_ptr(), C // 32, 0, 0,
        bank.device.index, torch.cuda.current_stream(bank.device).cuda_stream)
    if err:
        raise RuntimeError(f"probe variant launch failed: cudaError {err}")
    return out


def plain(bank: torch.Tensor, rows: np.ndarray, shifts: np.ndarray, T: int,
          mode: int) -> torch.Tensor:
    """The plain version of ``launch``'s epilogue on the bank's device."""
    match = pk.probe_plain(bank, torch.from_numpy(rows).to(bank.device),
                           torch.from_numpy(shifts).to(bank.device), T, K)
    if mode == pk.MODE_REDUCE:
        match = pk.reduce_and_plain(match, (1 << T) - 1)
    elif mode == pk.MODE_CLAUSES:
        match = pk.clauses_plain(match, CLAUSES, MEMBERS)
    return pk.pack_bitmap_plain(match)


def device_ms(fn, reps: int) -> float:
    """Median ms of ``fn(i)`` for i < reps between CUDA events, each behind
    a spin kernel that keeps the stream busy while the host enqueues it."""
    times = []
    for i in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn(i)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def random_bank(rows: int, cols: int, gen: torch.Generator, device) -> torch.Tensor:
    words = torch.randint(0, 1 << 32, (rows, cols), generator=gen, device=device,
                          dtype=torch.int64)
    return (words - (1 << 31)).to(torch.int32)


def measure(device="cuda", reps: int = 25, seed: int = 0, log=log) -> dict:
    """Every variant at every shape -> {shape label: {variant: [ms, ms]}}."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("the probe variants run on the card only")
    log(f"device {torch.cuda.get_device_name(device)}; nvidia-smi: {card()}")
    gen = torch.Generator(device=device).manual_seed(seed)
    rng = np.random.default_rng(seed)
    result = {}
    with tempfile.TemporaryDirectory(prefix="bloomsearch-probe-variants-") as tmp, \
            torch.cuda.device(device):
        t0 = time.perf_counter()
        libs = build_variants(tmp)
        log(f"built {len(libs)} variants of csrc/probe.cu in {time.perf_counter() - t0:.1f} s")
        order = list(libs) + list(libs)[::-1]
        for label, R, C, T, mode in SHAPES:
            bank = random_bank(R, C, gen, device)
            sets = [(rng.integers(0, R, T * K).astype(np.int32),
                     rng.integers(0, 32, T * K).astype(np.int32))
                    for _ in range(len(order) * reps)]
            want = plain(bank, *sets[0], T, mode)
            times = {name: [] for name in libs}
            for run, name in enumerate(order):
                if not torch.equal(launch(libs[name], bank, *sets[0], T, mode), want):
                    raise AssertionError(f"{label}: variant {name} differs from the plain "
                                         "version")
                times[name].append(device_ms(
                    lambda i, o=run * reps, lib=libs[name]: launch(lib, bank, *sets[o + i],
                                                                   T, mode), reps))
            key = f"{label} (R = {R}, T = {T}, k = {K})"
            result[key] = times
            log(f"{key}: " + ", ".join(f"{name} {t[0]:.6f}/{t[1]:.6f} ms"
                                       for name, t in times.items()))
            del bank
            torch.cuda.empty_cache()
    return result


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="bloomsearch_tpu_torch.tools.exp_probe_variants")
    parser.add_argument("--device", default="cuda", help="a CUDA device (no CPU form)")
    parser.add_argument("--reps", type=int, default=25)
    args = parser.parse_args(argv)
    print(json.dumps(measure(args.device, args.reps)))


if __name__ == "__main__":
    main()
