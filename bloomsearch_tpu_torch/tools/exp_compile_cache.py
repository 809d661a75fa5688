"""Experiment: what a kernel costs to build, and what a restart costs once it
is built. The port of ``scripts/exp_compile_cache.py``.

The JAX package compiled its kernels with ``jax.jit`` and kept the programs
in a persistent compilation cache; the question was whether a restart reads
them back instead of compiling. The port has no jit cache: each kernel
source under ``csrc/`` is compiled once by ``nvcc`` into a shared library
under ``_build/`` (``kernels/build.py``), which is reused while it is newer
than its source. Three numbers tell the same story:

 1. cold build: ``nvcc`` of each source, forced, into a temporary directory
    (the libraries in use are never touched);
 2. warm start: a fresh child process, where each library is newer than its
    source, loads it (``library()``: no nvcc) and runs its first launch;
    the CUDA context is made first and timed apart;
 3. warm launch: the next launch in that child.

Each launch is timed on the host clock up to ``torch.cuda.synchronize()``.
There is no CPU form: the tool raises when no card is visible.

Usage::

    python -m bloomsearch_tpu_torch.tools.exp_compile_cache
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

from ..kernels import build
from ..kernels import probe as pk
from ..kernels import scan as ks

PKG_PARENT = os.path.dirname(build.PKG_DIR)

# The child: make the CUDA context, then for each kernel library time its
# load, its first launch and a second launch; print one JSON line.
_CHILD = r"""
import json, os, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from bloomsearch_tpu_torch.kernels import probe as pk
from bloomsearch_tpu_torch.kernels import scan as ks

def synced(fn):
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0

out = {}
dev = torch.device("cuda", 0)
out["cuda_init_s"] = synced(lambda: torch.zeros(1, device=dev))
bank = torch.zeros((64, 512), dtype=torch.int32, device=dev)
rows = np.arange(8, dtype=np.int32)  # host probe arrays, in the launch's parameters
rows32 = torch.zeros((512, 128), dtype=torch.int32, device=dev)
needles = np.zeros((8, 32), np.int32)
needles[0, :4] = list(b"abcd")
lens = np.array([4, 0, 0, 0, 0, 0, 0, 0], np.int32)
launches = {
    "probe": (pk, lambda: pk.probe_and_pack(bank, rows, rows, 2, 4)),
    "scan": (ks, lambda: ks.byte_scan_stream(rows32, needles, lens, n_real=1)),
}
for name, (module, launch) in launches.items():
    mtime = os.path.getmtime(module.LIBRARY)
    out[name] = {
        "library_load_s": synced(module.library),
        "first_launch_s": synced(launch),
        "warm_launch_s": synced(launch),
        "rebuilt": os.path.getmtime(module.LIBRARY) != mtime,
    }
print(json.dumps(out))
"""

SOURCES = {"probe": pk, "scan": ks}


def log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def cold_builds(log=log) -> dict:
    """{kernel: seconds of a forced nvcc build of its source}, one at a
    time, into a temporary directory."""
    out = {}
    with tempfile.TemporaryDirectory(prefix="bloomsearch-nvcc-") as tmp:
        for name, module in SOURCES.items():
            library = os.path.join(tmp, os.path.basename(module.LIBRARY))
            t0 = time.perf_counter()
            build.build_library(module.SOURCE, library, force=True)
            out[name] = time.perf_counter() - t0
            log(f"{name}: cold nvcc build of {os.path.basename(module.SOURCE)} "
                f"{out[name]:.2f} s (host clock)")
    return out


def warm_start(log=log) -> dict:
    """Each library built if it is missing or older than its source (so the
    child finds it newer), then the child's readings."""
    for module in SOURCES.values():
        module.build_library()
    result = subprocess.run(
        [sys.executable, "-c", _CHILD, PKG_PARENT],
        capture_output=True, text=True, timeout=300,
    )
    if result.returncode != 0:
        raise RuntimeError(f"warm-start child failed:\n{result.stderr[-3000:]}")
    out = json.loads(result.stdout.strip().splitlines()[-1])
    log(f"warm start (child process): CUDA context {out['cuda_init_s']:.3f} s")
    for name in SOURCES:
        r = out[name]
        if r["rebuilt"]:
            raise AssertionError(f"{name}: the warm start rebuilt the library")
        log(f"{name}: library load {r['library_load_s'] * 1e3:.3f} ms, first launch "
            f"{r['first_launch_s'] * 1e3:.3f} ms, warm launch {r['warm_launch_s'] * 1e3:.3f} ms "
            f"(child process, host clock to synchronize; no nvcc)")
    return out


def measure(log=log) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible: the kernel build and its launches "
                           "need the card")
    return {"cold_build_s": cold_builds(log), "warm_start": warm_start(log)}


def main(argv=None) -> None:
    argparse.ArgumentParser(prog="bloomsearch_tpu_torch.tools.exp_compile_cache").parse_args(argv)
    print(json.dumps(measure()))


if __name__ == "__main__":
    main()
