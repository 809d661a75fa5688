"""Chained-launch timing: a kernel's time per launch as the slope between a
short and a long chain of launches.

The JAX package timed its kernels with a ``lax.scan`` of N launches behind an
``optimization_barrier``, compiled into one program (``bench.py:959-986``,
``scripts/exp_kernel_floor.py:71-100``). Here each chain is captured once in
a CUDA graph, each launch with its own probe arrays (host arrays that the
capture keeps in that launch's parameters), and the graph is replayed
between CUDA events; a chain's time is the best of ``reps`` replays. Launches
on one stream run one after another, so a chain's launches never overlap,
and a replay enqueues the whole chain at once, so the host's launch cost
(tens of microseconds a launch through ctypes) stays out of the slope. The
per-launch time is (long chain - short chain) / (N_long - N_short).

The chains are probe launches (``kernels/probe.py``), captured through its
``CapturedLaunches``: a capture runs nothing and counts nothing, and each
replay counts the launches it runs.

On a CPU device the same chains run the plain versions eagerly, timed with
``time.perf_counter``, so the tools run in the tests.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable

import torch

from ..kernels.probe import CapturedLaunches


def chain_ms(launch: Callable[[int], object], n: int, device, reps: int = 7) -> float:
    """Best time in ms of ``launch(0) ... launch(n - 1)`` back to back."""
    device = torch.device(device)
    best = float("inf")
    if device.type != "cuda":
        for _ in range(reps):
            t0 = time.perf_counter()
            for i in range(n):
                launch(i)
            best = min(best, (time.perf_counter() - t0) * 1e3)
        return best
    with torch.cuda.device(device):
        # Build, load and warm the kernel outside the capture: loading a
        # module while a stream captures is refused.
        launch(0)
        torch.cuda.synchronize(device)

        def record() -> None:
            for i in range(n):
                launch(i)

        chain = CapturedLaunches(record, device)
        chain.replay()
        torch.cuda.synchronize(device)
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            chain.replay()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end))
        del chain
    return best


def chain_slope(launch: Callable[[int], object], device, n_small: int, n_large: int,
                reps: int = 7) -> dict:
    """Per-launch ms as the slope between chains of ``n_small`` and
    ``n_large`` launches, with both chains' times."""
    small = chain_ms(launch, n_small, device, reps)
    large = chain_ms(launch, n_large, device, reps)
    return {"per_launch_ms": (large - small) / (n_large - n_small),
            "small_ms": small, "large_ms": large, "n_small": n_small, "n_large": n_large}


def event_ms(fn: Callable[[], object], device, reps: int = 7) -> float:
    """Median time in ms of single calls of ``fn``: between CUDA events on a
    CUDA device, by ``time.perf_counter`` on the CPU (after one warm call)."""
    device = torch.device(device)
    fn()
    times = []
    if device.type != "cuda":
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    else:
        with torch.cuda.device(device):
            torch.cuda.synchronize(device)
            for _ in range(reps):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
    return statistics.median(times)


def resolve_device(device) -> torch.device:
    """``device`` as a torch device; a CUDA device with no card visible
    raises (the tools measure the card and never fall back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} asked for but no CUDA device is visible; "
                           "pass --device cpu for the plain versions")
    return device


def card() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
