"""Pre-generate the bench's dataset caches: refscale (1.6 GB) and xlscale
(8 GB) by default, xxlscale (~30 GB raw) when named.

Host work only: generation ingests and flushes with the host probe backend
and needs no card. Writes the same cache paths and seeds that
``bloomsearch_tpu_torch.bench`` reads (``bench.dataset_cache``), so a bench
run reuses them instead of paying generation time; the bench's xxlscale
phase is skipped until its cache exists. Safe to re-run: completed caches
(GENERATION_COMPLETE marker) are left alone.

Usage: python -m bloomsearch_tpu_torch.tools.gen_bench_datasets
           [refscale|xlscale|xxlscale ...] [--target-mb N]
"""

import argparse
import sys
import time

from .. import bench


def log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="bloomsearch_tpu_torch.tools.gen_bench_datasets")
    parser.add_argument("names", nargs="*", choices=sorted(bench.DATASETS),
                        help="datasets to generate (default refscale and xlscale)")
    parser.add_argument("--target-mb", type=int, default=None,
                        help="size of each named dataset (default its own)")
    args = parser.parse_args(argv)
    for name in args.names or ("refscale", "xlscale"):
        t0 = time.perf_counter()
        cache = bench.ensure_dataset(name, args.target_mb, log=log)
        log(f"{name}: {cache} ready after {time.perf_counter() - t0:.0f}s")


if __name__ == "__main__":
    main()
