"""Dataset CLI: bulk load JSON-lines and run searches from the shell.

    python -m bloomsearch_tpu_torch.cli load --dir /data/search logs1.jsonl logs2.jsonl
    python -m bloomsearch_tpu_torch.cli search --dir /data/search --token error \\
        --field-token svc:payment --regex 'msg=time\\d+out' --limit 20
    python -m bloomsearch_tpu_torch.cli merge --dir /data/search

The library API (README quickstart) is the primary surface; this is the
zero-code path for loading and poking at a dataset. ``--object-dir`` targets
a LocalDirObjectStore bucket instead of a plain directory. ``--device``
(default ``cuda``) is the engine's torch device: with no card visible the
engine refuses to start; ``--device cpu`` runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import bloomsearch_tpu_torch as bs


def _stores(args):
    if getattr(args, "object_dir", None):
        client = bs.LocalDirObjectStore(args.object_dir)
        return bs.ObjectStoreMetaStore(client), bs.ObjectStoreDataStore(client)
    store = bs.FileSystemDataStore(args.dir)
    return store, store


def _engine(args, **overrides):
    meta, data = _stores(args)
    config = bs.BloomSearchEngineConfig(
        probe_backend=getattr(args, "probe_backend", "auto"),
        device=getattr(args, "device", "cuda"), **overrides
    )
    engine = bs.BloomSearchEngine(config, meta, data)
    engine.start()
    return engine


def cmd_load(args) -> None:
    engine = _engine(
        args,
        block_bloom_expected_items="auto",
        max_buffered_rows=50_000,
        max_buffered_bytes=32 << 20,
    )
    total = 0
    t0 = time.perf_counter()
    try:
        for path in args.files:
            batch: list[bytes] = []
            fh = sys.stdin.buffer if path == "-" else open(path, "rb")
            try:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    batch.append(line)
                    if len(batch) >= 2000:
                        engine.ingest_serialized(batch, timeout=300)
                        total += len(batch)
                        batch = []
                if batch:
                    engine.ingest_serialized(batch, timeout=300)
                    total += len(batch)
            finally:
                if path != "-":
                    fh.close()
        engine.flush(timeout=600)
    finally:
        engine.stop(timeout=600)
    dt = time.perf_counter() - t0
    print(f"loaded {total} rows in {dt:.1f}s ({total / max(dt, 1e-9):,.0f} rows/s)")


def build_query(args) -> "bs.Query":
    builder = bs.new_query()
    for token in args.token or []:
        builder.token(token)
    for field in args.field or []:
        builder.field(field)
    for pair in args.field_token or []:
        field, _, token = pair.partition(":")
        if not token:
            raise SystemExit(f"--field-token wants FIELD:TOKEN, got {pair!r}")
        builder.field_token(field, token)
    for spec in args.regex or []:
        field, _, pattern = spec.partition("=")
        if not pattern:
            raise SystemExit(f"--regex wants FIELD=PATTERN, got {spec!r}")
        builder.field_regex(field, pattern)
    if args.partition:
        builder.match_prefilter(bs.partition(bs.partition_equals(args.partition)))
    return builder.build()


def cmd_search(args) -> None:
    engine = _engine(args)
    try:
        query = build_query(args)
        n = 0
        t0 = time.perf_counter()
        for row in engine.query_iter(query, timeout=args.timeout):
            print(json.dumps(row, separators=(",", ":")))
            n += 1
            if args.limit and n >= args.limit:
                break
        print(
            f"# {n} rows in {(time.perf_counter() - t0) * 1e3:.0f} ms",
            file=sys.stderr,
        )
    finally:
        engine.stop(timeout=60)


def cmd_merge(args) -> None:
    engine = _engine(args)
    try:
        stats = engine.merge()
        print(
            f"merged {stats.files_processed} files / {stats.row_groups_processed} "
            f"row groups / {stats.rows_processed} rows in {stats.duration:.1f}s"
        )
    finally:
        engine.stop(timeout=60)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="bloomsearch_tpu_torch.cli")
    sub = parser.add_subparsers(dest="command", required=True)

    def common(p):
        src = p.add_mutually_exclusive_group(required=True)
        src.add_argument("--dir")
        src.add_argument("--object-dir")
        p.add_argument("--probe-backend", default="auto")
        p.add_argument("--device", default="cuda")

    load = sub.add_parser("load", help="bulk load JSON-lines files ('-' = stdin)")
    common(load)
    load.add_argument("files", nargs="+")
    load.set_defaults(func=cmd_load)

    search = sub.add_parser("search", help="query a dataset")
    common(search)
    search.add_argument("--token", action="append")
    search.add_argument("--field", action="append")
    search.add_argument("--field-token", action="append", metavar="FIELD:TOKEN")
    search.add_argument("--regex", action="append", metavar="FIELD=PATTERN")
    search.add_argument("--partition", default=None)
    search.add_argument("--limit", type=int, default=0)
    search.add_argument("--timeout", type=float, default=300.0)
    search.set_defaults(func=cmd_search)

    merge = sub.add_parser("merge", help="compact the dataset")
    common(merge)
    merge.set_defaults(func=cmd_merge)

    args = parser.parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
