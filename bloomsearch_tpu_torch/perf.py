"""End-to-end performance harness.

Modeled on the reference's performance test methodology
(bloom_tree_engine_performance_test.go): ``generate`` writes a synthetic
dataset of random JSON rows — 1-5 random keys, string-or-array values,
random ``00``-``09`` partitions (:30-33, :486-516) plus planted needle rows;
``inspect`` dumps the file/block/partition layout (:198-260); ``query`` runs
needle field / token / field:token searches and reports wall time, rows/s
and bytes/s over all candidate rows, per-worker peaks, and selectivity
(:263-473) — the numbers PERFORMANCE.md reports for the Go engine.

Usage::

    python -m bloomsearch_tpu_torch.perf generate --dir /tmp/perf --target-mb 200
    python -m bloomsearch_tpu_torch.perf inspect  --dir /tmp/perf
    python -m bloomsearch_tpu_torch.perf query    --dir /tmp/perf

``--device`` (default ``cuda``) is the engine's torch device; with no card
visible the engine refuses to start. ``--device cpu`` runs the kernels'
plain versions.
"""

from __future__ import annotations

import argparse
import json
import queue
import random
import string
import sys
import time
from typing import Optional, Sequence

from .engine import BlockStats, BloomSearchEngine, BloomSearchEngineConfig
from .stores import FileSystemDataStore
from .utils import format_bytes_per_second, format_rate
from . import query as q

NEEDLE_FIELD = "needle_field_xq"
NEEDLE_TOKEN = "needletoken7q9z"
NEEDLE_FT_FIELD = "service_zz"
NEEDLE_FT_TOKEN = "ftneedle3k1x"


def _random_value(rng: random.Random) -> object:
    if rng.random() < 0.2:
        return [
            "".join(rng.choices(string.ascii_lowercase, k=rng.randrange(3, 10)))
            for _ in range(rng.randrange(1, 4))
        ]
    words = [
        "".join(rng.choices(string.ascii_lowercase + string.digits, k=rng.randrange(3, 12)))
        for _ in range(rng.randrange(1, 6))
    ]
    return " ".join(words)


def _random_row(rng: random.Random) -> dict:
    row = {}
    for _ in range(rng.randrange(1, 6)):
        key = "".join(rng.choices(string.ascii_lowercase, k=rng.randrange(4, 10)))
        row[key] = _random_value(rng)
    row["part"] = f"{rng.randrange(10):02d}"
    return row


def _engine(args, **overrides) -> tuple[BloomSearchEngine, FileSystemDataStore]:
    store = FileSystemDataStore(args.dir)
    config = BloomSearchEngineConfig(
        row_data_compression=args.compression,
        partition_func=lambda row: row.get("part", ""),
        max_query_concurrency=args.concurrency,
        probe_backend=args.probe_backend,
        bloom_layout=args.layout,
        block_bloom_expected_items=args.block_items,
        device=args.device,
        **overrides,
    )
    engine = BloomSearchEngine(config, store, store)
    engine.start()
    return engine, store


def cmd_generate(args) -> None:
    # Large ingest buffers so files end up at realistic sizes (the defaults
    # flush every 1000 rows, which would produce thousands of tiny files).
    engine, store = _engine(
        args,
        max_buffered_rows=100_000,
        max_buffered_bytes=64 * 1024 * 1024,
        max_buffered_time=3600.0,
    )
    rng = random.Random(args.seed)
    target = args.target_mb * 1024 * 1024
    written = 0
    rows_written = 0
    needles_planted = 0
    t0 = time.perf_counter()
    try:
        while written < target:
            batch = [_random_row(rng) for _ in range(1000)]
            # Plant a handful of needle rows across the dataset.
            if needles_planted < 5 and rng.random() < 0.02:
                batch.append(
                    {
                        NEEDLE_FIELD: "present",
                        "message": f"alpha {NEEDLE_TOKEN} omega",
                        NEEDLE_FT_FIELD: f"value {NEEDLE_FT_TOKEN}",
                        "part": f"{rng.randrange(10):02d}",
                    }
                )
                needles_planted += 1
            engine.ingest_rows(batch, timeout=60)
            written += sum(len(json.dumps(r)) for r in batch)
            rows_written += len(batch)
            if rows_written % 50_000 < 1000:
                elapsed = time.perf_counter() - t0
                print(
                    f"  {rows_written} rows, {written / 1e6:.0f} MB, "
                    f"{format_rate(rows_written / elapsed)} rows/s",
                    file=sys.stderr,
                )
        # Ensure at least one needle row exists.
        if needles_planted == 0:
            engine.ingest_rows(
                [
                    {
                        NEEDLE_FIELD: "present",
                        "message": f"alpha {NEEDLE_TOKEN} omega",
                        NEEDLE_FT_FIELD: f"value {NEEDLE_FT_TOKEN}",
                        "part": "00",
                    }
                ],
                timeout=60,
            )
            needles_planted = 1
        engine.flush(timeout=300)
    finally:
        engine.stop(timeout=300)
    elapsed = time.perf_counter() - t0
    # stderr: the bench imports this and owns stdout (ONE JSON line).
    print(
        f"generated {rows_written} rows / {written / 1e6:.0f} MB "
        f"({needles_planted} needles) in {elapsed:.1f}s "
        f"({format_rate(rows_written / elapsed)} rows/s, "
        f"{format_bytes_per_second(written / elapsed)})",
        file=sys.stderr,
    )


def generate_fast(
    directory: str,
    target_mb: int,
    seed: int = 0,
    compression: Optional[str] = None,
    block_items: Optional[int | str] = None,
    log=lambda msg: print(msg, file=sys.stderr),
) -> dict:
    """Reference-shaped dataset at ingest speed (the refscale generator).

    Produces the shape AND physical layout of the reference's synthetic
    benchmark data (bloom_tree_engine_performance_test.go:14-60, :486-516):
    rows with 1-5 random keys and 1-5-word random string values,
    ``00``-``09`` partitions, 10 MB / up-to-1M-row row groups, 200 MB
    buffered flushes, block blooms sized by the 1M-row cap — plus planted
    needle rows. Rows are pre-serialized JSON bytes assembled from key/word
    pools with numpy-drawn randomness (each row still carries a unique hex
    token, so per-block token cardinality stays reference-like) and ingest
    through the serialized fast lane with explicit partition routing —
    what makes an 11M-row dataset practical to build inside a bench run.
    """
    import random as _random

    import numpy as np

    from .engine import _default_compression

    if compression is None:
        compression = _default_compression()
    rng = _random.Random(seed)
    np_rng = np.random.default_rng(seed)
    keys = [
        "".join(rng.choices(string.ascii_lowercase, k=rng.randrange(4, 10)))
        for _ in range(1 << 14)
    ]
    words = [
        "".join(rng.choices(string.ascii_lowercase + string.digits, k=rng.randrange(3, 12)))
        for _ in range(1 << 15)
    ]

    store = FileSystemDataStore(directory)
    # Physical layout = the reference perf harness config (:35-45): the
    # 10 MB row-group byte cap shapes blocks (~70k rows each), the 200 MB
    # buffer shapes files (~10 blocks each), and block blooms are sized by
    # max_row_group_rows=1M like the reference — NOT saturated, unlike the
    # defaults on high-cardinality data.
    config = BloomSearchEngineConfig(
        row_data_compression=compression,
        # Generation only ingests and flushes: no probe backend, no card.
        probe_backend="host",
        block_bloom_expected_items=block_items,
        max_row_group_bytes=10 * 1024 * 1024,
        max_row_group_rows=1_000_000,
        max_buffered_rows=2_000_000,
        max_buffered_bytes=200 * 1024 * 1024,
        max_buffered_time=3600.0,
        max_file_size=100 * 1024 * 1024,
    )
    engine = BloomSearchEngine(config, store, store)
    engine.start()
    target = target_mb * 1024 * 1024
    written = 0
    rows_written = 0
    uid = 0
    BATCH = 4000
    # Template pool: 256k unique row prefixes (1-5 random keys, 1-5-word
    # values). Per-BLOCK (~70k rows) templates are ~95% distinct and every
    # row appends a unique uid token, so block-level key cardinality stays
    # reference-like; only whole-dataset reuse is reduced, which matters
    # only to the (already saturated) file-level filters.
    POOL = 1 << 18
    nks = np_rng.integers(1, 6, size=POOL)
    total_keys = int(nks.sum())
    kidx = np_rng.integers(0, len(keys), size=total_keys).tolist()
    nws = np_rng.integers(1, 6, size=total_keys).tolist()
    widx = np_rng.integers(0, len(words), size=int(sum(nws))).tolist()
    pool: list[bytes] = []
    ki = wi = 0
    for nk in nks.tolist():
        parts = ["{"]
        for _ in range(nk):
            nw = nws[ki]
            value = " ".join(words[w] for w in widx[wi : wi + nw])
            wi += nw
            parts.append(f'"{keys[kidx[ki]]}":"{value}",')
            ki += 1
        pool.append("".join(parts).encode())
    del nks, kidx, nws, widx

    t0 = time.perf_counter()
    try:
        while written < target:
            # One serialized batch per random partition (blocks are
            # per-partition, so batch-level partition draws keep the same
            # physical layout as per-row draws).
            part = f"{rng.randrange(10):02d}"
            tail = b'"uid":"u%08x","part":"' + part.encode() + b'"}'
            draws = np_rng.integers(0, POOL, size=BATCH).tolist()
            batch = [pool[t] + tail % (uid + j) for j, t in enumerate(draws)]
            uid += BATCH
            batch_bytes = sum(map(len, batch))
            engine.ingest_serialized(batch, timeout=600, partition_id=part)
            written += batch_bytes
            rows_written += len(batch)
            if rows_written % 1_000_000 < BATCH:
                elapsed = time.perf_counter() - t0
                log(
                    f"  {rows_written} rows, {written / 1e6:.0f} MB, "
                    f"{format_rate(rows_written / elapsed)} rows/s"
                )
        # Plant the needle rows (one per shape, in random partitions).
        for _ in range(3):
            part = f"{rng.randrange(10):02d}"
            needle = {
                NEEDLE_FIELD: "present",
                "message": f"alpha {NEEDLE_TOKEN} omega",
                NEEDLE_FT_FIELD: f"value {NEEDLE_FT_TOKEN}",
                "part": part,
            }
            engine.ingest_serialized(
                [json.dumps(needle, separators=(",", ":")).encode()],
                timeout=600,
                partition_id=part,
            )
            rows_written += 1
        engine.flush(timeout=1800)
    finally:
        engine.stop(timeout=1800)
    elapsed = time.perf_counter() - t0
    stats = {
        "rows": rows_written,
        "bytes": written,
        "seconds": round(elapsed, 1),
        "rows_per_sec": round(rows_written / elapsed),
    }
    log(
        f"generated {rows_written} rows / {written / 1e6:.0f} MB in {elapsed:.1f}s "
        f"({format_rate(rows_written / elapsed)} rows/s)"
    )
    return stats


def cmd_generate_fast(args) -> None:
    generate_fast(
        args.dir, args.target_mb, seed=args.seed,
        compression=args.compression, block_items=args.block_items,
    )


def measure_block_pipeline_scaling(
    worker_counts: Sequence[int] = (1, 2, 4, 8),
    n_blocks: int = 16,
    rows_per_block: int = 30_000,
    compression: str = "snappy",
    log=lambda msg: print(msg, file=sys.stderr),
) -> dict[int, int]:
    """Block-pipeline rows/s at each worker count -> {workers: rows_per_sec}.

    The query stage's scaling claim made falsifiable: the fused native
    block pipeline (CRC + decompress + split + scan) releases the GIL, so a
    worker pool should scale near-linearly with cores. Builds reference-
    shaped compressed blocks in memory, then times a fixed batch of block
    tasks through ThreadPoolExecutors of each size. Worker counts above
    cpu_count are skipped (nothing to measure).
    """
    import os
    from concurrent.futures import ThreadPoolExecutor

    from . import native
    from .checksum import crc32c
    from .compression import StreamEncoder, compression_available

    if not native.available():
        raise RuntimeError("scaling harness requires the native library")
    if not compression_available(compression):
        compression = "none"

    rng = random.Random(7)
    words = [
        "".join(rng.choices(string.ascii_lowercase, k=rng.randrange(4, 10)))
        for _ in range(4096)
    ]
    blocks = []
    for b in range(n_blocks):
        enc = StreamEncoder(compression, 3)
        raw_len = 0
        for i in range(rows_per_block):
            row = json.dumps(
                {
                    "svc": words[(b * 31 + i) % 977],
                    "msg": " ".join(words[(i * 7 + j) % 4096] for j in range(6)),
                    "n": i,
                },
                separators=(",", ":"),
            ).encode()
            import struct as _struct

            framed = _struct.pack("<I", len(row)) + row
            enc.write(framed)
            raw_len += len(framed)
        compressed = enc.finish()
        blocks.append((compressed, crc32c(compressed), raw_len))

    def task(block):
        compressed, crc, raw_len = block
        res = native.process_block(compressed, compression, crc, raw_len, [b"needle"])
        assert res is not None

    cpu = os.cpu_count() or 1
    out: dict[int, int] = {}
    total_rows = n_blocks * rows_per_block
    reps = 4
    for w in worker_counts:
        if w > cpu:
            continue
        pool = ThreadPoolExecutor(w)
        try:
            list(pool.map(task, blocks))  # warm (page in, code paths)
            t0 = time.perf_counter()
            for _ in range(reps):
                list(pool.map(task, blocks))
            dt = time.perf_counter() - t0
        finally:
            pool.shutdown(wait=False)
        rate = round(reps * total_rows / dt)
        out[w] = rate
        log(f"  block pipeline @ {w} workers: {format_rate(rate)} rows/s")
    return out


def cmd_scaling(args) -> None:
    result = measure_block_pipeline_scaling(
        worker_counts=tuple(int(w) for w in args.workers.split(",")),
        compression=args.compression,
    )
    print(json.dumps(result))


def cmd_inspect(args) -> None:
    store = FileSystemDataStore(args.dir)
    files = store.get_maybe_files_for_query(None)
    total_rows = 0
    total_bytes = 0
    total_blocks = 0
    for i, mf in enumerate(files):
        blocks = mf.metadata.data_blocks
        rows = sum(b.rows for b in blocks)
        total_rows += rows
        total_bytes += mf.size
        total_blocks += len(blocks)
        partitions = sorted({b.partition_id for b in blocks})
        print(
            f"file {i}: {mf.size / 1e6:.1f} MB, {len(blocks)} blocks, {rows} rows, "
            f"partitions={partitions[:5]}{'...' if len(partitions) > 5 else ''} "
            f"bank_groups={len(mf.metadata.bank_groups)}"
        )
        if args.blocks:
            for b in blocks:
                print(
                    f"    block@{b.offset}: part={b.partition_id} rows={b.rows} "
                    f"size={b.size} ({b.compression}, {b.uncompressed_size} raw)"
                )
    print(
        f"total: {len(files)} files, {total_blocks} blocks, {total_rows} rows, "
        f"{total_bytes / 1e9:.2f} GB"
    )


def _run_one_query(engine, store, label: str, built_query) -> dict:
    result_q: queue.Queue = queue.Queue()
    error_q: queue.Queue = queue.Queue()
    stats_q: queue.Queue = queue.Queue(maxsize=100_000)
    t0 = time.perf_counter()
    engine.query(built_query, result_q, error_q, stats_q)
    results = []
    while True:
        item = result_q.get()
        if item is None:
            break
        results.append(item)
    wall = time.perf_counter() - t0
    if not error_q.empty():
        raise error_q.get_nowait()

    stats: list[BlockStats] = []
    while not stats_q.empty():
        stats.append(stats_q.get_nowait())
    candidate_rows = sum(s.total_rows for s in stats)
    candidate_bytes = sum(s.total_bytes for s in stats)
    skipped = sum(1 for s in stats if s.bloom_filter_skipped)
    processed = [s for s in stats if not s.bloom_filter_skipped]
    processed_rows = sum(s.rows_processed for s in processed)
    busy = sum(s.duration for s in processed)
    peak = max(
        (s.rows_processed / s.duration for s in processed if s.duration > 0),
        default=0.0,
    )
    out = {
        "label": label,
        "wall_ms": wall * 1e3,
        "results": len(results),
        "candidate_rows": candidate_rows,
        "candidate_bytes": candidate_bytes,
        "rows_per_sec": candidate_rows / wall if wall > 0 else 0.0,
        "bytes_per_sec": candidate_bytes / wall if wall > 0 else 0.0,
        "blocks_skipped_by_bloom": skipped,
        "blocks_processed": len(processed),
        "rows_decoded_or_scanned": processed_rows,
        "peak_worker_rows_per_sec": peak,
        "concurrency_factor": busy / wall if wall > 0 else 0.0,
        "selectivity_pct": 100.0 * len(results) / candidate_rows if candidate_rows else 0.0,
        # Breakdown for slow-query triage: time INSIDE block processing
        # (sum + max over blocks) vs the wall. wall >> block_busy means the
        # cost sits outside blocks — planning, bank probes, or launches
        # queued behind background device work (pins/compactions).
        "block_busy_ms": busy * 1e3,
        "block_max_ms": max((s.duration for s in processed), default=0.0) * 1e3,
    }
    # stderr: the bench imports this and owns stdout (ONE JSON line).
    print(
        f"{label:>14}: {out['wall_ms']:.0f} ms | {out['results']} results | "
        f"{format_rate(out['rows_per_sec'])} rows/s | "
        f"{format_bytes_per_second(out['bytes_per_sec'])} | "
        f"blocks {out['blocks_processed']} scanned / {skipped} bloom-skipped "
        f"(busy {out['block_busy_ms']:.0f} ms, max {out['block_max_ms']:.0f}) | "
        f"selectivity {out['selectivity_pct']:.4f}%",
        file=sys.stderr,
    )
    return out


def cmd_ingest(args) -> None:
    """Ingest throughput with flushes landing concurrently — the reference's
    'ingest during flush' metric (PERFORMANCE.md:105-126: zero flush impact
    because flushing happens on its own pipeline stage)."""
    engine, store = _engine(
        args,
        max_buffered_rows=20_000,  # frequent flushes while ingest continues
        max_buffered_bytes=16 * 1024 * 1024,
    )
    rng = random.Random(args.seed)
    t0 = time.perf_counter()
    rows_written = 0
    nbytes = 0
    try:
        while rows_written < args.rows:
            batch = [_random_row(rng) for _ in range(1000)]
            engine.ingest_rows(batch, timeout=60)
            rows_written += len(batch)
            nbytes += sum(len(json.dumps(r)) for r in batch)
        engine.flush(timeout=300)
    finally:
        engine.stop(timeout=300)
    elapsed = time.perf_counter() - t0
    files = len(store.get_maybe_files_for_query(None))
    print(
        f"ingested {rows_written} rows / {nbytes / 1e6:.0f} MB across {files} "
        f"flushed files in {elapsed:.1f}s ({format_rate(rows_written / elapsed)} rows/s, "
        f"{format_bytes_per_second(nbytes / elapsed)})"
    )


def cmd_query(args) -> None:
    engine, store = _engine(args)
    try:
        queries = [
            ("token", q.new_query().token(NEEDLE_TOKEN).build),
            ("field", q.new_query().field(NEEDLE_FIELD).build),
            (
                "field:token",
                q.new_query().field_token(NEEDLE_FT_FIELD, NEEDLE_FT_TOKEN).build,
            ),
        ]
        all_results = []
        for label, build in queries:
            for rep in range(args.repeat):
                result = _run_one_query(engine, store, f"{label}#{rep}", build())
                all_results.append(result)
        if args.json_out:
            with open(args.json_out, "w") as fh:
                json.dump(all_results, fh, indent=2)
    finally:
        engine.stop(timeout=60)


def _block_items(text: str):
    return text if text == "auto" else int(text)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="bloomsearch_tpu_torch.perf")
    sub = parser.add_subparsers(dest="command", required=True)

    def common(p):
        p.add_argument("--dir", required=True)
        p.add_argument("--compression", default=None)
        p.add_argument("--concurrency", type=int, default=100)
        p.add_argument("--probe-backend", default="auto")
        p.add_argument("--layout", default="classic", choices=["classic", "blocked256"])
        p.add_argument(
            "--block-items", type=_block_items, default=None,
            help="block bloom expected items: an int, or 'auto' to size from "
            "measured keys/row (default: rows-based reference sizing)",
        )
        p.add_argument(
            "--device", default="cuda",
            help="torch device of the probe backend (default cuda; raises when no "
            "card is visible — pass cpu for the plain versions)",
        )

    g = sub.add_parser("generate")
    common(g)
    g.add_argument("--target-mb", type=int, default=100)
    g.add_argument("--seed", type=int, default=0)
    g.set_defaults(func=cmd_generate)

    gf = sub.add_parser("generate-fast", help="reference-shaped data via the serialized fast lane")
    common(gf)
    gf.add_argument("--target-mb", type=int, default=1600)
    gf.add_argument("--seed", type=int, default=0)
    gf.set_defaults(func=cmd_generate_fast)

    i = sub.add_parser("inspect")
    common(i)
    i.add_argument("--blocks", action="store_true")
    i.set_defaults(func=cmd_inspect)

    qq = sub.add_parser("query")
    common(qq)
    qq.add_argument("--repeat", type=int, default=2)
    qq.add_argument("--json-out", default=None)
    qq.set_defaults(func=cmd_query)

    ing = sub.add_parser("ingest")
    common(ing)
    ing.add_argument("--rows", type=int, default=100_000)
    ing.add_argument("--seed", type=int, default=0)
    ing.set_defaults(func=cmd_ingest)

    sc = sub.add_parser(
        "scaling", help="block-pipeline rows/s at 1/2/4/8 workers (multicore hosts)"
    )
    sc.add_argument("--workers", default="1,2,4,8")
    sc.add_argument("--compression", default="snappy")
    sc.set_defaults(func=cmd_scaling)

    args = parser.parse_args(argv)
    if args.compression is None:
        from .engine import _default_compression

        args.compression = _default_compression()
    args.func(args)


if __name__ == "__main__":
    main()
