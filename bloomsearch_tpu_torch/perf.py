"""Reference-shaped dataset generator (the refscale dataset) and its needles.

``generate_fast`` writes the shape and physical layout of the reference's
synthetic benchmark data (bloom_tree_engine_performance_test.go:14-60,
:486-516) through the serialized ingest lane, plus planted needle rows that
the needle queries find: one row per needle shape, three in all.
"""

from __future__ import annotations

import json
import string
import sys
import time
from typing import Optional

from .engine import BloomSearchEngine, BloomSearchEngineConfig
from .stores import FileSystemDataStore
from .utils import format_rate

NEEDLE_FIELD = "needle_field_xq"
NEEDLE_TOKEN = "needletoken7q9z"
NEEDLE_FT_FIELD = "service_zz"
NEEDLE_FT_TOKEN = "ftneedle3k1x"


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
