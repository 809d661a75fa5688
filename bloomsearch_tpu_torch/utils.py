"""Small shared helpers.

Mirrors the reference's utils.go:9-40 (`FormatRate`, `FormatBytesPerSecond`)
plus the Go-`%v`-style stringification contract that the tokenizer and row
verification both depend on (reference tokenizer.go:79, :98, :374).
"""

from __future__ import annotations

import math
from typing import Any

INT64_MIN = -(2**63)
INT64_MAX = 2**63 - 1


def go_like_str(value: Any) -> str:
    """Stringify a primitive the way the whole engine expects.

    The reference uses Go's ``fmt.Sprintf("%v", value)`` to turn non-string
    primitives into indexable/searchable strings (tokenizer.go:79, :98).  What
    matters for correctness is *internal consistency*: the same value must
    stringify identically at ingest time and at row-verification time.  Rules:

    - ``bool`` -> ``"true"`` / ``"false"`` (Go style, not Python's True/False)
    - ``int`` -> decimal digits
    - ``float`` -> shortest round-trip repr, with a trailing ``.0`` stripped so
      integral floats render like Go's ``%v`` (``25.0`` -> ``"25"``)
    - everything else -> ``str(value)``
    """
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, float):
        if math.isinf(value):
            return "+Inf" if value > 0 else "-Inf"
        if math.isnan(value):
            return "NaN"
        text = repr(value)
        if text.endswith(".0"):
            text = text[:-2]
        return text
    return str(value)


def format_rate(rate: float) -> str:
    """Format a rows/sec style rate with K/M/B suffixes (utils.go:9-24)."""
    if rate >= 1e9:
        return f"{rate / 1e9:.2f}B"
    if rate >= 1e6:
        return f"{rate / 1e6:.2f}M"
    if rate >= 1e3:
        return f"{rate / 1e3:.2f}K"
    return f"{rate:.2f}"


def format_bytes_per_second(bytes_per_sec: float) -> str:
    """Format a bytes/sec rate with KB/MB/GB suffixes (utils.go:26-40)."""
    if bytes_per_sec >= 1 << 30:
        return f"{bytes_per_sec / (1 << 30):.2f} GB/s"
    if bytes_per_sec >= 1 << 20:
        return f"{bytes_per_sec / (1 << 20):.2f} MB/s"
    if bytes_per_sec >= 1 << 10:
        return f"{bytes_per_sec / (1 << 10):.2f} KB/s"
    return f"{bytes_per_sec:.2f} B/s"


def clamp_int64(value: int) -> int:
    """Clamp an unbounded Python int into int64 range for format fidelity."""
    return max(INT64_MIN, min(INT64_MAX, value))


def collect_query_sync(query_fn, q, timeout: float | None = None) -> list:
    """Drain a streaming query synchronously; raise its first error.

    ``query_fn(q, result_queue, error_queue)`` is any of the engine's
    streaming query entry points (BloomSearchEngine.query, RemoteQueryPeer
    .query, ScatterGatherCoordinator.query — all share the rows-then-None
    sentinel contract). THE one copy of the drain loop: three hand-copied
    versions predictably drifted."""
    import queue as _queue
    import time as _time

    result_queue: _queue.Queue = _queue.Queue()
    error_queue: _queue.Queue = _queue.Queue()
    query_fn(q, result_queue, error_queue)
    rows: list = []
    deadline = None if timeout is None else _time.monotonic() + timeout
    while True:
        remaining = (
            None if deadline is None else max(0.0, deadline - _time.monotonic())
        )
        item = result_queue.get(timeout=remaining)
        if item is None:
            break
        rows.append(item)
    try:
        raise error_queue.get_nowait()
    except _queue.Empty:
        pass
    return rows


# Tombstoned files a cache remembers (``remember``): late background work
# on a file (a bank warm, a row pin) is a few queued jobs, far below this.
TOMBSTONE_MEMORY = 4096


def remember(recent: dict, key) -> None:
    """Add ``key`` to an insertion-ordered set (a dict of None values) of
    at most ``TOMBSTONE_MEMORY`` keys, dropping the oldest."""
    recent[key] = None
    if len(recent) > TOMBSTONE_MEMORY:
        del recent[next(iter(recent))]
