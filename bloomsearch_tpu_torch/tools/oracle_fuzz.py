"""The reference's oracle fuzz as episodes that drive an engine, or several in step.

The JAX package's ``tests/test_oracle_fuzz.py`` drives random operation
sequences (ingest rows, ingest non-canonical serialized JSON, flush, merge,
query) and holds every query to a naive oracle that keeps every row in
memory and evaluates it with the row-verification semantics
(``tokenizer.row_matches_query``). This module is that episode, written
once for both of its users: the port's CPU test, which drives the port's
engine and the JAX engine in step, and ``chip_smoke.py``'s query-language
phase, which drives the port on the card.

An episode is planned before it runs (``plan_episode``): the operations
and their rows and queries depend on the seed alone, so one plan drives
any number of engines (``run_episode``). The plan consumes the random
stream exactly as the reference's ``run_fuzz`` does (its three config
draws, then its steps and its final sweep), so a seed plans the rows and
queries the reference's case of that seed sees; the codec and the layout
it draws may be overridden (``EpisodeSettings``). Queries are planned as
package-neutral specs (``random_query``) and built by each engine's own
package (``build_query``); the JAX package is passed in, never imported
here.

``variant="long"`` plans rows the reference never makes: rows longer than
one 480-byte stream chunk, non-ASCII tokens, and tokens longer than the
row stream's 32-byte needle limit, queried as tokens and field tokens, and
last an OR of every token, wider than one probe launch.

``EscapeCounter`` counts, on a serving engine, the candidate rows that
only the row stream's always-candidate flags made (non-ASCII bytes,
``\\uXXXX`` and ``\\/`` escapes) and that verification then accepted: the
rows the scan bitmap alone would have lost.
"""

from __future__ import annotations

import dataclasses
import json
import random
import threading
from typing import Callable, Optional

import numpy as np

TIMEOUT = 60.0

WORDS = [
    "alpha", "bravo", "Charlie", "delta", "écho", "fox-7", "golf", "42",
    "true", "hotel india", "x", "",
]
FIELDS = ["svc", "msg", "level", "nested", "num", "arr"]

# The long variant's vocabulary: non-ASCII tokens and tokens longer than
# the row stream's 32-byte needle limit (rowcache.MAX_NEEDLE).
LONG_TOKEN = "supercalifragilisticexpialidocious-overlong-token-0042"
LONG_WORDS = WORDS[:-1] + [
    "straße", "日本語", "ñandú", "crème brûlée", LONG_TOKEN,
    "quantum-entanglement-observability-pipeline-x",
]
LONG_FILLER = ["lorem", "ipsum", "dolor", "sit", "amet", "consectetur", "adipiscing", "elit"]

BACKENDS = ("host", "device", "serving")


def random_row(rng: random.Random, i: int) -> dict:
    """The reference's ``random_row``, draw for draw."""
    row = {"id": i, "part": f"{rng.randrange(3)}"}
    for _ in range(rng.randrange(1, 4)):
        f = rng.choice(FIELDS)
        r = rng.random()
        if f == "nested" or r < 0.15:
            row["nested"] = {"inner": rng.choice(WORDS)}
        elif f == "arr" or r < 0.3:
            row["arr"] = [rng.choice(WORDS) for _ in range(rng.randrange(1, 3))]
        elif f == "num" or r < 0.45:
            row["num"] = rng.choice([rng.randrange(-50, 50), rng.uniform(-5, 5), 1e16])
        else:
            row[f] = " ".join(rng.choice(WORDS) for _ in range(rng.randrange(1, 3)))
    return row


def random_long_row(rng: random.Random, i: int) -> dict:
    """A row of the long variant: the reference's fields over LONG_WORDS,
    and in half the rows a ``msg`` of 500-1,500 bytes that spans two to
    four stream chunks with a word of LONG_WORDS somewhere inside it."""
    row = {"id": i, "part": f"{rng.randrange(3)}"}
    for _ in range(rng.randrange(1, 4)):
        f = rng.choice(FIELDS)
        if f == "nested":
            row["nested"] = {"inner": rng.choice(LONG_WORDS)}
        elif f == "arr":
            row["arr"] = [rng.choice(LONG_WORDS) for _ in range(rng.randrange(1, 3))]
        elif f == "num":
            row["num"] = rng.choice([rng.randrange(-50, 50), rng.uniform(-5, 5)])
        else:
            row[f] = " ".join(rng.choice(LONG_WORDS) for _ in range(rng.randrange(1, 3)))
    if rng.random() < 0.5:
        words = [rng.choice(LONG_FILLER) for _ in range(rng.randrange(80, 250))]
        words.insert(rng.randrange(len(words) + 1), rng.choice(LONG_WORDS))
        row["msg"] = " ".join(words)
    return row


# A query spec: {"calls": [call, ...], "minmax": bool}, the calls made in
# order on ``new_query()``. A call is ("token", t), ("field_token", f, t),
# ("match", expr), ("field_regex", f, pattern), ("partition_in", values)
# or ("min_max", field, lo, hi); an expr is ("token", t), ("field", f),
# ("field_token", f, t), ("or", [expr...]) or ("and", [expr...]).


def random_query(rng: random.Random) -> dict:
    """The reference's ``random_query``, draw for draw, as a spec."""
    kind = rng.random()

    def random_token():
        tokens = rng.choice(WORDS).lower().split()
        return ("token", tokens[0] if tokens else "alpha")

    leaf_makers = [
        random_token,
        lambda: ("field", rng.choice(["svc", "msg", "nested.inner", "arr", "num", "absent"])),
        lambda: ("field_token", rng.choice(["svc", "msg", "nested.inner"]),
                 rng.choice(["alpha", "bravo", "charlie", "zzz"])),
    ]

    def leaf():
        return rng.choice(leaf_makers)()

    calls: list = []
    if kind < 0.4:
        calls.append(("token", rng.choice(["alpha", "bravo", "charlie", "écho", "42", "true", "zzz"])))
    elif kind < 0.6:
        first = leaf()
        calls.append(("match", ("or", [first, ("and", [leaf(), leaf()])])))
    elif kind < 0.8:
        calls.append(("field_token", "svc", rng.choice(["alpha", "bravo", "x"])))
        calls.append(("token", rng.choice(["alpha", "delta", "golf"])))
    else:
        calls.append(("match", ("or", [leaf(), leaf(), leaf()])))
    return _prefilters(rng, calls)


def _prefilters(rng: random.Random, calls: list) -> dict:
    if rng.random() < 0.3:
        field = rng.choice(["msg", "svc", "nested.inner"])
        calls.append(("field_regex", field, rng.choice(["^al", "a.*a", "7$", "zzz"])))
    if rng.random() < 0.25:
        calls.append(("partition_in", ("0", "1")))
    minmax = rng.random() < 0.25
    if minmax:
        calls.append(("min_max", "num", -10, 20))
    return {"calls": calls, "minmax": minmax}


def random_long_query(rng: random.Random) -> dict:
    """A query of the long variant: its tokens (the overlong one and the
    non-ASCII ones among them) as tokens, field tokens over the fields that
    hold long messages, and OR/AND trees of them."""
    tokens = sorted({t for w in LONG_WORDS for t in w.lower().split()} | {"zzz"})

    def leaf():
        pick = rng.random()
        if pick < 0.4:
            return ("token", rng.choice(tokens))
        if pick < 0.8:
            return ("field_token", rng.choice(["msg", "svc", "nested.inner", "arr"]),
                    rng.choice(tokens))
        return ("field", rng.choice(["msg", "nested.inner", "arr", "num"]))

    kind = rng.random()
    calls: list = []
    if kind < 0.3:
        calls.append(("field_token", "msg", rng.choice([LONG_TOKEN, "straße", "日本語", "ñandú"])))
    elif kind < 0.6:
        calls.append(("match", ("or", [leaf(), ("and", [leaf(), leaf()])])))
    elif kind < 0.8:
        calls.append(("token", rng.choice(tokens)))
    else:
        calls.append(("match", ("or", [leaf(), leaf(), leaf()])))
    return _prefilters(rng, calls)


def _expr(pkg, spec):
    kind = spec[0]
    if kind == "token":
        return pkg.token(spec[1])
    if kind == "field":
        return pkg.field(spec[1])
    if kind == "field_token":
        return pkg.field_token(spec[1], spec[2])
    children = [_expr(pkg, child) for child in spec[1]]
    return pkg.or_(*children) if kind == "or" else pkg.and_(*children)


def build_query(pkg, spec: dict):
    """The spec as ``pkg``'s query (the port's or the JAX package's)."""
    q = pkg.new_query()
    for call in spec["calls"]:
        kind = call[0]
        if kind == "token":
            q.token(call[1])
        elif kind == "field_token":
            q.field_token(call[1], call[2])
        elif kind == "match":
            q.match(_expr(pkg, call[1]))
        elif kind == "field_regex":
            q.field_regex(call[1], call[2])
        elif kind == "partition_in":
            q.match_prefilter(pkg.partition(pkg.partition_in(*call[1])))
        elif kind == "min_max":
            q.match_prefilter(pkg.min_max(call[1], pkg.numeric_between(call[2], call[3])))
        else:
            raise ValueError(f"unknown query call {call!r}")
    return q.build()


def weird_json(rng: random.Random, value) -> str:
    """The reference's ``_weird_json``, draw for draw: valid but
    non-canonical JSON (\\uXXXX escapes of printable ASCII, an escaped
    solidus, "1e2"-style numbers), the spellings whose bytes need not hold
    their tokens (``scan.py`` rows_canonical and ``_numeric_unsafe``)."""
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        pick = rng.random()
        if pick < 0.25:
            return f"{value}e0"
        if pick < 0.5:
            return f"{value}.0"
        return str(value)
    if isinstance(value, float):
        if rng.random() < 0.4:
            return f"{value:.6e}"
        return repr(value)
    if isinstance(value, str):
        out = ['"']
        for ch in value:
            o = ord(ch)
            if ch in '"\\':
                out.append("\\" + ch)
            elif o < 0x20:
                out.append(f"\\u{o:04x}")
            elif ch == "/" and rng.random() < 0.5:
                out.append("\\/")
            elif o < 128 and ch.isalpha() and rng.random() < 0.15:
                out.append(f"\\u{o:04x}")
            elif o >= 128:
                out.append(json.dumps(ch)[1:-1])
            else:
                out.append(ch)
        out.append('"')
        return "".join(out)
    if isinstance(value, dict):
        return "{" + ",".join(
            f"{weird_json(rng, k)}:{weird_json(rng, v)}" for k, v in value.items()) + "}"
    if isinstance(value, list):
        return "[" + ",".join(weird_json(rng, v) for v in value) + "]"
    raise TypeError(f"unserializable fuzz value: {value!r}")


@dataclasses.dataclass
class Episode:
    """One planned episode: the reference's three config draws and its
    operations. An op is ("rows", batch), ("serialized", payloads, part,
    parsed rows), ("merge",) or ("query", spec, label); an ingest op is
    followed by a flush."""

    seed: int
    compression: str
    max_buffered_rows: int
    layout: str
    ops: list


def plan_episode(seed: int, serialized_frac: float = 0.0, variant: str = "reference",
                 steps: int = 12, final_queries: int = 8) -> Episode:
    """Plan the reference's ``run_fuzz(seed, serialized_frac)`` episode."""
    rng = random.Random(seed)
    row_of, query_of = ((random_row, random_query) if variant == "reference"
                        else (random_long_row, random_long_query))
    compression = rng.choice(["none", "zstd", "snappy"])
    max_buffered_rows = rng.choice([50, 1000])
    layout = rng.choice(["classic", "blocked256"])
    ops: list = []
    next_id = 0
    have_rows = False
    for step in range(steps):
        op = rng.random()
        if op < 0.5 or not have_rows:
            batch = [row_of(rng, next_id + j) for j in range(rng.randrange(5, 40))]
            next_id += len(batch)
            have_rows = True
            if rng.random() < serialized_frac:
                part = f"{rng.randrange(3)}"
                for r in batch:
                    r["part"] = part
                payload = [weird_json(rng, r).encode("utf-8") for r in batch]
                ops.append(("serialized", payload, part, [json.loads(b) for b in payload]))
            else:
                ops.append(("rows", batch))
        elif op < 0.65:
            ops.append(("merge",))
        else:
            ops.append(("query", query_of(rng), f"seed={seed} step={step}"))
    ops.append(("merge",))
    for _ in range(final_queries):
        ops.append(("query", query_of(rng), f"seed={seed} final"))
    if variant != "reference":
        ops.append(("query", wide_or_query(), f"seed={seed} final wide OR"))
    return Episode(seed, compression, max_buffered_rows, layout, ops)


def wide_or_query() -> dict:
    """An OR of every token of the long variant: more terms than one probe
    launch takes (16), so the combiner splits it and packs each part."""
    tokens = sorted({t for w in LONG_WORDS for t in w.lower().split()} | {"zzz"})
    return {"calls": [("match", ("or", [("token", t) for t in tokens]))], "minmax": False}


@dataclasses.dataclass(frozen=True)
class EpisodeSettings:
    """How an engine runs an episode. ``compression`` and ``layout`` None
    keep the episode's own draws; ``extra`` holds further config fields
    (``device``, ``mesh_devices``)."""

    backend: str = "host"
    store: str = "fs"
    compression: Optional[str] = None
    layout: Optional[str] = None
    extra: tuple = ()


def engine_config(pkg, episode: Episode, settings: EpisodeSettings):
    """The reference's config for the episode, in ``pkg``."""
    if settings.backend not in BACKENDS:
        raise ValueError(f"unknown backend {settings.backend!r}")
    serving = settings.backend == "serving"
    return pkg.BloomSearchEngineConfig(
        row_data_compression=settings.compression or episode.compression,
        partition_func=lambda r: r["part"],
        min_max_indexes=["num"],
        probe_backend="device" if serving else settings.backend,
        row_cache_bytes=(64 << 20) if serving else 0,
        max_buffered_rows=episode.max_buffered_rows,
        bloom_layout=settings.layout or episode.layout,
        **dict(settings.extra),
    )


def open_engine(pkg, episode: Episode, settings: EpisodeSettings, directory: str):
    """A started engine over a new store (a directory, or an in-memory
    object store)."""
    if settings.store == "fs":
        meta = data = pkg.FileSystemDataStore(directory)
    elif settings.store == "object":
        client = pkg.InMemoryObjectStore()
        data, meta = pkg.ObjectStoreDataStore(client), pkg.ObjectStoreMetaStore(client)
    else:
        raise ValueError(f"unknown store {settings.store!r}")
    engine = pkg.BloomSearchEngine(engine_config(pkg, episode, settings), meta, data)
    engine.start()
    return engine


def oracle_ids(rows: list[dict], query, apply_prefilter: bool = True) -> list[int]:
    """Ids of the rows the port's row-verification semantics match, as the
    reference's ``oracle_results``: the bloom tree and the regex, and with
    ``apply_prefilter`` the partition and minmax conditions row by row."""
    from ..minmax import MinMaxIndex, convert_to_min_max_int64
    from ..query import evaluate_data_block_metadata
    from ..tokenizer import basic_whitespace_lower_tokenizer, compile_regex_query, row_matches_query

    compiled = compile_regex_query(query.regex)
    out = []
    for row in rows:
        if apply_prefilter:
            class Meta:
                partition_id = row.get("part", "")
                min_max_indexes = {}

            bounds = convert_to_min_max_int64(row.get("num")) if "num" in row else None
            if bounds is not None:
                Meta.min_max_indexes = {"num": MinMaxIndex(*bounds)}
            if not evaluate_data_block_metadata(Meta, query.prefilter):
                continue
        parsed = json.loads(json.dumps(row))
        if row_matches_query(parsed, query.bloom, compiled, ".", basic_whitespace_lower_tokenizer):
            out.append(row["id"])
    return sorted(out)


def check_against_oracle(got: list[int], rows: list[dict], query, minmax: bool,
                         label: str) -> None:
    """The reference's ``_check``: equal to the oracle, or with a minmax
    prefilter (block-granular in the engine) between the oracle with the
    per-row prefilter and the oracle without it."""
    if minmax:
        lower = set(oracle_ids(rows, query, apply_prefilter=True))
        upper = set(oracle_ids(rows, query, apply_prefilter=False))
        if not lower <= set(got):
            raise AssertionError(f"{label}: FALSE NEGATIVES {sorted(lower - set(got))}")
        if not set(got) <= upper:
            raise AssertionError(f"{label}: impossible rows {sorted(set(got) - upper)}")
        if len(got) != len(set(got)):
            raise AssertionError(f"{label}: a row returned twice")
    else:
        expected = oracle_ids(rows, query)
        if got != expected:
            raise AssertionError(f"{label}: engine {got} != oracle {expected}")


def _port():
    import bloomsearch_tpu_torch

    return bloomsearch_tpu_torch


def multiset(rows) -> list[str]:
    return sorted(json.dumps(r, sort_keys=True) for r in rows)


@dataclasses.dataclass
class Target:
    """An engine an episode drives: its package, which builds its queries,
    and whether it serves (its background pins drain after each query)."""

    name: str
    pkg: object
    engine: object
    serving: bool = False


def run_episode(targets: list[Target], episode: Episode,
                on_query: Optional[Callable] = None, threads: int = 0) -> dict:
    """Drive every target through the episode in step. Each query's rows
    must equal the oracle (``check_against_oracle``, with the port's
    semantics) on every target, and be the same row multiset on every
    target. ``on_query(spec, query_of, rows_of, all_rows)`` may add checks;
    it gets each target's query and rows by name. With ``threads``, each
    target then runs the final sweep's queries again from that many
    threads at once, each held to the oracle (``concurrent_sweep``). ->
    counts of the episode."""
    all_rows: list[dict] = []
    counts = {"queries": 0, "minmax_queries": 0, "rows": 0, "merges": 0, "flushes": 0}
    for op in episode.ops:
        kind = op[0]
        if kind in ("rows", "serialized"):
            for t in targets:
                if kind == "rows":
                    t.engine.ingest_rows(op[1], timeout=TIMEOUT)
                else:
                    t.engine.ingest_serialized(op[1], timeout=TIMEOUT, partition_id=op[2])
                t.engine.flush(timeout=TIMEOUT)
            all_rows.extend(op[1] if kind == "rows" else op[3])
            counts["rows"] += len(op[1])
            counts["flushes"] += 1
        elif kind == "merge":
            for t in targets:
                t.engine.merge()
            counts["merges"] += 1
        else:
            spec, label = op[1], op[2]
            query_of, rows_of = {}, {}
            for t in targets:
                query_of[t.name] = build_query(t.pkg, spec)
                rows_of[t.name] = t.engine.query_sync(query_of[t.name], timeout=TIMEOUT)
                if t.serving:
                    t.engine.drain_background_pins(timeout=TIMEOUT)
            oracle_query = build_query(_port(), spec)
            first = targets[0].name
            for t in targets:
                got = sorted(r["id"] for r in rows_of[t.name])
                check_against_oracle(got, all_rows, oracle_query, spec["minmax"],
                                     f"{t.name} {label}")
                if multiset(rows_of[t.name]) != multiset(rows_of[first]):
                    raise AssertionError(f"{label}: {t.name}'s rows differ from {first}'s")
            if on_query is not None:
                on_query(spec, query_of, rows_of, all_rows)
            counts["queries"] += 1
            counts["minmax_queries"] += int(spec["minmax"])
    if threads:
        final = [op[1] for op in episode.ops[len(episode.ops) - _final_queries(episode):]]
        for t in targets:
            counts["concurrent_queries"] = concurrent_sweep(t, final, all_rows, threads)
    return counts


def _final_queries(episode: Episode) -> int:
    n = 0
    for op in reversed(episode.ops):
        if op[0] != "query":
            return n
        n += 1
    return n


def concurrent_sweep(target: Target, specs: list[dict], rows: list[dict], threads: int) -> int:
    """Every spec from each of ``threads`` threads at once (the probe and
    scan combiners then batch queries together), each answer held to the
    oracle. -> queries run."""
    errors: list[BaseException] = []
    oracle_query = [build_query(_port(), spec) for spec in specs]

    def worker(tid: int) -> None:
        try:
            for i in range(len(specs)):
                j = (tid + i) % len(specs)
                got = target.engine.query_sync(build_query(target.pkg, specs[j]), timeout=TIMEOUT)
                check_against_oracle(sorted(r["id"] for r in got), rows, oracle_query[j],
                                     specs[j]["minmax"], f"{target.name} thread {tid}")
        except BaseException as exc:  # re-raised by the caller
            errors.append(exc)

    pool = [threading.Thread(target=worker, args=(t,)) for t in range(threads)]
    for t in pool:
        t.start()
    for t in pool:
        t.join()
    if errors:
        raise errors[0]
    if target.serving:
        target.engine.drain_background_pins(timeout=TIMEOUT)
    return threads * len(specs)


class EscapeCounter:
    """Count the rows of a serving engine that only the row stream's
    always-candidate flags made candidates and that verification accepted.

    ``DeviceRowCache.scan_many`` ORs each pinned block's flags into the
    scan's per-needle bitmap (``scan_bitmaps``); this keeps each block's
    bitmap from before the OR, and where the engine evaluates the query
    plan over the ORed bitmap (``scan.evaluate_plan``) it evaluates the
    plan over the kernel's bitmap too. A row candidate by the first and not
    by the second is an escape; ``after_query(rows)`` counts the escapes
    among the query's rows. Install with ``with EscapeCounter(engine):``."""

    def __init__(self, engine):
        self.engine = engine
        self.flag_only = 0  # escape candidates, accepted or not
        self.accepted = 0
        self._pending: list[int] = []
        self._bitmaps: dict[int, tuple] = {}
        self._lock = threading.Lock()
        self._local = threading.local()

    def __enter__(self):
        from .. import scan as scan_mod

        cache = self.engine._row_cache
        if cache is None:
            raise ValueError("EscapeCounter needs a serving engine")
        original_bitmaps = cache.scan_bitmaps
        original_many = type(cache).scan_many
        original_plan = scan_mod.evaluate_plan
        counter = self

        def scan_bitmaps(blocks, needles):
            out = original_bitmaps(blocks, needles)
            counter._local.raw = {b.key: (out[b.key].copy(), b) for b in blocks}
            return out

        def scan_many(blocks, needles):
            out = original_many(cache, blocks, needles)
            raw = counter._local.__dict__.pop("raw", {})
            with counter._lock:
                for key, mat in out.items():
                    counter._bitmaps[id(mat)] = (mat,) + raw[key]
            return out

        def evaluate_plan(plan, scanned, n_rows, trust_numeric=False):
            mask = original_plan(plan, scanned, n_rows, trust_numeric)
            with counter._lock:
                entry = counter._bitmaps.get(id(scanned))
            if entry is not None and entry[0] is scanned:
                _, raw, block = entry
                only = np.nonzero(mask & ~original_plan(plan, raw, n_rows, trust_numeric))[0]
                if only.size:
                    counter._note(block, only)
            return mask

        self._restore = (cache, original_plan)
        cache.scan_bitmaps = scan_bitmaps
        cache.scan_many = scan_many
        scan_mod.evaluate_plan = evaluate_plan
        return self

    def __exit__(self, *exc):
        from .. import scan as scan_mod

        cache, original_plan = self._restore
        del cache.scan_bitmaps, cache.scan_many
        scan_mod.evaluate_plan = original_plan
        return False

    def _note(self, block, idx: np.ndarray) -> None:
        if block.data is not None:
            data, offsets, lengths = block.data, block.row_offsets, block.row_lengths
        else:
            data, offsets, lengths = block.fetch_rows(idx)
            idx = np.arange(offsets.shape[0])
        ids = []
        for i in idx.tolist():
            payload = bytes(data[int(offsets[i]): int(offsets[i]) + int(lengths[i])])
            ids.append(json.loads(payload)["id"])
        with self._lock:
            self.flag_only += len(ids)
            self._pending.extend(ids)

    def after_query(self, rows: list[dict]) -> int:
        """Count the query's accepted escapes; -> how many it had."""
        with self._lock:
            pending, self._pending = self._pending, []
            self._bitmaps.clear()
        got = {r["id"] for r in rows}
        n = sum(1 for i in pending if i in got)
        self.accepted += n
        return n
