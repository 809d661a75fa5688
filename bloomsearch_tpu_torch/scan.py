"""Candidate row scanning: substring pre-filter before exact verification.

The reference's block hot loop parses and verifies EVERY row of a surviving
block with gjson (bloom_tree_engine.go:1156-1194) — that scan is its query
bottleneck. Here, a sound necessary-condition pre-filter runs first: a row
can only match

- a TOKEN / FIELD_TOKEN condition if the token's bytes appear in the row
  (tokens are whitespace-delimited substrings of the value, and values are
  stored verbatim in the row JSON), and
- a FIELD condition if its last path segment appears as a JSON key
  (``"seg"`` quoted — colon omitted since serialized ingest may carry legal
  whitespace before it),

so a multi-needle case-insensitive substring scan (native C++ memmem over a
lowercased copy) yields a per-condition row bitmask, the bloom AND/OR tree
evaluates over those bitmasks, and only candidate rows get JSON-parsed and
exactly verified. Zero false negatives by construction:

- needles that could be altered by JSON string escaping (containing ``"``,
  ``\\``, control bytes, or any non-ASCII — json.dumps escapes non-ASCII)
  are declared unusable and their condition conservatively matches all rows;
- rows whose stored bytes can't prove a needle's absence — any byte >= 0x80
  (Unicode lowercase may be pure ASCII: U+212A -> 'k') or a ``\\uXXXX`` /
  ``\\/`` escape (may hide printable-ASCII needle bytes, e.g. serialized
  ingest carrying ``\\u003c`` for '<') — are candidates for every needle;
- hits spanning row boundaries mark both rows;
- regex conditions never pre-filter (their field guard already pruned blocks).

False positives are fine — the exact row verification stage still runs.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from . import native
from .query import (
    BloomConditionType,
    BloomExpression,
    BloomQuery,
    bloom_query_conditions,
)
from .bloom.probe import evaluate_match_expression


def _usable_needle(text: str) -> bool:
    if not text:
        return False
    for ch in text:
        code = ord(ch)
        if code < 0x20 or code > 0x7E:  # control or non-ASCII
            return False
        if ch in ('"', "\\"):
            return False
    return True


def regex_mandatory_literal(pattern: str) -> Optional[str]:
    """The longest literal substring every match of ``pattern`` must contain.

    Walks the top level of the parsed pattern: every item of a top-level
    concatenation is mandatory, so any contiguous LITERAL run there is a
    necessary substring of any match. Anything else (branches, classes,
    repeats, anchors, groups) just breaks the run — never unsound, only
    less selective. Returns a lowercased needle (the scan lowers both
    sides) of length >= 2, or None.
    """
    try:
        import re._constants as sre_c
        import re._parser as sre_p

        parsed = sre_p.parse(pattern)
    except Exception:
        return None
    best = ""
    run: list[str] = []

    def flush():
        nonlocal best
        if len(run) > len(best):
            best = "".join(run)
        run.clear()

    for op, arg in parsed:
        if op is sre_c.LITERAL and isinstance(arg, int) and 0x20 <= arg <= 0x7E:
            run.append(chr(arg))
        else:
            flush()
    flush()
    best = best.lower()
    return best if len(best) >= 2 and _usable_needle(best) else None


def regex_scan_query(regex_query) -> Optional[BloomQuery]:
    """Mirror a regex tree as pseudo-TOKEN scan conditions over each
    pattern's mandatory literal (regex conditions otherwise never
    pre-filter, so regex-only queries JSON-parse every row of surviving
    blocks). Conditions without an extractable literal become nil
    (always-true) leaves; the AND/OR shape is preserved, so the mask is a
    sound necessary condition for the regex stage. FOR SCANNING ONLY —
    these pseudo conditions are not bloom keys.
    """
    from .query import (
        BloomCondition,
        BloomExprType,
        RegexExprType,
    )

    if regex_query is None or regex_query.expression is None:
        return None

    def visit(expr) -> BloomExpression:
        if expr.expression_type == RegexExprType.CONDITION:
            literal = (
                regex_mandatory_literal(expr.condition.pattern)
                if expr.condition is not None
                else None
            )
            if literal is None:
                return BloomExpression(BloomExprType.CONDITION, condition=None)  # nil: true
            return BloomExpression(
                BloomExprType.CONDITION,
                condition=BloomCondition(BloomConditionType.TOKEN, token=literal),
            )
        kind = (
            BloomExprType.AND
            if expr.expression_type == RegexExprType.AND
            else BloomExprType.OR
        )
        return BloomExpression(kind, children=[visit(c) for c in expr.children])

    return BloomQuery(visit(regex_query.expression))


_NUMERIC_CHARS = frozenset("0123456789.eE+-")


def _numeric_unsafe(token: str) -> bool:
    """Could ``token``'s bytes be absent from a row that MATCHES it?

    Number tokens derive from repr() of the PARSED value, so a row stored
    with a different-but-legal spelling ("1e5" for token "100000",
    "0.1999999999999999999" rounding to token "0.2") contains no needle
    bytes even though exact verification matches it. Such needles may only
    DISQUALIFY rows of blocks whose metadata attests canonical
    re-serialization (DataBlockMetadata.rows_canonical — the substring
    invariant is fuzz-tested for that path). Two conservative tests, both
    required:

    - float()-parseable: whole tokens that ARE a number's spelling — also
      catches "inf"/"nan" (verbatim bytes may spell "Infinity"/"NaN" while
      the token is "+inf"; Python's non-standard json.dumps emits those).
    - all chars in [0-9.eE+-]: regex mandatory literals are SUBSTRINGS of a
      value's stringification, so "e+25" (not float-parseable) must still
      not prune a verbatim block storing "15e24" — its canonical spelling
      "1.5e+25" matches the regex.
    """
    if not token:
        return False
    try:
        float(token)
        return True
    except ValueError:
        pass
    return all(c in _NUMERIC_CHARS for c in token)


class ScanPlan:
    """Per-query compiled needle set + expression over condition bitmasks."""

    __slots__ = (
        "expression", "conditions", "needles", "needle_index", "term_index",
        "numeric_unsafe",
    )

    def __init__(self, expression: BloomExpression, conditions, needles, needle_index):
        self.expression = expression
        self.conditions = conditions
        self.needles = needles  # list[bytes] for the usable conditions
        self.needle_index = needle_index  # condition idx -> needle row or None
        self.term_index = {
            (c.type, c.field, c.token): i for i, c in enumerate(conditions)
        }
        # Needle rows that must not disqualify non-canonical blocks.
        self.numeric_unsafe = [
            _numeric_unsafe(n.decode("ascii", "replace")) for n in needles
        ]


def compile_scan_plan(
    bloom_query: Optional[BloomQuery], delimiter: str = "."
) -> Optional[ScanPlan]:
    """Build a scan plan; None when scanning can't help (no usable needle
    or the native scanner is unavailable)."""
    if bloom_query is None or bloom_query.expression is None:
        return None
    if not native.available():
        return None
    conditions = bloom_query_conditions(bloom_query.expression)
    if not conditions:
        return None
    needles: list[bytes] = []
    needle_index: list[Optional[int]] = []
    seen: dict[bytes, int] = {}  # dedup: identical needles share one scan row
    for cond in conditions:
        needle: Optional[bytes] = None
        if cond.type in (BloomConditionType.TOKEN, BloomConditionType.FIELD_TOKEN):
            token_lower = cond.token.lower()
            # Non-finite stringifications ("+inf"/"-inf"/"nan") come from
            # Infinity/NaN literals whose raw bytes differ — never scannable.
            if _usable_needle(cond.token) and token_lower not in ("+inf", "-inf", "nan"):
                needle = token_lower.encode("ascii")
        elif cond.type == BloomConditionType.FIELD:
            segment = cond.field.split(delimiter)[-1]
            if _usable_needle(segment):
                # Quoted key WITHOUT the colon: ingest_serialized may carry
                # legal whitespace between key and colon.
                needle = ('"' + segment.lower() + '"').encode("ascii")
        if needle is None:
            needle_index.append(None)
        else:
            idx = seen.get(needle)
            if idx is None:
                idx = len(needles)
                needles.append(needle)
                seen[needle] = idx
            needle_index.append(idx)
    if not needles:
        return None
    return ScanPlan(bloom_query.expression, conditions, needles, needle_index)


def evaluate_plan(
    plan: ScanPlan, scanned: np.ndarray, n_rows: int,
    trust_numeric: bool = False,
) -> np.ndarray:
    """Evaluate the bloom tree over a per-needle row-hit matrix -> bool[rows].

    ``scanned`` is bool[len(plan.needles), n_rows] from any scanner backend
    (native C++ memmem or the device row-cache scan). Conditions without a
    usable needle are conservatively all-True. ``trust_numeric`` False
    (block not attested rows_canonical) additionally makes numeric-unsafe
    needles all-True — a verbatim-stored number may spell its token
    differently than the needle bytes (see _numeric_unsafe)."""
    matrix = np.ones((len(plan.conditions), n_rows), dtype=bool)
    for cond_idx, needle_row in enumerate(plan.needle_index):
        if needle_row is not None and (
            trust_numeric or not plan.numeric_unsafe[needle_row]
        ):
            matrix[cond_idx] = scanned[needle_row]

    class _TermsView:
        term_index = plan.term_index

    return np.asarray(
        evaluate_match_expression(plan.expression, _TermsView, matrix, n_rows)
    )


def candidate_rows(
    plan: ScanPlan,
    data: np.ndarray,
    row_offsets: np.ndarray,
    row_lengths: np.ndarray,
    trust_numeric: bool = False,
) -> Optional[np.ndarray]:
    """bool[num_rows] candidate mask, or None to fall back to full verify."""
    n_rows = row_offsets.shape[0]
    scanned = native.scan_candidates(data, plan.needles, row_offsets, row_lengths)
    if scanned is None:
        return None
    return evaluate_plan(plan, scanned, n_rows, trust_numeric)


def split_rows_arrays(data: bytes):
    """Length-prefixed stream -> (uint8 buffer, offsets[int64], lengths[int64]).

    Array-of-offsets variant of file_format.split_rows for the scan path.
    """
    import struct

    from .file_format import InvalidFormatError

    buf = np.frombuffer(data, dtype=np.uint8)
    if len(data) == 0:
        return buf, np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
    if native.available():
        result = native.split_rows(buf, max_rows=len(data) // 4 + 1)
        if result is None:
            raise InvalidFormatError("malformed length-prefixed row stream")
        offsets, lengths = result
        return buf, offsets, lengths
    offsets_list = []
    lengths_list = []
    pos = 0
    n = len(data)
    while pos + 4 <= n:
        (length,) = struct.unpack_from("<I", data, pos)
        pos += 4
        if pos + length > n:
            raise InvalidFormatError("malformed length-prefixed row stream")
        offsets_list.append(pos)
        lengths_list.append(length)
        pos += length
    if pos != n:
        raise InvalidFormatError("malformed length-prefixed row stream")
    return (
        buf,
        np.asarray(offsets_list, dtype=np.int64),
        np.asarray(lengths_list, dtype=np.int64),
    )
