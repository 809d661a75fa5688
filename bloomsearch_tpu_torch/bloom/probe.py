"""Query-term compilation and batched bank probing.

The reference probes filters one ``TestString`` at a time per file/block
(bloom_tree_engine.go:823-908). Here a bloom query is compiled once into a
*term batch* — each distinct leaf condition becomes one probe key, hashed
once — and a whole filter bank ``[3, num_words, num_blocks]`` is probed in
one vectorized pass producing a ``[num_terms, num_blocks]`` match matrix.
The AND/OR expression tree then evaluates as masked reductions over term
rows, yielding a per-block survival bitmap.

The same semantics run on three backends sharing this compilation step:
- host numpy (this module) — always available, the semantic spec
- XLA/jnp (``bank.py``) — jit-compiled gathers over HBM-resident banks
- Pallas kernel (``pallas_kernels.py``) — scalar-prefetched row DMA

Semantics preserved exactly (bloom_tree_engine.go:854-870): empty OR ⇒
false, empty AND ⇒ true, nil expression/condition ⇒ true (bloom only ever
*disqualifies* — :831).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..query import (
    BloomCondition,
    BloomConditionType,
    BloomExpression,
    BloomExprType,
    BloomQuery,
    bloom_query_conditions,
)
from ..tokenizer import make_field_token_key
from .hashing import hash_keys, positions_for_layout

_KS_INDEX = {
    BloomConditionType.FIELD: 0,
    BloomConditionType.TOKEN: 1,
    BloomConditionType.FIELD_TOKEN: 2,
}


def condition_probe_key(condition: BloomCondition) -> str:
    """The bloom key a condition probes (field path, token, or joined pair)."""
    if condition.type == BloomConditionType.FIELD:
        return condition.field
    if condition.type == BloomConditionType.TOKEN:
        return condition.token
    return make_field_token_key(condition.field, condition.token)


class CompiledBloomTerms:
    """Distinct leaf conditions of a bloom query, hashed once.

    Probe positions are derived per (m_bits, k) on demand and cached, so one
    compilation serves banks with heterogeneous bloom params (file-level vs
    block-level vs merged groups).
    """

    def __init__(self, conditions: Sequence[BloomCondition]):
        self.conditions = list(conditions)
        self.keys = [condition_probe_key(c) for c in self.conditions]
        self.ks_idx = np.array(
            [_KS_INDEX[c.type] for c in self.conditions], dtype=np.int32
        )
        self.hashes = hash_keys(self.keys)  # [T, 2] uint64
        self.term_index = {
            (c.type, c.field, c.token): i for i, c in enumerate(self.conditions)
        }
        self._positions_cache: dict[tuple, tuple[np.ndarray, np.ndarray]] = {}

    def __len__(self) -> int:
        return len(self.conditions)

    def positions_for(
        self, m_bits: int, k: int, layout: str = "classic"
    ) -> tuple[np.ndarray, np.ndarray]:
        """(word_idx[T, k] int32, bit_idx[T, k] int32) for given params."""
        key = (m_bits, k, layout)
        cached = self._positions_cache.get(key)
        if cached is None:
            positions = positions_for_layout(self.hashes, k, m_bits, layout)
            word = (positions >> np.uint64(5)).astype(np.int32)
            bit = (positions & np.uint64(31)).astype(np.int32)
            cached = (word, bit)
            self._positions_cache[key] = cached
        return cached


def compile_bloom_terms(query: Optional[BloomQuery]) -> Optional[CompiledBloomTerms]:
    """Extract and hash the distinct leaf conditions; None if query is empty."""
    if query is None or query.expression is None:
        return None
    conditions = bloom_query_conditions(query.expression)
    if not conditions:
        return None
    return CompiledBloomTerms(conditions)


def is_flat_and_expression(expression: Optional[BloomExpression]) -> bool:
    """True when the expression is a single condition or a flat AND of
    conditions — the dominant query shape (builder's implicit AND), which
    the device backend can reduce on-chip (probe + AND fused, only a [C]
    survivor bitmap transferred)."""
    if expression is None:
        return False
    if expression.expression_type == BloomExprType.CONDITION:
        return expression.condition is not None
    if expression.expression_type == BloomExprType.AND:
        return bool(expression.children) and all(
            c.expression_type == BloomExprType.CONDITION and c.condition is not None
            for c in expression.children
        )
    return False


# CNF compilation: bloom expressions are MONOTONE (AND/OR over leaf
# conditions, no negation — query.go:448-478), so every tree converts to a
# conjunction of disjunctions. On device that evaluates as two small
# matmuls over the [T, B] match matrix (MXU-friendly), letting arbitrary
# AND/OR trees fuse like flat-AND does: only a [B] survivor bitmap
# transfers. Conversion can blow up exponentially in theory; above
# MAX_CNF_CLAUSES the caller falls back to host evaluation of the full
# bitmap (reference semantics either way).

MAX_CNF_CLAUSES = 64

_CNF_TRUE = object()
_CNF_FALSE = object()


def _cnf_minimize(clauses: list[frozenset]) -> list[frozenset]:
    """Dedupe + absorption (a clause that is a superset of another is
    implied by it and drops out)."""
    uniq = sorted(set(clauses), key=lambda c: (len(c), sorted(c)))
    out: list[frozenset] = []
    for c in uniq:
        if not any(kept <= c for kept in out):
            out.append(c)
    return out


def _to_cnf(expression: Optional[BloomExpression], term_index: dict):
    if expression is None:
        return _CNF_TRUE
    if expression.expression_type == BloomExprType.CONDITION:
        cond = expression.condition
        if cond is None:
            return _CNF_TRUE  # nil condition passes (reference :885-905)
        idx = term_index.get((cond.type, cond.field, cond.token))
        if idx is None:
            return None  # term not compiled (shouldn't happen): host path
        return [frozenset([idx])]
    kids = [_to_cnf(child, term_index) for child in expression.children]
    if any(k is None for k in kids):
        return None
    if expression.expression_type == BloomExprType.AND:
        out: list[frozenset] = []
        for k in kids:
            if k is _CNF_TRUE:
                continue
            if k is _CNF_FALSE:
                return _CNF_FALSE
            out.extend(k)
        out = _cnf_minimize(out)
        if len(out) > MAX_CNF_CLAUSES:
            return None
        return out if out else _CNF_TRUE  # empty AND = true (:854-870)
    if expression.expression_type == BloomExprType.OR:
        useful = []
        for k in kids:
            if k is _CNF_TRUE:
                return _CNF_TRUE  # true absorbs the OR
            if k is _CNF_FALSE:
                continue
            useful.append(k)
        if not useful:
            return _CNF_FALSE  # empty OR = false (:854-870)
        acc = useful[0]
        for nxt in useful[1:]:
            # OR distributes over the two CNFs: cross-union of clauses.
            acc = _cnf_minimize([a | b for a in acc for b in nxt])
            if len(acc) > MAX_CNF_CLAUSES:
                return None
        return acc
    return None


def compile_cnf_clauses(
    expression: Optional[BloomExpression], terms: CompiledBloomTerms
) -> Optional[np.ndarray]:
    """Compile a bloom expression to a CNF clause mask bool[C, T].

    Evaluation contract (matches evaluate_match_expression exactly for
    monotone trees): ``result[b] = all_c(any_t(mask[c, t] & match[t, b]))``.
    Constant-true compiles to zero clauses (vacuous all); constant-false to
    one empty clause (vacuous any = false). Returns None when the tree
    can't compile within MAX_CNF_CLAUSES — callers evaluate host-side.
    """
    clauses = _to_cnf(expression, terms.term_index)
    if clauses is None:
        return None
    if clauses is _CNF_TRUE:
        return np.zeros((0, len(terms)), dtype=bool)
    if clauses is _CNF_FALSE:
        return np.zeros((1, len(terms)), dtype=bool)
    mask = np.zeros((len(clauses), len(terms)), dtype=bool)
    for i, clause in enumerate(clauses):
        mask[i, list(clause)] = True
    return mask


def evaluate_cnf_mask(mask: np.ndarray, match: np.ndarray) -> np.ndarray:
    """Host reference evaluation of a CNF mask: bool[C,T] x bool[T,B] -> bool[B].

    The semantic spec the device clause reduction must match (tests
    cross-check both against evaluate_match_expression).
    """
    if mask.shape[0] == 0:
        return np.ones(match.shape[1], dtype=bool)
    clause_or = (mask.astype(np.int32) @ match.astype(np.int32)) > 0  # [C, B]
    return clause_or.all(axis=0)


def probe_bank_host(
    bank: np.ndarray,
    terms: CompiledBloomTerms,
    m_bits: int,
    k: int,
    layout: str = "classic",
) -> np.ndarray:
    """Probe every block of a bank against every term -> bool[T, B].

    ``bank`` is uint32[3, num_words, num_blocks] in probe layout: for a fixed
    (keyspace, word) the per-block words are contiguous, so each of the T*k
    probes is one contiguous row read — the same access pattern the device
    kernels use.
    """
    word_idx, bit_idx = terms.positions_for(m_bits, k, layout)  # [T, k]
    # Gather rows: [T, k, B]
    rows = bank[terms.ks_idx[:, None], word_idx, :]
    bits = (rows >> bit_idx[:, :, None].astype(np.uint32)) & np.uint32(1)
    return bits.astype(bool).all(axis=1)


def probe_rows_sparse(
    read_rows, terms: CompiledBloomTerms, m_bits: int, k: int, layout: str = "classic"
) -> np.ndarray:
    """Probe via targeted row reads -> bool[T, B].

    ``read_rows(flat_rows int64[U]) -> uint32[U, B]`` fetches only the rows
    the terms actually probe (keyspace*num_words + word). For needle queries
    on large filters this touches KBs instead of the whole bank — the cold
    fast path (file_format.read_bank_rows documents the CRC caveat).
    """
    word_idx, bit_idx = terms.positions_for(m_bits, k, layout)  # [T, k]
    num_words = (m_bits + 31) // 32
    flat = (
        terms.ks_idx[:, None].astype(np.int64) * num_words + word_idx
    ).reshape(-1)
    uniq, inverse = np.unique(flat, return_inverse=True)
    rows = read_rows(uniq)  # [U, B]
    T = len(terms)
    gathered = rows[inverse].reshape(T, k, -1)
    bits = (gathered >> bit_idx[:, :, None].astype(np.uint32)) & np.uint32(1)
    return bits.astype(bool).all(axis=1)


def stack_filter_bank(triples) -> np.ndarray:
    """Stack per-file/block ``BloomFilters`` triples into a probe-layout bank.

    triples: sequence of objects with .field/.token/.field_token BloomFilter
    (all at identical (m, k)). Returns uint32[3, num_words, len(triples)].
    """
    field = np.stack([t.field.words for t in triples], axis=1)
    token = np.stack([t.token.words for t in triples], axis=1)
    field_token = np.stack([t.field_token.words for t in triples], axis=1)
    return np.stack([field, token, field_token], axis=0)


def evaluate_match_expression(
    expression: Optional[BloomExpression],
    terms: Optional[CompiledBloomTerms],
    match: np.ndarray,
    num_blocks: int,
    xp=np,
):
    """Evaluate the AND/OR tree over the term-match matrix -> bool[num_blocks].

    Vectorized equivalent of evaluateBloomExpression
    (bloom_tree_engine.go:837-874): a condition leaf selects its term row;
    OR is elementwise any (empty ⇒ false); AND is elementwise all (empty ⇒
    true); nil expression/condition ⇒ true. Works with numpy or jax.numpy
    via ``xp``.
    """
    ones = xp.ones(num_blocks, dtype=bool)
    zeros = xp.zeros(num_blocks, dtype=bool)

    def visit(expr: Optional[BloomExpression]):
        if expr is None:
            return ones
        if expr.expression_type == BloomExprType.CONDITION:
            if expr.condition is None or terms is None:
                return ones
            idx = terms.term_index[
                (expr.condition.type, expr.condition.field, expr.condition.token)
            ]
            return match[idx]
        if expr.expression_type == BloomExprType.OR:
            if not expr.children:
                return zeros
            result = visit(expr.children[0])
            for child in expr.children[1:]:
                result = result | visit(child)
            return result
        if expr.expression_type == BloomExprType.AND:
            result = ones
            for child in expr.children:
                result = result & visit(child)
            return result
        return zeros

    return visit(expression)


def evaluate_bloom_filters_host(
    triple, query: Optional[BloomQuery], terms: Optional[CompiledBloomTerms] = None
) -> bool:
    """Single filter-triple evaluation (file-level check, merge paths).

    Equivalent to reference evaluateBloomFilters (bloom_tree_engine.go:823-835).
    """
    if query is None or query.expression is None:
        return True
    if terms is None:
        terms = compile_bloom_terms(query)
        if terms is None:
            return True
    bank = stack_filter_bank([triple])
    match = probe_bank_host(
        bank, terms, triple.field.m_bits, triple.field.k, triple.field.layout
    )
    result = evaluate_match_expression(query.expression, terms, match, 1)
    return bool(result[0])
