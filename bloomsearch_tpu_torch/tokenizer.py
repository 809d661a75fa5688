"""Field extraction, tokenization, and exact row verification.

This is the semantic core that everything else hangs off: ingest expands each
row into three keyspaces (field paths, tokens, ``field::token`` pairs), and
the query path re-verifies every bloom-candidate row against the raw JSON so
final results have zero false positives despite bloom FPR.

Behavioral contract (mirrors reference tokenizer.go — cited per function):

- Field paths are dot-joined; arrays are traversed but **indices are dropped**,
  so paths from different array elements collapse ("information loss",
  tokenizer.go:18-28 and tokenizer_test.go:238-277).
- Values are deduplicated per path (tokenizer.go:29-43).
- Non-string primitives are stringified Go-``%v``-style before tokenization
  (tokenizer.go:79, :98) — see :func:`bloomsearch_tpu_torch.utils.go_like_str`.
- The default tokenizer lowercases and splits on whitespace
  (tokenizer.go:89-99).
- Row verification walks parsed JSON exactly like the reference's gjson walk
  (tokenizer.go:107-456): arrays are walked transparently at every level,
  ``null`` never matches, and regex conditions match against the **full**
  stringified value, not tokens (tokenizer.go:368-376).
"""

from __future__ import annotations

import re
from typing import Any, Callable, Mapping, Optional, Sequence

from .utils import go_like_str

# A ValueTokenizer turns one field value into a list of tokens
# (reference tokenizer.go:86).
ValueTokenizer = Callable[[Any], list[str]]

DEFAULT_DELIMITER = "."

# Key join for the field::token keyspace (reference bloom_tree_engine.go:33-36).
FIELD_TOKEN_SEPARATOR = "::"


def make_field_token_key(field: str, token: str) -> str:
    return field + FIELD_TOKEN_SEPARATOR + token


def basic_whitespace_lower_tokenizer(value: Any) -> list[str]:
    """Lowercase + split-on-whitespace tokenizer (tokenizer.go:89-99).

    Non-string primitives are stringified Go-style first, so numbers and
    booleans are searchable as tokens (tokenizer_test.go:264-268).
    """
    if isinstance(value, str):
        return value.lower().split()
    return basic_whitespace_lower_tokenizer(go_like_str(value))


def unique_fields(row: Mapping[str, Any], delimiter: str = DEFAULT_DELIMITER) -> dict[str, list[str]]:
    """Extract all unique field paths and their deduplicated string values.

    Equivalent of reference ``UniqueFields`` (tokenizer.go:29-43): a recursive
    walk of the nested mapping where array indices are ignored (elements of a
    list contribute to the *same* path) and values are deduplicated per path.
    ``None`` values are skipped entirely (tokenizer.go:46-48).
    """
    path_values: dict[str, dict[str, None]] = {}
    _collect_paths_and_values(row, "", path_values, delimiter)
    return {path: list(values) for path, values in path_values.items()}


def _collect_paths_and_values(
    obj: Any, prefix: str, path_values: dict[str, dict[str, None]], delimiter: str
) -> None:
    if obj is None:
        return
    if isinstance(obj, Mapping):
        for key, value in obj.items():
            key_str = key if isinstance(key, str) else go_like_str(key)
            new_path = key_str if not prefix else prefix + delimiter + key_str
            _collect_paths_and_values(value, new_path, path_values, delimiter)
    elif isinstance(obj, (list, tuple)):
        for item in obj:
            _collect_paths_and_values(item, prefix, path_values, delimiter)
    else:
        if prefix:
            # dict used as insertion-ordered set for per-path value dedup
            path_values.setdefault(prefix, {})[go_like_str(obj)] = None


# ---------------------------------------------------------------------------
# Row verification against parsed JSON (the "gjson" equivalent).
#
# These walk plain Python objects produced by json.loads. Primitives are
# str / int / float / bool; None (JSON null) never matches
# (reference tokenizer.go:170-203: only String/Number/True/False are tested).
# ---------------------------------------------------------------------------


def _is_primitive(value: Any) -> bool:
    return isinstance(value, (str, int, float, bool)) and value is not None


def walk_json_for_field(value: Any, components: Sequence[str], depth: int) -> bool:
    """Does the field path exist, walking arrays transparently?

    (reference walkJSONForField, tokenizer.go:113-140)
    """
    if depth >= len(components):
        return True
    component = components[depth]
    if isinstance(value, Mapping):
        if component in value:
            return walk_json_for_field(value[component], components, depth + 1)
        return False
    if isinstance(value, list):
        return any(walk_json_for_field(item, components, depth) for item in value)
    return False


def walk_json_for_value(value: Any, test: Callable[[Any], bool]) -> bool:
    """Test every primitive value anywhere in the structure.

    (reference walkJSONForValue, tokenizer.go:170-203)
    """
    if value is None:
        return False
    if isinstance(value, (Mapping, list)):
        items = value.values() if isinstance(value, Mapping) else value
        return any(walk_json_for_value(item, test) for item in items)
    if _is_primitive(value):
        return test(value)
    return False


def walk_json_for_field_value(
    value: Any, components: Sequence[str], depth: int, test: Callable[[Any], bool]
) -> bool:
    """Walk to a field path, then test its values.

    (reference walkJSONForFieldValue, tokenizer.go:206-234)
    """
    if depth >= len(components):
        return walk_json_for_value(value, test)
    component = components[depth]
    if isinstance(value, Mapping):
        if component in value:
            return walk_json_for_field_value(value[component], components, depth + 1, test)
        return False
    if isinstance(value, list):
        return any(walk_json_for_field_value(item, components, depth, test) for item in value)
    return False


def row_has_field(row: Any, field_path: str, delimiter: str = DEFAULT_DELIMITER) -> bool:
    """Field-path existence test (reference TestGJSONForField, tokenizer.go:428-431)."""
    return walk_json_for_field(row, field_path.split(delimiter), 0)


def row_has_token(row: Any, token: str, tokenizer: ValueTokenizer) -> bool:
    """Token-anywhere test (reference TestGJSONForToken, tokenizer.go:433-443)."""
    return walk_json_for_value(row, lambda v: token in tokenizer(v))


def row_has_field_token(
    row: Any, field_path: str, token: str, tokenizer: ValueTokenizer, delimiter: str = DEFAULT_DELIMITER
) -> bool:
    """Field-scoped token test (reference TestGJSONForFieldToken, tokenizer.go:445-456)."""
    return walk_json_for_field_value(
        row, field_path.split(delimiter), 0, lambda v: token in tokenizer(v)
    )


# ---------------------------------------------------------------------------
# Bloom / regex expression evaluation against a parsed row.
# The AST types live in query.py; evaluation lives here with the JSON walks.
# ---------------------------------------------------------------------------


def row_matches_bloom_expression(row, expression, delimiter, tokenizer: ValueTokenizer) -> bool:
    """Short-circuit AND/OR evaluation of a bloom expression against a row.

    Empty OR is false, empty AND is true, nil expression/condition is true
    (reference testGJSONForBloomExpression, tokenizer.go:257-288).
    """
    from .query import BloomExprType, BloomConditionType

    if expression is None:
        return True
    if expression.expression_type == BloomExprType.CONDITION:
        cond = expression.condition
        if cond is None:
            return True
        if cond.type == BloomConditionType.FIELD:
            return row_has_field(row, cond.field, delimiter)
        if cond.type == BloomConditionType.TOKEN:
            return row_has_token(row, cond.token, tokenizer)
        if cond.type == BloomConditionType.FIELD_TOKEN:
            return row_has_field_token(row, cond.field, cond.token, tokenizer, delimiter)
        return False
    if expression.expression_type == BloomExprType.OR:
        if not expression.children:
            return False
        return any(
            row_matches_bloom_expression(row, child, delimiter, tokenizer)
            for child in expression.children
        )
    if expression.expression_type == BloomExprType.AND:
        return all(
            row_matches_bloom_expression(row, child, delimiter, tokenizer)
            for child in expression.children
        )
    return False


class CompiledRegexCondition:
    __slots__ = ("field", "matcher")

    def __init__(self, field: str, matcher):
        self.field = field
        self.matcher = matcher  # callable str -> bool, bounded execution


class CompiledRegexExpression:
    __slots__ = ("expression_type", "condition", "children")

    def __init__(self, expression_type, condition=None, children=()):
        self.expression_type = expression_type
        self.condition = condition
        self.children = list(children)


class CompiledRegexQuery:
    __slots__ = ("expression",)

    def __init__(self, expression: Optional[CompiledRegexExpression]):
        self.expression = expression


def compile_regex_query(regex_query) -> Optional[CompiledRegexQuery]:
    """Compile all patterns in a regex query once, failing fast on bad patterns.

    (reference CompileRegexQuery, tokenizer.go:315-366; invalid patterns raise
    ``re.error`` like the reference returns an error.)

    Matchers are execution-bounded: the reference's Go regexp is RE2-class
    (guaranteed linear), so patterns that could backtrack catastrophically
    under CPython ``re`` are routed through :mod:`.relinear` (Pike-VM NFA or
    a per-row wall-clock budget) instead of stalling a block worker.
    """
    if regex_query is None or regex_query.expression is None:
        return None
    compiled = _compile_regex_expression(regex_query.expression)
    return CompiledRegexQuery(compiled)


def _compile_regex_expression(expression) -> Optional[CompiledRegexExpression]:
    from .query import RegexExprType

    if expression is None:
        return None
    if expression.expression_type == RegexExprType.CONDITION:
        if expression.condition is None:
            # Nil condition = ALWAYS TRUE (the evaluator's rule, matching
            # the reference's nil-filter passthrough). It must compile to an
            # explicit true leaf, not drop out of its parent: dropping one
            # from an OR narrows the OR (false negatives), and an OR of
            # only nil children would become the empty OR = always FALSE —
            # the exact inversion.
            return CompiledRegexExpression(RegexExprType.CONDITION, condition=None)
        from .relinear import build_safe_matcher

        matcher = build_safe_matcher(expression.condition.pattern)
        return CompiledRegexExpression(
            RegexExprType.CONDITION,
            condition=CompiledRegexCondition(expression.condition.field, matcher),
        )
    children = []
    for child in expression.children:
        compiled_child = _compile_regex_expression(child)
        if compiled_child is not None:
            children.append(compiled_child)
    return CompiledRegexExpression(expression.expression_type, children=children)


def row_matches_regex_condition(row, condition: CompiledRegexCondition, delimiter: str) -> bool:
    """Regex match against the full stringified field value — not tokens.

    (reference testGJSONForRegexCondition, tokenizer.go:368-376; README.md:166)
    """
    if condition is None:
        return True
    components = condition.field.split(delimiter)
    return walk_json_for_field_value(
        row, components, 0, lambda v: condition.matcher(go_like_str(v))
    )


def row_matches_regex_expression(row, expression: Optional[CompiledRegexExpression], delimiter: str) -> bool:
    """(reference testGJSONForRegexExpression, tokenizer.go:378-409)"""
    from .query import RegexExprType

    if expression is None:
        return True
    if expression.expression_type == RegexExprType.CONDITION:
        if expression.condition is None:
            return True
        return row_matches_regex_condition(row, expression.condition, delimiter)
    if expression.expression_type == RegexExprType.OR:
        if not expression.children:
            return False
        return any(
            row_matches_regex_expression(row, child, delimiter) for child in expression.children
        )
    if expression.expression_type == RegexExprType.AND:
        return all(
            row_matches_regex_expression(row, child, delimiter) for child in expression.children
        )
    return False


def row_matches_query(
    row,
    bloom_query,
    compiled_regex: Optional[CompiledRegexQuery],
    delimiter: str,
    tokenizer: ValueTokenizer,
) -> bool:
    """The correctness core: exact verification of one parsed row.

    Bloom expression re-verified against the raw structure, then the compiled
    regex query applied as a final AND stage
    (reference TestGJSONForQuery, tokenizer.go:411-425).
    """
    if bloom_query is not None and bloom_query.expression is not None:
        if not row_matches_bloom_expression(row, bloom_query.expression, delimiter, tokenizer):
            return False
    if compiled_regex is not None and compiled_regex.expression is not None:
        if not row_matches_regex_expression(row, compiled_regex.expression, delimiter):
            return False
    return True
