"""Query model: prefilter / bloom / regex ASTs, fluent builder, metadata eval.

Pure data + pure functions, no JAX. Mirrors the reference's query.go surface:

- operators (query.go:6-24), string/numeric conditions (query.go:27-42)
- prefilter AST ``partition``/``min_max``/``prefilter_and``/``prefilter_or``
  with auto-flattening (query.go:80-125)
- bloom AST ``field``/``token``/``field_token``/``and_``/``or_``
  (query.go:503-558)
- regex AST ``field_regex``/``regex_and``/``regex_or`` (query.go:560-594)
- metadata evaluators with **strict prefilter semantics**: a condition on
  missing partition/minmax metadata excludes the block (query.go:403-426)
- regex -> bloom "field guard" used to prune files/blocks for regex queries
  (query.go:596-663)
- ``QueryBuilder`` with implicit-AND chaining and explicit ``match`` trees
  (query.go:673-778)
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field as dc_field
from typing import Optional

from .minmax import MinMaxIndex


class Operator(str, enum.Enum):
    """Comparison operators for prefilter conditions (query.go:6-24)."""

    EQ = "EQ"
    NE = "NE"
    GT = "GT"
    GTE = "GTE"
    LT = "LT"
    LTE = "LTE"
    IN = "IN"
    NOT_IN = "NOT_IN"
    BETWEEN = "BETWEEN"
    NOT_BETWEEN = "NOT_BETWEEN"


@dataclass
class StringCondition:
    """Condition on string values like partition IDs (query.go:27-33)."""

    operator: Operator
    value: str = ""
    values: tuple[str, ...] = ()
    min: str = ""
    max: str = ""


@dataclass
class NumericCondition:
    """Condition on int64 values like minmax indexes (query.go:36-42)."""

    operator: Operator
    value: int = 0
    values: tuple[int, ...] = ()
    min: int = 0
    max: int = 0


# ---------------------------------------------------------------------------
# Prefilter AST (partitions + minmax)
# ---------------------------------------------------------------------------


class PrefilterConditionType(str, enum.Enum):
    PARTITION = "PARTITION"
    MINMAX = "MINMAX"


class PrefilterExprType(str, enum.Enum):
    CONDITION = "CONDITION"
    AND = "AND"
    OR = "OR"


@dataclass
class PrefilterCondition:
    condition_type: PrefilterConditionType
    partition_condition: Optional[StringCondition] = None
    min_max_field_name: str = ""
    min_max_condition: Optional[NumericCondition] = None


@dataclass
class PrefilterExpression:
    expression_type: PrefilterExprType
    condition: Optional[PrefilterCondition] = None
    children: list["PrefilterExpression"] = dc_field(default_factory=list)


def partition(condition: StringCondition) -> PrefilterExpression:
    """A partition-ID condition leaf (query.go:80-88)."""
    return PrefilterExpression(
        PrefilterExprType.CONDITION,
        condition=PrefilterCondition(
            PrefilterConditionType.PARTITION, partition_condition=condition
        ),
    )


def min_max(field_name: str, condition: NumericCondition) -> PrefilterExpression:
    """A minmax-index condition leaf (query.go:90-99)."""
    return PrefilterExpression(
        PrefilterExprType.CONDITION,
        condition=PrefilterCondition(
            PrefilterConditionType.MINMAX,
            min_max_field_name=field_name,
            min_max_condition=condition,
        ),
    )


def _flatten(expressions, expression_type):
    """Same-type combinator children are inlined (query.go:115-125)."""
    flattened = []
    for expression in expressions:
        if expression.expression_type == expression_type and expression.condition is None:
            flattened.extend(expression.children)
        else:
            flattened.append(expression)
    return flattened


def prefilter_and(*expressions: PrefilterExpression) -> PrefilterExpression:
    return PrefilterExpression(
        PrefilterExprType.AND, children=_flatten(expressions, PrefilterExprType.AND)
    )


def prefilter_or(*expressions: PrefilterExpression) -> PrefilterExpression:
    return PrefilterExpression(
        PrefilterExprType.OR, children=_flatten(expressions, PrefilterExprType.OR)
    )


@dataclass
class QueryPrefilter:
    """Prefilter over partition IDs and minmax indexes (query.go:127-135)."""

    expression: Optional[PrefilterExpression] = None


# Condition helper constructors (query.go:137-237)


def partition_equals(value: str) -> StringCondition:
    return StringCondition(Operator.EQ, value=value)


def partition_not_equals(value: str) -> StringCondition:
    return StringCondition(Operator.NE, value=value)


def partition_in(*values: str) -> StringCondition:
    return StringCondition(Operator.IN, values=tuple(values))


def partition_not_in(*values: str) -> StringCondition:
    return StringCondition(Operator.NOT_IN, values=tuple(values))


def partition_greater_than(value: str) -> StringCondition:
    return StringCondition(Operator.GT, value=value)


def partition_greater_than_equal(value: str) -> StringCondition:
    return StringCondition(Operator.GTE, value=value)


def partition_less_than(value: str) -> StringCondition:
    return StringCondition(Operator.LT, value=value)


def partition_less_than_equal(value: str) -> StringCondition:
    return StringCondition(Operator.LTE, value=value)


def partition_between(min_value: str, max_value: str) -> StringCondition:
    return StringCondition(Operator.BETWEEN, min=min_value, max=max_value)


def partition_not_between(min_value: str, max_value: str) -> StringCondition:
    return StringCondition(Operator.NOT_BETWEEN, min=min_value, max=max_value)


def numeric_equals(value: int) -> NumericCondition:
    return NumericCondition(Operator.EQ, value=value)


def numeric_not_equals(value: int) -> NumericCondition:
    return NumericCondition(Operator.NE, value=value)


def numeric_greater_than(value: int) -> NumericCondition:
    return NumericCondition(Operator.GT, value=value)


def numeric_greater_than_equal(value: int) -> NumericCondition:
    return NumericCondition(Operator.GTE, value=value)


def numeric_less_than(value: int) -> NumericCondition:
    return NumericCondition(Operator.LT, value=value)


def numeric_less_than_equal(value: int) -> NumericCondition:
    return NumericCondition(Operator.LTE, value=value)


def numeric_in(*values: int) -> NumericCondition:
    return NumericCondition(Operator.IN, values=tuple(values))


def numeric_not_in(*values: int) -> NumericCondition:
    return NumericCondition(Operator.NOT_IN, values=tuple(values))


def numeric_between(min_value: int, max_value: int) -> NumericCondition:
    return NumericCondition(Operator.BETWEEN, min=min_value, max=max_value)


def numeric_not_between(min_value: int, max_value: int) -> NumericCondition:
    return NumericCondition(Operator.NOT_BETWEEN, min=min_value, max=max_value)


# ---------------------------------------------------------------------------
# Condition evaluation (query.go:242-360)
# ---------------------------------------------------------------------------


def evaluate_string_condition(value: str, condition: StringCondition) -> bool:
    """Exact string comparison per operator (query.go:242-277)."""
    op = condition.operator
    if op == Operator.EQ:
        return value == condition.value
    if op == Operator.NE:
        return value != condition.value
    if op == Operator.GT:
        return value > condition.value
    if op == Operator.GTE:
        return value >= condition.value
    if op == Operator.LT:
        return value < condition.value
    if op == Operator.LTE:
        return value <= condition.value
    if op == Operator.IN:
        return value in condition.values
    if op == Operator.NOT_IN:
        return value not in condition.values
    if op == Operator.BETWEEN:
        return condition.min <= value <= condition.max
    if op == Operator.NOT_BETWEEN:
        return value < condition.min or value > condition.max
    return False


def evaluate_numeric_condition(value: int, condition: NumericCondition) -> bool:
    """Exact numeric comparison per operator (query.go:280-315)."""
    op = condition.operator
    if op == Operator.EQ:
        return value == condition.value
    if op == Operator.NE:
        return value != condition.value
    if op == Operator.GT:
        return value > condition.value
    if op == Operator.GTE:
        return value >= condition.value
    if op == Operator.LT:
        return value < condition.value
    if op == Operator.LTE:
        return value <= condition.value
    if op == Operator.IN:
        return value in condition.values
    if op == Operator.NOT_IN:
        return value not in condition.values
    if op == Operator.BETWEEN:
        return condition.min <= value <= condition.max
    if op == Operator.NOT_BETWEEN:
        return value < condition.min or value > condition.max
    return False


def evaluate_min_max_condition(index: MinMaxIndex, condition: NumericCondition) -> bool:
    """Conservative range-overlap check: may the range contain a match?

    (query.go:317-360; ``NOT_IN`` is conservatively always true, :347-350)
    """
    op = condition.operator
    if op == Operator.EQ:
        return index.min <= condition.value <= index.max
    if op == Operator.NE:
        return index.min != condition.value or index.max != condition.value
    if op == Operator.GT:
        return index.max > condition.value
    if op == Operator.GTE:
        return index.max >= condition.value
    if op == Operator.LT:
        return index.min < condition.value
    if op == Operator.LTE:
        return index.min <= condition.value
    if op == Operator.IN:
        return any(index.min <= v <= index.max for v in condition.values)
    if op == Operator.NOT_IN:
        # Conservative: let exact row verification do the detailed filtering.
        return True
    if op == Operator.BETWEEN:
        return index.min <= condition.max and condition.min <= index.max
    if op == Operator.NOT_BETWEEN:
        return index.min < condition.min or index.max > condition.max
    return False


def evaluate_data_block_metadata(metadata, prefilter: Optional[QueryPrefilter]) -> bool:
    """May this data block match the prefilter? (query.go:362-368)

    ``metadata`` is any object with ``partition_id`` (str) and
    ``min_max_indexes`` (dict[str, MinMaxIndex]) attributes.
    """
    if prefilter is None or prefilter.expression is None:
        return True
    return _evaluate_prefilter_expression(metadata, prefilter.expression)


def _evaluate_prefilter_expression(metadata, expression: Optional[PrefilterExpression]) -> bool:
    if expression is None:
        return True
    if expression.expression_type == PrefilterExprType.CONDITION:
        if expression.condition is None:
            return True
        return _evaluate_prefilter_condition(metadata, expression.condition)
    if expression.expression_type == PrefilterExprType.OR:
        if not expression.children:
            return False
        return any(_evaluate_prefilter_expression(metadata, c) for c in expression.children)
    if expression.expression_type == PrefilterExprType.AND:
        return all(_evaluate_prefilter_expression(metadata, c) for c in expression.children)
    return False


def _evaluate_prefilter_condition(metadata, condition: PrefilterCondition) -> bool:
    """Strict semantics: missing metadata excludes the block (query.go:403-426)."""
    if condition.condition_type == PrefilterConditionType.PARTITION:
        if condition.partition_condition is None:
            return True
        if not metadata.partition_id:
            return False
        return evaluate_string_condition(metadata.partition_id, condition.partition_condition)
    if condition.condition_type == PrefilterConditionType.MINMAX:
        if condition.min_max_condition is None:
            return True
        index = metadata.min_max_indexes.get(condition.min_max_field_name)
        if index is None:
            return False
        return evaluate_min_max_condition(index, condition.min_max_condition)
    return False


def filter_data_blocks(blocks, prefilter: Optional[QueryPrefilter]):
    """Filter block metadata by the prefilter; no prefilter keeps everything.

    (query.go:429-442)
    """
    if prefilter is None:
        return list(blocks)
    return [b for b in blocks if evaluate_data_block_metadata(b, prefilter)]


# ---------------------------------------------------------------------------
# Bloom query AST (query.go:444-558)
# ---------------------------------------------------------------------------


class BloomConditionType(str, enum.Enum):
    FIELD = "FIELD"
    TOKEN = "TOKEN"
    FIELD_TOKEN = "FIELD_TOKEN"


class BloomExprType(str, enum.Enum):
    CONDITION = "CONDITION"
    AND = "AND"
    OR = "OR"


@dataclass
class BloomCondition:
    type: BloomConditionType
    field: str = ""
    token: str = ""


@dataclass
class BloomExpression:
    expression_type: BloomExprType
    condition: Optional[BloomCondition] = None
    children: list["BloomExpression"] = dc_field(default_factory=list)


@dataclass
class BloomQuery:
    expression: Optional[BloomExpression] = None


def field(field_path: str) -> BloomExpression:
    """Match rows that contain this field path (query.go:503-511)."""
    return BloomExpression(
        BloomExprType.CONDITION,
        condition=BloomCondition(BloomConditionType.FIELD, field=field_path),
    )


def token(token_value: str) -> BloomExpression:
    """Match rows containing this token in any field (query.go:513-521)."""
    return BloomExpression(
        BloomExprType.CONDITION,
        condition=BloomCondition(BloomConditionType.TOKEN, token=token_value),
    )


def field_token(field_path: str, token_value: str) -> BloomExpression:
    """Match rows whose field contains this token (query.go:523-532)."""
    return BloomExpression(
        BloomExprType.CONDITION,
        condition=BloomCondition(
            BloomConditionType.FIELD_TOKEN, field=field_path, token=token_value
        ),
    )


def and_(*expressions: BloomExpression) -> BloomExpression:
    return BloomExpression(BloomExprType.AND, children=_flatten(expressions, BloomExprType.AND))


def or_(*expressions: BloomExpression) -> BloomExpression:
    return BloomExpression(BloomExprType.OR, children=_flatten(expressions, BloomExprType.OR))


# ---------------------------------------------------------------------------
# Regex query AST (query.go:480-501, :560-594)
# ---------------------------------------------------------------------------


class RegexExprType(str, enum.Enum):
    CONDITION = "CONDITION"
    AND = "AND"
    OR = "OR"


@dataclass
class RegexCondition:
    field: str
    pattern: str


@dataclass
class RegexExpression:
    expression_type: RegexExprType
    condition: Optional[RegexCondition] = None
    children: list["RegexExpression"] = dc_field(default_factory=list)


@dataclass
class RegexQuery:
    expression: Optional[RegexExpression] = None


def field_regex(field_path: str, pattern: str) -> RegexExpression:
    """Field-scoped regex condition, applied as a final-stage filter

    on full field-value strings (query.go:560-568; README.md:166).
    """
    return RegexExpression(
        RegexExprType.CONDITION, condition=RegexCondition(field_path, pattern)
    )


def regex_and(*expressions: RegexExpression) -> RegexExpression:
    return RegexExpression(RegexExprType.AND, children=_flatten(expressions, RegexExprType.AND))


def regex_or(*expressions: RegexExpression) -> RegexExpression:
    return RegexExpression(RegexExprType.OR, children=_flatten(expressions, RegexExprType.OR))


def _regex_expression_to_bloom_field_expression(
    expression: Optional[RegexExpression],
) -> Optional[BloomExpression]:
    """Derive a bloom Field() tree mirroring the regex tree's AND/OR shape.

    (query.go:596-641)
    """
    if expression is None:
        return None
    if expression.expression_type == RegexExprType.CONDITION:
        if expression.condition is None:
            return None
        return field(expression.condition.field)
    children = []
    for child in expression.children:
        converted = _regex_expression_to_bloom_field_expression(child)
        if converted is not None:
            children.append(converted)
    expr_type = (
        BloomExprType.AND if expression.expression_type == RegexExprType.AND else BloomExprType.OR
    )
    return BloomExpression(expr_type, children=children)


def regex_field_guard_bloom_query(query: Optional[RegexQuery]) -> Optional[BloomQuery]:
    """Bloom field-guard query enabling file/block pruning for regex queries.

    (query.go:643-652)
    """
    if query is None or query.expression is None:
        return None
    expression = _regex_expression_to_bloom_field_expression(query.expression)
    if expression is None:
        return None
    return BloomQuery(expression)


def and_bloom_queries(left: Optional[BloomQuery], right: Optional[BloomQuery]) -> Optional[BloomQuery]:
    """Combine two bloom queries under AND, tolerating nils (query.go:654-663)."""
    if left is None or left.expression is None:
        return right
    if right is None or right.expression is None:
        return left
    return BloomQuery(and_(left.expression, right.expression))


# ---------------------------------------------------------------------------
# Query + builder (query.go:665-778)
# ---------------------------------------------------------------------------


@dataclass
class Query:
    """Prefilter (partitions/minmax) + bloom + regex (query.go:666-670)."""

    prefilter: QueryPrefilter = dc_field(default_factory=QueryPrefilter)
    bloom: BloomQuery = dc_field(default_factory=BloomQuery)
    regex: RegexQuery = dc_field(default_factory=RegexQuery)


class QueryBuilder:
    """Fluent builder (query.go:673-778).

    Chained ``.field()``/``.token()``/``.field_token()``/``.field_regex()``
    calls are implicit-AND. ``.match()``/``.match_regex()`` install explicit
    trees — discarding pending implicit conditions — and later chained calls
    AND onto the explicit tree. ``.match_prefilter()`` sets the prefilter.
    """

    def __init__(self):
        self._query = Query()
        self._bloom_explicit = False
        self._implicit_bloom_and: list[BloomExpression] = []
        self._regex_explicit = False
        self._implicit_regex_and: list[RegexExpression] = []

    def field(self, field_path: str) -> "QueryBuilder":
        self._add_bloom(field(field_path))
        return self

    def token(self, token_value: str) -> "QueryBuilder":
        self._add_bloom(token(token_value))
        return self

    def field_token(self, field_path: str, token_value: str) -> "QueryBuilder":
        self._add_bloom(field_token(field_path, token_value))
        return self

    def match(self, expression: BloomExpression) -> "QueryBuilder":
        self._bloom_explicit = True
        self._implicit_bloom_and.clear()
        self._query.bloom.expression = expression
        return self

    def field_regex(self, field_path: str, pattern: str) -> "QueryBuilder":
        self._add_regex(field_regex(field_path, pattern))
        return self

    def match_regex(self, expression: RegexExpression) -> "QueryBuilder":
        self._regex_explicit = True
        self._implicit_regex_and.clear()
        self._query.regex.expression = expression
        return self

    def match_prefilter(self, expression: PrefilterExpression) -> "QueryBuilder":
        self._query.prefilter.expression = expression
        return self

    def _add_bloom(self, expression: BloomExpression) -> None:
        if self._bloom_explicit:
            if self._query.bloom.expression is None:
                self._query.bloom.expression = expression
            else:
                self._query.bloom.expression = and_(self._query.bloom.expression, expression)
        else:
            self._implicit_bloom_and.append(expression)

    def _add_regex(self, expression: RegexExpression) -> None:
        if self._regex_explicit:
            if self._query.regex.expression is None:
                self._query.regex.expression = expression
            else:
                self._query.regex.expression = regex_and(
                    self._query.regex.expression, expression
                )
        else:
            self._implicit_regex_and.append(expression)

    def build(self) -> Query:
        if not self._bloom_explicit and self._implicit_bloom_and:
            self._query.bloom.expression = and_(*self._implicit_bloom_and)
        if not self._regex_explicit and self._implicit_regex_and:
            self._query.regex.expression = regex_and(*self._implicit_regex_and)
        return self._query


def new_query() -> QueryBuilder:
    """Entry point matching the reference's ``NewQuery()`` (query.go:673)."""
    return QueryBuilder()


def bloom_query_conditions(expression: Optional[BloomExpression]) -> list[BloomCondition]:
    """Collect the distinct leaf conditions of a bloom expression tree.

    Used by the probe path to build the term list for a batched device probe.
    """
    out: list[BloomCondition] = []
    seen: set[tuple] = set()

    def visit(expr: Optional[BloomExpression]):
        if expr is None:
            return
        if expr.expression_type == BloomExprType.CONDITION:
            if expr.condition is not None:
                key = (expr.condition.type, expr.condition.field, expr.condition.token)
                if key not in seen:
                    seen.add(key)
                    out.append(expr.condition)
        else:
            for child in expr.children:
                visit(child)

    visit(expression)
    return out


# ---------------------------------------------------------------------------
# Query (de)serialization — the wire format for remote scatter/gather
# (README.md:397-418 sketches per-query task scattering; the ASTs are plain
# dataclasses over str-enums, so compact JSON round-trips exactly).
# ---------------------------------------------------------------------------


def query_to_json(q: Optional[Query]) -> Optional[dict]:
    """Query -> JSON-serializable dict (enums as their string values)."""
    if q is None:
        return None
    return dataclasses.asdict(q)


def _string_condition_from_json(o: Optional[dict]) -> Optional[StringCondition]:
    if o is None:
        return None
    return StringCondition(
        operator=Operator(o["operator"]),
        value=o.get("value", ""),
        values=tuple(o.get("values") or ()),
        min=o.get("min", ""),
        max=o.get("max", ""),
    )


def _numeric_condition_from_json(o: Optional[dict]) -> Optional[NumericCondition]:
    if o is None:
        return None
    return NumericCondition(
        operator=Operator(o["operator"]),
        value=int(o.get("value", 0)),
        values=tuple(int(v) for v in (o.get("values") or ())),
        min=int(o.get("min", 0)),
        max=int(o.get("max", 0)),
    )


def _prefilter_expression_from_json(o: Optional[dict]) -> Optional[PrefilterExpression]:
    if o is None:
        return None
    cond = o.get("condition")
    return PrefilterExpression(
        expression_type=PrefilterExprType(o["expression_type"]),
        condition=(
            PrefilterCondition(
                condition_type=PrefilterConditionType(cond["condition_type"]),
                partition_condition=_string_condition_from_json(
                    cond.get("partition_condition")
                ),
                min_max_field_name=cond.get("min_max_field_name", ""),
                min_max_condition=_numeric_condition_from_json(
                    cond.get("min_max_condition")
                ),
            )
            if cond is not None
            else None
        ),
        children=[
            _prefilter_expression_from_json(c) for c in (o.get("children") or [])
        ],
    )


def _bloom_expression_from_json(o: Optional[dict]) -> Optional[BloomExpression]:
    if o is None:
        return None
    cond = o.get("condition")
    return BloomExpression(
        expression_type=BloomExprType(o["expression_type"]),
        condition=(
            BloomCondition(
                type=BloomConditionType(cond["type"]),
                field=cond.get("field", ""),
                token=cond.get("token", ""),
            )
            if cond is not None
            else None
        ),
        children=[_bloom_expression_from_json(c) for c in (o.get("children") or [])],
    )


def _regex_expression_from_json(o: Optional[dict]) -> Optional[RegexExpression]:
    if o is None:
        return None
    cond = o.get("condition")
    return RegexExpression(
        expression_type=RegexExprType(o["expression_type"]),
        condition=(
            RegexCondition(field=cond["field"], pattern=cond["pattern"])
            if cond is not None
            else None
        ),
        children=[_regex_expression_from_json(c) for c in (o.get("children") or [])],
    )


def query_from_json(obj: Optional[dict]) -> Optional[Query]:
    """Inverse of :func:`query_to_json`."""
    if obj is None:
        return None
    return Query(
        prefilter=QueryPrefilter(
            _prefilter_expression_from_json((obj.get("prefilter") or {}).get("expression"))
        ),
        bloom=BloomQuery(
            _bloom_expression_from_json((obj.get("bloom") or {}).get("expression"))
        ),
        regex=RegexQuery(
            _regex_expression_from_json((obj.get("regex") or {}).get("expression"))
        ),
    )
