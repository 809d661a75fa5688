"""Per-block int64 min/max indexes for numeric fields.

Mirrors reference min_max.go: integers map to (v, v); floats widen with
floor/ceil (min_max.go:16-28); ``update`` takes the element-wise union
(min_max.go:74-83). Booleans are *not* numeric (Go type switch excludes bool)
even though Python's ``bool`` subclasses ``int``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

from .utils import clamp_int64


@dataclass
class MinMaxIndex:
    min: int
    max: int

    def to_json(self) -> dict:
        return {"Min": self.min, "Max": self.max}

    @classmethod
    def from_json(cls, obj: dict) -> "MinMaxIndex":
        return cls(min=int(obj["Min"]), max=int(obj["Max"]))


def convert_to_min_max_int64(value: Any) -> Optional[tuple[int, int]]:
    """Convert a numeric value to (min, max) int64 bounds, else None.

    Integers yield (v, v); floats yield (floor(v), ceil(v))
    (min_max.go:16-28). Non-finite floats and non-numerics are rejected.
    """
    if isinstance(value, bool):
        return None
    if isinstance(value, int):
        v = clamp_int64(value)
        return (v, v)
    if isinstance(value, float):
        if not math.isfinite(value):
            return None
        return (clamp_int64(math.floor(value)), clamp_int64(math.ceil(value)))
    return None


def convert_to_int64(value: Any) -> Optional[int]:
    """Convert a numeric value to int64 (floats round-to-nearest), else None.

    (min_max.go:33-44)
    """
    if isinstance(value, bool):
        return None
    if isinstance(value, int):
        return clamp_int64(value)
    if isinstance(value, float):
        if not math.isfinite(value):
            return None
        # Go math.Round: half away from zero.
        return clamp_int64(int(math.floor(value + 0.5)) if value >= 0 else int(math.ceil(value - 0.5)))
    return None


def update_min_max_index(existing: MinMaxIndex, new_min: int, new_max: int) -> MinMaxIndex:
    """Widen an index to include new bounds (min_max.go:74-83)."""
    return MinMaxIndex(min=min(existing.min, new_min), max=max(existing.max, new_max))


def union_min_max_indexes(a: dict[str, MinMaxIndex], b: dict[str, MinMaxIndex]) -> dict[str, MinMaxIndex]:
    """Field-wise union of two minmax maps (used by merge; engine :1425-1446)."""
    out = {k: MinMaxIndex(v.min, v.max) for k, v in a.items()}
    for k, v in b.items():
        if k in out:
            out[k] = update_min_max_index(out[k], v.min, v.max)
        else:
            out[k] = MinMaxIndex(v.min, v.max)
    return out
