"""Bloom filter sizing math.

Must match the reference's library semantics (SURVEY.md §1: bits-and-blooms
``NewWithEstimates``): for ``n`` expected items at false-positive rate ``p``,

    m = ceil(-n * ln(p) / ln(2)^2)        # total bits
    k = ceil(ln(2) * m / n)               # number of hash probes

Matching (m, k) at equal bits-per-row yields matched FPR vs the reference.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

WORD_BITS = 32

# Filter bit layouts:
# - "classic": Kirsch–Mitzenmacher positions anywhere in [0, m) — the
#   reference's semantics (bits-and-blooms), k independent random words.
# - "blocked256": each key selects ONE 256-bit (8-word) aligned block and
#   its k bits live inside it (split-block bloom filter, cf. Parquet/Impala).
#   The device probe then fetches a single aligned 8-row group per term
#   instead of per probe — ~k× less HBM traffic — at a measured FPR penalty
#   of ~1.6x at p=0.01, ~5x at p=0.001 and ~30x at p=0.0001 (the 256-bit
#   block floors achievable FPR near 3e-3; see docs/BLOCKED256.md for the
#   full sweep and why classic stays the default).
LAYOUT_CLASSIC = "classic"
LAYOUT_BLOCKED256 = "blocked256"
BLOCK_BITS = 256


def estimate_parameters(n: int, p: float) -> tuple[int, int]:
    """(m_bits, k) for n expected items at false positive rate p."""
    if n <= 0:
        n = 1
    if not (0.0 < p < 1.0):
        raise ValueError(f"false positive rate must be in (0, 1), got {p}")
    m = math.ceil(-float(n) * math.log(p) / (math.log(2.0) ** 2))
    k = math.ceil(math.log(2.0) * m / n)
    return max(1, int(m)), max(1, int(k))


def words_for_bits(m_bits: int) -> int:
    """Number of uint32 words backing an m-bit filter."""
    return (m_bits + WORD_BITS - 1) // WORD_BITS


@dataclass(frozen=True)
class BloomParams:
    """The (n, p) sizing pair plus derived (m, k) and the bit layout.

    Files record (expected_items, fpr, layout) per block and per file like
    the reference records its params (file_format.go:176-177); merge
    compatibility is gated on the full tuple (bloom_tree_engine.go:1374-1399).
    """

    expected_items: int
    false_positive_rate: float
    layout: str = LAYOUT_CLASSIC

    @property
    def m_bits(self) -> int:
        m = estimate_parameters(self.expected_items, self.false_positive_rate)[0]
        if self.layout == LAYOUT_BLOCKED256:
            m = ((m + BLOCK_BITS - 1) // BLOCK_BITS) * BLOCK_BITS
        return m

    @property
    def k(self) -> int:
        return estimate_parameters(self.expected_items, self.false_positive_rate)[1]

    @property
    def num_words(self) -> int:
        return words_for_bits(self.m_bits)

    def to_json(self) -> dict:
        out = {
            "ExpectedItems": self.expected_items,
            "FalsePositiveRate": self.false_positive_rate,
        }
        if self.layout != LAYOUT_CLASSIC:
            out["Layout"] = self.layout
        return out

    @classmethod
    def from_json(cls, obj: dict) -> "BloomParams":
        return cls(
            int(obj["ExpectedItems"]),
            float(obj["FalsePositiveRate"]),
            obj.get("Layout", LAYOUT_CLASSIC),
        )
