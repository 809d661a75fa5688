"""Host-side bloom filter over a uint32 word array.

The numerical replacement for the reference's bits-and-blooms dependency
(SURVEY.md §1): same sizing math (params.py), Kirsch–Mitzenmacher double
hashing over murmur3 x64_128 lanes (hashing.py), and the same semantic
guarantees — zero false negatives, FPR ≈ p at the estimated (m, k), and
OR-merge validity only at identical (m, k) (bloom_tree_engine.go:1401-1423).

The word layout (little-endian uint32, bit = pos & 31, word = pos >> 5) is
shared verbatim with the device filter banks (bank.py), so host-built filters
upload to HBM without conversion.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .. import native
from .hashing import KeyLike, hash_keys, positions_for_layout
from .params import LAYOUT_CLASSIC, BloomParams, words_for_bits


class BloomFilter:
    __slots__ = ("m_bits", "k", "words", "layout")

    def __init__(
        self,
        m_bits: int,
        k: int,
        words: Optional[np.ndarray] = None,
        layout: str = LAYOUT_CLASSIC,
    ):
        self.m_bits = int(m_bits)
        self.k = int(k)
        self.layout = layout
        n_words = words_for_bits(self.m_bits)
        if words is None:
            self.words = np.zeros(n_words, dtype=np.uint32)
        else:
            if words.dtype != np.uint32 or words.shape != (n_words,):
                raise ValueError(
                    f"words must be uint32[{n_words}], got {words.dtype}{words.shape}"
                )
            self.words = words

    @classmethod
    def new_with_estimates(cls, n: int, p: float, layout: str = LAYOUT_CLASSIC) -> "BloomFilter":
        """Sized like bits-and-blooms ``NewWithEstimates(n, p)`` (SURVEY.md §1)."""
        params = BloomParams(n, p, layout)
        return cls(params.m_bits, params.k, layout=layout)

    @classmethod
    def from_params(cls, params: BloomParams) -> "BloomFilter":
        return cls(params.m_bits, params.k, layout=params.layout)

    # -- build ------------------------------------------------------------

    def add_hashes(self, hashes: np.ndarray) -> None:
        """Add pre-hashed keys ([N, 2] uint64)."""
        if hashes.shape[0] == 0:
            return
        if native.available():
            if self.layout == LAYOUT_CLASSIC:
                native.build_from_hashes(self.words, self.m_bits, self.k, hashes)
            else:
                native.build_from_hashes_blocked(self.words, self.m_bits, self.k, hashes)
            return
        positions = positions_for_layout(hashes, self.k, self.m_bits, self.layout).ravel()
        word = (positions >> np.uint64(5)).astype(np.int64)
        bit = (positions & np.uint64(31)).astype(np.uint32)
        np.bitwise_or.at(self.words, word, np.uint32(1) << bit)

    def add_keys(self, keys: Sequence[KeyLike]) -> None:
        if len(keys) == 0:
            return
        self.add_hashes(hash_keys(keys))

    def add(self, key: KeyLike) -> None:
        self.add_keys([key])

    # -- probe ------------------------------------------------------------

    def test_hashes(self, hashes: np.ndarray) -> np.ndarray:
        """Membership test for pre-hashed keys -> [N] bool (no false negatives)."""
        if hashes.shape[0] == 0:
            return np.zeros(0, dtype=bool)
        if native.available():
            if self.layout == LAYOUT_CLASSIC:
                return native.probe_from_hashes(self.words, self.m_bits, self.k, hashes)
            return native.probe_from_hashes_blocked(self.words, self.m_bits, self.k, hashes)
        positions = positions_for_layout(hashes, self.k, self.m_bits, self.layout)
        word = (positions >> np.uint64(5)).astype(np.int64)
        bit = (positions & np.uint64(31)).astype(np.uint32)
        bits = (self.words[word] >> bit) & np.uint32(1)
        return np.all(bits.astype(bool), axis=1)

    def test_keys(self, keys: Sequence[KeyLike]) -> np.ndarray:
        if len(keys) == 0:
            return np.zeros(0, dtype=bool)
        return self.test_hashes(hash_keys(keys))

    def test(self, key: KeyLike) -> bool:
        return bool(self.test_keys([key])[0])

    # -- combine / serialize ----------------------------------------------

    def merge(self, other: "BloomFilter") -> None:
        """In-place OR-merge; only valid at identical (m, k)

        (reference merge gate, bloom_tree_engine.go:1374-1399).
        """
        if other.m_bits != self.m_bits or other.k != self.k or other.layout != self.layout:
            raise ValueError(
                f"cannot merge bloom filters with different params: "
                f"(m={self.m_bits}, k={self.k}, {self.layout}) vs "
                f"(m={other.m_bits}, k={other.k}, {other.layout})"
            )
        np.bitwise_or(self.words, other.words, out=self.words)

    def copy(self) -> "BloomFilter":
        return BloomFilter(self.m_bits, self.k, self.words.copy(), layout=self.layout)

    def reset(self) -> None:
        self.words.fill(0)

    def to_bytes(self) -> bytes:
        """Little-endian uint32 word dump (bank-loadable without conversion)."""
        return self.words.astype("<u4", copy=False).tobytes()

    @classmethod
    def from_bytes(
        cls, m_bits: int, k: int, data: bytes, layout: str = LAYOUT_CLASSIC
    ) -> "BloomFilter":
        words = np.frombuffer(data, dtype="<u4").astype(np.uint32)
        return cls(m_bits, k, words, layout=layout)

    def bit_count(self) -> int:
        """Number of set bits (diagnostics / fill-ratio checks)."""
        return int(np.unpackbits(self.words.view(np.uint8)).sum())

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, BloomFilter)
            and self.m_bits == other.m_bits
            and self.k == other.k
            and self.layout == other.layout
            and bool(np.array_equal(self.words, other.words))
        )

    # Defining __eq__ sets __hash__ to None implicitly; make the
    # unhashability EXPLICIT — filters are mutable (add/merge), so
    # value-hashing them into sets/dicts would be a correctness trap.
    __hash__ = None
