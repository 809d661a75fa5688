"""Stable batched string hashing for bloom filters.

Each key hashes to a 128-bit digest (murmur3 x64_128, seed 0) split into two
64-bit lanes ``(h1, h2)``; probe positions follow Kirsch–Mitzenmacher double
hashing: ``pos_i = (h1 + i*h2) mod m``. This replaces the reference's
bits-and-blooms/murmur3 numerical core (SURVEY.md §1). The exact bit layout
need not match the Go library — files are our own format — but it must be
stable across processes and identical between the native (C++) and pure
Python implementations, which the tests cross-check.

Hot paths use the native batch hasher (``_native/``); the pure-Python
implementation is the always-available fallback and the semantic spec.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np

_M64 = (1 << 64) - 1
_C1 = 0x87C37B91114253D5
_C2 = 0x4CF5AD432745937F

HASH_NAME = "murmur3_x64_128"


def _rotl64(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _fmix64(h: int) -> int:
    h ^= h >> 33
    h = (h * 0xFF51AFD7ED558CCD) & _M64
    h ^= h >> 33
    h = (h * 0xC4CEB9FE1A85EC53) & _M64
    h ^= h >> 33
    return h


def murmur3_x64_128(data: bytes, seed: int = 0) -> tuple[int, int]:
    """Reference implementation of murmur3 x64_128 (public algorithm)."""
    length = len(data)
    h1 = seed & _M64
    h2 = seed & _M64
    n_blocks = length // 16

    for i in range(n_blocks):
        off = i * 16
        k1 = int.from_bytes(data[off : off + 8], "little")
        k2 = int.from_bytes(data[off + 8 : off + 16], "little")

        k1 = (k1 * _C1) & _M64
        k1 = _rotl64(k1, 31)
        k1 = (k1 * _C2) & _M64
        h1 ^= k1
        h1 = _rotl64(h1, 27)
        h1 = (h1 + h2) & _M64
        h1 = (h1 * 5 + 0x52DCE729) & _M64

        k2 = (k2 * _C2) & _M64
        k2 = _rotl64(k2, 33)
        k2 = (k2 * _C1) & _M64
        h2 ^= k2
        h2 = _rotl64(h2, 31)
        h2 = (h2 + h1) & _M64
        h2 = (h2 * 5 + 0x38495AB5) & _M64

    tail = data[n_blocks * 16 :]
    k1 = 0
    k2 = 0
    tail_len = len(tail)
    for i in range(min(tail_len, 16) - 1, 7, -1):  # bytes 8..15 -> k2
        k2 = (k2 << 8) | tail[i]
    for i in range(min(tail_len, 8) - 1, -1, -1):  # bytes 0..7 -> k1
        k1 = (k1 << 8) | tail[i]
    if tail_len > 8:
        k2 = (k2 * _C2) & _M64
        k2 = _rotl64(k2, 33)
        k2 = (k2 * _C1) & _M64
        h2 ^= k2
    if tail_len > 0:
        k1 = (k1 * _C1) & _M64
        k1 = _rotl64(k1, 31)
        k1 = (k1 * _C2) & _M64
        h1 ^= k1

    h1 ^= length
    h2 ^= length
    h1 = (h1 + h2) & _M64
    h2 = (h2 + h1) & _M64
    h1 = _fmix64(h1)
    h2 = _fmix64(h2)
    h1 = (h1 + h2) & _M64
    h2 = (h2 + h1) & _M64
    return h1, h2


KeyLike = Union[str, bytes]


def _encode(key: KeyLike) -> bytes:
    return key.encode("utf-8") if isinstance(key, str) else key


def hash_keys_py(keys: Sequence[KeyLike]) -> np.ndarray:
    """Pure-Python batch hash -> [N, 2] uint64 array of (h1, h2)."""
    out = np.empty((len(keys), 2), dtype=np.uint64)
    for i, key in enumerate(keys):
        h1, h2 = murmur3_x64_128(_encode(key))
        out[i, 0] = h1
        out[i, 1] = h2
    return out


def hash_keys(keys: Sequence[KeyLike]) -> np.ndarray:
    """Batch hash using the native library when available -> [N, 2] uint64."""
    from .. import native

    if native.available():
        return native.hash_batch([_encode(k) for k in keys])
    return hash_keys_py(keys)


def positions_for_hashes(hashes: np.ndarray, k: int, m_bits: int) -> np.ndarray:
    """Kirsch–Mitzenmacher probe positions -> [N, k] uint64 in [0, m).

    uint64 arithmetic wraps (numpy unsigned overflow is silent), matching the
    native implementation's modular arithmetic.
    """
    i = np.arange(k, dtype=np.uint64)
    return (hashes[:, 0:1] + i[None, :] * hashes[:, 1:2]) % np.uint64(m_bits)


def positions_for_hashes_blocked(hashes: np.ndarray, k: int, m_bits: int) -> np.ndarray:
    """Blocked-256 probe positions -> [N, k] uint64, all k inside one

    256-bit aligned block per key. The block index comes from h1's high bits
    (decorrelated from the in-block KM sequence, which uses the low bits);
    in-block bits follow KM over h2 with an odd step so the k positions
    cycle through all 256 slots. Semantics shared bit-exactly by the numpy,
    C++, and device implementations.
    """
    assert m_bits % 256 == 0, "blocked layout requires m padded to 256 bits"
    num_blocks = m_bits // 256
    h1 = hashes[:, 0]
    h2 = hashes[:, 1]
    block = (h1 >> np.uint64(32)) % np.uint64(num_blocks)  # [N]
    step = (h2 | np.uint64(1)) & np.uint64(255)  # odd -> full 256-cycle
    j = np.arange(k, dtype=np.uint64)
    bits = (h1[:, None] + (j[None, :] + np.uint64(1)) * step[:, None]) & np.uint64(255)
    return block[:, None] * np.uint64(256) + bits


def positions_for_keys(keys: Sequence[KeyLike], k: int, m_bits: int) -> np.ndarray:
    """hash + KM positions in one call -> [N, k] uint64."""
    if len(keys) == 0:
        return np.empty((0, k), dtype=np.uint64)
    return positions_for_hashes(hash_keys(keys), k, m_bits)


def positions_for_layout(hashes: np.ndarray, k: int, m_bits: int, layout: str) -> np.ndarray:
    from .params import LAYOUT_BLOCKED256

    if layout == LAYOUT_BLOCKED256:
        return positions_for_hashes_blocked(hashes, k, m_bits)
    return positions_for_hashes(hashes, k, m_bits)


def split_positions(positions: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Split bit positions into (word_idx int32, bit_idx int32) for 32-bit words."""
    word = (positions >> np.uint64(5)).astype(np.int32)
    bit = (positions & np.uint64(31)).astype(np.int32)
    return word, bit
