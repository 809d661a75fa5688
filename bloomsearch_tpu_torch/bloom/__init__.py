from .params import BloomParams, estimate_parameters, words_for_bits
from .hashing import (
    HASH_NAME,
    hash_keys,
    murmur3_x64_128,
    positions_for_hashes,
    positions_for_keys,
    split_positions,
)
from .filter import BloomFilter

__all__ = [
    "BloomParams",
    "BloomFilter",
    "HASH_NAME",
    "estimate_parameters",
    "words_for_bits",
    "hash_keys",
    "murmur3_x64_128",
    "positions_for_hashes",
    "positions_for_keys",
    "split_positions",
]
