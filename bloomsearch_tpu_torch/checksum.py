"""CRC32C (Castagnoli) checksums for file integrity.

The file format CRCs metadata, filter banks, and row data exactly like the
reference (file_format.go:33-34, bloom_tree_engine.go:1197-1203). Uses the
native slicing-by-8 implementation when available; pure-Python table fallback
otherwise (identical outputs, cross-checked in tests).
"""

from __future__ import annotations

from . import native

_POLY = 0x82F63B78
_table: list[int] | None = None


def _get_table() -> list[int]:
    global _table
    if _table is None:
        table = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ (_POLY if crc & 1 else 0)
            table.append(crc)
        _table = table
    return _table


def crc32c_py(data: bytes, crc_in: int = 0) -> int:
    table = _get_table()
    crc = crc_in ^ 0xFFFFFFFF
    for byte in data:
        crc = (crc >> 8) ^ table[(crc ^ byte) & 0xFF]
    return crc ^ 0xFFFFFFFF


def crc32c(data, crc_in: int = 0) -> int:
    if native.available():
        return native.crc32c(data, crc_in)
    return crc32c_py(bytes(data), crc_in)
