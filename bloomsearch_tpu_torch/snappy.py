"""Snappy codec backed by the native C++ library (chunked stream framing).

The reference defaults to snappy for fast decompression
(bloom_tree_engine.go:223-224); this module provides the same codec choice
via our own C++ implementation of the public snappy block format.

Stream framing (our own; files are not byte-interchange with the Go
reference): a sequence of chunks, each ``uint32 LE compressed_len`` followed
by one snappy block covering up to 64 KiB of input. Blocks are independent,
so decompression is a simple chunk walk and a corrupted chunk cannot poison
the rest of the stream.
"""

from __future__ import annotations

import struct

from . import native

CHUNK_SIZE = native.SNAPPY_MAX_BLOCK_INPUT  # 64 KiB per snappy block


def available() -> bool:
    return native.snappy_available()


class SnappyStreamCompressor:
    """Incremental chunked compressor with the StreamEncoder obj protocol."""

    def __init__(self):
        if not available():
            raise RuntimeError("snappy compression requires the native library")
        self._pending = bytearray()

    def _emit_full_chunks(self) -> bytes:
        # Cursor walk, ONE tail copy at the end: `del pending[:CHUNK_SIZE]`
        # per chunk memmoved the whole remaining buffer each time — a
        # multi-MB compress() call went quadratic (~N^2/2/65536 bytes moved).
        pending = self._pending
        if len(pending) < CHUNK_SIZE:
            return b""
        n_full = (len(pending) // CHUNK_SIZE) * CHUNK_SIZE
        view = memoryview(pending)
        # One GIL-free native call for all full chunks (bit-identical
        # framing); per-chunk loop only under a stale pre-round-5 .so.
        out = native.snappy_compress_stream(view[:n_full], CHUNK_SIZE)
        if out is None:
            buf = bytearray()
            pos = 0
            while pos < n_full:
                compressed = native.snappy_compress_block(
                    bytes(view[pos : pos + CHUNK_SIZE])
                )
                buf += struct.pack("<I", len(compressed))
                buf += compressed
                pos += CHUNK_SIZE
            out = bytes(buf)
        tail = bytes(view[n_full:])
        view.release()
        self._pending = bytearray(tail)
        return out

    def compress(self, data: bytes) -> bytes:
        self._pending += data
        return self._emit_full_chunks()

    def flush(self) -> bytes:
        out = bytearray(self._emit_full_chunks())
        if self._pending:
            compressed = native.snappy_compress_block(bytes(self._pending))
            self._pending.clear()
            out += struct.pack("<I", len(compressed))
            out += compressed
        return bytes(out)


def chunk_index(data: bytes):
    """Per-chunk compressed offsets for random access into a stream.

    Returns an int64 array of length n_chunks+1: chunk ``i``'s compressed
    bytes live at ``data[index[i]+4 : index[i+1]]`` (4 = its length header)
    and cover uncompressed ``[i*CHUNK_SIZE, (i+1)*CHUNK_SIZE)`` (last chunk
    shorter). Chunks are independent snappy blocks, so any subrange decodes
    without touching the rest — the basis for shadow-free candidate
    extraction (engine._fetch_pinned_rows).
    """
    import numpy as np

    offsets = [0]
    pos = 0
    n = len(data)
    while pos < n:
        if pos + 4 > n:
            raise ValueError("truncated snappy stream chunk header")
        (clen,) = struct.unpack_from("<I", data, pos)
        pos += 4 + clen
        if pos > n:
            raise ValueError("truncated snappy stream chunk")
        offsets.append(pos)
    return np.asarray(offsets, dtype=np.int64)


def decompress_chunk_run(data: bytes) -> bytes:
    """Decode a contiguous run of framed chunks (a chunk_index subrange)."""
    return decompress_stream(data)


def decompress_stream(data: bytes) -> bytes:
    if not available():
        raise RuntimeError("snappy decompression requires the native library")
    out = bytearray()
    pos = 0
    n = len(data)
    while pos < n:
        if pos + 4 > n:
            raise ValueError("truncated snappy stream chunk header")
        (clen,) = struct.unpack_from("<I", data, pos)
        pos += 4
        if pos + clen > n:
            raise ValueError("truncated snappy stream chunk")
        out += native.snappy_decompress_block(data[pos : pos + clen])
        pos += clen
    return bytes(out)
