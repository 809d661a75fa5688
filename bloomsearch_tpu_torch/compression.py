"""Row-data compression codecs: none / zstd / snappy.

The reference supports none, snappy, and zstd with streaming encoders per
partition buffer and one-shot decode per block read
(bloom_tree_engine.go:46-80, :1136-1153). Here:

- ``none``: identity
- ``zstd``: the ``zstandard`` package's streaming compressor
- ``snappy``: our native C++ codec (chunked framing); available only when the
  native library is built — config validation gates on this.

A block's compressed payload is written/read as a whole; codecs may be mixed
across blocks in a merged file (each block records its own codec, like the
reference; bloom_tree_engine.go:1762-1786).
"""

from __future__ import annotations

import io
from typing import Optional

try:
    import zstandard as _zstd
except ImportError:  # pragma: no cover - zstandard is in the base image
    _zstd = None

COMPRESSION_NONE = "none"
COMPRESSION_SNAPPY = "snappy"
COMPRESSION_ZSTD = "zstd"

ALL_COMPRESSIONS = (COMPRESSION_NONE, COMPRESSION_SNAPPY, COMPRESSION_ZSTD)


def compression_available(compression: str) -> bool:
    if compression == COMPRESSION_NONE:
        return True
    if compression == COMPRESSION_ZSTD:
        return _zstd is not None
    if compression == COMPRESSION_SNAPPY:
        from . import snappy as _snappy

        return _snappy.available()
    return False


class StreamEncoder:
    """Incremental compressor accumulating the compressed block payload.

    Mirrors the reference's per-partition-buffer compression encoders
    (bloom_tree_engine.go:46-80): rows are appended as they arrive, and
    ``finish()`` finalizes the stream and returns the complete payload.
    ``compressed_len`` is the bytes accumulated so far (an *approximation*
    while the encoder buffers internally), used for row-group byte caps the
    same way the reference uses ``buffer.Len()``.
    """

    def __init__(self, compression: str, zstd_level: int = 3):
        self.compression = compression
        self._buf = io.BytesIO()
        self._uncompressed = 0
        self._finished = False
        if compression == COMPRESSION_NONE:
            self._obj = None
        elif compression == COMPRESSION_ZSTD:
            if _zstd is None:
                raise RuntimeError("zstandard package not available")
            self._obj = _zstd.ZstdCompressor(level=zstd_level).compressobj()
        elif compression == COMPRESSION_SNAPPY:
            from . import snappy as _snappy

            self._obj = _snappy.SnappyStreamCompressor()
        else:
            raise ValueError(f"unknown compression type: {compression!r}")

    def write(self, data: bytes) -> None:
        assert not self._finished
        self._uncompressed += len(data)
        if self._obj is None:
            self._buf.write(data)
        else:
            out = self._obj.compress(data)
            if out:
                self._buf.write(out)

    @property
    def compressed_len(self) -> int:
        return self._buf.tell()

    @property
    def uncompressed_len(self) -> int:
        return self._uncompressed

    def finish(self) -> bytes:
        if not self._finished:
            if self._obj is not None:
                tail = self._obj.flush()
                if tail:
                    self._buf.write(tail)
            self._finished = True
        return self._buf.getvalue()


def decompress_block(data: bytes, compression: str, uncompressed_size: Optional[int] = None) -> bytes:
    """One-shot decode of a block's compressed row payload."""
    if compression == COMPRESSION_NONE or not compression:
        return data
    if compression == COMPRESSION_ZSTD:
        if _zstd is None:
            raise RuntimeError("zstandard package not available")
        obj = _zstd.ZstdDecompressor().decompressobj()
        return obj.decompress(data)
    if compression == COMPRESSION_SNAPPY:
        from . import snappy as _snappy

        return _snappy.decompress_stream(data)
    raise ValueError(f"unknown compression type: {compression!r}")
