"""Persisted packed serving state (the restart sidecar cache).

An engine restart re-derives the device row-cache's stream contents from
immutable file bytes: read block -> CRC verify -> decompress -> split rows
-> lowercase + overlapped-chunk pack (rowcache.pack_block). Every output is
a pure function of the block's bytes — data files are immutable and only
become visible via the atomic metadata publish — so the packed state is
persisted ONCE, and a restart becomes mmap + h2d upload instead of
decode + pack. This bounds restart cost by the pin-upload floor (the one
thing that must physically recur per process: getting bytes back into
device memory).

The format is the JAX package's (``bloomsearch_tpu/servingcache.py``), so
a sidecar written by either package loads in the other.

Sidecar files are a CACHE, not data: any validation failure (version
skew, hash mismatch, torn write) silently misses and the engine falls
back to the decode+pack path, then rewrites the sidecar. Writes go to a
temp file + os.replace so readers never observe a partial file; a trailer
magic guards against truncation even on filesystems without atomic
rename semantics.

Layout (little-endian, sections 64-byte aligned for a zero-copy int32
view of the mmap'd chunk matrix):

    MAGIC(8) | header_len u32 | header JSON | pad
    chunks   uint8[n_chunks * CHUNK_BYTES]          (mmap'd on load)
    flags    packbits-LE uint8[ceil(num_rows / 8)]
    row_offsets i32[num_rows] | row_lengths i32[num_rows]
    comp_index  i64[comp_index_len]
    TRAILER(8)
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import tempfile
import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np

from .rowcache import CHUNK_BYTES, STREAM_STRIDE
from .utils import remember

logger = logging.getLogger("bloomsearch_tpu_torch.servingcache")

MAGIC = b"BSRVCACH"
TRAILER = b"BSRVEND\n"
# Bump on ANY change to the pack layout (rowcache pack semantics, chunk
# geometry, or this file's format) — stale sidecars then miss cleanly.
PACK_VERSION = 1
_ALIGN = 64


def _align(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


@dataclass
class PackedEntry:
    """A block's persisted serving state, ready for DeviceRowCache.pin's
    ``prepacked`` fast path. ``chunks`` is a read-only mmap view — pin()
    pages it in one upload piece at a time, so a restart never
    materializes the whole stream in host RAM."""

    chunks: np.ndarray  # uint8[max(n_chunks,1), CHUNK_BYTES]
    always_candidate: np.ndarray  # bool[num_rows]
    n_chunks: int
    row_offsets: np.ndarray  # int32[num_rows]
    row_lengths: np.ndarray  # int32[num_rows]
    comp_index: Optional[np.ndarray]  # int64[], snappy chunk offsets


class ServingStateCache:
    """One sidecar file per (file pointer, block); names embed a pointer
    hash + block offset + row-data CRC so a re-created pointer with
    different bytes can never read a stale entry."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.stores = 0
        # Name prefixes of the last tombstoned files (utils.remember).
        self._tombstoned: dict[str, None] = {}

    # -- paths -------------------------------------------------------------

    def _prefix(self, pointer: bytes) -> str:
        return hashlib.sha1(pointer).hexdigest()[:24]

    def _path(self, pointer: bytes, blk) -> str:
        return os.path.join(
            self.directory,
            f"{self._prefix(pointer)}-{blk.offset}-"
            f"{blk.row_data_hash & 0xFFFFFFFF:08x}.srv",
        )

    # -- read --------------------------------------------------------------

    def load(self, pointer: bytes, blk) -> Optional[PackedEntry]:
        """Validated load; any mismatch is a miss (never an error)."""
        path = self._path(pointer, blk)
        try:
            entry = self._load_impl(path, blk)
        except Exception:
            logger.debug("sidecar load failed for %s", path, exc_info=True)
            entry = None
        with self._lock:
            if entry is None:
                self.misses += 1
            else:
                self.hits += 1
        return entry

    def _load_impl(self, path: str, blk) -> Optional[PackedEntry]:
        try:
            fh = open(path, "rb")
        except FileNotFoundError:
            return None
        with fh:
            head = fh.read(12)
            if len(head) != 12 or head[:8] != MAGIC:
                return None
            hlen = int.from_bytes(head[8:12], "little")
            if hlen <= 0 or hlen > 1 << 20:
                return None
            try:
                hdr = json.loads(fh.read(hlen))
            except Exception:
                return None
            if (
                hdr.get("pack_version") != PACK_VERSION
                or hdr.get("stream_stride") != STREAM_STRIDE
                or hdr.get("chunk_bytes") != CHUNK_BYTES
                or hdr.get("row_data_hash") != blk.row_data_hash
                or hdr.get("uncompressed_size") != blk.uncompressed_size
                or hdr.get("rows") != blk.rows
                or hdr.get("compression") != blk.compression
            ):
                return None
            n_chunks = int(hdr["n_chunks"])
            num_rows = int(hdr["rows"])
            ci_len = int(hdr["comp_index_len"])
            chunk_rows = max(n_chunks, 1)
            chunks_off = _align(12 + hlen)
            chunks_nbytes = chunk_rows * CHUNK_BYTES
            flags_off = chunks_off + chunks_nbytes
            flags_nbytes = (num_rows + 7) // 8
            coords_off = _align(flags_off + flags_nbytes)
            coords_nbytes = 2 * 4 * num_rows
            ci_off = coords_off + coords_nbytes
            end = ci_off + 8 * ci_len
            # Truncation check BEFORE any mmap: the trailer must be intact.
            fh.seek(0, os.SEEK_END)
            if fh.tell() != end + len(TRAILER):
                return None
            fh.seek(end)
            if fh.read(len(TRAILER)) != TRAILER:
                return None
            fh.seek(flags_off)
            flags_raw = np.frombuffer(fh.read(flags_nbytes), dtype=np.uint8)
            always = (
                np.unpackbits(flags_raw, bitorder="little")[:num_rows].astype(bool)
                if num_rows
                else np.zeros(0, dtype=bool)
            )
            fh.seek(coords_off)
            coords = np.frombuffer(fh.read(coords_nbytes), dtype=np.int32)
            row_offsets = coords[:num_rows].copy()
            row_lengths = coords[num_rows:].copy()
            comp_index = None
            if ci_len:
                fh.seek(ci_off)
                comp_index = np.frombuffer(fh.read(8 * ci_len), dtype=np.int64).copy()
        # mmap the chunk matrix read-only: pin() slices pow2 pieces out of
        # it and uploads each piece.
        mm = np.memmap(path, dtype=np.uint8, mode="r", offset=chunks_off,
                       shape=(chunk_rows, CHUNK_BYTES))
        return PackedEntry(mm, always, n_chunks, row_offsets, row_lengths, comp_index)

    # -- write ---------------------------------------------------------------

    def store(
        self,
        pointer: bytes,
        blk,
        chunks: np.ndarray,
        always_candidate: np.ndarray,
        n_chunks: int,
        row_offsets: np.ndarray,
        row_lengths: np.ndarray,
        comp_index: Optional[np.ndarray],
    ) -> bool:
        """Best-effort atomic write; skipped if the entry already exists.
        Returns True when a new sidecar landed."""
        path = self._path(pointer, blk)
        if os.path.exists(path):
            return False
        num_rows = int(row_offsets.shape[0])
        ci = (
            np.ascontiguousarray(comp_index, dtype=np.int64)
            if comp_index is not None
            else np.zeros(0, dtype=np.int64)
        )
        hdr = json.dumps(
            {
                "pack_version": PACK_VERSION,
                "stream_stride": STREAM_STRIDE,
                "chunk_bytes": CHUNK_BYTES,
                "row_data_hash": blk.row_data_hash,
                "uncompressed_size": blk.uncompressed_size,
                "rows": num_rows,
                "n_chunks": int(n_chunks),
                "comp_index_len": int(ci.shape[0]),
                "compression": blk.compression,
            },
            separators=(",", ":"),
        ).encode()
        if num_rows != blk.rows or chunks.shape != (max(int(n_chunks), 1), CHUNK_BYTES):
            # Out of step with metadata / geometry: don't persist state a
            # future load would mis-validate against the block.
            return False
        try:
            fd, tmp = tempfile.mkstemp(
                prefix=".srv-", suffix=".tmp", dir=self.directory
            )
            try:
                with os.fdopen(fd, "wb") as out:
                    out.write(MAGIC)
                    out.write(len(hdr).to_bytes(4, "little"))
                    out.write(hdr)
                    out.write(b"\x00" * (_align(12 + len(hdr)) - (12 + len(hdr))))
                    out.write(np.ascontiguousarray(chunks, dtype=np.uint8).tobytes())
                    flags_u8 = np.packbits(
                        np.asarray(always_candidate, dtype=bool), bitorder="little"
                    )
                    out.write(flags_u8.tobytes())
                    pos = _align(12 + len(hdr)) + chunks.shape[0] * CHUNK_BYTES + flags_u8.nbytes
                    out.write(b"\x00" * (_align(pos) - pos))
                    out.write(np.ascontiguousarray(row_offsets, dtype=np.int32).tobytes())
                    out.write(np.ascontiguousarray(row_lengths, dtype=np.int32).tobytes())
                    out.write(ci.tobytes())
                    out.write(TRAILER)
                with self._lock:
                    # Under the lock ``invalidate_file`` marks a tombstone
                    # with: a store racing it lands before its listing or
                    # not at all.
                    landed = self._prefix(pointer) not in self._tombstoned
                    if landed:
                        os.replace(tmp, path)
                if not landed:
                    os.unlink(tmp)
                    return False
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
        except Exception:
            logger.debug("sidecar store failed for %s", path, exc_info=True)
            return False
        with self._lock:
            self.stores += 1
        return True

    # -- invalidation --------------------------------------------------------

    def invalidate_file(self, pointer: bytes) -> None:
        """Remove every sidecar belonging to a (tombstoned) file; the file is
        gone for good, so no later ``store`` of it lands."""
        with self._lock:
            remember(self._tombstoned, self._prefix(pointer))
        prefix = self._prefix(pointer) + "-"
        try:
            for name in os.listdir(self.directory):
                if name.startswith(prefix) and name.endswith(".srv"):
                    try:
                        os.unlink(os.path.join(self.directory, name))
                    except OSError:
                        pass
        except OSError:
            pass

    def stats(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses, "stores": self.stores}
