"""On-disk file format v1 — immutable, single-pass, bank-oriented.

Structural parity with the reference format (FILE_FORMAT.md:9-75,
file_format.go, footer writer bloom_tree_engine.go:2072-2103) with one
TPU-first redesign: instead of serializing each block's bloom-filter triple
adjacent to the block (read back one block at a time — file_format.go:80-142),
all block filters of a file are packed into **dense filter banks** stored in
probe layout, so a single read (and a single device upload) covers every
block, and one kernel launch probes them all.

Layout (all integers little-endian)::

    [data block 0: compressed length-prefixed rows]
    [data block 1: ...]
    ...
    [bank group 0: uint32[3, num_words, num_blocks] + crc32c(4)]
    [bank group 1: ...]                      # one group per distinct (m, k)
    ...
    [footer: metadata JSON | crc32c(4) | metadata_len(4) | version(4) | magic(8)]

- A data block is a stream of ``(uint32 LE length | row JSON bytes)`` records,
  compressed as a whole (mirrors bloom_tree_engine.go:586-613).
- A bank group holds the filters of all blocks sharing bloom params (m, k),
  in probe layout ``[keyspace, word, block]`` — axis 0 is the keyspace
  (0=field, 1=token, 2=field:token), and for a fixed word the per-block words
  are contiguous, which is exactly the row-gather the probe kernel performs.
  Merged files may contain several groups because raw-copied blocks keep
  their original params (reference copyDataBlock, bloom_tree_engine.go:
  1762-1786).
- File-level filters live in the metadata JSON (base64 words) like the
  reference keeps them in ``FileMetadata`` (file_format.go:36-42), so the
  MetaStore can file-level-prune without opening the file.
- The footer is structurally identical to the reference's
  (metadata + CRC32C + length + version + magic).
"""

from __future__ import annotations

import base64
import struct
from dataclasses import dataclass, field as dc_field
from typing import BinaryIO, Optional

import json

import numpy as np

from .bloom.filter import BloomFilter
from .bloom.params import BloomParams
from .bloom.hashing import HASH_NAME
from .checksum import crc32c
from .minmax import MinMaxIndex

FILE_VERSION = 1
MAGIC_BYTES = b"BLMSTPU1"
HASH_SIZE = 4
LENGTH_PREFIX_SIZE = 4

KEYSPACE_FIELD = 0
KEYSPACE_TOKEN = 1
KEYSPACE_FIELD_TOKEN = 2
NUM_KEYSPACES = 3


class InvalidHashError(Exception):
    pass


class InvalidFormatError(Exception):
    pass


@dataclass
class BloomFilters:
    """The field / token / field:token filter triple (file_format.go:80-84)."""

    field: BloomFilter
    token: BloomFilter
    field_token: BloomFilter

    @classmethod
    def from_params(cls, params: BloomParams) -> "BloomFilters":
        return cls(
            BloomFilter.from_params(params),
            BloomFilter.from_params(params),
            BloomFilter.from_params(params),
        )

    def as_tuple(self) -> tuple[BloomFilter, BloomFilter, BloomFilter]:
        return (self.field, self.token, self.field_token)

    def merge(self, other: "BloomFilters") -> None:
        self.field.merge(other.field)
        self.token.merge(other.token)
        self.field_token.merge(other.field_token)

    def copy(self) -> "BloomFilters":
        return BloomFilters(self.field.copy(), self.token.copy(), self.field_token.copy())

    def to_json(self) -> dict:
        def one(f: BloomFilter) -> dict:
            out = {
                "MBits": f.m_bits,
                "K": f.k,
                "Words": base64.b64encode(f.words.astype("<u4").tobytes()).decode("ascii"),
            }
            if f.layout != "classic":
                out["Layout"] = f.layout
            return out

        return {
            "Field": one(self.field),
            "Token": one(self.token),
            "FieldToken": one(self.field_token),
        }

    @classmethod
    def from_json(cls, obj: dict) -> "BloomFilters":
        def one(o: dict) -> BloomFilter:
            return BloomFilter.from_bytes(
                int(o["MBits"]),
                int(o["K"]),
                base64.b64decode(o["Words"]),
                layout=o.get("Layout", "classic"),
            )

        return cls(one(obj["Field"]), one(obj["Token"]), one(obj["FieldToken"]))


@dataclass
class BankGroupMetadata:
    """One dense filter bank covering all blocks at a given (m, k).

    ``row_crc_offset`` locates an optional per-row CRC32C array (uint32 LE,
    one per flat bank row) written right after the payload — it lets sparse
    seek-reads be verified row-by-row so cold probes never *disqualify* a
    block on unverified bytes (the reference never tests an unverified
    filter, file_format.go:121-142). ``None`` on files written before the
    field existed; such groups must take the full verified read.
    """

    params: BloomParams
    m_bits: int
    k: int
    num_blocks: int
    offset: int
    size: int
    crc: int
    row_crc_offset: Optional[int] = None

    @property
    def num_words(self) -> int:
        return (self.m_bits + 31) // 32

    def to_json(self) -> dict:
        out = {
            "BloomExpectedItems": self.params.expected_items,
            "BloomFalsePositiveRate": self.params.false_positive_rate,
            "MBits": self.m_bits,
            "K": self.k,
            "NumBlocks": self.num_blocks,
            "Offset": self.offset,
            "Size": self.size,
            "Crc": self.crc,
        }
        if self.row_crc_offset is not None:
            out["RowCrcOffset"] = self.row_crc_offset
        if self.params.layout != "classic":
            out["Layout"] = self.params.layout
        return out

    @classmethod
    def from_json(cls, obj: dict) -> "BankGroupMetadata":
        row_crc_offset = obj.get("RowCrcOffset")
        return cls(
            params=BloomParams(
                int(obj["BloomExpectedItems"]),
                float(obj["BloomFalsePositiveRate"]),
                obj.get("Layout", "classic"),
            ),
            m_bits=int(obj["MBits"]),
            k=int(obj["K"]),
            num_blocks=int(obj["NumBlocks"]),
            offset=int(obj["Offset"]),
            size=int(obj["Size"]),
            crc=int(obj["Crc"]),
            row_crc_offset=int(row_crc_offset) if row_crc_offset is not None else None,
        )


@dataclass
class DataBlockMetadata:
    """Per-block metadata (reference file_format.go:153-178, plus bank coords).

    ``offset``/``size`` cover the compressed row payload only — block filters
    live in the bank section, addressed by (``bank_group``, ``bank_col``).
    ``created_at_ms`` supports TTL expiry during merge (README.md:283-287 —
    designed but unimplemented in the reference; implemented here).
    """

    offset: int = 0
    size: int = 0
    rows: int = 0
    partition_id: str = ""
    min_max_indexes: dict[str, MinMaxIndex] = dc_field(default_factory=dict)
    compression: str = "none"
    uncompressed_size: int = 0
    row_data_hash: int = 0
    created_at_ms: int = 0
    bloom_expected_items: int = 0
    bloom_false_positive_rate: float = 0.0
    bloom_layout: str = "classic"
    bank_group: int = 0
    bank_col: int = 0
    # True when every stored row is the engine's own canonical
    # re-serialization (json.dumps of the parsed object): numeric tokens
    # are then guaranteed substrings of their stored spelling (fuzz-tested
    # invariant) and the candidate scan may prune on them. Verbatim
    # (ingest_serialized) and foreign/older blocks default False — a row
    # spelled "1e5" stores no "100000" bytes even though the token index
    # and exact verification both match it.
    rows_canonical: bool = False

    @property
    def bloom_params(self) -> BloomParams:
        return BloomParams(
            self.bloom_expected_items, self.bloom_false_positive_rate, self.bloom_layout
        )

    def to_json(self) -> dict:
        out = {
            "Offset": self.offset,
            "Size": self.size,
            "Rows": self.rows,
            "Compression": self.compression,
            "UncompressedSize": self.uncompressed_size,
            "RowDataHash": self.row_data_hash,
            "CreatedAtMs": self.created_at_ms,
            "BloomExpectedItems": self.bloom_expected_items,
            "BloomFalsePositiveRate": self.bloom_false_positive_rate,
            "BankGroup": self.bank_group,
            "BankCol": self.bank_col,
        }
        if self.bloom_layout != "classic":
            out["BloomLayout"] = self.bloom_layout
        if self.rows_canonical:
            out["RowsCanonical"] = True
        if self.partition_id:
            out["PartitionID"] = self.partition_id
        if self.min_max_indexes:
            out["MinMaxIndexes"] = {k: v.to_json() for k, v in self.min_max_indexes.items()}
        return out

    @classmethod
    def from_json(cls, obj: dict) -> "DataBlockMetadata":
        return cls(
            offset=int(obj["Offset"]),
            size=int(obj["Size"]),
            rows=int(obj["Rows"]),
            partition_id=obj.get("PartitionID", ""),
            min_max_indexes={
                k: MinMaxIndex.from_json(v)
                for k, v in obj.get("MinMaxIndexes", {}).items()
            },
            compression=obj.get("Compression", "none"),
            uncompressed_size=int(obj.get("UncompressedSize", 0)),
            row_data_hash=int(obj.get("RowDataHash", 0)),
            created_at_ms=int(obj.get("CreatedAtMs", 0)),
            bloom_expected_items=int(obj["BloomExpectedItems"]),
            bloom_false_positive_rate=float(obj["BloomFalsePositiveRate"]),
            bloom_layout=obj.get("BloomLayout", "classic"),
            bank_group=int(obj.get("BankGroup", 0)),
            bank_col=int(obj.get("BankCol", 0)),
            rows_canonical=bool(obj.get("RowsCanonical", False)),
        )


@dataclass
class FileMetadata:
    """File footer metadata (reference file_format.go:36-42).

    Carries the file-level filter triple inline (so the MetaStore can prune
    without opening the file), the file-level bloom params, all block
    metadata, and the bank-group directory.
    """

    bloom_filters: Optional[BloomFilters]  # None: foreign/trimmed footer — pass through
    bloom_expected_items: int
    bloom_false_positive_rate: float
    data_blocks: list[DataBlockMetadata] = dc_field(default_factory=list)
    bank_groups: list[BankGroupMetadata] = dc_field(default_factory=list)
    hash_name: str = HASH_NAME

    @property
    def file_bloom_params(self) -> BloomParams:
        # Layout from the stored filter triple, NOT hardcoded classic: a
        # blocked256 engine writes blocked file-level filters, and a caller
        # sizing or merge-gating on these params with the wrong layout gets
        # unpadded m_bits / a classic filter probed with blocked positions.
        layout = (
            self.bloom_filters.field.layout
            if self.bloom_filters is not None
            else "classic"
        )
        return BloomParams(
            self.bloom_expected_items, self.bloom_false_positive_rate, layout=layout
        )

    def to_json(self) -> dict:
        return {
            "Version": FILE_VERSION,
            "HashName": self.hash_name,
            "BloomFilters": (
                self.bloom_filters.to_json() if self.bloom_filters is not None else None
            ),
            "BloomExpectedItems": self.bloom_expected_items,
            "BloomFalsePositiveRate": self.bloom_false_positive_rate,
            "DataBlocks": [b.to_json() for b in self.data_blocks],
            "BankGroups": [g.to_json() for g in self.bank_groups],
        }

    @classmethod
    def from_json(cls, obj: dict) -> "FileMetadata":
        # Tolerate absent file-level filters: the engine warns and passes
        # the file through unprobed rather than failing the scan (the
        # reference's nil-filter stance, bloom_tree_engine.go:885-905).
        filters_obj = obj.get("BloomFilters")
        return cls(
            bloom_filters=(
                BloomFilters.from_json(filters_obj) if filters_obj is not None else None
            ),
            bloom_expected_items=int(obj.get("BloomExpectedItems", 0)),
            bloom_false_positive_rate=float(obj.get("BloomFalsePositiveRate", 0.0)),
            data_blocks=[DataBlockMetadata.from_json(b) for b in obj.get("DataBlocks", [])],
            bank_groups=[BankGroupMetadata.from_json(g) for g in obj.get("BankGroups", [])],
            hash_name=obj.get("HashName", HASH_NAME),
        )

    def to_bytes(self) -> tuple[bytes, bytes]:
        """(metadata JSON bytes, CRC32C bytes) — reference FileMetadata.Bytes."""
        payload = json.dumps(self.to_json(), separators=(",", ":")).encode("utf-8")
        crc = crc32c(payload)
        return payload, struct.pack("<I", crc)

    @classmethod
    def from_bytes_with_hash(cls, payload: bytes, expected_hash: bytes) -> "FileMetadata":
        """Verify CRC then parse (reference FileMetadataFromBytesWithHash)."""
        actual = crc32c(payload)
        expected = struct.unpack("<I", expected_hash)[0]
        if actual != expected:
            raise InvalidHashError(f"metadata hash mismatch: expected {expected:x}, got {actual:x}")
        return cls.from_json(json.loads(payload))


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


class DataFileWriter:
    """Single-pass, append-only writer: rows stream out as blocks arrive;

    bank section and footer are written at ``finish()``. One flush = one file;
    one partition buffer = one data block (reference invariant, SURVEY.md
    §3.2).
    """

    def __init__(self, fh: BinaryIO, file_bloom_params: BloomParams):
        self._fh = fh
        self._pos = 0
        self._file_params = file_bloom_params
        self._blocks: list[DataBlockMetadata] = []
        self._block_filters: list[BloomFilters] = []
        # Banks built by finish(), keyed by group index — lets the engine
        # warm its device cache without re-reading what it just wrote.
        self.bank_arrays: list[np.ndarray] = []

    @property
    def bytes_written(self) -> int:
        return self._pos

    def _write(self, data: bytes) -> None:
        self._fh.write(data)
        self._pos += len(data)

    def add_block(
        self,
        compressed_rows: bytes,
        filters: BloomFilters,
        *,
        rows: int,
        partition_id: str,
        min_max_indexes: dict[str, MinMaxIndex],
        compression: str,
        uncompressed_size: int,
        created_at_ms: int,
        params: BloomParams,
        rows_canonical: bool = False,
    ) -> DataBlockMetadata:
        block = DataBlockMetadata(
            offset=self._pos,
            size=len(compressed_rows),
            rows=rows,
            partition_id=partition_id,
            min_max_indexes=dict(min_max_indexes),
            compression=compression,
            uncompressed_size=uncompressed_size,
            row_data_hash=crc32c(compressed_rows),
            created_at_ms=created_at_ms,
            bloom_expected_items=params.expected_items,
            bloom_false_positive_rate=params.false_positive_rate,
            bloom_layout=params.layout,
            rows_canonical=rows_canonical,
        )
        self._write(compressed_rows)
        self._blocks.append(block)
        self._block_filters.append(filters)
        return block

    def finish(self, file_filters: BloomFilters) -> FileMetadata:
        """Write bank section + footer; returns the complete metadata."""
        # Group blocks by (m, k); stable order of first appearance.
        groups: dict[tuple[int, int, str], list[int]] = {}
        for i, f in enumerate(self._block_filters):
            key = (f.field.m_bits, f.field.k, f.field.layout)
            groups.setdefault(key, []).append(i)

        bank_groups: list[BankGroupMetadata] = []
        for group_idx, ((m_bits, k, _layout), block_indices) in enumerate(groups.items()):
            num_blocks = len(block_indices)
            num_words = (m_bits + 31) // 32
            bank = np.zeros((NUM_KEYSPACES, num_words, num_blocks), dtype=np.uint32)
            for col, bi in enumerate(block_indices):
                triple = self._block_filters[bi]
                for ks, filt in enumerate(triple.as_tuple()):
                    bank[ks, :, col] = filt.words
                self._blocks[bi].bank_group = group_idx
                self._blocks[bi].bank_col = col
            self.bank_arrays.append(bank)
            payload = bank.astype("<u4", copy=False).tobytes()
            offset = self._pos
            self._write(payload)
            # Per-row CRC array: one uint32 per flat bank row, enabling
            # verified sparse seek-reads (cold needle probes touch a few
            # rows, each checked against its own CRC).
            row_crc_offset = self._pos
            self._write(_bank_row_crcs(payload, NUM_KEYSPACES * num_words, num_blocks * 4))
            group = BankGroupMetadata(
                params=self._blocks[block_indices[0]].bloom_params,
                m_bits=m_bits,
                k=k,
                num_blocks=num_blocks,
                offset=offset,
                size=len(payload),
                crc=crc32c(payload),
                row_crc_offset=row_crc_offset,
            )
            bank_groups.append(group)

        metadata = FileMetadata(
            bloom_filters=file_filters,
            bloom_expected_items=self._file_params.expected_items,
            bloom_false_positive_rate=self._file_params.false_positive_rate,
            data_blocks=self._blocks,
            bank_groups=bank_groups,
        )
        write_footer(self._write, metadata)
        return metadata


def write_footer(write, metadata: FileMetadata) -> None:
    """metadata JSON | crc(4) | len(4) | version(4) | magic(8)

    (structure mirrors reference writeFileMetadataAndFooter,
    bloom_tree_engine.go:2072-2103)
    """
    payload, crc_bytes = metadata.to_bytes()
    write(payload)
    write(crc_bytes)
    write(struct.pack("<I", len(payload)))
    write(struct.pack("<I", FILE_VERSION))
    write(MAGIC_BYTES)


# ---------------------------------------------------------------------------
# Readers
# ---------------------------------------------------------------------------

_FOOTER_TAIL = len(MAGIC_BYTES) + 4 + 4 + HASH_SIZE  # magic + version + len + crc


def read_file_metadata(fh: BinaryIO, file_size: Optional[int] = None) -> FileMetadata:
    """Parse the footer of an open seekable file.

    (mirrors reference readFileMetadata, testing_file_system_store.go:59-135)
    """
    if file_size is None:
        fh.seek(0, 2)
        file_size = fh.tell()
    if file_size < _FOOTER_TAIL:
        raise InvalidFormatError("file too small to be a valid bloomsearch file")

    fh.seek(file_size - len(MAGIC_BYTES))
    magic = fh.read(len(MAGIC_BYTES))
    if magic != MAGIC_BYTES:
        raise InvalidFormatError(f"invalid magic bytes: {magic!r}")

    fh.seek(file_size - len(MAGIC_BYTES) - 4)
    (version,) = struct.unpack("<I", fh.read(4))
    if version != FILE_VERSION:
        raise InvalidFormatError(f"unsupported file version {version}")

    fh.seek(file_size - len(MAGIC_BYTES) - 8)
    (metadata_len,) = struct.unpack("<I", fh.read(4))

    metadata_offset = file_size - _FOOTER_TAIL - metadata_len
    if metadata_offset < 0:
        raise InvalidFormatError("metadata length exceeds file size")
    fh.seek(metadata_offset)
    payload = fh.read(metadata_len)
    crc_bytes = fh.read(HASH_SIZE)
    return FileMetadata.from_bytes_with_hash(payload, crc_bytes)


def _bank_row_crcs(payload: bytes, num_rows: int, row_bytes: int) -> bytes:
    """uint32 LE CRC32C per fixed-stride row of ``payload``."""
    from . import native

    if native.available():
        return native.crc32c_rows(payload, num_rows, row_bytes).astype("<u4").tobytes()
    mv = memoryview(payload)
    crcs = np.empty(num_rows, dtype="<u4")
    for r in range(num_rows):
        crcs[r] = crc32c(mv[r * row_bytes : (r + 1) * row_bytes])
    return crcs.tobytes()


def read_bank_rows(
    fh: BinaryIO, group: BankGroupMetadata, flat_rows: np.ndarray
) -> np.ndarray:
    """Seek-read specific bank rows -> uint32[len(flat_rows), num_blocks].

    ``flat_rows`` are keyspace*num_words + word indices. A needle query
    probes ~terms×k rows out of hundreds of thousands, so reading only
    those (a few KB of seeks) instead of the whole group makes COLD
    queries I/O-proportional to the probe, not the filter size.

    Every row read is verified against its per-row CRC32C (written by
    ``DataFileWriter.finish``), so sparse probes carry the same integrity
    guarantee as the full :func:`read_bank_group` path — unverified bytes
    never disqualify a block (the invariant the reference enforces with
    its whole-filter CRC, file_format.go:121-142). Groups written before
    the per-row CRC field existed raise ``InvalidFormatError``; callers
    must fall back to the full verified read.
    """
    if group.row_crc_offset is None:
        raise InvalidFormatError(
            "bank group has no per-row CRCs; sparse reads unavailable"
        )
    row_bytes = group.num_blocks * 4
    out = np.empty((len(flat_rows), group.num_blocks), dtype=np.uint32)
    want: dict[int, list[int]] = {}
    for i, r in enumerate(flat_rows):
        want.setdefault(int(r), []).append(i)
    rows_sorted = sorted(want)

    # Fetch the needed 4-byte CRC entries FIRST, coalesced into ranged
    # reads (gap <= 64 KB). Interleaving a far-away CRC seek with every
    # payload read doubled the I/O round-trips of cold sparse probes and
    # thrashed the object store reader's single cached window; the CRC
    # array is contiguous, so a handful of reads covers every probed row.
    crc_map: dict[int, int] = {}
    gap_rows = (64 << 10) // 4
    run_start = 0
    while run_start < len(rows_sorted):
        run_end = run_start
        while (
            run_end + 1 < len(rows_sorted)
            and rows_sorted[run_end + 1] - rows_sorted[run_end] <= gap_rows
        ):
            run_end += 1
        lo, hi = rows_sorted[run_start], rows_sorted[run_end]
        fh.seek(group.row_crc_offset + lo * 4)
        data = fh.read((hi - lo + 1) * 4)
        if len(data) != (hi - lo + 1) * 4:
            raise InvalidFormatError("short read of bank row CRC")
        arr = np.frombuffer(data, dtype="<u4")
        for r in rows_sorted[run_start : run_end + 1]:
            crc_map[r] = int(arr[r - lo])
        run_start = run_end + 1

    # Payload reads in ascending offset order, each row read once even
    # when several terms probe it.
    for r in rows_sorted:
        fh.seek(group.offset + r * row_bytes)
        payload = fh.read(row_bytes)
        if len(payload) != row_bytes:
            raise InvalidFormatError("short read of bank row")
        if crc32c(payload) != crc_map[r]:
            raise InvalidHashError(
                f"bank row {r} CRC mismatch on sparse read"
            )
        vals = np.frombuffer(payload, dtype="<u4")
        for i in want[r]:
            out[i] = vals
    return out


def read_bank_rows_buf(
    buf, group: BankGroupMetadata, flat_rows
) -> np.ndarray:
    """:func:`read_bank_rows` over a bytes-like buffer (an mmap of the
    whole file): identical semantics and per-row CRC verification, but
    slices instead of seek+read syscalls. A warm sparse probe of a
    400-file dataset is ~4k syscalls via the fh path and ~zero here —
    the difference is most of beyond-bank-budget warm p50."""
    if group.row_crc_offset is None:
        raise InvalidFormatError(
            "bank group has no per-row CRCs; sparse reads unavailable"
        )
    row_bytes = group.num_blocks * 4
    out = np.empty((len(flat_rows), group.num_blocks), dtype=np.uint32)
    want: dict[int, list[int]] = {}
    for i, r in enumerate(flat_rows):
        want.setdefault(int(r), []).append(i)
    for r in sorted(want):
        crc_off = group.row_crc_offset + r * 4
        crc_bytes = bytes(buf[crc_off : crc_off + 4])
        if len(crc_bytes) != 4:
            raise InvalidFormatError("short read of bank row CRC")
        crc_want = int(np.frombuffer(crc_bytes, dtype="<u4")[0])
        off = group.offset + r * row_bytes
        payload = bytes(buf[off : off + row_bytes])
        if len(payload) != row_bytes:
            raise InvalidFormatError("short read of bank row")
        if crc32c(payload) != crc_want:
            raise InvalidHashError(
                f"bank row {r} CRC mismatch on sparse read"
            )
        vals = np.frombuffer(payload, dtype="<u4")
        for i in want[r]:
            out[i] = vals
    return out


def read_bank_group(fh: BinaryIO, group: BankGroupMetadata) -> np.ndarray:
    """Read one bank group -> uint32[3, num_words, num_blocks], CRC-verified.

    The returned array is a READ-ONLY view over the file bytes on
    little-endian hosts (bank groups run to hundreds of MB; an eager
    native-order copy dominated merge profiles). Callers that need to
    mutate must copy; every current consumer (device staging, host
    probes, merge column extraction) only reads.
    """
    fh.seek(group.offset)
    payload = fh.read(group.size)
    if len(payload) != group.size:
        raise InvalidFormatError("short read of bank group")
    if crc32c(payload) != group.crc:
        raise InvalidHashError("bank group CRC mismatch")
    bank = np.frombuffer(payload, dtype="<u4")
    if bank.dtype != np.uint32:  # big-endian host: normalize (copies)
        bank = bank.astype(np.uint32)
    return bank.reshape(NUM_KEYSPACES, group.num_words, group.num_blocks)


def extract_block_filters(bank: np.ndarray, group: BankGroupMetadata, bank_col: int) -> BloomFilters:
    """Rebuild one block's filter triple from a bank column (merge path).

    Always COPIES the columns: ``bank`` may be a read-only view over
    shared (cached) file bytes, and merge OR-accumulates into the first
    extracted triple in place — a single-block group's contiguous column
    would otherwise alias (and corrupt) the shared bank.
    """
    layout = group.params.layout
    return BloomFilters(
        BloomFilter(
            group.m_bits, group.k,
            bank[KEYSPACE_FIELD, :, bank_col].copy(), layout=layout,
        ),
        BloomFilter(
            group.m_bits, group.k,
            bank[KEYSPACE_TOKEN, :, bank_col].copy(), layout=layout,
        ),
        BloomFilter(
            group.m_bits, group.k,
            bank[KEYSPACE_FIELD_TOKEN, :, bank_col].copy(), layout=layout,
        ),
    )


def read_block_rows_compressed(fh: BinaryIO, block: DataBlockMetadata, verify: bool = True) -> bytes:
    """Read a block's compressed row payload, verifying its CRC32C.

    (reference integrity check, bloom_tree_engine.go:1197-1203)

    Contract: decode buffers WHOLE blocks in memory (compressed here, then
    decompressed), unlike the reference's LimitReader→decompressor chain
    (bloom_tree_engine.go:1120-1153). Per-query peak memory is therefore
    bounded by concurrency × max_row_group_bytes (10 MB default), not by
    result size — the trade that lets the fused native pipeline (CRC +
    decode + split + scan in one GIL-free call) and the device row cache
    exist.
    """
    fh.seek(block.offset)
    payload = fh.read(block.size)
    if len(payload) != block.size:
        raise InvalidFormatError("short read of data block")
    if verify and crc32c(payload) != block.row_data_hash:
        raise InvalidHashError("row data CRC mismatch")
    return payload


def encode_row(row_bytes: bytes) -> bytes:
    """uint32 LE length prefix + payload (reference bloom_tree_engine.go:586-613)."""
    return struct.pack("<I", len(row_bytes)) + row_bytes


def split_rows(data: bytes, max_rows: int) -> list[bytes]:
    """Split a decompressed length-prefixed stream into row payloads.

    Uses the native splitter when available; raises InvalidFormatError on a
    malformed stream.
    """
    from . import native

    if not data:
        return []
    buf = np.frombuffer(data, dtype=np.uint8)
    if native.available():
        result = native.split_rows(buf, max_rows)
        if result is None:
            raise InvalidFormatError("malformed length-prefixed row stream")
        offsets, lengths = result
        return [data[o : o + l] for o, l in zip(offsets.tolist(), lengths.tolist())]
    rows = []
    pos = 0
    n = len(data)
    while pos + 4 <= n and len(rows) < max_rows:
        (length,) = struct.unpack_from("<I", data, pos)
        pos += 4
        if pos + length > n:
            raise InvalidFormatError("malformed length-prefixed row stream")
        rows.append(data[pos : pos + length])
        pos += length
    if pos != n and len(rows) < max_rows:
        raise InvalidFormatError("malformed length-prefixed row stream")
    return rows
