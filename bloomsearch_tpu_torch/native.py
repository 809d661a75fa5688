"""ctypes loader for the native host-runtime library.

Compiles ``_native/bloomsearch_native.cpp`` with g++ on first use (cached as
a .so next to the source) and exposes batch APIs operating on numpy arrays.
Everything here has a pure-Python fallback elsewhere — callers must check
:func:`available` — so the engine still works without a toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "_native")
_SRC = os.path.join(_NATIVE_DIR, "bloomsearch_native.cpp")
_SO = os.path.join(_NATIVE_DIR, "libbloomsearch_native.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _compile() -> bool:
    # Build to a temp path and rename into place: `g++ -o` truncates the
    # output in place, which SIGBUSes any running process that has the old
    # .so mapped (and races concurrent compiles in sibling processes).
    tmp = f"{_SO}.build.{os.getpid()}"
    base = [
        "g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-fvisibility=hidden",
        "-o", tmp, _SRC,
    ]
    # -march=native can fail on exotic hosts; a host without zstd's headers
    # builds without the native zstd decoder (zstd blocks decode in Python).
    variants = (
        ["-march=native", "-DBS_HAVE_ZSTD", "-lzstd"],
        ["-DBS_HAVE_ZSTD", "-lzstd"],
        ["-march=native"],
        [],
    )
    try:
        for extra in variants:
            result = subprocess.run(base + extra, capture_output=True, timeout=120)
            if result.returncode == 0:
                os.replace(tmp, _SO)
                return True
        return False
    except (OSError, subprocess.TimeoutExpired):
        return False
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        if os.environ.get("BLOOMSEARCH_TPU_NO_NATIVE"):
            _load_failed = True
            return None
        if not os.path.exists(_SO) or (
            os.path.exists(_SRC) and os.path.getmtime(_SRC) > os.path.getmtime(_SO)
        ):
            if not _compile():
                _load_failed = True
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            _load_failed = True
            return None

        lib.bs_hash_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.bs_hash_batch.restype = None
        lib.bs_scatter_or.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        lib.bs_scatter_or.restype = None
        lib.bs_build_from_hashes.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.bs_build_from_hashes.restype = None
        lib.bs_probe_from_hashes.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.bs_probe_from_hashes.restype = None
        lib.bs_build_from_hashes_blocked.argtypes = lib.bs_build_from_hashes.argtypes
        lib.bs_build_from_hashes_blocked.restype = None
        lib.bs_probe_from_hashes_blocked.argtypes = lib.bs_probe_from_hashes.argtypes
        lib.bs_probe_from_hashes_blocked.restype = None
        lib.bs_crc32c.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32]
        lib.bs_crc32c.restype = ctypes.c_uint32
        lib.bs_crc32c_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.bs_crc32c_rows.restype = None
        lib.bs_verify_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_uint8,
            ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.bs_verify_rows.restype = ctypes.c_int64
        lib.bs_split_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.bs_split_rows.restype = ctypes.c_int64
        lib.bs_snappy_max_compressed.argtypes = [ctypes.c_int64]
        lib.bs_snappy_max_compressed.restype = ctypes.c_int64
        lib.bs_snappy_compress_block.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.bs_snappy_compress_block.restype = ctypes.c_int64
        lib.bs_snappy_uncompressed_length.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.bs_snappy_uncompressed_length.restype = ctypes.c_int64
        lib.bs_snappy_decompress_block.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.bs_snappy_decompress_block.restype = ctypes.c_int64
        lib.bs_scan_candidates.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p,
        ]
        lib.bs_scan_candidates.restype = ctypes.c_int64
        lib.bs_ingest_tokenize.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_uint8,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        lib.bs_ingest_tokenize.restype = ctypes.c_int64
        lib.bs_process_block.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_uint32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p,
        ]
        lib.bs_process_block.restype = ctypes.c_int64
        if hasattr(lib, "bs_pack_stream"):  # absent in pre-round-3 cached .so
            lib.bs_pack_stream.argtypes = [
                ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p,
            ]
            lib.bs_pack_stream.restype = None
        if hasattr(lib, "bs_snappy_compress_stream"):  # pre-round-5 .so lacks it
            lib.bs_snappy_compress_stream.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
            ]
            lib.bs_snappy_compress_stream.restype = ctypes.c_int64
        if hasattr(lib, "bs_extract_minmax"):  # absent in pre-round-4 cached .so
            lib.bs_extract_minmax.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ]
            lib.bs_extract_minmax.restype = ctypes.c_int64
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


# --- CPython-API row serializer (separate .so; needs Python headers and a
# resolvable libpython at load, so it degrades independently of the compute
# library) -------------------------------------------------------------------

_PYSER_SRC = os.path.join(_NATIVE_DIR, "bloomsearch_pyser.cpp")
_PYSER_SO = os.path.join(_NATIVE_DIR, "libbloomsearch_pyser.so")
_pyser_lock = threading.Lock()
_pyser_fn = None
_pyser_failed = False


def _load_pyser():
    global _pyser_fn, _pyser_failed
    if _pyser_fn is not None or _pyser_failed:
        return _pyser_fn
    with _pyser_lock:
        if _pyser_fn is not None or _pyser_failed:
            return _pyser_fn
        if os.environ.get("BLOOMSEARCH_TPU_NO_NATIVE"):
            _pyser_failed = True
            return None
        import sysconfig

        include = sysconfig.get_paths().get("include")
        if not include or not os.path.exists(os.path.join(include, "Python.h")):
            _pyser_failed = True
            return None
        if not os.path.exists(_PYSER_SO) or (
            os.path.exists(_PYSER_SRC)
            and os.path.getmtime(_PYSER_SRC) > os.path.getmtime(_PYSER_SO)
        ):
            # Compile to a tmp then rename (same pattern as _compile above):
            # writing the final path directly lets a concurrent process
            # PyDLL-load a half-written .so, and truncating an .so another
            # process has mapped can SIGBUS it.
            tmp_so = f"{_PYSER_SO}.tmp.{os.getpid()}"
            cmd = [
                "g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                "-fvisibility=hidden", f"-I{include}", "-o", tmp_so, _PYSER_SRC,
            ]
            try:
                result = subprocess.run(cmd, capture_output=True, timeout=120)
                if result.returncode != 0:
                    _pyser_failed = True
                    return None
                os.replace(tmp_so, _PYSER_SO)
            except (OSError, subprocess.TimeoutExpired):
                _pyser_failed = True
                return None
            finally:
                try:
                    os.unlink(tmp_so)
                except OSError:
                    pass
        try:
            # PyDLL: calls hold the GIL (required for CPython API).
            lib = ctypes.PyDLL(_PYSER_SO)
            fn = lib.bs_serialize_rows
            fn.argtypes = [ctypes.py_object]
            fn.restype = ctypes.py_object
            # Smoke-test so unresolved libpython symbols fail HERE, not on
            # the ingest path.
            out = fn([{"a": 1}])
            if out is None or out[0] != b'\x07\x00\x00\x00{"a":1}':
                _pyser_failed = True
                return None
        except Exception:
            _pyser_failed = True
            return None
        _pyser_fn = fn
        return _pyser_fn


def serialize_rows(rows: list) -> Optional[tuple[bytes, np.ndarray, np.ndarray]]:
    """Batch-serialize dict rows into the length-prefixed stream format.

    Returns (stream bytes, row offsets int64, row lengths int64) with
    offsets pointing past each 4-byte prefix, or None when the serializer is
    unavailable or the batch contains content it does not support (caller
    falls back to json.dumps; see bloomsearch_pyser.cpp for the exactness
    contract).
    """
    fn = _load_pyser()
    if fn is None:
        return None
    out = fn(rows)
    if out is None:
        return None
    stream, offs, lens = out
    return (
        stream,
        np.frombuffer(offs, dtype=np.int64),
        np.frombuffer(lens, dtype=np.int64),
    )


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.c_void_p)


def hash_batch(keys: Sequence[bytes]) -> np.ndarray:
    """Batch murmur3 x64_128 -> [N, 2] uint64."""
    lib = _load()
    assert lib is not None
    n = len(keys)
    out = np.empty((n, 2), dtype=np.uint64)
    if n == 0:
        return out
    lengths = np.fromiter((len(k) for k in keys), dtype=np.int64, count=n)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    data = b"".join(keys)
    buf = np.frombuffer(data, dtype=np.uint8) if data else np.empty(0, dtype=np.uint8)
    lib.bs_hash_batch(_ptr(buf), _ptr(offsets), n, _ptr(out))
    return out


def scatter_or(words: np.ndarray, positions: np.ndarray) -> None:
    """OR absolute bit positions (uint64) into a uint32 word array, in place."""
    lib = _load()
    assert lib is not None
    positions = np.ascontiguousarray(positions, dtype=np.uint64)
    lib.bs_scatter_or(_ptr(words), _ptr(positions), positions.size)


def build_from_hashes(words: np.ndarray, m_bits: int, k: int, hashes: np.ndarray) -> None:
    """Fused KM-position + scatter-OR build, in place."""
    lib = _load()
    assert lib is not None
    hashes = np.ascontiguousarray(hashes, dtype=np.uint64)
    lib.bs_build_from_hashes(_ptr(words), m_bits, k, _ptr(hashes), hashes.shape[0])


def probe_from_hashes(words: np.ndarray, m_bits: int, k: int, hashes: np.ndarray) -> np.ndarray:
    """AND-reduce probe -> [N] bool."""
    lib = _load()
    assert lib is not None
    hashes = np.ascontiguousarray(hashes, dtype=np.uint64)
    n = hashes.shape[0]
    out = np.empty(n, dtype=np.uint8)
    lib.bs_probe_from_hashes(_ptr(words), m_bits, k, _ptr(hashes), n, _ptr(out))
    return out.astype(bool)


def build_from_hashes_blocked(words: np.ndarray, m_bits: int, k: int, hashes: np.ndarray) -> None:
    """Blocked-256 layout build, in place."""
    lib = _load()
    assert lib is not None
    hashes = np.ascontiguousarray(hashes, dtype=np.uint64)
    lib.bs_build_from_hashes_blocked(_ptr(words), m_bits, k, _ptr(hashes), hashes.shape[0])


def probe_from_hashes_blocked(words: np.ndarray, m_bits: int, k: int, hashes: np.ndarray) -> np.ndarray:
    """Blocked-256 layout probe -> [N] bool."""
    lib = _load()
    assert lib is not None
    hashes = np.ascontiguousarray(hashes, dtype=np.uint64)
    n = hashes.shape[0]
    out = np.empty(n, dtype=np.uint8)
    lib.bs_probe_from_hashes_blocked(_ptr(words), m_bits, k, _ptr(hashes), n, _ptr(out))
    return out.astype(bool)


def crc32c(data, crc_in: int = 0) -> int:
    """CRC32C (Castagnoli) of a bytes-like object."""
    lib = _load()
    assert lib is not None
    buf = np.frombuffer(data, dtype=np.uint8) if len(data) else np.empty(0, dtype=np.uint8)
    return int(lib.bs_crc32c(_ptr(buf), buf.size, ctypes.c_uint32(crc_in)))


def verify_rows(
    data,
    row_offsets: np.ndarray,
    row_lengths: np.ndarray,
    conditions: list[tuple[int, bytes, bytes]],
    delimiter: int,
) -> Optional[tuple[np.ndarray, np.ndarray]]:
    """Exact native verification of bloom leaf conditions over raw row bytes.

    ``conditions`` are ``(kind, field_bytes, token_bytes)`` with kind
    0=FIELD, 1=TOKEN, 2=FIELD_TOKEN (the leaves of a bloom query; semantic
    spec tokenizer.py::row_matches_bloom_expression ≙ reference
    tokenizer.go:107-456). Returns ``(match bool[n_conds, n_rows],
    fallback bool[n_rows])`` — fallback rows must be re-verified in Python —
    or None when the library is unavailable or errors.
    """
    lib = _load()
    if lib is None:
        return None
    n_rows = len(row_offsets)
    n_conds = len(conditions)
    buf = np.frombuffer(data, dtype=np.uint8) if len(data) else np.empty(0, dtype=np.uint8)
    kinds = np.array([c[0] for c in conditions], dtype=np.uint8)
    field_bytes = b"".join(c[1] for c in conditions) or b"\x00"
    field_offsets = np.zeros(n_conds + 1, dtype=np.int64)
    np.cumsum([len(c[1]) for c in conditions], out=field_offsets[1:])
    token_bytes = b"".join(c[2] for c in conditions) or b"\x00"
    token_offsets = np.zeros(n_conds + 1, dtype=np.int64)
    np.cumsum([len(c[2]) for c in conditions], out=token_offsets[1:])
    fbuf = np.frombuffer(field_bytes, dtype=np.uint8)
    tbuf = np.frombuffer(token_bytes, dtype=np.uint8)
    offs = np.ascontiguousarray(row_offsets, dtype=np.int64)
    lens = np.ascontiguousarray(row_lengths, dtype=np.int64)
    out = np.zeros(n_conds * n_rows, dtype=np.uint8)
    fallback = np.zeros(n_rows, dtype=np.uint8)
    rc = lib.bs_verify_rows(
        _ptr(buf), _ptr(offs), _ptr(lens), n_rows,
        ctypes.c_uint8(delimiter),
        _ptr(kinds),
        _ptr(fbuf), _ptr(field_offsets),
        _ptr(tbuf), _ptr(token_offsets),
        n_conds,
        _ptr(out), _ptr(fallback),
    )
    if rc != 0:
        return None
    return out.reshape(n_conds, n_rows).astype(bool), fallback.astype(bool)


def crc32c_rows(data, num_rows: int, row_bytes: int) -> np.ndarray:
    """Per-row CRC32C of a fixed-stride buffer -> uint32[num_rows]."""
    lib = _load()
    assert lib is not None
    buf = np.frombuffer(data, dtype=np.uint8)
    out = np.empty(num_rows, dtype=np.uint32)
    lib.bs_crc32c_rows(_ptr(buf), num_rows, row_bytes, _ptr(out))
    return out


def scan_candidates(
    data: np.ndarray,
    needles: list[bytes],
    row_offsets: np.ndarray,
    row_lengths: np.ndarray,
) -> Optional[np.ndarray]:
    """Multi-needle case-insensitive substring scan -> bool[needles, rows]."""
    lib = _load()
    assert lib is not None
    n_rows = row_offsets.shape[0]
    n_needles = len(needles)
    out = np.zeros((n_needles, n_rows), dtype=np.uint8)
    if n_rows == 0 or n_needles == 0:
        return out.astype(bool)
    lengths = np.fromiter((len(b) for b in needles), dtype=np.int64, count=n_needles)
    offsets = np.zeros(n_needles + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    blob = b"".join(needles)
    needle_buf = np.frombuffer(blob, dtype=np.uint8) if blob else np.empty(0, dtype=np.uint8)
    row_offsets = np.ascontiguousarray(row_offsets, dtype=np.int64)
    row_lengths = np.ascontiguousarray(row_lengths, dtype=np.int64)
    rc = lib.bs_scan_candidates(
        _ptr(data), data.size,
        _ptr(needle_buf), _ptr(offsets), n_needles,
        _ptr(row_offsets), _ptr(row_lengths), n_rows,
        _ptr(out),
    )
    if rc != 0:
        return None
    return out.astype(bool)


def pack_stream(
    data: bytes,
    row_offsets: np.ndarray,
    row_lengths: np.ndarray,
    stride: int,
    chunk_bytes: int,
) -> Optional[tuple[np.ndarray, np.ndarray]]:
    """Serving-mode stream pack: lowered overlapped-chunk matrix +
    conservative always-candidate flags in one native pass.

    Returns (chunks uint8[max(n_chunks, 1), chunk_bytes], always_candidate
    uint8[n_rows]) bit-identical to rowcache.py's numpy fallback, or None
    when the native library (or symbol) is unavailable.
    """
    lib = _load()
    if lib is None or not hasattr(lib, "bs_pack_stream"):
        return None
    n_rows = row_offsets.shape[0]
    data_len = len(data)
    n_chunks = -(-data_len // stride) if data_len else 0
    chunks = np.zeros((max(n_chunks, 1), chunk_bytes), dtype=np.uint8)
    flags = np.zeros(max(n_rows, 1), dtype=np.uint8)
    buf = np.frombuffer(data, dtype=np.uint8) if data else np.empty(0, dtype=np.uint8)
    row_offsets = np.ascontiguousarray(row_offsets, dtype=np.int64)
    row_lengths = np.ascontiguousarray(row_lengths, dtype=np.int64)
    lib.bs_pack_stream(
        _ptr(buf), data_len,
        _ptr(row_offsets), _ptr(row_lengths), n_rows,
        stride, chunk_bytes,
        _ptr(chunks), _ptr(flags),
    )
    return chunks, flags[:n_rows]


def ingest_tokenize(
    data: bytes,
    row_offsets: np.ndarray,
    row_lengths: np.ndarray,
    delimiter: str = ".",
) -> Optional[tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """Tokenize + hash serialized rows in one native pass.

    Returns (field_hashes[Nf,2], token_hashes[Nt,2], ft_hashes[Nft,2],
    fallback_mask[bool]) — rows flagged in fallback_mask must go through
    the Python tokenizer. NOTE: a flagged row MAY still have contributed
    hashes for the prefix parsed before the fallback point (the sink is not
    row-transactional); extra set bits only inflate FPR — conservative —
    but do not rely on "no hashes from fallback rows" for key-count
    accounting or filter rebuilds. None means the native library is
    unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    if len(delimiter) != 1 or ord(delimiter) > 0x7E or ord(delimiter) < 0x21:
        return None  # native path needs a single printable-ASCII delimiter
    n_rows = row_offsets.shape[0]
    buf = np.frombuffer(data, dtype=np.uint8) if data else np.empty(0, dtype=np.uint8)
    row_offsets = np.ascontiguousarray(row_offsets, dtype=np.int64)
    row_lengths = np.ascontiguousarray(row_lengths, dtype=np.int64)
    fallback = np.zeros(n_rows, dtype=np.uint8)
    # Token-ish keys per byte is bounded; start generous, retry doubling.
    cap = max(1024, len(data) // 3)
    for _ in range(8):
        field_out = np.empty((cap, 2), dtype=np.uint64)
        token_out = np.empty((cap, 2), dtype=np.uint64)
        ft_out = np.empty((cap, 2), dtype=np.uint64)
        n_field = ctypes.c_int64()
        n_token = ctypes.c_int64()
        n_ft = ctypes.c_int64()
        rc = lib.bs_ingest_tokenize(
            _ptr(buf), _ptr(row_offsets), _ptr(row_lengths), n_rows,
            ord(delimiter),
            _ptr(field_out), cap, ctypes.byref(n_field),
            _ptr(token_out), cap, ctypes.byref(n_token),
            _ptr(ft_out), cap, ctypes.byref(n_ft),
            _ptr(fallback),
        )
        if rc == 0:
            return (
                field_out[: n_field.value],
                token_out[: n_token.value],
                ft_out[: n_ft.value],
                fallback.astype(bool),
            )
        if rc == -1:
            cap *= 2
            fallback.fill(0)
            continue
        return None
    return None


def extract_minmax(
    data: bytes,
    row_offsets: np.ndarray,
    row_lengths: np.ndarray,
    field: str,
) -> Optional[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Byte-level top-level numeric field extraction for fast-lane minmax.

    Per row returns int64 (lo, hi) bounds plus a status byte: 0 = field
    absent/non-numeric, 1 = bounds valid, 2 = Python fallback required
    (semantic spec: convert_to_min_max_int64(json.loads(row)[field]),
    minmax.py:32-46 ≙ reference min_max.go:16-28). None when the library or
    symbol is unavailable or the field name is outside the ASCII fast path.
    """
    lib = _load()
    if lib is None or not hasattr(lib, "bs_extract_minmax"):
        return None
    try:
        field_b = field.encode("ascii")
    except UnicodeEncodeError:
        return None
    if not field_b or len(field_b) > 256:
        return None
    n_rows = row_offsets.shape[0]
    buf = np.frombuffer(data, dtype=np.uint8) if data else np.empty(0, dtype=np.uint8)
    fbuf = np.frombuffer(field_b, dtype=np.uint8)
    offs = np.ascontiguousarray(row_offsets, dtype=np.int64)
    lens = np.ascontiguousarray(row_lengths, dtype=np.int64)
    lo = np.empty(max(n_rows, 1), dtype=np.int64)
    hi = np.empty(max(n_rows, 1), dtype=np.int64)
    status = np.zeros(max(n_rows, 1), dtype=np.uint8)
    rc = lib.bs_extract_minmax(
        _ptr(buf), _ptr(offs), _ptr(lens), n_rows,
        _ptr(fbuf), len(field_b),
        _ptr(lo), _ptr(hi), _ptr(status),
    )
    if rc != 0:
        return None
    return lo[:n_rows], hi[:n_rows], status[:n_rows]


_CODEC_IDS = {"none": 0, "snappy": 1, "zstd": 2}


def process_block(
    compressed: bytes,
    codec: str,
    expected_crc: int,
    uncompressed_size: int,
    needles: list[bytes],
    verify_crc: bool = True,
):
    """Full native block pipeline: CRC -> decompress -> split -> scan.

    Returns (data bytes-like, row_offsets, row_lengths, scan bool[needles,
    rows]) or None when the native library / codec is unavailable. Raises
    ValueError on integrity failures (CRC/malformed data).
    """
    lib = _load()
    if lib is None:
        return None
    codec_id = _CODEC_IDS.get(codec or "none")
    if codec_id is None:
        return None
    comp = np.frombuffer(compressed, dtype=np.uint8) if compressed else np.empty(0, dtype=np.uint8)
    out_cap = max(uncompressed_size, len(compressed), 16)
    out = np.empty(out_cap, dtype=np.uint8)
    max_rows = out_cap // 4 + 1
    row_offsets = np.empty(max_rows, dtype=np.int64)
    row_lengths = np.empty(max_rows, dtype=np.int64)
    n_rows = ctypes.c_int64()

    n_needles = len(needles)
    if n_needles:
        nlens = np.fromiter((len(b) for b in needles), dtype=np.int64, count=n_needles)
        noffs = np.zeros(n_needles + 1, dtype=np.int64)
        np.cumsum(nlens, out=noffs[1:])
        nblob = b"".join(needles)
        nbuf = np.frombuffer(nblob, dtype=np.uint8) if nblob else np.empty(0, dtype=np.uint8)
        # The native scan writes compactly at stride = actual row count
        # (known only after splitting), so hand it a flat buffer and reshape
        # with the returned count.
        scan_out = np.zeros(n_needles * max_rows, dtype=np.uint8)
        nbuf_p, noffs_p, scan_p = _ptr(nbuf), _ptr(noffs), _ptr(scan_out)
    else:
        scan_out = None
        nbuf_p = noffs_p = scan_p = None

    dlen = lib.bs_process_block(
        _ptr(comp), comp.size, codec_id,
        ctypes.c_uint32(expected_crc), 1 if verify_crc else 0,
        _ptr(out), out_cap,
        _ptr(row_offsets), _ptr(row_lengths), max_rows, ctypes.byref(n_rows),
        nbuf_p, noffs_p, n_needles,
        scan_p,
    )
    if dlen == -1:
        raise ValueError("block CRC mismatch")
    if dlen in (-2, -3):
        raise ValueError("malformed block data")
    if dlen < 0:
        return None  # capacity/codec issue: fall back to the Python path
    rows = int(n_rows.value)
    scan = (
        scan_out[: n_needles * rows].reshape(n_needles, rows).astype(bool)
        if scan_out is not None
        else None
    )
    return (
        out[:dlen],
        row_offsets[:rows].copy(),
        row_lengths[:rows].copy(),
        scan,
    )


SNAPPY_MAX_BLOCK_INPUT = 65536


def snappy_available() -> bool:
    return available()


def snappy_compress_block(data: bytes) -> bytes:
    """Compress one <=64 KiB block into the snappy block format."""
    lib = _load()
    assert lib is not None
    n = len(data)
    assert n <= SNAPPY_MAX_BLOCK_INPUT
    buf = np.frombuffer(data, dtype=np.uint8) if n else np.empty(0, dtype=np.uint8)
    out = np.empty(int(lib.bs_snappy_max_compressed(n)), dtype=np.uint8)
    written = lib.bs_snappy_compress_block(_ptr(buf), n, _ptr(out))
    if written < 0:
        raise ValueError("snappy compress failed")
    return out[:written].tobytes()


def snappy_compress_stream(data, chunk_size: int = SNAPPY_MAX_BLOCK_INPUT):
    """Compress a whole buffer into the chunked stream framing in ONE
    GIL-free native call ([<u4 len><snappy block>] per chunk; the last
    chunk may be short). Bit-identical to looping snappy_compress_block
    over chunks. Returns bytes, or None when the symbol is unavailable
    (stale cached .so) — callers fall back to the per-chunk loop."""
    lib = _load()
    if lib is None or not hasattr(lib, "bs_snappy_compress_stream"):
        return None
    n = len(data)
    buf = np.frombuffer(data, dtype=np.uint8) if n else np.empty(0, dtype=np.uint8)
    n_chunks = -(-n // chunk_size) if n else 0
    cap = n_chunks * (4 + int(lib.bs_snappy_max_compressed(chunk_size)))
    out = np.empty(max(cap, 1), dtype=np.uint8)
    written = lib.bs_snappy_compress_stream(_ptr(buf), n, chunk_size, _ptr(out))
    if written < 0:
        raise ValueError("snappy stream compress failed")
    return out[:written].tobytes()


def snappy_decompress_block(data: bytes) -> bytes:
    """Decompress one snappy block."""
    lib = _load()
    assert lib is not None
    buf = np.frombuffer(data, dtype=np.uint8)
    expected = lib.bs_snappy_uncompressed_length(_ptr(buf), buf.size)
    if expected < 0 or expected > SNAPPY_MAX_BLOCK_INPUT:
        raise ValueError("malformed snappy block header")
    out = np.empty(int(expected), dtype=np.uint8)
    written = lib.bs_snappy_decompress_block(_ptr(buf), buf.size, _ptr(out), expected)
    if written != expected:
        raise ValueError(f"malformed snappy block (wrote {written}, expected {expected})")
    return out.tobytes()


def split_rows(data: np.ndarray, max_rows: int) -> Optional[tuple[np.ndarray, np.ndarray]]:
    """Split a length-prefixed row stream -> (offsets, lengths), or None if malformed."""
    lib = _load()
    assert lib is not None
    offsets = np.empty(max_rows, dtype=np.int64)
    lengths = np.empty(max_rows, dtype=np.int64)
    count = lib.bs_split_rows(_ptr(data), data.size, max_rows, _ptr(offsets), _ptr(lengths))
    if count < 0:
        return None
    return offsets[:count], lengths[:count]
