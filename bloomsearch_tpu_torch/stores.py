"""Pluggable storage: DataStore / MetaStore protocols and implementations.

Contracts mirror the reference (data_store.go:12-22, meta_store.go:8-41):

- ``DataStore``: create-for-single-pass-write, open-for-seek-read, tombstone.
- ``MetaStore``: prefiltered file listing (strict prefilter semantics) and an
  atomic write/delete batch.
- ``FileSystemDataStore`` implements *both* (testing_file_system_store.go):
  metadata is read back from file footers, so MetaStore writes are no-ops and
  deletes unlink.
- ``MemoryMetaStore``: map-backed store for tests (simple_meta_store.go:9-63);
  applies the prefilter to its stored metadata.
- Null stores: no-ops (data_store.go:25-45, meta_store.go:45-53).
"""

from __future__ import annotations

import logging
import os
import tempfile
import threading
import dataclasses
from dataclasses import dataclass
from typing import BinaryIO, Optional, Protocol, runtime_checkable

from .file_format import FileMetadata, read_file_metadata
from .query import QueryPrefilter, filter_data_blocks

logger = logging.getLogger("bloomsearch_tpu_torch.stores")


# Metadata-deleted files rename to this suffix until physically tombstoned.
TOMBSTONED_SUFFIX = ".tombstoned"


def _touch_tombstone(path: str) -> None:
    """Stamp NOW on a just-tombstoned file.

    os.replace preserves st_mtime, so the grace window would otherwise be
    measured from the file's WRITE time — effectively zero for any file
    older than the window, unlinking it under a concurrent reader the grace
    period exists to protect."""
    try:
        os.utime(path)
    except OSError:
        pass  # sweep just errs toward early removal, as before


@dataclass
class WriteOperation:
    file_metadata: FileMetadata
    file_pointer: bytes
    # Total file bytes; lets metadata-only stores report MaybeFile.size
    # (merge grouping depends on it).
    file_size: int = 0


@dataclass
class DeleteOperation:
    file_pointer: bytes


@dataclass
class MaybeFile:
    """A file that may contain matching rows; prefiltered, blooms untested.

    ``metadata.data_blocks`` may be a prefiltered subset (meta_store.go:33-41).
    """

    pointer: bytes
    metadata: FileMetadata
    size: int


@runtime_checkable
class DataStore(Protocol):
    def create_file(self) -> tuple[BinaryIO, bytes]:
        """New file for single-pass writing -> (writable handle, pointer bytes)."""
        ...

    def open_file(self, file_pointer: bytes) -> BinaryIO:
        """Open for seekable reading."""
        ...

    def tombstone_file(self, file_pointer: bytes) -> None:
        """Mark no longer referenced; implementation decides physical GC."""
        ...


@runtime_checkable
class MetaStore(Protocol):
    def get_maybe_files_for_query(self, prefilter: Optional[QueryPrefilter]) -> list[MaybeFile]:
        """Prefiltered candidate files (strict semantics on missing metadata)."""
        ...

    def update(self, writes: list[WriteOperation], deletes: list[DeleteOperation]) -> None:
        """Atomically apply a batch of metadata writes and deletes."""
        ...


class NullDataStore:
    def create_file(self):
        return None, b""

    def open_file(self, file_pointer: bytes):
        return None

    def tombstone_file(self, file_pointer: bytes) -> None:
        return None


class NullMetaStore:
    def get_maybe_files_for_query(self, prefilter):
        return []

    def update(self, writes, deletes) -> None:
        return None


class _RenamingFile:
    """Write handle that atomically renames into place on close."""

    def __init__(self, fh: BinaryIO, tmp_path: str, final_path: str):
        self._fh = fh
        self._tmp_path = tmp_path
        self._final_path = final_path
        self._closed = False

    def write(self, data) -> int:
        return self._fh.write(data)

    def flush(self) -> None:
        self._fh.flush()

    def tell(self) -> int:
        return self._fh.tell()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._fh.close()
        os.replace(self._tmp_path, self._final_path)

    def abort(self) -> None:
        """Discard: close and delete the temp file WITHOUT publishing it.

        Failed writes must never rename a truncated file into the visible
        namespace (a corrupt .dat poisons every subsequent directory scan).
        """
        if self._closed:
            return
        self._closed = True
        self._fh.close()
        try:
            os.remove(self._tmp_path)
        except FileNotFoundError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        # An exception inside the with-block means the write is INCOMPLETE:
        # abort (discard the temp) — close() would rename the truncated
        # file into the visible namespace, poisoning every later scan.
        if exc_type is not None:
            self.abort()
        else:
            self.close()


class FileSystemDataStore:
    """Local-filesystem DataStore + MetaStore in one, for tests and embedding.

    Files are ``bloom-*.dat`` in ``root_dir``; pointers are utf-8 paths;
    ``get_maybe_files_for_query`` scans the dir, parses footers, and applies
    the prefilter (testing_file_system_store.go:13-192).

    **Known limitation (shared with the reference's testing store): publish
    is not atomic when this store serves as the MetaStore.** A merged file
    becomes visible at rename-on-close, before ``update()`` renames the
    replaced files away, so a concurrent query that scans the directory in
    that window can plan both old and new files and return duplicate rows.
    Metadata-backed MetaStores (``MemoryMetaStore``, the object-store
    manifest) don't have this window — their ``update`` applies writes and
    deletes in one atomic step. Use one of those when exactly-once results
    under concurrent merges matter.
    """

    # Local files serve sub-ms ranged reads, so shadow-free serving
    # (engine row_cache_host_shadow="auto") re-reads candidate rows from
    # disk instead of holding a decompressed host copy per pinned block.
    supports_fast_ranged_reads = True

    def __init__(self, root_dir: str, tombstone_grace_seconds: float = 0.0):
        os.makedirs(root_dir, exist_ok=True)
        self.root_dir = root_dir
        # Grace window before physically deleting replaced files (protects
        # readers in OTHER processes; in-process readers are protected by
        # the engine's deferred tombstones). 0 = delete immediately.
        self.tombstone_grace_seconds = tombstone_grace_seconds
        # Startup sweep: orphaned .tombstoned files from crashed processes.
        self._sweep_tombstoned()
        # Files are immutable once visible, so parsed footers cache safely:
        # path -> (size, mtime_ns, FileMetadata). Without this every query
        # re-reads and re-parses every footer (file-level filters included),
        # which dominates query latency once files accumulate.
        self._metadata_cache: dict[str, tuple[int, int, FileMetadata]] = {}
        self._cache_lock = threading.Lock()

    # DataStore

    def create_file(self) -> tuple[BinaryIO, bytes]:
        # Write under a .tmp name and rename on close: files become visible to
        # the directory scan only once complete, so a crash mid-flush leaves
        # an orphaned temp file but no corrupt state (the reference gets the
        # same property from its atomic MetaStore.Update; meta_store.go:20-21).
        fd, tmp_path = tempfile.mkstemp(prefix="bloom-", suffix=".dat.tmp", dir=self.root_dir)
        final_path = tmp_path[: -len(".tmp")]
        fh = _RenamingFile(os.fdopen(fd, "wb"), tmp_path, final_path)
        return fh, final_path.encode("utf-8")

    def open_file(self, file_pointer: bytes) -> BinaryIO:
        path = file_pointer.decode("utf-8")
        try:
            return open(path, "rb")
        except FileNotFoundError as original:
            # Metadata-deleted but not yet physically tombstoned (in-flight
            # queries keep reading replaced files until they drain).
            try:
                return open(path + TOMBSTONED_SUFFIX, "rb")
            except FileNotFoundError:
                raise original  # report the pointer's real path

    def tombstone_file(self, file_pointer: bytes) -> None:
        """Physically remove — immediately at grace 0 (single-writer default),

        else rename to .tombstoned and leave removal to the age-based sweep
        so concurrent readers in OTHER processes get a grace window
        (multi-writer deployments set tombstone_grace_seconds > 0; see
        coordination.py for the matching merge-lease story)."""
        path = file_pointer.decode("utf-8")
        if self.tombstone_grace_seconds <= 0:
            for candidate in (path, path + TOMBSTONED_SUFFIX):
                try:
                    os.remove(candidate)
                except FileNotFoundError:
                    pass
            return
        try:
            os.replace(path, path + TOMBSTONED_SUFFIX)
            _touch_tombstone(path + TOMBSTONED_SUFFIX)
        except FileNotFoundError:
            pass

    def _sweep_tombstoned(self) -> None:
        """Remove .tombstoned files older than the grace period."""
        import time as _time

        cutoff = _time.time() - max(self.tombstone_grace_seconds, 0)
        try:
            names = os.listdir(self.root_dir)
        except FileNotFoundError:
            return
        for name in names:
            if not name.endswith(TOMBSTONED_SUFFIX):
                continue
            path = os.path.join(self.root_dir, name)
            try:
                if os.stat(path).st_mtime <= cutoff:
                    os.remove(path)
            except FileNotFoundError:
                pass

    # MetaStore

    def _read_file_metadata(self, path: str, stat: os.stat_result) -> FileMetadata:
        key = (stat.st_size, stat.st_mtime_ns)
        with self._cache_lock:
            cached = self._metadata_cache.get(path)
            if cached is not None and cached[:2] == key:
                return cached[2]
        with open(path, "rb") as fh:
            metadata = read_file_metadata(fh, file_size=stat.st_size)
        with self._cache_lock:
            self._metadata_cache[path] = (key[0], key[1], metadata)
        return metadata

    def get_maybe_files_for_query(self, prefilter: Optional[QueryPrefilter]) -> list[MaybeFile]:
        maybe_files: list[MaybeFile] = []
        with self._cache_lock:
            stale = set(self._metadata_cache)
        entries: list[tuple[str, os.stat_result]] = []
        for name in sorted(os.listdir(self.root_dir)):
            if not name.endswith(".dat"):
                continue
            path = os.path.join(self.root_dir, name)
            try:
                stat = os.stat(path)
            except FileNotFoundError:
                continue
            if not os.path.isfile(path):
                continue
            stale.discard(path)
            entries.append((path, stat))
        # Prefetch footer-cache misses over a small transient I/O pool: a
        # cold listing of a large dataset (hundreds of files) otherwise
        # pays serial seek+read chains that leave the disk queue empty
        # (454-file / 33 GB dataset, cold page cache: ~2.4 s serial).
        # Errors are swallowed here — the serial loop below re-reads the
        # (rare) failed file and applies the documented tolerant handling,
        # so semantics and warning order are unchanged.
        with self._cache_lock:
            misses = [
                e
                for e in entries
                if (c := self._metadata_cache.get(e[0])) is None
                or c[:2] != (e[1].st_size, e[1].st_mtime_ns)
            ]
        if len(misses) > 4:
            from concurrent.futures import ThreadPoolExecutor

            def _prefetch(e):
                try:
                    self._read_file_metadata(*e)
                except Exception:
                    pass

            with ThreadPoolExecutor(
                max_workers=8, thread_name_prefix="bloomsearch-footer"
            ) as ex:
                list(ex.map(_prefetch, misses))
        for path, stat in entries:
            try:
                cached = self._read_file_metadata(path, stat)
            except FileNotFoundError:
                # Renamed away (metadata-deleted) between stat and open: the
                # file is no longer part of the dataset — skip it.
                continue
            except Exception as exc:
                # Corrupt / truncated / unknown-version footer: one bad file
                # must not fail the whole directory scan (the reference's
                # tolerant stance, bloom_tree_engine.go:885-905). Skip and
                # warn; the file stays on disk for forensics.
                logger.warning("skipping unreadable file %s: %s", path, exc)
                continue
            # Never mutate the cached object: present a shallow view with the
            # prefiltered block list (meta_store.go:33-41 allows subsetting).
            # dataclasses.replace: a hand-listed copy silently reset any
            # FileMetadata field added after it was written.
            metadata = dataclasses.replace(
                cached, data_blocks=filter_data_blocks(cached.data_blocks, prefilter)
            )
            # Include all files when unfiltered; otherwise only files with
            # surviving blocks (testing_file_system_store.go:168-175).
            if prefilter is None or metadata.data_blocks:
                maybe_files.append(
                    MaybeFile(
                        pointer=path.encode("utf-8"), metadata=metadata, size=stat.st_size
                    )
                )
        if stale:
            with self._cache_lock:
                for path in stale:
                    self._metadata_cache.pop(path, None)
        return maybe_files

    def update(self, writes, deletes) -> None:
        # Writes are no-ops: metadata lives in the file footers. Deletes
        # RENAME out of the scanned namespace (invisible to new queries)
        # rather than unlinking — tombstone_file does the physical removal,
        # which the engine defers past in-flight queries. Sweeping here is
        # only safe with a real grace window: at grace 0 the engine's
        # deferral alone decides when renamed files die (an immediate sweep
        # would delete files still held by in-flight queries).
        if self.tombstone_grace_seconds > 0:
            self._sweep_tombstoned()
        for op in deletes:
            path = op.file_pointer.decode("utf-8")
            try:
                os.replace(path, path + TOMBSTONED_SUFFIX)
                _touch_tombstone(path + TOMBSTONED_SUFFIX)
            except FileNotFoundError:
                pass


class MemoryMetaStore:
    """Map-backed MetaStore (reference simple_meta_store.go:9-63), but unlike
    the reference's (which returns everything), it applies the prefilter so it
    exercises the strict-prefilter path in tests."""

    def __init__(self):
        self._lock = threading.Lock()
        self._files: dict[bytes, tuple[FileMetadata, int]] = {}

    def get_maybe_files_for_query(self, prefilter: Optional[QueryPrefilter]) -> list[MaybeFile]:
        out = []
        with self._lock:
            items = list(self._files.items())
        for pointer, (metadata, size) in items:
            blocks = filter_data_blocks(metadata.data_blocks, prefilter)
            if prefilter is not None and not blocks:
                continue
            # dataclasses.replace: a hand-listed copy silently reset any
            # FileMetadata field added after it was written.
            filtered = dataclasses.replace(metadata, data_blocks=blocks)
            out.append(MaybeFile(pointer=pointer, metadata=filtered, size=size))
        return out

    def update(self, writes, deletes) -> None:
        with self._lock:
            for w in writes:
                self._files[w.file_pointer] = (w.file_metadata, w.file_size)
            for d in deletes:
                self._files.pop(d.file_pointer, None)

    def print_files(self) -> None:
        with self._lock:
            for pointer, (metadata, _) in self._files.items():
                print(pointer.decode("utf-8", "replace"), f"{len(metadata.data_blocks)} blocks")


def new_simple_meta_store() -> MemoryMetaStore:
    """Reference-parity constructor name (simple_meta_store.go:9)."""
    return MemoryMetaStore()
