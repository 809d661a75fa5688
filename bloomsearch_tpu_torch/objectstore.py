"""Object-store (S3-compatible) DataStore + MetaStore.

The storage abstraction exists exactly so backends like this can plug in
(reference data_store.go:12-22; README.md:289-315: "file path, S3
bucket/key, etc."). Everything here targets a minimal
:class:`ObjectStoreClient` surface — GET / ranged GET / conditional PUT /
conditional DELETE / LIST — which S3, GCS, and R2 all provide.
:class:`InMemoryObjectStore` implements that surface for tests and
embedding.

- :class:`ObjectStoreDataStore`: immutable data objects under
  ``data/bloom-<uuid>.dat``; ``create_file`` buffers and uploads on close
  (single-pass write, never visible until complete — object PUT is atomic),
  ``open_file`` reads lazily via ranged GETs so block decodes never download
  whole files.
- :class:`ObjectStoreMetaStore`: one ``meta/manifest.json`` object updated
  with compare-and-swap (``if_match`` etag). Writes and deletes land in ONE
  CAS, so metadata publishes truly atomically — concurrent queries can
  never observe a merge's new file alongside its replaced sources (the
  window the FileSystemDataStore-as-MetaStore combination documents).
- Merge lease via conditional PUT on ``meta/merge.lease`` with expiry steal
  — the ``CoordinatedMetaStore`` design README.md:279-281 sketches —
  implementing :class:`coordination.MergeCoordinator`, so
  ``BloomSearchEngine.merge`` coordinates automatically.
"""

from __future__ import annotations

import dataclasses
import io
import json
import logging
import threading
import time
import uuid
from typing import BinaryIO, Optional, Protocol, runtime_checkable

from .coordination import Lease
from .file_format import FileMetadata
from .query import QueryPrefilter, filter_data_blocks
from .stores import DeleteOperation, MaybeFile, WriteOperation

logger = logging.getLogger("bloomsearch_tpu_torch.objectstore")


class PreconditionFailed(Exception):
    """Conditional PUT/DELETE lost the race (HTTP 412 analog)."""


@runtime_checkable
class ObjectStoreClient(Protocol):
    """Minimal S3-compatible surface. etags are opaque version strings."""

    def get(self, key: str) -> tuple[bytes, str]:
        """-> (data, etag); raises KeyError when absent."""
        ...

    def get_range(self, key: str, start: int, length: int) -> bytes:
        """Ranged read (clamped at object end); raises KeyError when absent."""
        ...

    def head(self, key: str) -> tuple[int, str]:
        """-> (size, etag); raises KeyError when absent."""
        ...

    def put(
        self, key: str, data: bytes, *, if_match: Optional[str] = None,
        if_none_match: bool = False,
    ) -> str:
        """-> new etag. if_match: CAS on current etag; if_none_match: only
        create. Raises PreconditionFailed on condition failure."""
        ...

    def delete(self, key: str, *, if_match: Optional[str] = None) -> None:
        """Idempotent; with if_match raises PreconditionFailed on mismatch."""
        ...

    def list(self, prefix: str) -> list[str]: ...


class InMemoryObjectStore:
    """Thread-safe in-memory ObjectStoreClient (the test/embedding fake)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._objects: dict[str, tuple[bytes, str]] = {}

    def _new_etag(self) -> str:
        return uuid.uuid4().hex

    def get(self, key: str) -> tuple[bytes, str]:
        with self._lock:
            data, etag = self._objects[key]
            return data, etag

    def get_range(self, key: str, start: int, length: int) -> bytes:
        with self._lock:
            data, _ = self._objects[key]
        return data[start : start + length]

    def head(self, key: str) -> tuple[int, str]:
        with self._lock:
            data, etag = self._objects[key]
            return len(data), etag

    def put(self, key, data, *, if_match=None, if_none_match=False) -> str:
        with self._lock:
            current = self._objects.get(key)
            if if_none_match and current is not None:
                raise PreconditionFailed(key)
            if if_match is not None and (current is None or current[1] != if_match):
                raise PreconditionFailed(key)
            etag = self._new_etag()
            self._objects[key] = (bytes(data), etag)
            return etag

    def delete(self, key, *, if_match=None) -> None:
        with self._lock:
            current = self._objects.get(key)
            if if_match is not None and (current is None or current[1] != if_match):
                raise PreconditionFailed(key)
            self._objects.pop(key, None)

    def list(self, prefix: str) -> list[str]:
        with self._lock:
            return sorted(k for k in self._objects if k.startswith(prefix))


class _UploadOnCloseFile:
    """Single-pass write buffer; PUT on close (atomic object visibility)."""

    def __init__(self, client: ObjectStoreClient, key: str):
        self._client = client
        self._key = key
        self._buf = io.BytesIO()
        self._closed = False

    def write(self, data) -> int:
        return self._buf.write(data)

    def flush(self) -> None:
        pass

    def tell(self) -> int:
        return self._buf.tell()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        # getbuffer(), not getvalue(): getvalue COPIES the whole buffered
        # file, transiently doubling host memory for every upload (a multi-GB
        # merge output would need 2x its size). Every client put() accepts
        # buffer-likes (bytes(data) / fh.write(data)).
        try:
            self._client.put(self._key, self._buf.getbuffer())
        finally:
            self._buf = io.BytesIO()  # drop the exported view + buffer

    def abort(self) -> None:
        """Discard without uploading (failed flushes never publish)."""
        self._closed = True
        self._buf = io.BytesIO()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        # Exception inside the with-block = incomplete write: abort — close()
        # would PUT the truncated object into the visible namespace.
        if exc_type is not None:
            self.abort()
        else:
            self.close()


class _RangedReadFile:
    """Seekable read-only file over ranged GETs with block readahead.

    Readahead is adaptive: tiny reads (sparse bank-row probes, footer
    fields) fetch a small window, bulk reads fetch large ones — a fixed
    256 KB window would turn a 40-byte sparse probe into a 256 KB GET.
    """

    READAHEAD = 256 * 1024
    SMALL_READAHEAD = 4 * 1024

    def __init__(self, client: ObjectStoreClient, key: str, size: int):
        self._client = client
        self._key = key
        self._size = size
        self._pos = 0
        self._cache_start = 0
        self._cache = b""

    def seek(self, offset: int, whence: int = 0) -> int:
        if whence == 0:
            self._pos = offset
        elif whence == 1:
            self._pos += offset
        elif whence == 2:
            self._pos = self._size + offset
        else:
            raise ValueError(f"bad whence {whence}")
        return self._pos

    def tell(self) -> int:
        return self._pos

    def read(self, n: int = -1) -> bytes:
        if n < 0:
            n = self._size - self._pos
        n = max(0, min(n, self._size - self._pos))
        if n == 0:
            return b""
        start, end = self._pos, self._pos + n
        cache_end = self._cache_start + len(self._cache)
        if not (self._cache_start <= start and end <= cache_end):
            fetch_len = max(n, self.SMALL_READAHEAD if n <= 1024 else self.READAHEAD)
            self._cache = self._client.get_range(self._key, start, fetch_len)
            self._cache_start = start
        rel = start - self._cache_start
        out = self._cache[rel : rel + n]
        self._pos += len(out)
        return out

    def close(self) -> None:
        self._cache = b""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ObjectStoreDataStore:
    """DataStore over an ObjectStoreClient (data_store.go:12-22 contract)."""

    def __init__(self, client: ObjectStoreClient, prefix: str = "data/"):
        self.client = client
        self.prefix = prefix

    def create_file(self) -> tuple[BinaryIO, bytes]:
        key = f"{self.prefix}bloom-{uuid.uuid4().hex}.dat"
        return _UploadOnCloseFile(self.client, key), key.encode("utf-8")

    def open_file(self, file_pointer: bytes) -> BinaryIO:
        key = file_pointer.decode("utf-8")
        try:
            size, _ = self.client.head(key)
        except KeyError:
            raise FileNotFoundError(key)
        return _RangedReadFile(self.client, key, size)

    def tombstone_file(self, file_pointer: bytes) -> None:
        self.client.delete(file_pointer.decode("utf-8"))


class ObjectStoreMetaStore:
    """MetaStore + MergeCoordinator over one CAS-updated manifest object."""

    def __init__(
        self,
        client: ObjectStoreClient,
        manifest_key: str = "meta/manifest.json",
        lease_key: str = "meta/merge.lease",
    ):
        self.client = client
        self.manifest_key = manifest_key
        self.lease_key = lease_key
        # Parsed-manifest cache keyed by etag (metadata objects are reused
        # across queries; FileMetadata.from_json dominates otherwise).
        self._cache_lock = threading.Lock()
        self._cached_etag: Optional[str] = None
        self._cached_files: dict[str, tuple[FileMetadata, int]] = {}

    # -- manifest ---------------------------------------------------------

    def _load(self) -> tuple[dict, Optional[str]]:
        try:
            data, etag = self.client.get(self.manifest_key)
        except KeyError:
            return {"files": {}}, None
        return json.loads(data), etag

    def _parsed_files(self) -> dict[str, tuple[FileMetadata, int]]:
        manifest, etag = self._load()
        with self._cache_lock:
            if etag is not None and etag == self._cached_etag:
                return self._cached_files
        files = {
            key: (FileMetadata.from_json(entry["metadata"]), int(entry.get("size", 0)))
            for key, entry in manifest["files"].items()
        }
        with self._cache_lock:
            self._cached_etag = etag
            self._cached_files = files
        return files

    def get_maybe_files_for_query(
        self, prefilter: Optional[QueryPrefilter]
    ) -> list[MaybeFile]:
        out: list[MaybeFile] = []
        for key, (metadata, size) in self._parsed_files().items():
            blocks = filter_data_blocks(metadata.data_blocks, prefilter)
            if prefilter is not None and not blocks:
                continue
            # dataclasses.replace: a hand-listed copy silently reset any
            # FileMetadata field added after it was written.
            filtered = dataclasses.replace(metadata, data_blocks=blocks)
            out.append(MaybeFile(pointer=key.encode("utf-8"), metadata=filtered, size=size))
        return out

    def update(
        self, writes: list[WriteOperation], deletes: list[DeleteOperation]
    ) -> None:
        """Atomic batch via CAS: retry on concurrent manifest updates."""
        for _ in range(64):
            manifest, etag = self._load()
            files = manifest.setdefault("files", {})
            for w in writes:
                files[w.file_pointer.decode("utf-8")] = {
                    "metadata": w.file_metadata.to_json(),
                    "size": w.file_size,
                }
            for d in deletes:
                files.pop(d.file_pointer.decode("utf-8"), None)
            payload = json.dumps(manifest, separators=(",", ":")).encode("utf-8")
            try:
                if etag is None:
                    self.client.put(self.manifest_key, payload, if_none_match=True)
                else:
                    self.client.put(self.manifest_key, payload, if_match=etag)
                return
            except PreconditionFailed:
                continue  # lost the CAS; re-read and re-apply
        raise RuntimeError("manifest CAS kept failing; too much contention")

    # -- merge lease (CoordinatedMetaStore, README.md:279-281) -------------

    def acquire_merge_lease(self, ttl_seconds: float = 300.0) -> Optional[Lease]:
        lease_id = uuid.uuid4().hex
        expires_at = time.time() + ttl_seconds
        payload = json.dumps({"id": lease_id, "expires_at": expires_at}).encode()
        try:
            etag = self.client.put(self.lease_key, payload, if_none_match=True)
        except PreconditionFailed:
            stale_etag = self._expired_lease_etag()
            if stale_etag is None:
                return None
            try:
                etag = self.client.put(self.lease_key, payload, if_match=stale_etag)
            except PreconditionFailed:
                return None  # someone else won the steal race

        state = {"etag": etag}

        def release():
            try:
                self.client.delete(self.lease_key, if_match=state["etag"])
            except PreconditionFailed:
                pass  # expired and stolen; nothing to release

        def renew(ttl: float) -> Optional[float]:
            # Conditional put against OUR etag: succeeds only while we are
            # still the recorded holder; a steal after expiry changed the
            # etag and the renew (correctly) fails — the merger aborts
            # before publishing.
            new_expiry = time.time() + ttl
            body = json.dumps({"id": lease_id, "expires_at": new_expiry}).encode()
            try:
                state["etag"] = self.client.put(
                    self.lease_key, body, if_match=state["etag"]
                )
            except PreconditionFailed:
                return None
            return new_expiry

        return Lease(release, lease_id, expires_at, renew_fn=renew)

    def _expired_lease_etag(self) -> Optional[str]:
        try:
            data, etag = self.client.get(self.lease_key)
        except KeyError:
            return None
        try:
            if time.time() > float(json.loads(data)["expires_at"]):
                return etag
        except (ValueError, KeyError, TypeError):
            return etag  # malformed lease: stealable
        return None


class LocalDirObjectStore:
    """File-backed ObjectStoreClient: the object-store stack (CAS manifest,
    merge lease, peer registry) on any shared filesystem — no S3 required.

    Layout: each object is ``<root>/<key>`` plus a ``.etag`` sidecar.
    Conditional operations serialize on an O_EXCL lock file (spin with
    backoff), making read-check-write atomic across processes on the same
    filesystem; payload writes go through temp + rename so readers never
    observe partial objects. Unconditional gets/puts don't take the lock.
    """

    _LOCK_TIMEOUT = 10.0

    def __init__(self, root_dir: str):
        import os

        self.root = root_dir
        os.makedirs(root_dir, exist_ok=True)
        self._lock_path = os.path.join(root_dir, ".cas.lock")

    # -- paths ------------------------------------------------------------

    def _path(self, key: str) -> str:
        import os

        # Keys must stay strictly under root: os.path.join discards root
        # entirely for absolute keys ('/etc/passwd' would read/write outside
        # the store), and '..' segments climb out of it.
        if (
            not key
            or os.path.isabs(key)
            or key.startswith(("/", "\\"))
            or ".." in key.replace("\\", "/").split("/")
        ):
            raise ValueError(f"invalid key: {key!r}")
        path = os.path.join(self.root, key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        return path

    # -- cross-process critical section ------------------------------------

    class _Lock:
        """Cross-process critical section via ``flock(2)`` on a persistent
        lock file (never unlinked — unlink would let a late acquirer lock a
        deleted inode while a newcomer locks a fresh one).

        The kernel drops the lock when the holder's fd closes — including
        process crash — so there are NO stale locks and NO steal heuristic.
        (Earlier mtime-based stealing could steal from a merely-SLOW live
        holder, admitting two processes to the CAS critical section; every
        release scheme short of the kernel's is a TOCTOU.) A holder that
        cannot acquire within the timeout raises TimeoutError instead.
        Local filesystems only (flock is advisory and unreliable on NFS) —
        which is this store's contract: a local directory posing as a
        bucket."""

        def __init__(self, path: str, timeout: float):
            self.path = path
            self.timeout = timeout
            self._fd: Optional[int] = None

        def __enter__(self):
            import fcntl
            import os

            fd = os.open(self.path, os.O_CREAT | os.O_RDWR)
            deadline = time.monotonic() + self.timeout
            delay = 0.001
            while True:
                try:
                    fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                    self._fd = fd
                    return self
                except OSError:
                    if time.monotonic() > deadline:
                        os.close(fd)
                        raise TimeoutError(f"CAS lock stuck: {self.path}")
                    time.sleep(delay)
                    delay = min(delay * 2, 0.05)

        def __exit__(self, *exc):
            import os

            if self._fd is not None:
                os.close(self._fd)  # close releases the flock
                self._fd = None

    def _cas_lock(self) -> "_Lock":
        return self._Lock(self._lock_path, self._LOCK_TIMEOUT)

    # -- ObjectStoreClient --------------------------------------------------

    def _read_etag(self, path: str) -> str:
        with open(path + ".etag", "r") as fh:
            return fh.read().strip()

    def get(self, key: str) -> tuple[bytes, str]:
        """Consistent-or-CAS-safe read: etag, data, etag — equal etags mean
        no write completed in between; an unequal pair retries. Combined
        with _write's data-before-etag ordering, a returned (data, etag)
        pair is either fully consistent or pairs NEWER data with an OLDER
        etag — and a CAS on an older etag fails, never losing an update."""
        path = self._path(key)
        for _ in range(64):
            try:
                e1 = self._read_etag(path)
                with open(path, "rb") as fh:
                    data = fh.read()
                e2 = self._read_etag(path)
            except FileNotFoundError:
                raise KeyError(key)
            if e1 == e2:
                return data, e1
        raise RuntimeError(f"torn reads persisted for {key!r}")

    def get_range(self, key: str, start: int, length: int) -> bytes:
        path = self._path(key)
        try:
            with open(path, "rb") as fh:
                fh.seek(start)
                return fh.read(length)
        except FileNotFoundError:
            raise KeyError(key)

    def head(self, key: str) -> tuple[int, str]:
        import os

        path = self._path(key)
        try:
            return os.stat(path).st_size, self._read_etag(path)
        except FileNotFoundError:
            raise KeyError(key)

    def _write(self, path: str, data: bytes) -> str:
        import os

        etag = uuid.uuid4().hex
        tmp = f"{path}.tmp.{etag}"
        with open(tmp, "wb") as fh:
            fh.write(data)
        # DATA lands first, etag second: a torn read can then only pair
        # newer data with an older etag, and a CAS on the older etag fails
        # (conservative). The reverse order would let stale data carry the
        # new etag and a CAS silently lose the concurrent update.
        os.replace(tmp, path)
        tmp_etag = f"{path}.etag.tmp.{etag}"
        with open(tmp_etag, "w") as fh:
            fh.write(etag)
        os.replace(tmp_etag, path + ".etag")
        return etag

    def put(self, key, data, *, if_match=None, if_none_match=False) -> str:
        import os

        path = self._path(key)
        if if_match is None and not if_none_match:
            return self._write(path, bytes(data))
        with self._cas_lock():
            # The etag sidecar is written LAST, so it is the commit record:
            # a data file without one is a torn crash leftover == absent.
            try:
                current = self._read_etag(path)
            except FileNotFoundError:
                current = None
            if if_none_match and current is not None:
                raise PreconditionFailed(key)
            if if_match is not None and current != if_match:
                raise PreconditionFailed(key)
            return self._write(path, bytes(data))

    def delete(self, key, *, if_match=None) -> None:
        import os

        path = self._path(key)
        if if_match is None:
            # .etag FIRST: the sidecar is the commit record, and a crash
            # between the two unlinks must leave "no object", not an orphan
            # etag that makes if_none_match puts (the merge lease) fail
            # forever.
            for p in (path + ".etag", path):
                try:
                    os.remove(p)
                except FileNotFoundError:
                    pass
            return
        with self._cas_lock():
            try:
                if self._read_etag(path) != if_match:
                    raise PreconditionFailed(key)
            except FileNotFoundError:
                raise PreconditionFailed(key)
            for p in (path + ".etag", path):  # etag first (commit record)
                try:
                    os.remove(p)
                except FileNotFoundError:
                    pass

    def list(self, prefix: str) -> list[str]:
        import os

        out = []
        for dirpath, _dirs, names in os.walk(self.root):
            for name in names:
                if name.endswith(".etag") or ".tmp." in name or name == ".cas.lock":
                    continue
                rel = os.path.relpath(os.path.join(dirpath, name), self.root)
                key = rel.replace(os.sep, "/")
                if key.startswith(prefix):
                    out.append(key)
        return sorted(out)
