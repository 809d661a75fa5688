"""Multi-writer coordination: merge leases.

The reference sketches a ``CoordinatedMetaStore`` exposing leases so multiple
writers can merge against shared storage without racing (README.md:279-281 —
design only, never implemented). Implemented here:

- :class:`CoordinatedMetaStore` — the protocol: a MetaStore that can also
  grant exclusive, expiring merge leases.
- :class:`FileLeaseCoordinator` — filesystem implementation; every
  read/steal/create/release runs under an ``flock(2)`` on a sidecar lock
  file, so there is no check-then-act window (an earlier version stole with
  bare read→remove→create, which let remove-create-remove-create
  interleavings hand the lease to two holders; object-store backends
  implement the same protocol with conditional puts instead).

``BloomSearchEngine.merge`` acquires the lease automatically when its
MetaStore provides one, so concurrent mergers on shared storage serialize
and a crashed merger's lease expires rather than wedging the system. Mergers
must treat the lease as a *publish guard*: check ``lease.valid()`` (after
``lease.renew()``) immediately before each atomic metadata publish and abort
if lost — a merge that outruns its TTL may have been legitimately stolen.
"""

from __future__ import annotations

import os
import time
import uuid
from contextlib import contextmanager
from typing import Optional, Protocol, runtime_checkable


class Lease:
    """An exclusive, expiring right to run a merge."""

    def __init__(self, release_fn, lease_id: str, expires_at: float, renew_fn=None):
        self._release = release_fn
        self._renew = renew_fn
        self.lease_id = lease_id
        self.expires_at = expires_at

    def valid(self) -> bool:
        return time.time() < self.expires_at

    def renew(self, ttl_seconds: float = 300.0) -> bool:
        """Extend the lease if still held; False means it was lost
        (expired and stolen) — the merger must NOT publish."""
        if self._renew is None:
            return self.valid()
        new_expiry = self._renew(ttl_seconds)
        if new_expiry is None:
            return False
        self.expires_at = new_expiry
        return True

    def release(self) -> None:
        self._release()

    def __enter__(self) -> "Lease":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


@runtime_checkable
class MergeCoordinator(Protocol):
    def acquire_merge_lease(self, ttl_seconds: float = 300.0) -> Optional[Lease]:
        """Try to acquire the exclusive merge lease; None if someone holds it."""
        ...


class FileLeaseCoordinator:
    """Lease via a file on a (shared) filesystem, serialized by flock(2).

    The lease file holds ``lease_id expires_at``. All operations (acquire,
    expired-steal, renew, release) run inside an exclusive flock on a
    sidecar ``.lock`` file, making each one atomic with respect to every
    other process on the filesystem — no TOCTOU between reading the current
    holder and replacing/removing it.
    """

    def __init__(self, root_dir: str, name: str = "merge.lease"):
        os.makedirs(root_dir, exist_ok=True)
        self._path = os.path.join(root_dir, name)
        self._lock_path = self._path + ".lock"

    @contextmanager
    def _locked(self):
        import fcntl

        fd = os.open(self._lock_path, os.O_CREAT | os.O_RDWR)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            yield
        finally:
            os.close(fd)  # releases the flock

    def _read_current(self) -> Optional[tuple[bytes, float]]:
        """(lease_id, expires_at) of the recorded holder, or None if absent
        or malformed (malformed = stealable)."""
        try:
            with open(self._path, "rb") as fh:
                lease_id, expiry_text = fh.read().split(b" ", 1)
            return lease_id, float(expiry_text)
        except FileNotFoundError:
            return None
        except (ValueError, OSError):
            return None

    def acquire_merge_lease(self, ttl_seconds: float = 300.0) -> Optional[Lease]:
        lease_id = uuid.uuid4().hex
        with self._locked():
            current = self._read_current()
            if current is not None and time.time() <= current[1]:
                return None  # live holder
            expires_at = time.time() + ttl_seconds
            with open(self._path, "wb") as fh:
                fh.write(f"{lease_id} {expires_at}".encode())

        def release():
            with self._locked():
                current = self._read_current()
                if current is not None and current[0] == lease_id.encode():
                    try:
                        os.remove(self._path)
                    except FileNotFoundError:
                        pass

        def renew(ttl: float) -> Optional[float]:
            with self._locked():
                current = self._read_current()
                if current is None or current[0] != lease_id.encode():
                    return None  # lost (stolen after expiry)
                new_expiry = time.time() + ttl
                with open(self._path, "wb") as fh:
                    fh.write(f"{lease_id} {new_expiry}".encode())
                return new_expiry

        return Lease(release, lease_id, expires_at, renew_fn=renew)
