"""S3-compatible HTTP ObjectStoreClient with SigV4 signing.

The real-network backend for the object-store stack (objectstore.py): the
reference names S3 buckets as the point of the storage abstraction
(README.md:289-315); ObjectStoreDataStore / ObjectStoreMetaStore already
implement the engine side against the :class:`ObjectStoreClient` protocol,
and this client completes the pair — stdlib-only (http.client + hmac), no
boto.

Maps the protocol onto the S3 REST API:

- ``get``/``get_range``/``head`` → GET / GET+Range / HEAD (etag from the
  ``ETag`` header, quotes stripped)
- ``put(if_match=...)`` → ``If-Match`` conditional write;
  ``put(if_none_match=True)`` → ``If-None-Match: *`` create-only (both are
  native S3 features as of 2024; MinIO/R2 support them too)
- ``delete(if_match=...)`` → ``If-Match`` conditional delete
- ``list`` → ListObjectsV2 with continuation tokens

HTTP 412 (and 409 ConditionalRequestConflict) map to
:class:`PreconditionFailed`; 404 to ``KeyError``. Retries with exponential
backoff + jitter on connection errors, 429, and 5xx — conditional PUTs
included (a replayed conditional PUT is idempotent-safe: if the first
attempt actually landed, the replay fails the precondition, which the CAS
loop upstream treats as "lost the race" and re-reads).

Addressing is path-style (``/<bucket>/<key>``) so MinIO, Ceph, R2, GCS-interop
and local fakes work without wildcard DNS. Credentials come from arguments
or the standard ``AWS_ACCESS_KEY_ID`` / ``AWS_SECRET_ACCESS_KEY`` /
``AWS_SESSION_TOKEN`` environment variables.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import http.client
import logging
import os
import random
import socket
import threading
import time
import urllib.parse
import xml.etree.ElementTree as ET
from typing import Optional

from .objectstore import PreconditionFailed

logger = logging.getLogger("bloomsearch_tpu_torch.s3")

_EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()


class S3Error(Exception):
    """Non-retryable S3 failure (status + body excerpt)."""

    def __init__(self, status: int, method: str, key: str, body: bytes = b""):
        self.status = status
        super().__init__(f"S3 {method} {key!r}: HTTP {status} {body[:200]!r}")


def _sign(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode("utf-8"), hashlib.sha256).digest()


def sigv4_headers(
    method: str,
    host: str,
    canonical_uri: str,
    query: str,
    headers: dict[str, str],
    payload_hash: str,
    *,
    region: str,
    access_key: str,
    secret_key: str,
    session_token: Optional[str] = None,
    now: Optional[datetime.datetime] = None,
) -> dict[str, str]:
    """Compute the SigV4 Authorization + x-amz-* headers for one request.

    Module-level (not a method) so the test fake can recompute and VERIFY
    signatures with the same code path the client signs with... except the
    fake recomputes from the parsed request, which catches canonicalization
    bugs on both sides.
    """
    now = now or datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    datestamp = now.strftime("%Y%m%d")

    all_headers = dict(headers)
    all_headers["host"] = host
    all_headers["x-amz-date"] = amz_date
    all_headers["x-amz-content-sha256"] = payload_hash
    if session_token:
        all_headers["x-amz-security-token"] = session_token

    lowered = {k.lower(): " ".join(v.split()) for k, v in all_headers.items()}
    signed_names = sorted(lowered)
    canonical_headers = "".join(f"{k}:{lowered[k]}\n" for k in signed_names)
    signed_headers = ";".join(signed_names)

    canonical_request = "\n".join(
        [method, canonical_uri, query, canonical_headers, signed_headers, payload_hash]
    )
    scope = f"{datestamp}/{region}/s3/aws4_request"
    string_to_sign = "\n".join(
        [
            "AWS4-HMAC-SHA256",
            amz_date,
            scope,
            hashlib.sha256(canonical_request.encode("utf-8")).hexdigest(),
        ]
    )
    k_date = _sign(("AWS4" + secret_key).encode("utf-8"), datestamp)
    k_region = hmac.new(k_date, region.encode(), hashlib.sha256).digest()
    k_service = hmac.new(k_region, b"s3", hashlib.sha256).digest()
    k_signing = hmac.new(k_service, b"aws4_request", hashlib.sha256).digest()
    signature = hmac.new(
        k_signing, string_to_sign.encode("utf-8"), hashlib.sha256
    ).hexdigest()

    out = {
        "x-amz-date": amz_date,
        "x-amz-content-sha256": payload_hash,
        "Authorization": (
            f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
            f"SignedHeaders={signed_headers}, Signature={signature}"
        ),
    }
    if session_token:
        out["x-amz-security-token"] = session_token
    return out


def _canonical_query(params: dict[str, str]) -> str:
    return "&".join(
        f"{urllib.parse.quote(k, safe='-_.~')}={urllib.parse.quote(v, safe='-_.~')}"
        for k, v in sorted(params.items())
    )


class S3ObjectStore:
    """ObjectStoreClient over the S3 REST API (SigV4, retries, ranged GET).

    One persistent HTTP(S) connection per thread (query workers read
    concurrently); connections reconnect transparently on error.
    """

    def __init__(
        self,
        bucket: str,
        *,
        region: str = "us-east-1",
        endpoint: Optional[str] = None,
        scheme: str = "https",
        access_key: Optional[str] = None,
        secret_key: Optional[str] = None,
        session_token: Optional[str] = None,
        key_prefix: str = "",
        max_retries: int = 4,
        timeout: float = 30.0,
        list_page_size: int = 1000,
    ):
        self.bucket = bucket
        self.region = region
        self.scheme = scheme
        self.endpoint = endpoint or f"s3.{region}.amazonaws.com"
        self.key_prefix = key_prefix
        self.max_retries = max_retries
        self.timeout = timeout
        self.list_page_size = list_page_size
        self.access_key = access_key or os.environ.get("AWS_ACCESS_KEY_ID", "")
        self.secret_key = secret_key or os.environ.get("AWS_SECRET_ACCESS_KEY", "")
        self.session_token = session_token or os.environ.get("AWS_SESSION_TOKEN")
        if not self.access_key or not self.secret_key:
            raise ValueError(
                "S3 credentials required (args or AWS_ACCESS_KEY_ID / "
                "AWS_SECRET_ACCESS_KEY environment)"
            )
        self._local = threading.local()

    # -- transport ----------------------------------------------------------

    def _connection(self) -> http.client.HTTPConnection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            cls = (
                http.client.HTTPSConnection
                if self.scheme == "https"
                else http.client.HTTPConnection
            )
            conn = cls(self.endpoint, timeout=self.timeout)
            self._local.conn = conn
        return conn

    def _drop_connection(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            try:
                conn.close()
            except Exception:
                pass
            self._local.conn = None

    def _uri_for(self, key: str) -> str:
        path = f"/{self.bucket}/{self.key_prefix}{key}" if key else f"/{self.bucket}"
        # RFC 3986 segment encoding with '/' kept — S3's canonical form.
        return urllib.parse.quote(path, safe="/-_.~")

    def _request(
        self,
        method: str,
        key: str,
        *,
        headers: Optional[dict[str, str]] = None,
        body: bytes = b"",
        query: Optional[dict[str, str]] = None,
        ok: tuple[int, ...] = (200,),
    ) -> tuple[int, dict[str, str], bytes]:
        canonical_uri = self._uri_for(key)
        query_string = _canonical_query(query or {})
        payload_hash = hashlib.sha256(body).hexdigest() if body else _EMPTY_SHA256
        last_exc: Optional[Exception] = None
        for attempt in range(self.max_retries + 1):
            req_headers = dict(headers or {})
            req_headers.update(
                sigv4_headers(
                    method, self.endpoint, canonical_uri, query_string, req_headers,
                    payload_hash, region=self.region, access_key=self.access_key,
                    secret_key=self.secret_key, session_token=self.session_token,
                )
            )
            if body is not None and method in ("PUT", "POST"):
                # Explicit even for EMPTY bodies: http.client only adds
                # Content-Length for non-None bodies, and AWS rejects a PUT
                # without one (411 MissingContentLength) — a zero-byte
                # object (marker/sentinel key) must be creatable.
                req_headers["Content-Length"] = str(len(body))
            url = canonical_uri + (f"?{query_string}" if query_string else "")
            try:
                conn = self._connection()
                conn.request(
                    method, url,
                    # Empty PUT/POST bodies stay b"" (Content-Length: 0 is
                    # required); bodiless methods send None as before.
                    body=body if (body or method in ("PUT", "POST")) else None,
                    headers=req_headers,
                )
                resp = conn.getresponse()
                data = resp.read()
                status = resp.status
                resp_headers = {k.lower(): v for k, v in resp.getheaders()}
            except (OSError, http.client.HTTPException, socket.timeout) as exc:
                self._drop_connection()
                last_exc = exc
                if attempt < self.max_retries:
                    self._backoff(attempt)
                    continue
                raise
            if status in ok:
                return status, resp_headers, data
            if status == 404:
                raise KeyError(key)
            if status in (409, 412):
                # 412 PreconditionFailed; 409 ConditionalRequestConflict
                # (S3's answer when concurrent conditional writes collide).
                raise PreconditionFailed(key)
            if status in (429, 500, 502, 503, 504) and attempt < self.max_retries:
                self._backoff(attempt)
                continue
            raise S3Error(status, method, key, data)
        raise last_exc if last_exc else RuntimeError("unreachable")

    @staticmethod
    def _backoff(attempt: int) -> None:
        time.sleep(min(2.0, 0.05 * (2**attempt)) * (0.5 + random.random()))

    @staticmethod
    def _etag(headers: dict[str, str]) -> str:
        return headers.get("etag", "").strip('"')

    # -- ObjectStoreClient ----------------------------------------------------

    def get(self, key: str) -> tuple[bytes, str]:
        _, headers, data = self._request("GET", key)
        return data, self._etag(headers)

    def get_range(self, key: str, start: int, length: int) -> bytes:
        try:
            status, _, data = self._request(
                "GET", key,
                headers={"Range": f"bytes={start}-{start + length - 1}"},
                ok=(200, 206),
            )
        except S3Error as exc:
            if exc.status == 416:  # start beyond EOF: clamped read is empty
                return b""
            raise
        if status == 200:
            # Server (or proxy) ignored the Range header and returned the
            # whole object: slice locally. Returning the full body as if it
            # started at `start` would hand callers bytes from offset 0
            # misattributed to `start` — silently corrupt bank/metadata
            # reads.
            return data[start : start + length]
        return data

    def head(self, key: str) -> tuple[int, str]:
        _, headers, _ = self._request("HEAD", key)
        return int(headers.get("content-length", "0")), self._etag(headers)

    def put(
        self, key: str, data: bytes, *, if_match: Optional[str] = None,
        if_none_match: bool = False,
    ) -> str:
        headers: dict[str, str] = {}
        if if_none_match:
            headers["If-None-Match"] = "*"
        if if_match is not None:
            headers["If-Match"] = f'"{if_match}"'
        # No bytes(data) copy: hashlib and http.client both accept
        # buffer-likes, and _UploadOnCloseFile passes getbuffer() precisely
        # so a multi-GB merge upload never holds two copies.
        body = data if isinstance(data, (bytes, memoryview)) else memoryview(data)
        _, resp_headers, _ = self._request("PUT", key, headers=headers, body=body)
        return self._etag(resp_headers)

    def delete(self, key: str, *, if_match: Optional[str] = None) -> None:
        headers: dict[str, str] = {}
        if if_match is not None:
            headers["If-Match"] = f'"{if_match}"'
        try:
            self._request("DELETE", key, headers=headers, ok=(200, 204))
        except KeyError:
            if if_match is not None:
                raise PreconditionFailed(key)
            # unconditional delete is idempotent

    def list(self, prefix: str) -> list[str]:
        out: list[str] = []
        token: Optional[str] = None
        while True:
            params = {
                "list-type": "2",
                "prefix": f"{self.key_prefix}{prefix}",
                "max-keys": str(self.list_page_size),
            }
            if token:
                params["continuation-token"] = token
            _, _, data = self._request("GET", "", query=params)
            root = ET.fromstring(data)
            ns = ""
            if root.tag.startswith("{"):
                ns = root.tag[: root.tag.index("}") + 1]
            for contents in root.findall(f"{ns}Contents"):
                key_el = contents.find(f"{ns}Key")
                if key_el is not None and key_el.text:
                    key = key_el.text
                    if self.key_prefix and key.startswith(self.key_prefix):
                        key = key[len(self.key_prefix):]
                    out.append(key)
            truncated = root.find(f"{ns}IsTruncated")
            if truncated is not None and (truncated.text or "").lower() == "true":
                token_el = root.find(f"{ns}NextContinuationToken")
                token = token_el.text if token_el is not None else None
                if not token:
                    # Truncated with no continuation token: a silent break
                    # would return a plausible-looking PARTIAL listing and
                    # callers (manifest recovery, peer discovery) would
                    # treat missing keys as deleted. Fail loudly.
                    raise S3Error(
                        "truncated ListObjectsV2 response without "
                        "NextContinuationToken"
                    )
                continue
            break
        return sorted(out)
