"""Aliyun OSS blob backend and a pcache-style read-through cache.

Counterpart of ``diffute_tpu/io/oss.py`` (stdlib only, so a copy): the
reference trains against blobs on Aliyun OSS behind a local read-through
cache.

  - :class:`OSSClient`: a minimal signed-GET client for ``oss://bucket/key``
    URLs (header signature ``Authorization: OSS <id>:<base64(hmac-sha1(
    secret, VERB\\n\\n\\nDate\\n/bucket/key))>``), anonymous GETs for
    public buckets, bounded retries with backoff.  Credentials and endpoint
    come from ``OSS_ENDPOINT`` / ``OSS_ACCESS_KEY_ID`` /
    ``OSS_ACCESS_KEY_SECRET`` when not passed.
  - :func:`read_through_cache`: wraps any opener with a local blob cache;
    the first read pulls and persists, repeat reads stay local.
  - :func:`register_oss`: plugs both into the ``oss://`` scheme of
    :mod:`diffute_tpu_torch.io.storage`, so manifests can name OSS paths.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import io
import os
import time
import urllib.error
import urllib.parse
import urllib.request
from email.utils import formatdate
from typing import BinaryIO, Callable, Optional


class OSSClient:
    """GETs ``oss://bucket/key`` blobs.

    ``path_style=True`` addresses ``endpoint/bucket/key`` (local emulators,
    tests); the default virtual-host style addresses ``bucket.endpoint/key``
    (real OSS).
    """

    def __init__(self, endpoint: Optional[str] = None,
                 access_key_id: Optional[str] = None,
                 access_key_secret: Optional[str] = None,
                 path_style: bool = False,
                 retries: int = 3, backoff_s: float = 0.2,
                 timeout_s: float = 30.0):
        self.endpoint = (endpoint or os.environ.get("OSS_ENDPOINT", "")
                         ).rstrip("/")
        if not self.endpoint:
            raise ValueError("OSS endpoint required (arg or $OSS_ENDPOINT)")
        if "://" not in self.endpoint:
            self.endpoint = "https://" + self.endpoint
        self.access_key_id = access_key_id or os.environ.get(
            "OSS_ACCESS_KEY_ID")
        self.access_key_secret = access_key_secret or os.environ.get(
            "OSS_ACCESS_KEY_SECRET")
        self.path_style = path_style
        self.retries = retries
        self.backoff_s = backoff_s
        self.timeout_s = timeout_s

    @staticmethod
    def parse(url: str):
        if not url.startswith("oss://"):
            raise ValueError(f"not an oss:// url: {url!r}")
        rest = url[len("oss://"):]
        bucket, _, key = rest.partition("/")
        if not bucket or not key:
            raise ValueError(f"oss url must be oss://bucket/key: {url!r}")
        return bucket, key

    def _sign(self, verb: str, bucket: str, key: str, date: str) -> str:
        to_sign = f"{verb}\n\n\n{date}\n/{bucket}/{key}"
        digest = hmac.new(self.access_key_secret.encode(),
                          to_sign.encode(), hashlib.sha1).digest()
        return f"OSS {self.access_key_id}:{base64.b64encode(digest).decode()}"

    def url_for(self, bucket: str, key: str) -> str:
        # the SIGNATURE uses the raw canonical resource /bucket/key; the URL
        # must percent-encode the key (spaces / non-ASCII are routine in
        # document-OCR manifests and would otherwise break the request line)
        quoted = urllib.parse.quote(key, safe="/")
        if self.path_style:
            return f"{self.endpoint}/{bucket}/{quoted}"
        scheme, host = self.endpoint.split("://", 1)
        return f"{scheme}://{bucket}.{host}/{quoted}"

    def get(self, url: str) -> bytes:
        bucket, key = self.parse(url)
        last_err: Exception = RuntimeError("unreachable")
        for attempt in range(self.retries):
            date = formatdate(usegmt=True)
            req = urllib.request.Request(self.url_for(bucket, key))
            req.add_header("Date", date)
            if self.access_key_id and self.access_key_secret:
                req.add_header("Authorization",
                               self._sign("GET", bucket, key, date))
            try:
                with urllib.request.urlopen(req,
                                            timeout=self.timeout_s) as resp:
                    return resp.read()
            except urllib.error.HTTPError as e:
                if e.code == 404:
                    raise FileNotFoundError(f"{url}: HTTP 404") from e
                if e.code == 403:
                    raise PermissionError(f"{url}: HTTP 403 (check "
                                          "credentials/signature)") from e
                last_err = e
            except urllib.error.URLError as e:
                last_err = e
            time.sleep(self.backoff_s * (2 ** attempt))
        raise IOError(f"OSS GET failed after {self.retries} tries: {url}"
                      ) from last_err

    def opener(self) -> Callable[[str], BinaryIO]:
        return lambda url: io.BytesIO(self.get(url))


def read_through_cache(opener: Callable[[str], BinaryIO],
                       cache_dir: str) -> Callable[[str], BinaryIO]:
    """pcache-style local cache: blob keyed by sha1(url), written atomically
    (tmp + rename) so concurrent loader threads never see partial files."""
    os.makedirs(cache_dir, exist_ok=True)

    def cached_open(url: str) -> BinaryIO:
        name = hashlib.sha1(url.encode()).hexdigest()
        path = os.path.join(cache_dir, name)
        if os.path.exists(path):
            return open(path, "rb")
        with opener(url) as f:
            data = f.read()
        tmp = f"{path}.tmp.{os.getpid()}.{id(data)}"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
        return io.BytesIO(data)

    return cached_open


def register_oss(endpoint: Optional[str] = None,
                 access_key_id: Optional[str] = None,
                 access_key_secret: Optional[str] = None,
                 cache_dir: Optional[str] = None,
                 path_style: bool = False, **client_kwargs) -> OSSClient:
    """Register the ``oss://`` scheme with diffute_tpu_torch.io.storage
    (with the read-through cache when ``cache_dir`` is given).  Returns the
    client."""
    from diffute_tpu_torch.io.storage import register_opener

    client = OSSClient(endpoint, access_key_id, access_key_secret,
                       path_style=path_style, **client_kwargs)
    opener = client.opener()
    if cache_dir:
        opener = read_through_cache(opener, cache_dir)
    register_opener("oss", opener)
    return client
