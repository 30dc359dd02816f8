"""S3-analogue object store: buckets, keys, metadata (TTL), URL handles.

Used by FAME for (a) the MCP invocation cache (§3.3.2), (b) S3-based file
handling — tools put large payloads here and pass ``s3://`` URLs instead of
inlining content into the agent context window.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import time
from typing import Any, Dict, Optional, Tuple

from repro_torch.core.pricing import PRICING
from repro_torch.core.telemetry import emit


@dataclasses.dataclass
class Obj:
    data: bytes
    metadata: Dict[str, Any]
    put_time: float


class ObjectStore:
    """In-process S3 semantics; deterministic; costs metered."""

    def __init__(self, clock=None):
        self._buckets: Dict[str, Dict[str, Obj]] = {}
        self.clock = clock           # FaaS clock provider (for TTLs); optional

    def _now(self) -> float:
        return self.clock.now() if self.clock is not None else time.time()

    # ---- core API -------------------------------------------------------
    def put(self, bucket: str, key: str, data: bytes,
            metadata: Optional[Dict[str, Any]] = None, t: Optional[float] = None) -> str:
        b = self._buckets.setdefault(bucket, {})
        now = t if t is not None else self._now()
        b[key] = Obj(bytes(data), dict(metadata or {}), now)
        emit("store", f"s3:put:{bucket}", now, now, bytes=len(data),
             cost_cents=PRICING.s3_put_cents)
        return f"s3://{bucket}/{key}"

    def get(self, bucket: str, key: str, t: Optional[float] = None) -> Optional[Obj]:
        now = t if t is not None else self._now()
        obj = self._buckets.get(bucket, {}).get(key)
        emit("store", f"s3:get:{bucket}", now, now,
             bytes=len(obj.data) if obj else 0, cost_cents=PRICING.s3_get_cents,
             hit=obj is not None)
        if obj is None:
            return None
        ttl = obj.metadata.get("ttl_s")
        if ttl is not None and ttl >= 0 and now - obj.put_time > ttl:
            return None                      # stale per §3.3.2
        return obj

    def get_url(self, url: str, t: Optional[float] = None) -> Optional[Obj]:
        bucket, key = self.parse_url(url)
        return self.get(bucket, key, t)

    def delete(self, bucket: str, key: str):
        self._buckets.get(bucket, {}).pop(key, None)

    def list(self, bucket: str, pattern: str = "*"):
        return [k for k in self._buckets.get(bucket, {}) if fnmatch.fnmatch(k, pattern)]

    @staticmethod
    def parse_url(url: str) -> Tuple[str, str]:
        assert url.startswith("s3://"), url
        bucket, _, key = url[5:].partition("/")
        return bucket, key

    # ---- convenience: the file-handling library (§3.3.2) ----------------
    def stash(self, bucket: str, key: str, text: str, t: Optional[float] = None,
              **metadata) -> str:
        """Store large content, return a URL handle for the agent context."""
        return self.put(bucket, key, text.encode(), metadata, t=t)

    def fetch_text(self, url: str, t: Optional[float] = None) -> Optional[str]:
        obj = self.get_url(url, t)
        return obj.data.decode() if obj is not None else None
