"""MCP invocation cache (§3.3.2): S3-backed, content-hash keys, TTL.

Cache key = H(tool name, canonicalized arguments); entries live in an object
store bucket with the TTL in metadata. Developers set per-tool TTLs —
``-1`` (infinite; e.g. DOI downloads), ``0`` (never cache; e.g. stock quotes),
or a finite number of seconds.

Canonicalization is explicit: only JSON-safe argument values participate in
the key (None, bool, int, finite float, str, list/tuple, dict with str keys).
Anything else raises ``TypeError`` instead of being silently keyed by its
``str()`` repr — two distinct objects with equal reprs must not collide, and
a non-JSON type sneaking into a key is a caching bug at the call site, not
something to paper over.
"""
from __future__ import annotations

import hashlib
import json
import math
from typing import Any, Optional, Tuple

from repro_torch.core.objectstore import ObjectStore
from repro_torch.core.telemetry import emit

CACHE_BUCKET = "fame-mcp-cache"


def canonicalize(value: Any, path: str = "args") -> Any:
    """Canonical JSON-safe form of a tool-argument value.

    Tuples become lists, dict keys are required to be strings (ordering is
    handled by sorted serialization, not here). Non-finite floats and any
    other type raise ``TypeError`` naming the offending path.
    """
    if value is None or isinstance(value, (bool, str)):
        return value
    if isinstance(value, int):
        return value
    if isinstance(value, float):
        if not math.isfinite(value):
            raise TypeError(
                f"tool argument {path} is a non-finite float ({value!r}); "
                "non-finite floats have no canonical JSON form")
        return value
    if isinstance(value, (list, tuple)):
        return [canonicalize(v, f"{path}[{i}]") for i, v in enumerate(value)]
    if isinstance(value, dict):
        for k in value:
            if not isinstance(k, str):
                raise TypeError(
                    f"tool argument {path} has a non-string dict key "
                    f"({k!r}); cache keys require string-keyed mappings")
        return {k: canonicalize(value[k], f"{path}.{k}")
                for k in sorted(value)}
    raise TypeError(
        f"tool argument {path} has non-JSON type {type(value).__name__}; "
        "pass JSON-safe values (None/bool/int/float/str/list/dict) or mark "
        "the tool ttl_s=0 / cacheable=False")


def canonical_args_text(args: dict) -> str:
    """Deterministic rendering of tool arguments — shared by the cache key
    and the serving layer's tool-stream injection (fame/toolflow.py), so a
    cached result re-enters the token stream byte-identically."""
    return json.dumps(canonicalize(args), sort_keys=True,
                      separators=(",", ":"))


def cache_key(tool: str, args: dict) -> str:
    canon = json.dumps({"tool": tool, "args": canonicalize(args)},
                       sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(canon.encode()).hexdigest()


class CacheManager:
    def __init__(self, store: ObjectStore, *, enabled: bool = True,
                 upload_latency_s: float = 0.19, lookup_latency_s: float = 0.03):
        self.store = store
        self.enabled = enabled
        self.upload_latency_s = upload_latency_s     # §5.3.1 measured 0.19s
        self.lookup_latency_s = lookup_latency_s
        self.hits = 0
        self.misses = 0

    def lookup(self, tool: str, args: dict, ttl_s: float,
               t: Optional[float] = None) -> Tuple[bool, Any]:
        if not self.enabled or ttl_s == 0:
            return False, None
        key = cache_key(tool, args)
        obj = self.store.get(CACHE_BUCKET, key, t=t)
        if obj is None:
            self.misses += 1
            emit("cache", tool, t or 0, t or 0, hit=False)
            return False, None
        self.hits += 1
        emit("cache", tool, t or 0, t or 0, hit=True)
        return True, json.loads(obj.data.decode())

    def store_latency(self) -> float:
        return self.upload_latency_s

    def put(self, tool: str, args: dict, result: Any, ttl_s: float,
            t: Optional[float] = None):
        if not self.enabled or ttl_s == 0:
            return
        key = cache_key(tool, args)
        self.store.put(CACHE_BUCKET, key, json.dumps(result, default=str).encode(),
                       {"ttl_s": None if ttl_s < 0 else ttl_s, "tool": tool}, t=t)
