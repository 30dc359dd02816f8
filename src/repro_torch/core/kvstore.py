"""DynamoDB-analogue KV store: tables, composite keys, conditional puts.

Backs FAME's durable agent memory (§3.2): one table keyed by ``session_id``
with ``invocation_id``-indexed entries appended per workflow invocation.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from repro_torch.core.pricing import PRICING
from repro_torch.core.telemetry import emit


class KVStore:
    def __init__(self, clock=None):
        self._tables: Dict[str, Dict[str, Dict[str, Any]]] = {}
        self.clock = clock

    def _now(self):
        return self.clock.now() if self.clock is not None else time.time()

    def put(self, table: str, key: str, item: Dict[str, Any],
            t: Optional[float] = None, if_not_exists: bool = False) -> bool:
        tb = self._tables.setdefault(table, {})
        if if_not_exists and key in tb:
            return False
        now = t if t is not None else self._now()
        tb[key] = dict(item)
        emit("store", f"kv:put:{table}", now, now, cost_cents=PRICING.kv_write_cents)
        return True

    def get(self, table: str, key: str, t: Optional[float] = None) -> Optional[Dict[str, Any]]:
        now = t if t is not None else self._now()
        emit("store", f"kv:get:{table}", now, now, cost_cents=PRICING.kv_read_cents)
        item = self._tables.get(table, {}).get(key)
        return dict(item) if item is not None else None

    def query_prefix(self, table: str, prefix: str, t: Optional[float] = None) -> List[Dict[str, Any]]:
        now = t if t is not None else self._now()
        tb = self._tables.get(table, {})
        keys = sorted(k for k in tb if k.startswith(prefix))
        emit("store", f"kv:query:{table}", now, now,
             cost_cents=PRICING.kv_read_cents * max(1, len(keys)))
        return [dict(tb[k]) for k in keys]

    def update(self, table: str, key: str, updates: Dict[str, Any],
               t: Optional[float] = None):
        tb = self._tables.setdefault(table, {})
        item = tb.setdefault(key, {})
        item.update(updates)
        now = t if t is not None else self._now()
        emit("store", f"kv:update:{table}", now, now, cost_cents=PRICING.kv_write_cents)
