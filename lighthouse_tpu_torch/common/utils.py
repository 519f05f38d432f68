"""Small host utilities, copied from ``lighthouse_tpu/common/utils.py``."""

from __future__ import annotations

import threading
import time
from collections import OrderedDict


class LruCache:
    """Size-bounded LRU with optional per-entry TTL."""

    def __init__(self, capacity: int, ttl_s: float | None = None,
                 clock=time.monotonic):
        self.capacity = capacity
        self.ttl_s = ttl_s
        self.clock = clock
        self._d: OrderedDict = OrderedDict()
        self._lock = threading.Lock()

    def clear(self) -> None:
        with self._lock:
            self._d.clear()

    def get(self, key):
        with self._lock:
            item = self._d.get(key)
            if item is None:
                return None
            value, ts = item
            if self.ttl_s is not None and self.clock() - ts > self.ttl_s:
                del self._d[key]
                return None
            self._d.move_to_end(key)
            return value

    def put(self, key, value) -> None:
        with self._lock:
            self._d[key] = (value, self.clock())
            self._d.move_to_end(key)
            while len(self._d) > self.capacity:
                self._d.popitem(last=False)

    def __len__(self) -> int:
        return len(self._d)
