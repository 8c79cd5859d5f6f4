"""Keyed, bounded, instrumented memo tables (named :class:`CompileCache`
instances) — a standalone copy of ``repro.core.cache`` with the same
semantics, so the PyTorch package never imports the JAX one.

* LRU eviction with a per-cache ``maxsize`` (memoized entries pin device
  tensors — segment tables, decode tables — so unbounded growth is a
  leak, not a convenience);
* hit/miss/built counters surfaced by :func:`stats`;
* graceful handling of unhashable keys (built uncached and *counted*,
  not hidden);
* :func:`clear` for tests that must observe a cold build.

Keys are plain tuples; the first element names the family for readable
stats.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, Hashable


class CompileCache:
    """A named, bounded, instrumented memo table for compiled engines.

    ``get`` is thread-safe (the serving queue documents thread-safe
    submits, and submission resolves Problems through a cache); the lock
    is held ACROSS the build so two racing threads cannot pay for — or
    worse, register distinct instances of — the same key.
    """

    def __init__(self, name: str, maxsize: int = 64):
        self.name = name
        self.maxsize = maxsize
        self._store: OrderedDict[Hashable, Any] = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.uncached = 0   # unhashable keys: built fresh, never stored
        self.evictions = 0  # LRU drops (a compiled engine was discarded)

    def get(self, key: Hashable, build: Callable[[], Any]) -> Any:
        """Return the cached value for ``key``, building it on first use.

        ``build`` is a zero-argument callable invoked only on a miss.  An
        unhashable ``key`` (e.g. an objective capturing a list) falls back
        to an uncached build — same behaviour the old ``except TypeError``
        paths provided, but visible in :meth:`stats`.
        """
        with self._lock:
            try:
                hit = key in self._store
            except TypeError:
                self.uncached += 1
                return build()
            if hit:
                self.hits += 1
                self._store.move_to_end(key)
                return self._store[key]
            self.misses += 1
            value = build()
            self._store[key] = value
            while len(self._store) > self.maxsize:
                self._store.popitem(last=False)
                self.evictions += 1
            return value

    @property
    def built(self) -> int:
        """Total engine compilations this cache paid for."""
        return self.misses + self.uncached

    def __len__(self) -> int:
        return len(self._store)

    def stats(self) -> dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "uncached": self.uncached, "built": self.built,
                "evictions": self.evictions, "size": len(self._store)}

    def snapshot(self) -> dict:
        """Identity + counters as one flat dict — the unit the serving
        metrics endpoint reports per cache."""
        return {"name": self.name, "maxsize": self.maxsize, **self.stats()}

    def clear(self) -> None:
        """Drop every entry AND reset the counters (cold-compile tests)."""
        with self._lock:
            self._store.clear()
            self.hits = self.misses = self.uncached = self.evictions = 0


_CACHES: dict[str, CompileCache] = {}


def get_cache(name: str, maxsize: int = 64) -> CompileCache:
    """The process-wide cache registered under ``name`` (created on first
    use).  ``maxsize`` only applies at creation time."""
    cache = _CACHES.get(name)
    if cache is None:
        cache = _CACHES[name] = CompileCache(name, maxsize=maxsize)
    return cache


def stats() -> dict[str, dict[str, int]]:
    """Per-cache counters, keyed by cache name."""
    return {name: cache.stats() for name, cache in sorted(_CACHES.items())}


def totals(suffix: str | None = None) -> dict[str, int]:
    """Counters summed across registered caches; ``suffix`` restricts to
    cache names ending with it (``".engine"`` sums only the compiled-
    engine caches — the serving/bench reports use this so memo tables
    like ``solver.problem`` cannot inflate 'engines built' numbers)."""
    out = {"hits": 0, "misses": 0, "uncached": 0, "built": 0,
           "evictions": 0, "size": 0}
    for name, cache in _CACHES.items():
        if suffix is not None and not name.endswith(suffix):
            continue
        for k, v in cache.stats().items():
            out[k] += v
    return out


def snapshot() -> dict:
    """One observability dict for the whole subsystem: per-cache snapshots
    plus the summed totals — what the serving metrics endpoint embeds
    under its ``"cache"`` key."""
    return {"caches": {name: cache.snapshot()
                       for name, cache in sorted(_CACHES.items())},
            "totals": totals()}


def clear() -> None:
    """Clear every registered cache (tests / benchmarks needing a cold
    start).  The registry itself survives so module-level handles stay
    valid."""
    for cache in _CACHES.values():
        cache.clear()
