"""Cross-batch shared HC-s path cache (persistent Ψ-node result store).

Counterpart of ``repro/core/cache.py``. Within one batch the engine reuses
materialized HC-s path queries via the sharing graph Ψ; everything is
thrown away when the batch ends. Real serving workloads repeat themselves
-- consecutive batches from the same traffic overlap heavily -- so this
module persists the per-level ``PathSet`` results of every Ψ node *across*
batches, keyed by a canonical query signature. A later batch whose plan
contains an identical node skips materialization entirely and uploads the
host copy to the engine's device.

Canonical cache key::

    (direction, source, budget, slack_signature, stop_vertex)

* ``direction``        -- "f" (enumerate on G) or "b" (on G_r).
* ``source, budget``   -- the HC-s path query itself: all simple paths of
                          length <= budget starting at ``source``.
* ``slack_signature``  -- sorted tuple of ``(endpoint, remaining_hops)``
                          pairs over the node's consumers. The engine's
                          slack prune is ``slack[v] = max_c (k_c - off_c -
                          dist(v, endpoint_c))``, which is a pure function
                          of these pairs and the (fixed) graph, so equal
                          signatures imply identical pruned result sets.
* ``stop_vertex``      -- the dedicated-node early-stop target (-2 when
                          disabled); it changes the materialized levels so
                          it must be part of the key.

Keys record no capacity of the device graph; entries keep their own
PathSet capacity buckets, so an upload restores the buffers of the
original materialization.

Entries are stored host-side (``HostPathSet``) with byte-accurate
accounting; the cache is a bytes-budgeted LRU. It is only valid for one
graph, tracked per entry by an epoch: a wholesale swap must call
:meth:`SharedPathCache.invalidate` (``BatchPathEngine.set_graph`` does
this); after an incremental edge delta,
:meth:`SharedPathCache.invalidate_delta` evicts only the entries whose hop
radius the damage reaches and re-stamps the rest. Not thread-safe; each
engine owns its cache.
"""
from __future__ import annotations

import dataclasses
from collections import Counter, OrderedDict
from typing import Iterable, Optional

import numpy as np

from .pathset import HostPathSet, PathSet, offload, pathset_nbytes, upload
from .query import midpoint_split
from ..obs import metrics as obsmetrics

__all__ = ["SharedPathCache", "CacheStats", "node_signature",
           "dedicated_keys", "DEFAULT_CACHE_BYTES"]

DEFAULT_CACHE_BYTES = 256 << 20

CacheKey = tuple  # (direction, source, budget, slack_signature, stop_vertex)


def node_signature(direction: str, src: int, budget: int,
                   consumers: Iterable[tuple[int, int]],
                   endpoints: dict[int, tuple[int, int]]) -> tuple:
    """Canonical signature of a Ψ node (without the engine's stop vertex).

    consumers : (query_idx, min_offset) pairs as built by detect.py.
    endpoints : query_idx -> (endpoint_vertex, k) for this direction
                (forward: (q.t, q.k); backward: (q.s, q.k)).
    """
    sig = tuple(sorted({(int(endpoints[qi][0]), int(endpoints[qi][1]) - int(off))
                        for qi, off in consumers}))
    return (direction, int(src), int(budget), sig)


def dedicated_keys(s: int, t: int, k: int) -> tuple[CacheKey, CacheKey]:
    """Full cache keys of the two halves of query (s, t, k) when it runs as
    its own singleton cluster with the default midpoint split. This pins the
    engine's key format (tests assert engine-inserted keys match); admission
    warmth probes use the cheaper :meth:`SharedPathCache.has_root` instead.
    The split comes from :func:`~repro_torch.core.query.midpoint_split` — the
    same helper the engine's cluster splitter uses — so these keys cannot
    drift from what the engine inserts. Only the cost-based "+" planners
    (which pick a per-query split) may deviate."""
    a, b = midpoint_split(k)
    fkey = ("f", int(s), a, ((int(t), int(k)),), int(t))
    bkey = ("b", int(t), b, ((int(s), int(k)),), int(s))
    return fkey, bkey


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    inserts: int = 0
    evictions: int = 0
    invalidations: int = 0
    oversize_skips: int = 0
    delta_invalidations: int = 0   # invalidate_delta calls
    delta_evictions: int = 0       # entries a delta proved stale
    delta_kept: int = 0            # entries that stayed warm across deltas

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class _Entry:
    levels: list[HostPathSet]
    nbytes: int
    epoch: int = 0                 # graph epoch this entry is valid for


class SharedPathCache:
    """Bytes-budgeted LRU over host-pinned Ψ-node results."""

    _n_instances = 0   # process-wide ordinal for metric labels

    def __init__(self, budget_bytes: int = DEFAULT_CACHE_BYTES):
        if budget_bytes <= 0:
            raise ValueError("budget_bytes must be positive")
        self.budget_bytes = int(budget_bytes)
        self._entries: "OrderedDict[CacheKey, _Entry]" = OrderedDict()
        self._roots: Counter = Counter()   # (direction, src) -> live entries
        self._nbytes = 0
        self.epoch = 0
        self.stats = CacheStats()
        # CacheStats mirrors into the process metrics registry, labeled
        # per cache instance (replica caches are distinct instances):
        # the scrape view of hit ratio / eviction pressure / residency
        idx = str(SharedPathCache._n_instances)
        SharedPathCache._n_instances += 1
        reg = obsmetrics.registry()
        self._m_hits = reg.counter("cache_hits_total", cache=idx)
        self._m_misses = reg.counter("cache_misses_total", cache=idx)
        self._m_inserts = reg.counter("cache_inserts_total", cache=idx)
        self._m_evictions = reg.counter("cache_evictions_total", cache=idx)
        self._m_bytes = reg.gauge("cache_bytes", cache=idx)

    # -- queries -------------------------------------------------------
    def __len__(self) -> int:
        return len(self._entries)

    @property
    def nbytes(self) -> int:
        return self._nbytes

    def contains(self, key: CacheKey) -> bool:
        """Probe without touching LRU order or hit/miss stats."""
        return key in self._entries

    def has_root(self, direction: str, src: int) -> bool:
        """Is ANY entry enumerated from (direction, src) warm? Cheap probe
        for cache-aware admission: a plan rooting a half-query here has a
        chance to hit regardless of the consumer-set details."""
        return self._roots[(direction, int(src))] > 0

    def get(self, key: CacheKey, device) -> Optional[list[PathSet]]:
        """Copies of the cached per-level PathSets on ``device``, or None
        on miss.

        Each call uploads from the host copy (device memory for cached
        nodes is owned by the batch, not the cache). The per-entry epoch
        guard enforces the invalidation contract: every resident entry
        must carry the current graph epoch (invalidate_delta re-stamps
        survivors), so an entry that somehow missed an invalidation pass
        is served as a miss and dropped rather than as stale data.
        """
        entry = self._entries.get(key)
        if entry is None:
            self.stats.misses += 1
            self._m_misses.inc()
            return None
        if entry.epoch != self.epoch:
            self._entries.pop(key)
            self._nbytes -= entry.nbytes
            self._drop_root(key)
            self.stats.misses += 1
            self.stats.evictions += 1   # anomaly must show up in telemetry
            self._m_misses.inc()
            self._m_evictions.inc()
            self._m_bytes.set(self._nbytes)
            return None
        self._entries.move_to_end(key)
        self.stats.hits += 1
        self._m_hits.inc()
        return [upload(h, device) for h in entry.levels]

    # -- updates -------------------------------------------------------
    def put(self, key: CacheKey, levels: list[PathSet]) -> None:
        """Insert (or refresh) a materialized node; evicts LRU to fit."""
        # size is known from the device shapes — reject oversize entries
        # before paying the device->host transfer (they recur every batch).
        # Same byte-math as HostPathSet.nbytes (pathset_nbytes), so this
        # pre-transfer check can never diverge from the LRU accounting.
        nbytes = sum(pathset_nbytes(ps.cap, ps.width, ps.verts.dtype.itemsize)
                     for ps in levels)
        if nbytes > self.budget_bytes:
            self.stats.oversize_skips += 1
            return
        host = [offload(ps) for ps in levels]
        nbytes = sum(h.nbytes for h in host)
        old = self._entries.pop(key, None)
        if old is not None:
            self._nbytes -= old.nbytes
            self._drop_root(key)
        while self._nbytes + nbytes > self.budget_bytes and self._entries:
            ekey, evicted = self._entries.popitem(last=False)
            self._nbytes -= evicted.nbytes
            self._drop_root(ekey)
            self.stats.evictions += 1
            self._m_evictions.inc()
        self._entries[key] = _Entry(levels=host, nbytes=nbytes,
                                    epoch=self.epoch)
        self._roots[key[:2]] += 1
        self._nbytes += nbytes
        self.stats.inserts += 1
        self._m_inserts.inc()
        self._m_bytes.set(self._nbytes)

    def _drop_root(self, key: CacheKey) -> None:
        # delete zero counts: root churn must not grow the Counter forever
        root = key[:2]
        self._roots[root] -= 1
        if self._roots[root] <= 0:
            del self._roots[root]

    def invalidate(self) -> None:
        """Graph mutation hook: drop every entry and start a new epoch."""
        self._m_evictions.inc(len(self._entries))
        self._entries.clear()
        self._roots.clear()
        self._nbytes = 0
        self.epoch += 1
        self.stats.invalidations += 1
        self._m_bytes.set(0)

    def max_radius(self) -> int:
        """Largest hop radius any live entry's validity depends on: its
        enumeration budget or a consumer's remaining-hop prune radius --
        the ``k_max`` the invalidation MS-BFS from the touched frontier
        must cover."""
        r = 0
        for key in self._entries:
            _, _, budget, sig = key[0], key[1], key[2], key[3]
            r = max(r, int(budget), max((int(rr) for _, rr in sig), default=0))
        return r

    def invalidate_delta(self, touched, dists: dict) -> dict:
        """Hop-scoped eviction after an incremental graph delta.

        touched : the delta's touched vertices (endpoints of every changed
            edge); only used for reporting/no-op detection -- the hop
            geometry arrives pre-computed in ``dists``.
        dists : two ``(n+1,)`` arrays of min hop distances **to/from the
            touched frontier** (both endpoints of every changed edge are
            seeds, so these agree on the old, new, and union graphs -- one
            BFS pair certifies cached state and its fresh recomputation
            alike; see ``delta.host_set_dist``):

            * ``dists["to"][v]``   -- min hops v -> any touched vertex
                                      along forward edges,
            * ``dists["from"][v]`` -- min hops any touched vertex -> v.

        An entry ``(direction, source, budget, sig, stop)`` is evicted iff
        the damage intersects either radius that defines its result set:

        * its **enumeration ball** -- some touched vertex within ``budget``
          hops of ``source`` in the entry's search direction (a cached
          path could traverse, or a fresh enumeration could newly reach,
          a changed edge); or
        * a **consumer prune radius** -- some touched vertex within
          ``r = k_c - off_c`` hops of a consumer endpoint in the *prune*
          direction (the slack prune reads ``dist(v, endpoint)``; a
          changed edge inside that radius can loosen the prune and admit
          paths the cached levels never enumerated).

        Everything else provably equals a fresh materialization on the new
        graph and stays warm, re-stamped with the bumped epoch.
        """
        d_to = np.asarray(dists["to"])
        d_from = np.asarray(dists["from"])
        self.epoch += 1
        self.stats.delta_invalidations += 1
        if len(touched) == 0:
            for entry in self._entries.values():
                entry.epoch = self.epoch
            self.stats.delta_kept += len(self._entries)
            return {"evicted": 0, "kept": len(self._entries),
                    "epoch": self.epoch}
        stale = []
        for key in self._entries:
            direction, src, budget, sig = key[0], key[1], key[2], key[3]
            if direction == "f":
                hit = d_to[src] <= budget or any(d_from[e] <= r
                                                 for e, r in sig)
            else:
                hit = d_from[src] <= budget or any(d_to[e] <= r
                                                   for e, r in sig)
            if hit:
                stale.append(key)
        for key in stale:
            entry = self._entries.pop(key)
            self._nbytes -= entry.nbytes
            self._drop_root(key)
        for entry in self._entries.values():
            entry.epoch = self.epoch
        self.stats.delta_evictions += len(stale)
        self.stats.delta_kept += len(self._entries)
        self._m_evictions.inc(len(stale))
        self._m_bytes.set(self._nbytes)
        return {"evicted": len(stale), "kept": len(self._entries),
                "epoch": self.epoch}

    # -- reporting -----------------------------------------------------
    def info(self) -> dict:
        return {"entries": len(self._entries), "nbytes": self._nbytes,
                "budget_bytes": self.budget_bytes, "epoch": self.epoch,
                **self.stats.as_dict()}
