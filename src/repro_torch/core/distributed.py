"""Sharded batch execution: plan -> place -> gather.

Counterpart of ``repro/core/distributed.py``, of its cluster-parallel
layer. Sharing clusters are the natural data-parallel work unit (sharing
graphs never cross clusters, per the paper's Ψ construction), so detected
clusters are placed on per-device *engine replicas* by a greedy
cost-balanced assignment (:func:`plan_clusters`; cluster cost ≈ Σ
per-query hop budget × frontier estimate from the already-built index)
and executed concurrently, one worker thread per replica. Per-replica
``PathSet`` results and stats are gathered back into one ``BatchReport``
(``stats["per_device"]``).

**A mesh is a device list.** Where the reference takes a
``jax.sharding.Mesh``, the port takes its flattened device list
(:func:`resolve_mesh`): ``torch.device`` s of the engine's device type,
entry 0 the engine's own device, because replica 0 is the engine itself.
Entries may repeat: ``["cuda:0"] * 4`` is four replicas on one card,
``["cpu"] * 8`` eight on the CPU (the counterpart of eight forced host
devices).

**Streams.** On the card each replica other than 0 runs on a CUDA
stream of its own (one per device and replica slot, made once per
process: :func:`_replica_stream`); replica 0 runs on the caller's
current stream. At fan-out each replica stream waits on the caller's
stream (the index and its distances were written there); every kernel
wrapper launches on the current stream, so a replica's kernels run on
its own stream; at gather the caller's stream waits on every replica
stream before any result is read. That wait also makes results safe to
free on the caller's side without ``record_stream``: a block allocated
on a replica stream returns to that stream's pool and is reused only by
a later fan-out, whose replica work is ordered after the caller's stream
by the fan-out's wait.
A replica's stage fences synchronize its own stream, not the device
(``BatchPathEngine._fence``).

A replica is a shallow engine clone owning device-local views of the
``DeviceGraph`` tables (an alias where the device is the engine's: the
tables are never written in place, see ``delta.update_device_graph``)
and its *own* ``SharedPathCache`` (the cache is not thread-safe by
design); ``BatchPathEngine.apply_delta`` fans every edge delta out
through :meth:`ShardedExecutor.propagate_delta`, so every replica reads
the primary's patched tables (aliased on its device, copied to another)
and all replica caches see the same hop-scoped invalidation -- and
therefore the same epochs -- as the primary.

**The mesh-parallel index.** An engine on the segment route
(``EngineConfig.index_route="segment"``) with more than one slot sweeps
an edge-sharded view of its destination-sorted edge lists
(:func:`shard_graph_edges`): each list, padded with sentinel edges to
``edge_bucket_for(m, N)``, is cut into N contiguous slices, slice j on
slot j's device (an alias of the engine's list where that device is the
engine's). A hop of an index, walk-count or delta sweep copies the
frontier once to each distinct device, reduces each slice on its slot's
stream (slot 0 on the caller's, slot j on :func:`_replica_stream`) and
merges the partials on the engine's device in slot order, behind each
slot's event (``msbfs.segment_sweep``). The view is
``ShardedExecutor.index_dg``, recut when first read after a graph swap
or delta;
on one slot and on the ELL route it is the engine's own ``DeviceGraph``.
While a cluster fan-out runs, every replica sweeps its own unsharded
lists, as in the reference.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import os
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence, Union

import numpy as np
import torch

from .graph import DeviceGraph, EdgeSlices, Graph, pow2_ceil
from .query import midpoint_split
from ..launch.collectives import _replica_stream, slot_streams  # noqa: F401

__all__ = ["resolve_mesh", "replicate_graph", "query_ball_costs",
           "cluster_costs", "plan_clusters", "ShardedExecutor",
           "edge_bucket_for", "shard_edges", "shard_graph_edges",
           "distributed_graph"]

# every device-resident table of a DeviceGraph (the placement unit); the
# edge lists are None on the ELL route
_DG_TABLES = ("ell_idx", "r_ell_idx", "esrc", "edst", "r_esrc", "r_edst")

DeviceLike = Union[torch.device, str]


# ----------------------------------------------------------------------
# mesh resolution
# ----------------------------------------------------------------------
def _normalize(device: DeviceLike) -> torch.device:
    """A device with its index: ``"cuda"`` is the current CUDA device."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def resolve_mesh(mesh: Optional[Sequence[DeviceLike]] = None,
                 n_devices: Optional[int] = None,
                 device: DeviceLike = "cpu") -> Optional[list]:
    """The device list an engine on ``device`` executes on, or None for
    the plain single-device engine.

    ``mesh`` wins when given: a sequence of ``torch.device`` s (or
    strings) of ``device``'s type whose entry 0 is ``device`` itself;
    entries may repeat. Otherwise ``n_devices >= 1`` takes the first N
    local devices of ``device``'s type (``cuda:0`` .. ``cuda:N-1``; the
    CPU is one device) -- ``n_devices=1`` is a real (identity) mesh, so
    the executor's code path can be exercised on one device. ``None`` /
    ``0`` means no mesh. Anything else raises ``TypeError`` or
    ``ValueError``.
    """
    own = _normalize(device)
    if mesh is not None:
        if isinstance(mesh, (str, torch.device)) or not isinstance(
                mesh, Sequence):
            raise TypeError(f"mesh must be a sequence of torch devices, got "
                            f"{type(mesh).__name__}")
        devs = []
        for entry in mesh:
            if not isinstance(entry, (str, torch.device)):
                raise TypeError(f"mesh entry {entry!r} is not a torch "
                                f"device")
            try:
                dev = torch.device(entry)
            except RuntimeError as e:
                raise ValueError(f"mesh entry {entry!r}: {e}") from None
            if dev.type != own.type:
                raise ValueError(f"mesh entry {entry!r} is not a {own.type} "
                                 f"device like the engine's")
            devs.append(_normalize(dev))
        if not devs:
            raise ValueError("mesh is empty")
        if devs[0] != own:
            raise ValueError(f"mesh entry 0 is {devs[0]}; it must be the "
                             f"engine's own device {own} (replica 0 is the "
                             f"engine)")
        return devs
    if n_devices is None:
        return None
    if isinstance(n_devices, bool) or not isinstance(
            n_devices, (int, np.integer)):
        raise TypeError(f"n_devices must be an int, got "
                        f"{type(n_devices).__name__}")
    if n_devices < 0:
        raise ValueError(f"n_devices={n_devices} is negative")
    if n_devices == 0:
        return None
    visible = torch.cuda.device_count() if own.type == "cuda" else 1
    if n_devices > visible:
        raise ValueError(f"n_devices={n_devices} but only {visible} local "
                         f"{own.type} devices are visible")
    devs = [own] if own.type == "cpu" else \
        [torch.device("cuda", i) for i in range(int(n_devices))]
    if devs[0] != own:
        raise ValueError(f"n_devices takes {devs[0]} as replica 0, but the "
                         f"engine runs on {own}; pass mesh= instead")
    return devs


def replicate_graph(dg: DeviceGraph, device: DeviceLike) -> DeviceGraph:
    """Device-local copy of every DeviceGraph table, for a cluster
    replica. On the tables' own device ``.to`` returns them as they are:
    an alias, which is safe because no table is ever written in place
    (``delta.update_device_graph`` builds new ones)."""
    return dataclasses.replace(dg, **{f: getattr(dg, f).to(device)
                                      for f in _DG_TABLES
                                      if getattr(dg, f) is not None})


# ----------------------------------------------------------------------
# edge-list sharding (the mesh-parallel index)
# ----------------------------------------------------------------------
def edge_bucket_for(m: int, n_dev: int) -> int:
    """Slot-count-aligned edge capacity: the pow2 bucket of ``m``, grown
    to the next multiple of ``n_dev`` when the slot count is not a power
    of two (for pow2 counts the pow2 bucket is already divisible)."""
    cap = max(pow2_ceil(max(int(m), 1)), int(n_dev))
    if cap % n_dev:
        cap = -(-cap // n_dev) * n_dev
    return cap


def shard_edges(esrc: torch.Tensor, edst: torch.Tensor,
                devices: Sequence[DeviceLike], *, n: int,
                streams: Optional[Sequence] = None
                ) -> tuple[EdgeSlices, EdgeSlices]:
    """Cut a dst-sorted edge list into ``len(devices)`` contiguous slices,
    slice j on ``devices[j]``.

    The list is first padded to a multiple of the slot count with the
    sentinel ``(n, n)`` of :func:`~repro_torch.core.graph.pad_edge_list`,
    which every segmented reduction drops, so a slice of sentinels alone
    is inert. ``streams[j]`` is the CUDA stream slot j reduces on
    (``None``, the default for all: the caller's current stream).
    """
    n_dev = len(devices)
    if n_dev < 1:
        raise ValueError("shard_edges needs at least one device")
    streams = (None,) * n_dev if streams is None else tuple(streams)
    if len(streams) != n_dev:
        raise ValueError(f"{len(streams)} streams for {n_dev} devices")
    m_cap = int(esrc.shape[0])
    cap = -(-m_cap // n_dev) * n_dev
    if cap > m_cap:
        pad = esrc.new_full((cap - m_cap,), n)
        esrc, edst = torch.cat([esrc, pad]), torch.cat([edst, pad])
    L = cap // n_dev
    cut = [(j * L, (j + 1) * L) for j in range(n_dev)]
    return tuple(EdgeSlices(tuple(x[a:b].to(dev)
                                  for (a, b), dev in zip(cut, devices)),
                            streams) for x in (esrc, edst))


def shard_graph_edges(dg: DeviceGraph, devices: Sequence[DeviceLike],
                      streams: Optional[Sequence] = None) -> DeviceGraph:
    """A DeviceGraph whose edge lists are cut over ``devices``
    (:func:`shard_edges`); the ELL tables stay as they are. ``m`` stays
    the valid edge count: a pad added here is capacity, not edges."""
    if not dg.has_edge_lists:
        raise ValueError("shard_graph_edges needs a DeviceGraph built "
                         "with edge_lists=True")
    esrc, edst = shard_edges(dg.esrc, dg.edst, devices, n=dg.n,
                             streams=streams)
    r_esrc, r_edst = shard_edges(dg.r_esrc, dg.r_edst, devices, n=dg.n,
                                 streams=streams)
    return dataclasses.replace(dg, esrc=esrc, edst=edst, r_esrc=r_esrc,
                               r_edst=r_edst)


def distributed_graph(g: Graph, devices: Sequence[DeviceLike],
                      streams: Optional[Sequence] = None) -> DeviceGraph:
    """A DeviceGraph built straight into the sharded-edge layout: edge
    lists padded to ``edge_bucket_for(m, N)`` and cut over ``devices``,
    ELL tables on ``devices[0]``."""
    dg = DeviceGraph.build(g, devices[0], edge_lists=True,
                           edge_cap=edge_bucket_for(g.m, len(devices)))
    return shard_graph_edges(dg, devices, streams)


# ----------------------------------------------------------------------
# cluster placement (the data-parallel enumeration layer)
# ----------------------------------------------------------------------
def cluster_costs(index, clusters: Sequence[Sequence[int]]) -> list[float]:
    """Estimated enumeration cost per cluster:
    ``cost(C) = Σ_{q ∈ C} cost(q)`` (:func:`query_ball_costs`).

    The reference takes the engine's host copy of the distances here and
    counts a ``host_dist_transfers_total`` when it must make one; the
    port counts on the index's own device and copies nothing but the
    counts back, so it takes no such copy.
    """
    cost = query_ball_costs(index, [qi for cl in clusters for qi in cl])
    return [sum(cost[qi] for qi in cl) for cl in clusters]


def query_ball_costs(index, qis: Sequence[int]) -> dict:
    """Estimated enumeration cost of each query in ``qis``, as
    ``{qi: k × (|ball_a(s)| + |ball_b(t)|)}``, where the balls count
    vertices within the midpoint-split hop budgets of each endpoint -- a
    frontier-size estimate read straight from the index distance
    matrices (sentinel row sliced off). The shared per-query term of both
    LPT placement (:func:`cluster_costs`) and GREEN/YELLOW/RED routing
    (:class:`repro_torch.core.planner.CostRouter`); the same floats as
    the reference's per-query ``query_ball_cost``. Deliberately cheap:
    callers need relative weight, not the exact DP bound.

    The balls of every column are counted at once, one reduction over
    each matrix per hop budget on the device the index lives on, and
    only the (hop budgets, S) counts come back. On the host a column of
    the (V+1, S) row-major matrix is a strided scan that touches a cache
    line per row (about as costly as the whole matrix), and even a pass
    over the whole matrix costs a reduction along its long axis.
    """
    qis = sorted(set(qis))
    if not qis:
        return {}
    half = {qi: midpoint_split(index.queries[qi][2]) for qi in qis}

    def balls(dist, hops):
        hops = sorted(hops)
        d = dist[:-1]
        got = torch.stack([(d <= h).sum(dim=0, dtype=torch.int32)
                           for h in hops]).cpu().numpy()
        return dict(zip(hops, got))
    ball_s = balls(index.dist_s, {a for a, _ in half.values()})
    ball_t = balls(index.dist_t, {b for _, b in half.values()})
    return {qi: float(index.queries[qi][2])
            * float(int(ball_s[a][index.src_col[qi]])
                    + int(ball_t[b][index.tgt_col[qi]]))
            for qi, (a, b) in half.items()}


def plan_clusters(costs: Sequence[float],
                  n_replicas: int) -> tuple[list[list[int]], list[float]]:
    """Greedy cost-balanced (LPT) assignment of clusters to replicas.

    Heaviest cluster first onto the least-loaded replica -- the classic
    4/3-approximate makespan heuristic, matching the work-stealing
    scheduler's submit order. Returns ``(assignment, loads)`` where
    ``assignment[r]`` lists cluster indices (ascending, so execution
    order within a replica is deterministic) and ``loads[r]`` the summed
    cost. Handles every uneven shape: more clusters than replicas (some
    replicas take several), fewer (trailing replicas stay empty), zero
    clusters (all empty). Load ties break on assignment *count* (then
    replica id) rather than always replica 0, so zero-cost clusters
    spread round-robin instead of serializing on one replica.
    """
    n_replicas = max(int(n_replicas), 1)
    order = sorted(range(len(costs)), key=lambda i: (-costs[i], i))
    assign: list[list[int]] = [[] for _ in range(n_replicas)]
    loads = [0.0] * n_replicas
    for ci in order:
        r = min(range(n_replicas),
                key=lambda i: (loads[i], len(assign[i]), i))
        assign[r].append(ci)
        loads[r] += costs[ci]
    for a in assign:
        a.sort()
    return assign, loads


# ----------------------------------------------------------------------
# the executor: one code path for 1..D replicas
# ----------------------------------------------------------------------
class ShardedExecutor:
    """Plan → place → gather for one engine.

    Built by ``BatchPathEngine.__init__`` for *every* engine: with no
    mesh (or a one-entry mesh) the only replica is the engine itself and
    :meth:`run_clusters` is the plain sequential loop -- sharded and
    single-device execution share this one code path.
    """

    def __init__(self, engine, mesh: Optional[Sequence[torch.device]] = None):
        # a weak reference: the engine owns its executor, and a cycle
        # would keep a dropped engine's device tables alive until the
        # cyclic collector happens to run
        self._engine = weakref.ref(engine)
        self.mesh = None if mesh is None else list(mesh)
        self.devices = [engine.device] if mesh is None else list(mesh)
        self._secondaries: Optional[list] = None   # replicas 1..D-1
        self._streams: list = []     # per replica; None = caller's stream
        self.in_fanout = False       # True while replica threads run:
        # every replica then fences its own stream, not the device
        self._index_view: Optional[tuple] = None   # (engine.dg, view)

    @property
    def engine(self):
        """The primary engine (replica 0)."""
        return self._engine()

    # -- topology ------------------------------------------------------
    @property
    def n_replicas(self) -> int:
        return len(self.devices)

    @property
    def sharded(self) -> bool:
        return self.n_replicas > 1

    @property
    def shards_index(self) -> bool:
        """Whether the index sweeps run edge-sharded: a segment-route
        engine with more than one slot."""
        return self.sharded and self.engine.cfg.index_route == "segment"

    @property
    def index_dg(self) -> DeviceGraph:
        """The tables the index, walk-count and delta sweeps read: the
        edge-sharded view on a sharded segment engine, else the engine's
        own ``DeviceGraph``. The view is cut here from the engine's lists
        when first read after a graph swap or delta (a new ``engine.dg``),
        keeping the engine's (monotone) edge bucket."""
        dg = self.engine.dg
        if not self.shards_index:
            return dg
        if self._index_view is None or self._index_view[0] is not dg:
            self._index_view = (dg, shard_graph_edges(dg, self.devices,
                                                      self.slot_streams()))
        return self._index_view[1]

    def slot_streams(self) -> list:
        """The CUDA stream of each slot: ``None`` (the caller's) for slot
        0 and for CPU slots, :func:`_replica_stream` for the others."""
        return slot_streams(self.devices)

    # -- graph lifecycle ----------------------------------------------
    def reset(self) -> None:
        """Wholesale graph swap: drop the replicas (they rebuild lazily
        from the new graph)."""
        self._secondaries = None
        self._streams = []

    def propagate_delta(self, applied) -> None:
        """Point every existing replica at the primary's tables, already
        patched for one merged delta: an alias on the primary's device, a
        copy on another. Replica caches are NOT touched here --
        ``BatchPathEngine._invalidate_for`` invalidates all caches with
        one shared distance sweep *before* any table changes, which keeps
        the epochs identical across replicas."""
        if self._secondaries is None:
            return
        for rep, dev in zip(self._secondaries, self.devices[1:]):
            rep.dg = replicate_graph(self.engine.dg, dev)
            rep.g = applied.graph
            rep._host_dists = None

    # -- replicas ------------------------------------------------------
    def replica_caches(self) -> list:
        """The caches of every *materialized* secondary replica (lazily
        created replicas sync their epoch at birth instead)."""
        if self._secondaries is None:
            return []
        return [r.cache for r in self._secondaries if r.cache is not None]

    def replicas(self) -> list:
        """All replicas, replica 0 being the engine itself; secondaries
        are created on first use (device-local tables, a fresh,
        epoch-synced SharedPathCache and, on the card, a stream each:
        :func:`_replica_stream`)."""
        if self._secondaries is None:
            self._secondaries = [self._clone(dev) for dev in self.devices[1:]]
            self._streams = self.slot_streams()
        return [self.engine, *self._secondaries]

    def _clone(self, device: torch.device):
        from .cache import SharedPathCache

        eng = self.engine
        rep = copy.copy(eng)
        rep.executor = None          # replicas are leaves: never re-fan-out
        rep.device = device
        rep.dg = replicate_graph(eng.dg, device)
        rep._host_dists = None
        rep.cache = None
        if eng.cache is not None:
            rep.cache = SharedPathCache(eng.cache.budget_bytes)
            rep.cache.epoch = eng.cache.epoch   # lockstep from birth
        return rep

    def _on_replica(self, ri: int, caller):
        """The device and stream context of replica ``ri``'s thread:
        replica 0 on the caller's stream, the others on their own."""
        dev = self.devices[ri]
        if dev.type != "cuda":
            return contextlib.nullcontext()
        stream = caller if ri == 0 else self._streams[ri]
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(dev))
        stack.enter_context(torch.cuda.stream(stream))
        return stack

    # -- execution -----------------------------------------------------
    def run_clusters(self, queries, index, plus: bool, min_sb: int,
                     clusters: list[list[int]], stats: dict,
                     planners: Optional[Sequence[str]] = None) -> dict:
        """Execute every sharing cluster, gathering ``{qi: QueryResult}``.

        One replica (or a single cluster): the inline sequential loop --
        the single-device engine. Several: clusters are cost-balanced onto
        replicas and executed by one worker thread per replica;
        per-replica stats land in ``stats["per_device"]``. ``planners``
        (one ``"batch"`` / ``"basic"`` entry per cluster, from the cost
        router) picks the per-cluster plan; ``None`` means batch
        everywhere. Results are exact either way, so the gather is a plain
        dict merge. A replica's exception is raised after every replica
        has finished, and nothing of that batch is returned.
        """
        eng = self.engine

        def cluster_fn(engine, ci: int):
            if planners is not None and planners[ci] == "basic":
                return engine._cluster_basic
            return engine._cluster_work

        if not self.sharded or len(clusters) <= 1:
            results: dict = {}
            for ci, cluster in enumerate(clusters):
                out, cstats = cluster_fn(eng, ci)(queries, index, plus,
                                                  min_sb, cluster)
                results.update(out)
                _merge_stats(stats, cstats)
            return results

        with eng.obs.span("executor.place",
                          n_clusters=len(clusters)) as sp:
            reps = self.replicas()
            assign, loads = plan_clusters(cluster_costs(index, clusters),
                                          len(reps))
        stats["t_place_s"] = sp.duration
        # the host copy of the distances (detection's input), made once
        # here and read by every replica
        eng._dists_host(index)
        for rep in reps[1:]:
            rep._host_dists = eng._host_dists

        outs: list[dict] = [{} for _ in reps]
        cstats_all: list[list[dict]] = [[] for _ in reps]
        walls = [0.0] * len(reps)
        errs: list = [None] * len(reps)
        on_card = self.devices[0].type == "cuda"
        caller = torch.cuda.current_stream(self.devices[0]) if on_card \
            else None
        if on_card:
            # the index and its distances were written on the caller's
            # stream: every replica stream starts after them
            for s in self._streams[1:]:
                s.wait_stream(caller)

        def work(ri: int) -> None:
            rep = reps[ri]
            try:
                # replica spans are roots of their worker thread's stack
                # (thread-local nesting); the recorded trace shows each
                # replica's clusters on its own timeline row
                with eng.obs.span("replica.run", replica=ri,
                                  device=str(self.devices[ri]),
                                  n_clusters=len(assign[ri])) as sr, \
                        self._on_replica(ri, caller):
                    for ci in assign[ri]:
                        out, cst = cluster_fn(rep, ci)(
                            queries, index, plus, min_sb, clusters[ci])
                        outs[ri].update(out)
                        cstats_all[ri].append(cst)
                walls[ri] = sr.duration
            except BaseException as e:  # noqa: BLE001 -- re-raised below
                errs[ri] = e

        # one worker per replica, but never more running than the host
        # has cores: replicas that share a card (or the CPU) only add
        # contention beyond that
        workers = max(1, min(len(reps), os.cpu_count() or 1))
        self.in_fanout = True
        # repro-lint: waive[RPL006] the fan-out's wall around the replica threads, whose spans are their own roots
        t0 = time.perf_counter()
        try:
            with ThreadPoolExecutor(max_workers=workers,
                                    thread_name_prefix="hcsp-replica") as px:
                list(px.map(work, range(len(reps))))
        finally:
            self.in_fanout = False
            if on_card:
                # no result is read before every replica's work is done
                for s in self._streams[1:]:
                    caller.wait_stream(s)
        for e in errs:
            if e is not None:
                raise e
        # repro-lint: waive[RPL006] closes the fan-out wall opened above (t_fanout_s, no stage of its own)
        t_fanout = time.perf_counter() - t0

        results = {}
        for ri in range(len(reps)):
            results.update(outs[ri])
            for cst in cstats_all[ri]:
                _merge_stats(stats, cst)
        stats["n_devices"] = len(reps)
        stats["t_fanout_s"] = t_fanout
        stats["per_device"] = [
            {"device": str(self.devices[ri]),
             "n_clusters": len(assign[ri]),
             "n_queries": sum(len(clusters[ci]) for ci in assign[ri]),
             "cost": loads[ri],
             "t_wall_s": walls[ri],
             "cache_hits": sum(c.get("n_cache_hits", 0)
                               for c in cstats_all[ri])}
            for ri in range(len(reps))]
        return results


def _merge_stats(stats: dict, cstats: dict) -> None:
    """Accumulate one cluster's counters/timings into the run stats."""
    for key, val in cstats.items():
        stats[key] = stats.get(key, 0) + val
