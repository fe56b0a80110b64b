"""BatchPathEngine: BasicEnum (Alg 1) and BatchEnum (Alg 4) on one device.

Counterpart of ``repro/core/engine.py`` for ``Planner.BASIC`` and
``Planner.BATCH`` with ``EngineConfig(plan_caps=False, plus=False,
cache_bytes=0)``. The host planner (clustering + detection) emits
per-cluster DirectionPlans; this module materializes HC-s path queries
level by level (expand supersteps + splice joins) and assembles per-query
HC-s-t results with the exact-split ⊕ join. Every buffer has a fixed
capacity with overflow-retry (x4, up to ``hard_cap``).

The engine runs on one device (``"cuda"`` unless the caller passes
``device="cpu"``), and each kernel takes the arm of that device: the CUDA
kernels on the card, their plain versions on the CPU.

Not in this port yet, and refused with ``NotImplementedError`` instead of
silently degrading: capacity planning from walk counts (``plan_caps=True``,
the default -- callers pass ``plan_caps=False``), the "+" planners and
``plus``, ``Planner.AUTO`` / ``PATHENUM``, the cross-batch cache
(``cache_bytes > 0``), sharding (``mesh`` / ``n_devices > 1``), compile
telemetry (``log_compiles``), span tracing (``trace*``), and the knobs of
the segment arm, deltas and the AUTO router (``edge_chunk``,
``delta_max_sources``, ``delta_backend``, ``router``) when set away from
their defaults.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from .clustering import cluster_queries
from .detect import DirectionPlan, PlanNode, detect_common_queries
from .enumerate import (count_ending_at, expand_level, extract_rows,
                        prune_table, select_ending_at)
from .graph import DeviceGraph, Graph
from .index import QueryIndex, build_index, slack_from_dists
from .join import cross_join, keyed_join, keyed_join_count, sort_by_last
from .pathset import PathSet, concat, empty, singleton
from .query import (BatchReport, Output, PathQuery, PathsStore, Planner,
                    QueryLike, QueryResult, midpoint_split)
from .similarity import similarity_matrix
from ..kernels.registry import resolve_arm

__all__ = ["EngineConfig", "BatchPathEngine", "EngineOverflow",
           "resolve_device"]

# backward levels are produced lazily: basic planners skip the whole
# backward enumeration when a forward level already answers exists-only
Levels = Callable[[], list]

_NEXT_SLICE = "the next slice of the PyTorch/CUDA port"


class EngineOverflow(RuntimeError):
    """A query exceeded hard capacity limits (the paper's OT analogue)."""


@dataclasses.dataclass
class EngineConfig:
    """The reference's field names and defaults; fields of parts that are
    not ported yet are refused at engine construction when set."""

    gamma: float = 0.5              # clustering threshold (paper default)
    kernel_backend: Optional[str] = None  # "torch" | "cuda"; None follows
    # the engine's device. A choice that contradicts the device raises.
    min_cap: int = 256
    max_cap: int = 1 << 20          # planned per-level frontier cap clamp
    hard_cap: int = 1 << 22         # absolute limit before EngineOverflow
    join_cap: int = 1 << 21
    min_shared_budget: int = 2      # don't materialize trivially small shares
    plus: bool = False              # cost-based fwd/bwd split (not ported)
    edge_chunk: int = 1 << 22       # segment-arm knob (not ported)
    plan_caps: bool = True          # DP-based capacity planning (not
    # ported: pass plan_caps=False)
    paper_faithful_shares: bool = False  # min_shared_budget -> 0
    cache_bytes: int = 0            # cross-batch cache (not ported)
    delta_max_sources: int = 1024   # delta knobs (deltas not ported)
    delta_backend: str = "host"
    log_compiles: bool = False      # compile telemetry (not ported)
    mesh: Optional[object] = None   # sharding (not ported)
    n_devices: Optional[int] = None
    balance_clusters: bool = False  # only acts on sharded runs
    trace: bool = False             # span tracing (not ported)
    trace_fence: bool = False
    trace_annotations: bool = False
    router: Optional[object] = None  # Planner.AUTO thresholds (not ported)


def resolve_device(device: Union[torch.device, str, None]) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device without CUDA raises. The
    entry points never carry on on the CPU unless asked to."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "kernel versions on the CPU")
    return dev


def _check_config(cfg: EngineConfig) -> None:
    """Refuse every option whose code is not ported yet."""
    refused = {
        "plan_caps=True (walk-count capacity planning; pass "
        "plan_caps=False)": cfg.plan_caps,
        "plus=True (the cost-based '+' split)": cfg.plus,
        "cache_bytes>0 (the cross-batch cache)": cfg.cache_bytes > 0,
        "mesh (sharded execution)": cfg.mesh is not None,
        "n_devices>1 (sharded execution)": (cfg.n_devices or 0) > 1,
        "log_compiles=True (compile telemetry)": cfg.log_compiles,
        "trace / trace_fence / trace_annotations (span tracing)":
            cfg.trace or cfg.trace_fence or cfg.trace_annotations,
        "edge_chunk (the segment arm)": cfg.edge_chunk != 1 << 22,
        "delta_max_sources / delta_backend (graph deltas)":
            cfg.delta_max_sources != 1024 or cfg.delta_backend != "host",
        "router (Planner.AUTO)": cfg.router is not None,
    }
    for what, bad in refused.items():
        if bad:
            raise NotImplementedError(f"EngineConfig {what} is not ported "
                                      f"yet; it comes with {_NEXT_SLICE}")


class _Stage:
    duration = 0.0


@contextlib.contextmanager
def _stage(device: torch.device):
    """Wall time of one engine stage, ending in a device synchronize so
    that asynchronous kernels are charged to the stage that launched them
    (the reference reads the same ``t_*`` stats off its spans)."""
    stage = _Stage()
    t0 = time.perf_counter()
    try:
        yield stage
    finally:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        stage.duration = time.perf_counter() - t0


def _bucket(x: int, min_cap: int = 256) -> int:
    """Quantize capacities to powers of four (fewer shape buckets)."""
    b = min_cap
    while b < x:
        b *= 4
    return b


class BatchPathEngine:
    def __init__(self, graph: Graph, config: Optional[EngineConfig] = None,
                 *, device: Union[torch.device, str, None] = None):
        self.device = resolve_device(device)
        self.g = graph
        self.cfg = config or EngineConfig()
        _check_config(self.cfg)
        # the arm follows the device; an explicit contradicting arm raises
        self.kernel_arm = resolve_arm(self.device, self.cfg.kernel_backend)
        self.dg = DeviceGraph.build(graph, self.device)
        self._host_dists: Optional[tuple] = None   # (index, (dist_s, dist_t))

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def run(self, queries: Sequence[QueryLike],
            planner: Planner | str = Planner.BATCH,
            clusters: Optional[list[list[int]]] = None) -> BatchReport:
        """Execute a batch of :class:`PathQuery` (tuples are coerced).

        planner : ``Planner.BATCH`` or ``Planner.BASIC`` (or their
        string values); the other planners are not ported yet.
        clusters : optional precomputed partition of query indices (batch
        planner only).

        (The reference splits this into ``run`` and ``_run_impl`` for its
        compile telemetry, which is not ported.)
        """
        qs = tuple(PathQuery.coerce(q).check_bounds(self.g.n)
                   for q in queries)
        planner = Planner.coerce(planner)
        if planner not in (Planner.BATCH, Planner.BASIC):
            raise NotImplementedError(
                f"Planner.{planner.name} is not ported yet; it comes with "
                f"{_NEXT_SLICE} (ported: BATCH, BASIC)")
        stats: dict = {"planner": planner.value, "mode": planner.value,
                       "kernel_backend": self.kernel_arm.value,
                       "n_queries": len(qs), "n_rows_assembled": 0}
        if not qs:   # degenerate but legal (e.g. a filter left nothing)
            stats["t_build_index"] = stats["t_enumerate"] = 0.0
            return BatchReport(queries=qs, results=(), stats=stats)
        with _stage(self.device) as root:
            with _stage(self.device) as sidx:
                index = build_index(self.dg, [q.key for q in qs])
            stats["t_build_index"] = sidx.duration
            if planner is Planner.BATCH:
                report = self._run_batch(qs, index, stats, clusters)
            else:
                report = self._run_basic(qs, index, stats)
        stats["t_wall_s"] = root.duration
        return report

    # ------------------------------------------------------------------
    # BasicEnum (Alg 1): shared index, per-query bidirectional enumeration
    # ------------------------------------------------------------------
    def _direct_query(self, q: PathQuery, qi: int, index: QueryIndex,
                      stats: dict) -> QueryResult:
        """One query through the Alg-1 direct plan: bidirectional
        enumeration off the shared index, backward half lazy."""
        a, b = self._split(qi, index)
        fs = self._dedicated_slack(index, qi, forward=True)
        fl = self._run_node(False, q.s, a, fs, [], stop_vertex=q.t)

        def bwd(qi=qi, q=q, b=b):
            bs = self._dedicated_slack(index, qi, forward=False)
            return self._run_node(True, q.t, b, bs, [], stop_vertex=q.s)

        return self._wrap(q, self._payload(q, fl, a, bwd, b, stats))

    def _run_basic(self, queries, index: QueryIndex,
                   stats) -> BatchReport:
        with _stage(self.device) as senum:
            results = []
            for qi, q in enumerate(queries):
                with _stage(self.device) as sq:
                    r = self._direct_query(q, qi, index, stats)
                r.time_s = sq.duration
                results.append(r)
        stats["t_enumerate"] = senum.duration
        return BatchReport(queries=tuple(queries), results=tuple(results),
                           stats=stats)

    # ------------------------------------------------------------------
    # BatchEnum (Alg 4): cluster -> detect -> shared enumeration
    # ------------------------------------------------------------------
    def _run_batch(self, queries, index: QueryIndex, stats,
                   clusters: Optional[list[list[int]]] = None) -> BatchReport:
        results = self._run_clustered(queries, index, stats, clusters)
        return BatchReport(queries=tuple(queries),
                           results=tuple(results[qi]
                                         for qi in range(len(queries))),
                           stats=stats)

    def _run_clustered(self, queries, index: QueryIndex, stats,
                       clusters: Optional[list[list[int]]] = None) -> dict:
        """Cluster -> execute every cluster; returns ``{qi: QueryResult}``."""
        qis = list(range(len(queries)))
        with _stage(self.device) as sc:
            if clusters is None:
                mu = similarity_matrix(index)
                stats["mu_mean"] = float(
                    (mu.sum() - len(queries)) /
                    max(len(queries) * (len(queries) - 1), 1))
                clusters = cluster_queries(mu, self.cfg.gamma)
            else:
                seen = [qi for cl in clusters for qi in cl]
                if sorted(seen) != sorted(qis):
                    raise ValueError(
                        "clusters must partition the query indices")
        stats["t_cluster"] = sc.duration
        stats["n_clusters"] = len(clusters)

        min_sb = 0 if self.cfg.paper_faithful_shares else self.cfg.min_shared_budget
        for key in ("n_psi_nodes", "n_materialized",
                    "n_cache_hits", "n_cache_misses",
                    "t_detect", "t_enumerate",
                    "n_shared", "n_dedup", "n_share_edges"):
            stats.setdefault(key, 0)
        # one device: the reference executor's inline cluster loop
        results: dict = {}
        for cluster in clusters:
            out, cstats = self._cluster_work(queries, index, min_sb, cluster)
            results.update(out)
            for key, val in cstats.items():
                stats[key] = stats.get(key, 0) + val
        return results

    def _cluster_work(self, queries, index: QueryIndex, min_sb: int,
                      cluster: list[int]):
        """One sharing cluster end-to-end: detect → plan execution →
        per-query ⊕ assembly. Returns ``({qi: QueryResult}, cstats)``."""
        cstats = {"n_psi_nodes": 0, "n_materialized": 0,
                  "n_cache_hits": 0, "n_cache_misses": 0,
                  "n_rows_assembled": 0}
        with _stage(self.device) as sd:
            halves_f = {}
            halves_b = {}
            ends_f = {}
            ends_b = {}
            for qi in cluster:
                s, t, k = queries[qi]
                a, b = self._split(qi, index)
                halves_f[qi] = (s, a)
                halves_b[qi] = (t, b)
                ends_f[qi] = (t, k)
                ends_b[qi] = (s, k)
            hop_f = self._hop_ok(index, cluster, forward=True)
            hop_b = self._hop_ok(index, cluster, forward=False)
            plan_f = detect_common_queries(self.g, cluster, halves_f, hop_f,
                                           reverse=False,
                                           min_shared_budget=min_sb,
                                           endpoints=ends_f)
            plan_b = detect_common_queries(self.g, cluster, halves_b, hop_b,
                                           reverse=True,
                                           min_shared_budget=min_sb,
                                           endpoints=ends_b)
            cstats["n_shared"] = plan_f.n_shared + plan_b.n_shared
            # deduped half-queries: halves mapped onto an existing node,
            # counted per direction (identical queries collapse entirely)
            cstats["n_dedup"] = (
                len(cluster) - len(set(plan_f.half_of_query.values()))
                + len(cluster) - len(set(plan_b.half_of_query.values())))
            cstats["n_share_edges"] = (
                sum(len(n.in_edges) for n in plan_f.nodes)
                + sum(len(n.in_edges) for n in plan_b.nodes))
        cstats["t_detect"] = sd.duration

        with _stage(self.device) as se:
            cache_f = self._run_plan(plan_f, index, forward=True,
                                     stats=cstats)
            cache_b = self._run_plan(plan_b, index, forward=False,
                                     stats=cstats)
            # identical (halves, k, output, limit) -> identical payloads
            assembled: dict = {}
            results: dict[int, QueryResult] = {}
            for qi in cluster:
                q = queries[qi]
                with _stage(self.device) as sq:
                    a = halves_f[qi][1]
                    b = halves_b[qi][1]
                    fid = plan_f.half_of_query[qi]
                    bid = plan_b.half_of_query[qi]
                    key = (fid, bid, a, b, q.k, q.t, q.output, q.limit)
                    if key not in assembled:
                        fl = cache_f[fid]
                        assembled[key] = self._payload(
                            q, fl, a, lambda bid=bid: cache_b[bid], b,
                            cstats)
                    results[qi] = self._wrap(q, assembled[key])
                results[qi].time_s = sq.duration
        cstats["t_enumerate"] = se.duration
        return results, cstats

    # ------------------------------------------------------------------
    # plan execution: materialize the needed Ψ nodes in topological order
    # ------------------------------------------------------------------
    @staticmethod
    def _plan_children(plan: DirectionPlan, node: PlanNode) -> list[int]:
        """Splice children after dedupe (same root vertex: keep max budget)."""
        seen_src: dict[int, int] = {}
        for cid in node.in_edges:
            c = plan.nodes[cid]
            if c.src in seen_src and plan.nodes[seen_src[c.src]].budget >= c.budget:
                continue
            seen_src[c.src] = cid
        return list(seen_src.values())

    def _node_stop(self, plan: DirectionPlan, node: PlanNode,
                   index: QueryIndex, forward: bool) -> int:
        # dedicated-node optimization: a half used by exactly one query
        # and spliced by nobody may stop at its own endpoint (Alg 1)
        if (node.query is not None and len(node.consumers) == 1
                and not node.out_edges):
            qi = node.consumers[0][0]
            s_, t_, _ = index.queries[qi]
            return t_ if forward else s_
        return -2

    def _run_plan(self, plan: DirectionPlan, index: QueryIndex, forward: bool,
                  stats: Optional[dict] = None):
        cache: dict[int, list[PathSet]] = {}
        children_of = {n.nid: self._plan_children(plan, n) for n in plan.nodes}
        stops = {n.nid: self._node_stop(plan, n, index, forward)
                 for n in plan.nodes}
        # a node must be present iff it is a query half or spliced by a
        # present node (no cache: every present node is materialized)
        need: set[int] = set()
        stack = sorted(set(plan.half_of_query.values()))
        while stack:
            nid = stack.pop()
            if nid in need:
                continue
            need.add(nid)
            stack.extend(children_of[nid])
        for nid in plan.topo:
            if nid not in need:
                continue
            node = plan.nodes[nid]
            slack = self._node_slack(index, node.consumers, forward)
            children = [(plan.nodes[cid].src, plan.nodes[cid].budget, cache[cid])
                        for cid in children_of[nid]]
            cache[nid] = self._run_node(not forward, node.src, node.budget,
                                        slack, children, stop_vertex=stops[nid])
        if stats is not None:
            stats["n_psi_nodes"] += len(plan.nodes)
            stats["n_materialized"] += len(need)
        return cache

    # ------------------------------------------------------------------
    # node enumeration with overflow retry
    # ------------------------------------------------------------------
    def _run_node(self, reverse: bool, source: int, budget: int, slack,
                  children, stop_vertex: int = -2):
        caps = self._plan_caps(budget)
        for _ in range(8):
            out = self._run_node_once(reverse, source, budget, slack,
                                      children, stop_vertex, caps)
            if out is not None:
                return out
            caps = [min(c * 4, self.cfg.hard_cap) for c in caps]
            if all(c >= self.cfg.hard_cap for c in caps[1:]):
                raise EngineOverflow(
                    f"node (src={source}, budget={budget}) exceeds "
                    f"hard_cap")
        raise EngineOverflow("retry limit reached")

    def _run_node_once(self, reverse, source, budget, slack, children,
                       stop_vertex, caps):
        ell_idx = self.dg.direction(reverse)
        width = budget + 1
        n = self.dg.n
        splice_np = np.full(n + 1, -1, np.int8)
        for (csrc, cb, _) in children:
            splice_np[csrc] = cb
        # slack + splice stacked once per node; every expand level then
        # pays a single prune gather (see enumerate.prune_table)
        prune_tbl = prune_table(slack,
                                torch.from_numpy(splice_np).to(self.device))

        pools: list[list[PathSet]] = [[] for _ in range(budget + 1)]
        frontier = singleton(source, width, self.device)
        pools[0].append(frontier)
        for lvl in range(budget):
            # the level's host sync point, as in the reference
            if int(frontier.count) == 0:
                break
            out = expand_level(frontier.verts, frontier.count, ell_idx,
                               prune_tbl, stop_vertex,
                               level=lvl, budget=budget,
                               out_cap=caps[lvl + 1])
            if bool(out.frontier.overflow):
                return None
            for (csrc, cb, clevels) in children:
                rmask = (out.splice_hit & (out.nbrs == csrc)).any(dim=1)
                prefixes = extract_rows(frontier.verts, rmask,
                                        out_cap=frontier.cap)
                if int(prefixes.count) == 0:
                    continue
                for lam in range(0, min(cb, budget - lvl - 1) + 1):
                    cl = clevels[lam]
                    if int(cl.count) == 0:
                        continue
                    res = self._retry_join(
                        lambda cap: cross_join(
                            prefixes.verts, prefixes.count,
                            cl.verts, cl.count,
                            p_col=lvl, c_col=lam, out_cap=cap,
                            out_width=width),
                        est=int(prefixes.count) * int(cl.count))
                    pools[lvl + 1 + lam].append(res)
            frontier = out.frontier
            pools[lvl + 1].append(out.frontier)
        merged = [concat(p) if p else empty(1, width, self.device)
                  for p in pools]
        return [self._shrink(ps) for ps in merged]

    def _shrink(self, ps: PathSet) -> PathSet:
        """Slice a packed PathSet down to a tight capacity bucket."""
        tight = _bucket(int(ps.count), self.cfg.min_cap)
        if tight >= ps.cap:
            return ps
        return PathSet(ps.verts[:tight], ps.count, ps.overflow)

    def _retry_capacity(self, fn, est: int):
        """Run ``fn(cap) -> (result, overflow)`` with cap-growing retry."""
        cap = _bucket(min(max(est, self.cfg.min_cap), self.cfg.join_cap),
                      self.cfg.min_cap)
        while True:
            res, overflow = fn(cap)
            if not bool(overflow):
                return res
            if cap >= self.cfg.hard_cap:
                raise EngineOverflow("join exceeds hard_cap")
            cap = min(cap * 4, self.cfg.hard_cap)

    def _retry_join(self, fn, est: int) -> PathSet:
        def attempt(cap):
            ps = fn(cap)
            return ps, ps.overflow
        return self._retry_capacity(attempt, est)

    # ------------------------------------------------------------------
    # final ⊕ assembly (exact split, each result exactly once), dispatched
    # per query output kind: paths are materialized (lazily host-visible),
    # counts/existence use counting joins and never assemble a path row
    # ------------------------------------------------------------------
    def _payload(self, q: PathQuery, fwd_levels, a: int, bwd: Levels,
                 b: int, stats: dict):
        """The (shareable) answer payload for one query: a PathsStore for
        output=paths, an int for count/exists. ``bwd`` is a thunk --
        count/exists/limit queries answered by the forward levels alone
        never enumerate the backward half (basic planner)."""
        if q.output is Output.PATHS:
            ps = self._assemble(fwd_levels, a, bwd, b, q.t, q.k,
                                limit=q.limit)
            stats["n_rows_assembled"] += int(ps.count)
            return PathsStore(ps)
        limit = 1 if q.output is Output.EXISTS else q.limit
        return self._assemble_count(fwd_levels, a, bwd, b, q.t, q.k,
                                    limit=limit)

    @staticmethod
    def _wrap(q: PathQuery, payload) -> QueryResult:
        if q.output is Output.PATHS:
            return QueryResult(q, _store=payload)
        if q.output is Output.EXISTS:
            return QueryResult(q, _exists=payload > 0)
        return QueryResult(q, _count=payload, _exists=payload > 0)

    def _assemble(self, fwd_levels, a: int, bwd: Levels, b: int, t: int,
                  k: int, limit: Optional[int] = None):
        """``bwd`` is a thunk, only forced when the bidirectional stage is
        reached -- a limit already met by forward completions skips the
        backward enumeration entirely (basic planner)."""
        width = k + 1
        outs = []
        found = 0
        for lvl in range(1, min(a, len(fwd_levels) - 1) + 1):
            if limit is not None and found >= limit:
                break
            ps = fwd_levels[lvl]
            if int(ps.count) == 0:
                continue
            sel = select_ending_at(ps.verts, ps.count, t,
                                   col=lvl, out_cap=ps.cap)
            if int(sel.count):
                outs.append(_pad_width(sel, width))
                found += int(sel.count)
        if (not (limit is not None and found >= limit) and b >= 1
                and len(fwd_levels) > a and int(fwd_levels[a].count) > 0):
            bwd_levels = bwd()
            fa = fwd_levels[a]
            sa = sort_by_last(fa.verts, fa.count, col=a)
            for lam in range(1, min(b, len(bwd_levels) - 1) + 1):
                if limit is not None and found >= limit:
                    break
                bs = bwd_levels[lam]
                if int(bs.count) == 0:
                    continue
                res = self._retry_join(
                    lambda cap: keyed_join(sa, bs.verts, bs.count,
                                           a_col=a, b_col=lam,
                                           out_cap=cap, out_width=width),
                    est=max(int(fa.count), int(bs.count)))
                if int(res.count):
                    outs.append(res)
                    found += int(res.count)
        if not outs:
            return empty(1, width, self.device)
        out = concat(outs)
        if limit is not None:
            out = PathSet(out.verts, torch.clamp(out.count, max=limit),
                          out.overflow)
        return out

    def _assemble_count(self, fwd_levels, a: int, bwd: Levels, b: int,
                        t: int, k: int, limit: Optional[int] = None) -> int:
        """Exact ⊕ count without assembling paths: forward completions are
        mask reductions, the bidirectional part a counting join. ``limit``
        early-terminates (1 for exists-only) and clamps the total."""
        total = 0
        for lvl in range(1, min(a, len(fwd_levels) - 1) + 1):
            ps = fwd_levels[lvl]
            if int(ps.count) == 0:
                continue
            total += int(count_ending_at(ps.verts, ps.count, t, col=lvl))
            if limit is not None and total >= limit:
                return limit
        if b >= 1 and len(fwd_levels) > a and int(fwd_levels[a].count) > 0:
            bwd_levels = bwd()
            fa = fwd_levels[a]
            sa = sort_by_last(fa.verts, fa.count, col=a)
            for lam in range(1, min(b, len(bwd_levels) - 1) + 1):
                bs = bwd_levels[lam]
                if int(bs.count) == 0:
                    continue
                total += int(self._retry_capacity(
                    lambda cap: keyed_join_count(sa, bs.verts, bs.count,
                                                 a_col=a, b_col=lam,
                                                 pair_cap=cap),
                    est=max(int(fa.count), int(bs.count))))
                if limit is not None and total >= limit:
                    return limit
        return total if limit is None else min(total, limit)

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    def _split(self, qi: int, index: QueryIndex) -> tuple[int, int]:
        """The midpoint split (the cost-based '+' split is not ported)."""
        return midpoint_split(index.queries[qi][2])

    def _dedicated_slack(self, index: QueryIndex, qi: int,
                         forward: bool) -> torch.Tensor:
        k = index.queries[qi][2]
        col = index.tgt_col[qi] if forward else index.src_col[qi]
        dist = index.dist_t if forward else index.dist_s
        return slack_from_dists(dist[:, int(col)][:, None],
                                np.array([k], np.int32),
                                np.array([0], np.int32), index.INF)

    def _node_slack(self, index: QueryIndex, consumers,
                    forward: bool) -> torch.Tensor:
        qs = [qi for qi, _ in consumers]
        offs = np.array([off for _, off in consumers], np.int32)
        ks = np.array([index.queries[qi][2] for qi in qs], np.int32)
        col = index.tgt_col[qs] if forward else index.src_col[qs]
        dist = index.dist_t if forward else index.dist_s
        cols = dist[:, torch.as_tensor(col, dtype=torch.int64,
                                       device=dist.device)]
        return slack_from_dists(cols, ks, offs, index.INF)

    def _dists_host(self, index: QueryIndex):
        """Host copies of the index distances, made once per index (the
        host planner's input)."""
        # memoized per index OBJECT: keep a strong reference so a freed
        # index's id can never be reused to serve stale distances
        if self._host_dists is None or self._host_dists[0] is not index:
            self._host_dists = (index, (index.dist_s.cpu().numpy(),
                                        index.dist_t.cpu().numpy()))
        return self._host_dists[1]

    def _hop_ok(self, index: QueryIndex, cluster, forward: bool) -> np.ndarray:
        k_max = max(index.queries[qi][2] for qi in cluster)
        ds, dt = self._dists_host(index)
        if forward:
            cols = dt[:-1, index.tgt_col[list(cluster)]]
        else:
            cols = ds[:-1, index.src_col[list(cluster)]]
        return (cols.min(axis=1) <= k_max)

    def _plan_caps(self, budget: int) -> list[int]:
        """Per-level capacities: ``min_cap`` everywhere, grown by the
        overflow retry (``plan_caps=False``; planning is not ported)."""
        return [self.cfg.min_cap] * (budget + 1)


def _pad_width(ps: PathSet, width: int) -> PathSet:
    pad = width - ps.verts.shape[1]
    if pad <= 0:
        return ps
    verts = torch.nn.functional.pad(ps.verts, (0, pad), value=-1)
    return PathSet(verts, ps.count, ps.overflow)

