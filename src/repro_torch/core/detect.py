"""DetectCommonQuery (Algorithm 3): build the query sharing graph Ψ and emit
a static execution plan for the device enumerator.

A numpy copy of ``repro/core/detect.py`` (host code).

Host-side "query compiler". Level-synchronous over remaining hop budget
(kappa = k_max .. 0), vectorized with numpy over each level's arrival set:

  * arrivals      -- (node_id, vertex) pairs: node's enumeration frontier
                     reaches vertex with remaining budget kappa.
  * >= 2 distinct nodes arriving at v  ->  new shared HC-s path node
    q_{v,kappa}; Psi edges (shared -> member) mean member *splices* the
    shared node's materialized results (Lemma 4.1).
  * M_Q[v]        -- latest node rooted at v; when a frontier touches such
                     a vertex the planner adds a splice edge instead of an
                     arrival (Alg 3 lines 20-24).

Deviations from the paper's pseudocode (documented in DESIGN.md §2):
  * the `M_Q[v] ⊀ M_Q[v']` guard exists to keep Psi acyclic; lacking
    all-pairs distances we enforce acyclicity directly (reachability check
    on insert; cycle-closing edges are skipped).
  * vertices are processed level-at-once rather than one-by-one (more
    same-level edges may be found; still acyclic by the check).
  * shared nodes with budget < min_shared_budget are not created (splicing
    a 1-hop cache costs more than recomputing it); set to 0 for the
    paper-faithful behaviour.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Optional, Sequence

import numpy as np

from .cache import node_signature
from .graph import Graph

__all__ = ["PlanNode", "DirectionPlan", "detect_common_queries"]


@dataclasses.dataclass
class PlanNode:
    nid: int
    src: int
    budget: int
    query: Optional[int]            # query idx if this is a query half
    in_edges: list[int] = dataclasses.field(default_factory=list)   # children to splice
    out_edges: list[int] = dataclasses.field(default_factory=list)  # parents splicing us
    consumers: list[tuple[int, int]] = dataclasses.field(default_factory=list)
    # consumers: (query_idx, min_offset) pairs for slack construction
    signature: Optional[tuple] = None
    # canonical HC-s query signature (direction, src, budget, slack-sig);
    # set when endpoints are provided — the cross-batch cache key prefix


@dataclasses.dataclass
class DirectionPlan:
    nodes: list[PlanNode]           # indexed by nid
    topo: list[int]                 # execution order (children before parents)
    half_of_query: dict[int, int]   # query idx -> nid of its half
    n_shared: int


def detect_common_queries(g: Graph, cluster: Sequence[int],
                          halves: dict[int, tuple[int, int]],
                          hop_ok: np.ndarray,
                          *, reverse: bool,
                          min_shared_budget: int = 2,
                          max_frontier: int = 1 << 22,
                          endpoints: Optional[dict[int, tuple[int, int]]] = None,
                          ) -> DirectionPlan:
    """Build the sharing plan for one cluster and one direction.

    halves : query idx -> (source_vertex, budget) for this direction
             (forward: (q.s, a_q) on G; backward: (q.t, b_q) on G_r).
    hop_ok : (n,) bool loose reachability filter ("meets the hop
             constraint", Alg 3 line 20) — vertices that can still reach
             some cluster endpoint.
    endpoints : optional query idx -> (endpoint_vertex, k) for this
             direction (forward: (q.t, q.k); backward: (q.s, q.k)). When
             given, every PlanNode gets a canonical ``signature`` usable
             as a cross-batch cache key prefix.
    """
    indptr = g.r_indptr if reverse else g.indptr
    indices = g.r_indices if reverse else g.indices

    nodes: list[PlanNode] = []
    root_node: dict[tuple[int, int], int] = {}   # (src, budget) -> nid (dedupe)
    half_of_query: dict[int, int] = {}
    by_budget: dict[int, list[int]] = defaultdict(list)
    for qi in cluster:
        src, budget = halves[qi]
        key = (src, budget)
        if key not in root_node:
            nid = len(nodes)
            nodes.append(PlanNode(nid=nid, src=src, budget=budget, query=qi))
            root_node[key] = nid
            by_budget[budget].append(nid)
        else:
            nid = root_node[key]
            if nodes[nid].query is None:
                nodes[nid].query = qi
        half_of_query[qi] = root_node[key]
    # queries sharing a (src, budget) half: extra owners tracked via consumers later
    owners = defaultdict(list)
    for qi in cluster:
        owners[half_of_query[qi]].append(qi)

    k_max = max(b for _, b in halves.values()) if halves else 0
    M_Q = np.full(g.n, -1, dtype=np.int64)       # vertex -> nid

    def add_edge(child: int, parent: int) -> None:
        """child's results spliced by parent; skip if it would close a cycle."""
        if child == parent or parent in _reachable(child):
            return
        if child in nodes[parent].in_edges:
            return
        nodes[parent].in_edges.append(child)
        nodes[child].out_edges.append(parent)

    def _reachable(nid: int) -> set[int]:
        # nodes reachable from nid following in_edges (its splice subtree)
        seen, stack = set(), [nid]
        while stack:
            x = stack.pop()
            for c in nodes[x].in_edges:
                if c not in seen:
                    seen.add(c)
                    stack.append(c)
        return seen

    # arrivals for the current level: per node, vertex array
    arrivals: dict[int, np.ndarray] = {}
    n_shared = 0
    for kappa in range(k_max, -1, -1):
        # inject roots whose budget matches this level
        for nid in by_budget.get(kappa, ()):  # roots start at their own level
            prev = arrivals.get(nid)
            v = np.array([nodes[nid].src], dtype=np.int64)
            arrivals[nid] = np.concatenate([prev, v]) if prev is not None else v

        if not arrivals:
            continue
        nid_arr = np.concatenate([np.full(v.size, nid, np.int64)
                                  for nid, v in arrivals.items()])
        vert_arr = np.concatenate(list(arrivals.values()))
        # dedupe (node, vertex)
        key = nid_arr * g.n + vert_arr
        _, idx = np.unique(key, return_index=True)
        nid_arr, vert_arr = nid_arr[idx], vert_arr[idx]

        # group by vertex; vertices with >= 2 nodes become shared queries
        order = np.argsort(vert_arr, kind="stable")
        vert_arr, nid_arr = vert_arr[order], nid_arr[order]
        uniq_v, starts, counts = np.unique(vert_arr, return_index=True,
                                           return_counts=True)
        cur_of_vertex = np.full(uniq_v.size, -1, np.int64)
        for ui in range(uniq_v.size):
            v = int(uniq_v[ui])
            members = nid_arr[starts[ui]:starts[ui] + counts[ui]]
            if counts[ui] >= 2 and kappa >= min_shared_budget:
                nid = len(nodes)
                nodes.append(PlanNode(nid=nid, src=v, budget=kappa, query=None))
                n_shared += 1
                for m in members:
                    add_edge(nid, int(m))     # members splice the shared node
                cur = nid
            else:
                cur = int(members[0])
            M_Q[v] = cur
            cur_of_vertex[ui] = cur

        if kappa == 0:
            break

        # push to out-neighbors (vectorized CSR expansion over the level)
        deg = (indptr[uniq_v + 1] - indptr[uniq_v]).astype(np.int64)
        flat_owner = np.repeat(cur_of_vertex, deg)
        offs = np.repeat(indptr[uniq_v], deg) + _ragged(deg)
        flat_nbr = indices[offs].astype(np.int64)
        ok = hop_ok[flat_nbr]
        flat_owner, flat_nbr = flat_owner[ok], flat_nbr[ok]
        if flat_nbr.size > max_frontier:  # planner safety valve
            keep = np.random.default_rng(0).choice(flat_nbr.size, max_frontier,
                                                   replace=False)
            flat_owner, flat_nbr = flat_owner[keep], flat_nbr[keep]

        has_mq = M_Q[flat_nbr] >= 0
        # splice edges: owner splices M_Q[v'] (dedup pairs first)
        e_child = M_Q[flat_nbr[has_mq]]
        e_parent = flat_owner[has_mq]
        if e_child.size:
            pair = np.unique(e_child * (len(nodes) + 1) + e_parent)
            for p in pair:
                add_edge(int(p // (len(nodes) + 1)), int(p % (len(nodes) + 1)))
        # arrivals for next level
        a_owner = flat_owner[~has_mq]
        a_vert = flat_nbr[~has_mq]
        arrivals = {}
        if a_owner.size:
            pair = np.unique(a_owner * g.n + a_vert)
            a_owner, a_vert = pair // g.n, pair % g.n
            cut = np.searchsorted(a_owner, np.arange(len(nodes) + 1))
            for nid in np.unique(a_owner):
                arrivals[int(nid)] = a_vert[cut[nid]:cut[nid + 1]]

    # consumers: propagate (query, min_offset) down from parents to children
    topo = _toposort(nodes)
    for nid in reversed(topo):                   # parents before children
        node = nodes[nid]
        if node.query is not None:
            for qi in owners[nid]:
                _, budget = halves[qi]
                node.consumers.append((qi, budget - node.budget))
        for parent in node.out_edges:
            for qi, off in nodes[parent].consumers:
                node.consumers.append((qi, off + nodes[parent].budget - node.budget))
        # dedupe, keep the smallest offset per query (loosest slack)
        best: dict[int, int] = {}
        for qi, off in node.consumers:
            if qi not in best or off < best[qi]:
                best[qi] = off
        node.consumers = sorted(best.items())

    if endpoints is not None:
        direction = "b" if reverse else "f"
        for node in nodes:
            node.signature = node_signature(direction, node.src, node.budget,
                                            node.consumers, endpoints)

    return DirectionPlan(nodes=nodes, topo=topo,
                         half_of_query=half_of_query, n_shared=n_shared)


def _toposort(nodes: list[PlanNode]) -> list[int]:
    """Children (in_edges targets) before parents."""
    indeg = {n.nid: len(n.in_edges) for n in nodes}
    from collections import deque
    q = deque([nid for nid, d in indeg.items() if d == 0])
    out = []
    while q:
        nid = q.popleft()
        out.append(nid)
        for parent in nodes[nid].out_edges:
            indeg[parent] -= 1
            if indeg[parent] == 0:
                q.append(parent)
    if len(out) != len(nodes):
        raise RuntimeError("sharing graph has a cycle (planner bug)")
    return out


def _ragged(counts: np.ndarray) -> np.ndarray:
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    offs = np.repeat(np.concatenate([[0], np.cumsum(counts)[:-1]]), counts)
    return np.arange(total, dtype=np.int64) - offs
