"""Work-stealing cluster scheduler for batch query serving.

A copy of ``repro/ft/scheduler.py`` (pure Python, no device code); the
snapshot's JSON layout is the reference's, so either package restores the
other's snapshot.

Straggler mitigation for the paper's engine at pod scale: query *clusters*
(the unit of sharing — a cluster's queries must stay together to reuse the
sharing graph) are assigned to data-parallel replica groups by estimated
cost; when a group runs dry it steals the largest pending cluster from the
most loaded group. The queue is checkpointable so a group failure only
loses its in-flight cluster, which returns to the queue (at-least-once;
results are idempotent by query id).
"""
from __future__ import annotations

import dataclasses
import json
import threading
from pathlib import Path
from typing import Callable, Optional

__all__ = ["WorkStealingScheduler"]


@dataclasses.dataclass
class _Item:
    cluster_id: int
    queries: list
    cost: float


class WorkStealingScheduler:
    def __init__(self, n_groups: int, cost_fn: Optional[Callable] = None):
        self.n_groups = n_groups
        self.cost_fn = cost_fn or (lambda qs: float(len(qs)))
        self.queues: list[list[_Item]] = [[] for _ in range(n_groups)]
        self.done: dict[int, object] = {}
        self.in_flight: dict[int, _Item] = {}
        self._inflight_group: dict[int, int] = {}   # cluster_id -> group
        self.steals = 0
        self.failovers = 0          # group failures absorbed (fail_group calls)
        self.requeued = 0           # in-flight items returned to a queue
        self._next_id = 0
        self._lock = threading.Lock()

    # -- planning ------------------------------------------------------
    def submit(self, clusters: list[list]) -> list[int]:
        """Greedy longest-processing-time assignment of clusters to groups.

        Returns the assigned cluster ids (in input order). Ids are globally
        monotonic so repeated submissions — the streaming admission loop
        feeds one micro-batch of clusters at a time — never collide.
        """
        with self._lock:
            ids = [self._alloc_id() for _ in clusters]
            items = [_Item(cid, qs, self.cost_fn(qs))
                     for cid, qs in zip(ids, clusters)]
            items.sort(key=lambda it: -it.cost)
            # account for load already queued or executing (streaming:
            # earlier micro-batches may still be in flight on a group)
            loads = [sum(i.cost for i in q) for q in self.queues]
            for cid, grp in self._inflight_group.items():
                it = self.in_flight.get(cid)
                if it is not None:
                    loads[grp] += it.cost
            for it in items:
                g = loads.index(min(loads))
                self.queues[g].append(it)
                loads[g] += it.cost
            return ids

    def submit_one(self, queries: list) -> int:
        """Streaming admission: enqueue a single cluster onto the least
        loaded group and return its cluster id."""
        return self.submit([queries])[0]

    def _alloc_id(self) -> int:
        cid = self._next_id
        self._next_id += 1
        return cid

    # -- execution -----------------------------------------------------
    def next_for(self, group: int) -> Optional[_Item]:
        with self._lock:
            if self.queues[group]:
                it = self.queues[group].pop(0)
            else:
                victim = max(range(self.n_groups),
                             key=lambda g: sum(i.cost for i in self.queues[g]))
                if not self.queues[victim]:
                    return None
                it = self.queues[victim].pop()      # steal from the back
                self.steals += 1
            self.in_flight[it.cluster_id] = it
            self._inflight_group[it.cluster_id] = group
            return it

    def complete(self, cluster_id: int, result) -> None:
        with self._lock:
            self.in_flight.pop(cluster_id, None)
            self._inflight_group.pop(cluster_id, None)
            self.done[cluster_id] = result

    def fail_group(self, group: int,
                   lost_cluster_ids: Optional[list[int]] = None) -> list[int]:
        """A replica group died: its in-flight clusters go back to the queue.

        ``lost_cluster_ids`` defaults to every cluster currently in flight
        on ``group`` (the scheduler tracks that mapping, so callers don't
        have to). Requeued items land on the least-loaded *surviving*
        queue — never back on the failed group, whose queue would only
        drain through steals. Returns the requeued cluster ids; already-
        completed clusters are not re-run (at-least-once, idempotent by
        query id downstream).
        """
        with self._lock:
            self.failovers += 1
            if lost_cluster_ids is None:
                lost_cluster_ids = [cid for cid, g in
                                    self._inflight_group.items() if g == group]
            survivors = [g for g in range(self.n_groups) if g != group] \
                or [group]
            requeued = []
            for cid in lost_cluster_ids:
                it = self.in_flight.pop(cid, None)
                self._inflight_group.pop(cid, None)
                if it is not None and cid not in self.done:
                    target = min(survivors,
                                 key=lambda g: sum(i.cost for i in self.queues[g]))
                    self.queues[target].append(it)
                    requeued.append(cid)
            self.requeued += len(requeued)
            return requeued

    def pending(self) -> int:
        with self._lock:
            return sum(len(q) for q in self.queues) + len(self.in_flight)

    # -- persistence (restart safety) ----------------------------------
    def snapshot(self, path: str | Path) -> None:
        with self._lock:
            state = {"queues": [[(i.cluster_id, i.queries, i.cost)
                                 for i in q] for q in self.queues],
                     "in_flight": [(i.cluster_id, i.queries, i.cost)
                                   for i in self.in_flight.values()],
                     "done": sorted(self.done)}
        Path(path).write_text(json.dumps(state))

    @classmethod
    def restore(cls, path: str | Path, n_groups: int) -> "WorkStealingScheduler":
        state = json.loads(Path(path).read_text())
        sched = cls(n_groups)
        for g, q in enumerate(state["queues"]):
            for cid, qs, cost in q:
                sched.queues[g % n_groups].append(_Item(cid, qs, cost))
        # in-flight work was lost with the crash: requeue it
        for cid, qs, cost in state["in_flight"]:
            sched.queues[0].append(_Item(cid, qs, cost))
        sched.done = dict.fromkeys(state["done"])
        seen = [i.cluster_id for q in sched.queues for i in q] + list(sched.done)
        sched._next_id = max(seen, default=-1) + 1
        return sched
