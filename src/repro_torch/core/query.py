"""Typed query/result contract: PathQuery in, QueryResult out.

Counterpart of ``repro/core/query.py``: the same types, with the lazy host
transfer reading torch tensors (``.cpu().numpy()``) instead of jax arrays.

The paper is query-centric — HC-s-t path queries whose shared HC-s path
computation the engine exploits — and this module makes that contract
first-class instead of bare ``(s, t, k)`` tuples and stringly-typed modes:

  * ``PathQuery``   -- (s, t, k) plus a per-query ``output`` kind
                       (paths | count | exists) and an optional ``limit``;
                       coerces from legacy tuples and validates eagerly.
  * ``Planner``     -- the execution strategy enum replacing the
                       'basic' | 'basic+' | 'batch' | 'batch+' | 'pathenum'
                       mode strings.
  * ``QueryResult`` -- per-query answer with *lazy* host transfer:
                       ``.count`` / ``.exists`` answer from the device
                       scalar; ``.paths`` materializes the matrix on demand.
  * ``BatchReport`` -- the aggregate the engine returns (one QueryResult
                       per query, ordered like the input, plus run stats).

count-only and exists-only queries are not a presentation veneer: the
engine skips the ⊕-join path materialization for them entirely (see
``join.keyed_join_count``) and early-terminates exists/limited queries.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Iterator, Optional, Sequence, Union

import numpy as np

from .pathset import PathSet
from ..obs import trace as obstrace

__all__ = ["Output", "Planner", "PathQuery", "QueryResult", "BatchReport",
           "PathsStore", "QueryLike", "ResultStatus", "midpoint_split"]


def midpoint_split(k: int) -> tuple[int, int]:
    """Default forward/backward hop split of a k-hop query: ``a = (k+1)//2``
    forward hops on G, ``b = k - a`` backward hops on G_r.

    The single source of truth for the split — the engine's cluster
    splitter and the cache-key builder (``cache.dedicated_keys``) both call
    this, so the cache's notion of a singleton query's half-keys can never
    drift from what the engine actually enumerates. The cost-based "+"
    planners may override the split per query; keys derived from this
    helper only describe the default.
    """
    a = (k + 1) // 2
    return a, k - a


class Output(enum.Enum):
    """What a query wants back: full paths, an exact count, or existence."""

    PATHS = "paths"
    COUNT = "count"
    EXISTS = "exists"

    @classmethod
    def coerce(cls, value: Union["Output", str]) -> "Output":
        if isinstance(value, cls):
            return value
        try:
            return cls(str(value).lower())
        except ValueError:
            raise ValueError(
                f"unknown output kind {value!r}; expected one of "
                f"{[o.value for o in cls]}") from None


class Planner(enum.Enum):
    """Execution strategy (replaces the legacy ``mode`` strings)."""

    BASIC = "basic"            # Alg 1: shared index, per-query enumeration
    BASIC_PLUS = "basic+"      # ... with cost-based fwd/bwd split
    BATCH = "batch"            # Alg 4: cluster -> detect -> shared enumeration
    BATCH_PLUS = "batch+"      # ... with cost-based fwd/bwd split
    PATHENUM = "pathenum"      # per-query index + enumeration (baseline)
    AUTO = "auto"              # cost-routed: GREEN/YELLOW/RED per query +
    #                            per-cluster basic/batch (core/planner.py)

    @classmethod
    def coerce(cls, value: Union["Planner", str]) -> "Planner":
        if isinstance(value, cls):
            return value
        try:
            return cls(str(value))
        except ValueError:
            raise ValueError(
                f"unknown planner {value!r}; expected one of "
                f"{[p.value for p in cls]}") from None

    @property
    def plus(self) -> bool:
        return self.value.endswith("+")

    @property
    def batched(self) -> bool:
        return self.value.startswith("batch")


@dataclasses.dataclass(frozen=True)
class PathQuery:
    """One hop-constrained s-t simple path query.

    ``output`` selects what the engine must produce; ``limit`` caps the
    number of paths (output=paths) or the counted total (output=count) —
    either way the engine stops working once the cap is reached.
    Iterating a PathQuery yields ``(s, t, k)``, so legacy unpacking code
    keeps working.

    ``deadline_s`` and ``tenant`` are the serving-side SLO contract
    (ignored by one-shot batch runs): ``deadline_s`` is the per-query
    latency budget in seconds *from submission* — the streaming admission
    loop admits a micro-batch early when the oldest waiter's slack is
    spent, sheds queries whose deadline already passed, and counts misses
    in ``serve_deadline_miss_total``. ``tenant`` names the submitting
    tenant for weighted-fair admission ordering and per-tenant wait
    histograms (see ``docs/serving.md`` § SLO-aware admission).
    """

    s: int
    t: int
    k: int
    limit: Optional[int] = None
    output: Output = Output.PATHS
    deadline_s: Optional[float] = None
    tenant: str = "default"

    def __post_init__(self):
        object.__setattr__(self, "s", int(self.s))
        object.__setattr__(self, "t", int(self.t))
        object.__setattr__(self, "k", int(self.k))
        object.__setattr__(self, "output", Output.coerce(self.output))
        if self.limit is not None:
            object.__setattr__(self, "limit", int(self.limit))
        if self.deadline_s is not None:
            object.__setattr__(self, "deadline_s", float(self.deadline_s))
        object.__setattr__(self, "tenant", str(self.tenant))
        if self.s < 0 or self.t < 0:
            raise ValueError("vertex ids must be >= 0")
        if self.s == self.t:
            raise ValueError("s == t queries are cycles, not s-t paths")
        if self.k < 1:
            raise ValueError("hop constraint must be >= 1")
        if self.limit is not None and self.limit < 1:
            raise ValueError("limit must be >= 1 (or None for unlimited)")
        if self.output is Output.EXISTS and self.limit is not None:
            raise ValueError("limit is meaningless for exists-only queries")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError("deadline_s must be > 0 (or None for no SLO)")

    @classmethod
    def coerce(cls, query: "QueryLike") -> "PathQuery":
        """Accept a PathQuery or any legacy ``(s, t, k)`` triple."""
        if isinstance(query, cls):
            return query
        try:
            s, t, k = query
        except (TypeError, ValueError):
            raise ValueError(
                f"cannot coerce {query!r} to PathQuery; expected a "
                f"PathQuery or an (s, t, k) triple") from None
        return cls(int(s), int(t), int(k))

    def check_bounds(self, n: int) -> "PathQuery":
        """Validate the endpoints against a graph of ``n`` vertices (the
        one check that needs a graph, shared by engine and server)."""
        if self.s >= n or self.t >= n:
            raise ValueError(f"query {self.key} references vertices "
                             f"outside the graph (n={n})")
        return self

    @property
    def key(self) -> tuple[int, int, int]:
        """The legacy ``(s, t, k)`` triple (index/cache key form)."""
        return (self.s, self.t, self.k)

    def __iter__(self) -> Iterator[int]:
        return iter((self.s, self.t, self.k))


QueryLike = Union[PathQuery, tuple[int, int, int], Sequence[int]]


class ResultStatus(enum.Enum):
    """Terminal outcome of one query: answered, or shed by admission.

    A ``SHED`` result is a first-class answer, not an exception path — a
    continuous server must be able to refuse work under pressure without
    tearing down the stream, and the caller must be able to tell "no
    paths" from "not attempted". Shed results carry no data: ``.paths`` /
    ``.count`` / ``.exists`` raise, ``.shed_reason`` says why
    (``"overload"`` | ``"deadline"``).
    """

    OK = "ok"
    SHED = "shed"


class PathsStore:
    """Device -> host materialization cache for one assembled result.

    Duplicate queries in a batch alias one store, so the host matrix is
    transferred exactly once no matter how many QueryResults share it;
    materializing also releases the (padded, capacity-bucketed) device
    buffer, which is typically much larger than the valid rows.
    """

    __slots__ = ("_pathset", "_host", "_count")

    def __init__(self, pathset: PathSet):
        self._pathset = pathset
        self._host: Optional[np.ndarray] = None
        self._count: Optional[int] = None

    @property
    def count(self) -> int:
        if self._count is None:
            self._count = int(self._pathset.count)
        return self._count

    @property
    def host(self) -> np.ndarray:
        if self._host is None:
            with obstrace.span("transfer.paths", rows=self.count):
                self._host = self._pathset.verts[:self.count].cpu().numpy()
            self._pathset = None   # release the padded device buffer
        return self._host

    @property
    def materialized(self) -> bool:
        return self._host is not None


@dataclasses.dataclass(repr=False)
class QueryResult:
    """Answer to one PathQuery, with lazy host transfer.

    For output=paths the assembled result stays a device ``PathSet``
    (behind a shared :class:`PathsStore`); ``.count`` / ``.exists`` read
    only its count scalar, and ``.paths`` pulls (and caches) the
    ``(n_paths, k+1)`` int32 matrix on first access. For output=count /
    output=exists no path matrix exists at all — the engine never
    assembled one — and ``.paths`` raises.
    """

    query: PathQuery
    # wall time attributable to this query ALONE: full per-query index +
    # enumeration under basic/pathenum planners, but only the final ⊕
    # assembly under batch planners (shared enumeration/clustering lives
    # in BatchReport.stats, and a deduplicated query reports ~0)
    time_s: float = 0.0
    _store: Optional[PathsStore] = None
    _count: Optional[int] = None
    _exists: Optional[bool] = None
    status: ResultStatus = ResultStatus.OK
    shed_reason: Optional[str] = None   # "overload" | "deadline" when SHED

    @classmethod
    def shed(cls, query: PathQuery, reason: str) -> "QueryResult":
        """A typed rejection: admission refused this query (see
        :class:`ResultStatus`). Accessors raise; ``.ok`` is False."""
        return cls(query=query, status=ResultStatus.SHED,
                   shed_reason=reason)

    @property
    def ok(self) -> bool:
        """False when admission shed the query instead of answering it."""
        return self.status is ResultStatus.OK

    def _check_shed(self) -> None:
        if self.status is ResultStatus.SHED:
            raise ValueError(
                f"query {self.query.key} was shed by admission "
                f"(reason: {self.shed_reason}); no result was computed — "
                f"check .status before reading data")

    @property
    def paths(self) -> np.ndarray:
        """(n_paths, k+1) int32 matrix (pad -1); materialized on demand."""
        self._check_shed()
        if self._store is None:
            raise ValueError(
                f"{self.query.output.value}-only query assembled no "
                f"paths; ask for output=paths")
        return self._store.host

    @property
    def count(self) -> int:
        """Number of result paths — no host matrix transfer needed."""
        self._check_shed()
        if self._count is None:
            if self._store is None:
                raise ValueError(
                    "exists-only query early-terminated without a count; "
                    "ask for output=count")
            self._count = self._store.count
        return self._count

    @property
    def exists(self) -> bool:
        """Whether at least one HC-s-t simple path exists."""
        self._check_shed()
        if self._exists is None:
            self._exists = self.count > 0
        return self._exists

    def offload(self) -> "QueryResult":
        """Materialize the host matrix now and release the device buffer.

        Long-lived results — e.g. a streaming backlog awaiting ``take()``
        — must not pin padded device PathSets; count/exists results hold
        no buffer and are unaffected. Returns self for chaining.
        """
        if self._store is not None:
            self._store.host
        return self

    def __repr__(self) -> str:  # never forces a host matrix transfer
        q = self.query
        if self.status is ResultStatus.SHED:
            return (f"QueryResult({q.s}->{q.t}, k={q.k}, SHED "
                    f"({self.shed_reason}))")
        if self._count is None and self._store is None:
            what = f"exists={self._exists}"
            mat = ""
        else:
            n = self._count if self._count is not None else self._store.count
            what = f"count={n}"
            mat = (", materialized"
                   if self._store is not None and self._store.materialized
                   else "")
        return (f"QueryResult({q.s}->{q.t}, k={q.k}, {q.output.value}, "
                f"{what}{mat})")


@dataclasses.dataclass
class BatchReport:
    """Aggregate result of one engine run: per-query QueryResults + stats.

    Indexable by query position (``report[qi]``), iterable in input order.
    ``routes`` is the per-query tier chosen under ``Planner.AUTO``
    (``"green"`` | ``"yellow"`` | ``"red"``, input order); ``None`` for
    forced planners, where no routing decision was made.
    """

    queries: tuple[PathQuery, ...]
    results: tuple[QueryResult, ...]
    stats: dict
    routes: Optional[tuple[str, ...]] = None

    def __len__(self) -> int:
        return len(self.results)

    def __iter__(self) -> Iterator[QueryResult]:
        return iter(self.results)

    def __getitem__(self, qi: int) -> QueryResult:
        return self.results[qi]

    @property
    def paths(self) -> dict[int, np.ndarray]:
        """Legacy-shaped view: query idx -> host path matrix (materializes
        every result; raises if any query was count-/exists-only)."""
        return {qi: r.paths for qi, r in enumerate(self.results)}
