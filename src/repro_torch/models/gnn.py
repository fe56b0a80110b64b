"""GNN zoo: MeshGraphNet, GraphCast(-style), SchNet, GraphSAGE.

Counterpart of ``repro/models/gnn.py``'s local path: message passing over
one edge list (a full graph, a sampled block, or a batch of molecules run
as one graph of disjoint parts). The JAX package aggregates with
``jax.ops.segment_sum`` / ``segment_max`` over gathered rows; here each
forward sorts its edges by destination once (:class:`EdgeList`, a stable
sort), so every
aggregation is a segmented reduction over contiguous runs and every
gather's backward adds in a fixed order (:mod:`.segment`): two runs of a
training step on the card give the same bits, as crash-resume needs. The
per-edge inputs (``edge_feat``, ``edge_rbf``) are permuted into that order
with the edges; the outputs are per node, so the order of the edges
changes nothing but the order of the sums, and a stable sort keeps each
destination's messages in their batch order. Masked (padding) edges are
keyed to an extra segment that is dropped, as in the JAX package: they
sort last and go through the same work as the others.

MLPs follow each paper's shape (ReLU between layers, then the
hand-written LayerNorm with eps 1e-6, for MGN / GraphCast; the shifted
softplus for SchNet). MGN / GraphCast / SchNet blocks are stacked on a
leading L axis and recomputed in the backward pass
(``torch.utils.checkpoint``, non-reentrant), as the JAX package's
``jax.checkpoint(nothing_saveable)`` scan.

Parameters are trees in the JAX layout (dicts, lists of weights) of
float32 ``nn.Parameter`` leaves: drawn by :func:`init_gnn_params` from a
``torch.Generator`` with the JAX init law, or carried over from a JAX tree
by :func:`gnn_params_from_jax`. The JAX ``constrain`` hook is a sharding
hint and has no counterpart on one device.

:func:`ring_aggregate` is the JAX ring over a mesh axis: node features
cut into one row block a slot of a layout (``launch/mesh.py``), edges
bucketed by (destination owner, source owner), P rounds that each add one
bucket's messages and rotate the features to the next slot
(:class:`RingPlan`). As in the JAX package, no model forward calls it.
"""
from __future__ import annotations

import math
from functools import cached_property
from typing import Any, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import GNNConfig
from ..kernels.registry import resolve_device
from ..launch.collectives import ppermute, run_slots
from ..pytree import leaves, tree_map
from .segment import Segments, gather_rows

__all__ = ["init_gnn_params", "gnn_param_logical", "gnn_params_from_jax",
           "gnn_param_count", "gnn_forward", "gnn_loss", "gnn_molecule_loss",
           "flatten_molecules", "graph_losses",
           "ring_aggregate", "RingPlan", "EdgeList"]

DeviceLike = Union[torch.device, str, None]


# ----------------------------------------------------------------------
# small building blocks
# ----------------------------------------------------------------------

class _Init:
    """A parameter's shape and init law: ``normal * scale``, or a fill
    (``scale`` None, ``fill`` 0 or 1)."""

    def __init__(self, shape, scale: Optional[float] = None,
                 fill: float = 0.0):
        self.shape, self.scale, self.fill = tuple(shape), scale, fill


def _normal(shape, fan_in: int) -> _Init:
    return _Init(shape, 1.0 / np.sqrt(fan_in))


def _mlp_spec(sizes, n_hidden_layers=2, layer_norm=True, stack=()):
    """The JAX ``_mlp_init`` law, on a leading ``stack`` of blocks."""
    dims = [sizes[0]] + [sizes[1]] * (n_hidden_layers - 1) + [sizes[-1]]
    p = {"w": [_normal(stack + (dims[i], dims[i + 1]), dims[i])
               for i in range(len(dims) - 1)],
         "b": [_Init(stack + (dims[i + 1],)) for i in range(len(dims) - 1)]}
    if layer_norm:
        p["ln_g"] = _Init(stack + (dims[-1],), fill=1.0)
        p["ln_b"] = _Init(stack + (dims[-1],))
    return p


def _mlp(p, x, act=torch.relu):
    n = len(p["w"])
    for i in range(n):
        x = x @ p["w"][i] + p["b"][i]
        if i < n - 1:
            x = act(x)
    if "ln_g" in p:
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        x = (x - mu) * torch.rsqrt(var + 1e-6) * p["ln_g"] + p["ln_b"]
    return x


def _ssp(x):  # shifted softplus (SchNet)
    return F.softplus(x) - math.log(2.0)


def _remat(fn, *args):
    """``fn(*args)``, recomputed in the backward pass when grads are on."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


class EdgeList:
    """A batch's edges sorted by destination (a stable sort), so that
    every destination's messages are one contiguous run in batch order.
    As in the JAX package, an edge whose ``mask`` is False is keyed to an
    extra segment ``n``: it sorts last, and its messages fall into the
    segment that :meth:`aggregate` drops. ``src`` / ``dst`` are the
    endpoints in sorted order (a masked edge keeps its own, as the JAX
    gathers do), ``perm`` their positions in the batch; :meth:`take` puts
    a per-edge input into that order."""

    def __init__(self, src: torch.Tensor, dst: torch.Tensor,
                 mask: Optional[torch.Tensor], n: int):
        self.n = int(n)
        key = dst if mask is None else torch.where(mask, dst, self.n)
        self.by_key = Segments(key, self.n + (mask is not None))
        self.perm = self.by_key.perm
        self.src = src.index_select(0, self.perm)
        self.dst = dst.index_select(0, self.perm)

    @cached_property
    def src_rows(self) -> Segments:
        return Segments(self.src, self.n)

    def gather_src(self, h: torch.Tensor) -> torch.Tensor:
        """``h[src]`` per sorted edge; the backward adds by source."""
        return self.src_rows.gather(h)

    def gather_dst(self, h: torch.Tensor) -> torch.Tensor:
        """``h[dst]`` per sorted edge; the backward adds through the
        destination sort as it stands (a masked edge's gradient, which is
        0, into the dropped segment)."""
        return self.by_key.gather(h, self.dst)

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """A per-edge input (E, ...) in batch order -> sorted order."""
        return x.index_select(0, self.perm)

    def aggregate(self, msgs: torch.Tensor, op: str) -> torch.Tensor:
        """(n, F) of the sorted messages per destination: sum, mean or
        max (a destination with no message gives 0); the masked edges'
        segment is dropped."""
        return self.by_key.reduce(msgs, op)[:self.n]


def _segment(msgs, dst, n, op):
    """The JAX ``_segment``: ``msgs`` (E, F) in any order reduced into
    ``n`` segments by ``dst``."""
    seg = Segments(dst, n)
    return seg.reduce(msgs.index_select(0, seg.perm), op)


# ----------------------------------------------------------------------
# ring-distributed aggregation (full-graph shapes over a mesh)
# ----------------------------------------------------------------------

class RingPlan:
    """The edges of :func:`ring_aggregate`, bucketed and compacted once.

    ``edge_src``, ``edge_dst``, ``edge_mask``: (slots, P, Eb), row ``s``
    slot ``s``'s buckets, bucket ``b`` its incoming edges whose sources
    live on the slot at position ``b`` of the ring's axis (local source
    and destination indices, ``mask`` False on the padding; Eb is the
    largest bucket). On each slot the valid entries of each bucket are
    kept (one host read of the bucket sizes a slot) and sorted by
    destination (:class:`~.segment.Segments`), so that a round gathers
    only real edges, in the order its fixed-order segmented sum adds
    them: the padding is never gathered."""

    def __init__(self, edge_src: torch.Tensor, edge_dst: torch.Tensor,
                 edge_mask: torch.Tensor, layout, axis_name: str,
                 n_loc: int):
        P = layout.axis_size(axis_name)
        want = (layout.size, P)
        for name, x in (("edge_src", edge_src), ("edge_dst", edge_dst),
                        ("edge_mask", edge_mask)):
            if x.dim() != 3 or tuple(x.shape[:2]) != want:
                raise ValueError(f"ring_aggregate: {name} must be (slots, "
                                 f"P, Eb) = {want + ('Eb',)}, got "
                                 f"{tuple(x.shape)}")
        self.layout, self.axis, self.P, self.n_loc = layout, axis_name, P, \
            int(n_loc)
        Eb = edge_src.shape[2]

        def buckets(s):
            dev = layout.device(s)
            keep = edge_mask[s].to(dev).reshape(-1).nonzero().squeeze(1)
            sizes = torch.bincount(keep // Eb, minlength=P).tolist()
            src = edge_src[s].to(dev).reshape(-1).index_select(0, keep)
            dst = edge_dst[s].to(dev).reshape(-1).index_select(0, keep)
            out = []
            for bs, bd in zip(src.split(sizes), dst.split(sizes)):
                seg = Segments(bd.long(), self.n_loc)
                out.append((bs.long().index_select(0, seg.perm),
                            bd.long().index_select(0, seg.perm), seg))
            return out

        self.buckets = run_slots(layout, buckets)

    def rounds(self, h: list, msg_fn=None):
        """Run the ring over the pieces ``h`` (one (N_loc, F) per slot),
        yielding the accumulators (one per slot) after each of the P
        rounds; the last yield is the result. Round r on the slot at
        position j: the rotating features hold block ``(j - r) mod P``;
        gather them at that bucket's sources, map them by ``msg_fn(src_h,
        dst)`` if given, add their sum per destination into the slot's
        accumulator; then every slot sends its rotating features to
        position ``j + 1`` (:func:`~repro_torch.launch.collectives.ppermute`;
        not after the last round, whose rotation nothing reads)."""
        layout, P = self.layout, self.P
        if len(h) != layout.size:
            raise ValueError(f"ring_aggregate: one piece of h per slot "
                             f"({layout.size}), got {len(h)}")
        if any(x.shape[0] != self.n_loc for x in h):
            raise ValueError(f"ring_aggregate: every piece of h has "
                             f"{self.n_loc} rows")

        def zeros(s):
            x = h[s]
            width = (msg_fn(x[:1], torch.zeros(1, dtype=torch.long,
                                               device=x.device)).shape[-1]
                     if msg_fn else x.shape[-1])
            return x.new_zeros((self.n_loc, width))

        acc = run_slots(layout, zeros)
        rot = list(h)
        perm = [(i, (i + 1) % P) for i in range(P)]
        for r in range(P):
            def step(s):
                blk = (layout.axis_index(s, self.axis) - r) % P
                src, dst, seg = self.buckets[s][blk]
                if src.numel():
                    src_h = rot[s].index_select(0, src)
                    msgs = msg_fn(src_h, dst) if msg_fn else src_h
                    acc[s].add_(seg.reduce(msgs, "sum"))

            run_slots(layout, step)
            if r < P - 1:
                rot = ppermute(rot, layout, self.axis, perm)
            yield acc


def ring_aggregate(h, edge_src, edge_dst, edge_mask, layout,
                   axis_name: str, msg_fn=None, op: str = "sum") -> list:
    """Row-partitioned SpMM by ring rotation over ``axis_name`` of
    ``layout`` (the JAX ``ring_aggregate`` under ``shard_map``, whose
    ``collective_permute`` is :func:`~repro_torch.launch.collectives.ppermute`).

    h        : one (N_loc, F) piece per slot, on the slot's device.
    edge_src, edge_dst, edge_mask : (slots, P, Eb), see :class:`RingPlan`.
    msg_fn   : optional map over the gathered source features and their
               destinations, ``msg_fn(src_h, dst)``, per edge.

    Returns one (N_loc, F') piece per slot: each destination's sum over
    its incoming edges. As the JAX body does, it sums whatever ``op``
    says (ROADMAP.md queue 3). The order of summation (a round's
    fixed-order segmented sum, then the rounds in turn) differs from a
    one-shot segmented sum: equal for integer-valued features below
    2**24, to rounding otherwise."""
    acc = None
    plan = RingPlan(edge_src, edge_dst, edge_mask, layout, axis_name,
                    h[0].shape[0])
    for acc in plan.rounds(h, msg_fn):
        pass
    return acc


# ----------------------------------------------------------------------
# parameters per architecture
# ----------------------------------------------------------------------

def _gnn_spec(cfg: GNNConfig, d_in: int, d_out: int) -> dict:
    """The JAX ``init_gnn_params`` tree of shapes and init laws."""
    d, L = cfg.d_hidden, cfg.n_layers
    if cfg.kind == "graphsage":
        dims = [d_in] + [d] * L
        return {"layers": [{"w_self": _normal((dims[i], d), dims[i]),
                            "w_nbr": _normal((dims[i], d), dims[i]),
                            "b": _Init((d,))} for i in range(L)],
                "out": _normal((d, d_out), d)}
    if cfg.kind in ("meshgraphnet", "graphcast"):
        m = cfg.mlp_layers
        return {
            "node_enc": _mlp_spec((d_in, d, d), m),
            "edge_enc": _mlp_spec((4, d, d), m),
            "blocks": {"edge_mlp": _mlp_spec((3 * d, d, d), m, stack=(L,)),
                       "node_mlp": _mlp_spec((2 * d, d, d), m, stack=(L,))},
            "node_dec": _mlp_spec((d, d, d_out), m, layer_norm=False),
        }
    if cfg.kind == "schnet":
        rbf = cfg.extra("rbf", 300)
        return {
            "embed": _Init((100, d), 0.1),
            "in_proj": _normal((d_in, d), d_in),
            "blocks": {"filter1": _normal((L, rbf, d), rbf),
                       "filter2": _normal((L, d, d), d),
                       "w_in": _normal((L, d, d), d),
                       "w_out1": _normal((L, d, d), d),
                       "w_out2": _normal((L, d, d), d)},
            "out1": _normal((d, d // 2), d),
            "out2": _normal((d // 2, d_out), d // 2),
        }
    raise ValueError(cfg.kind)


def gnn_param_count(cfg: GNNConfig, d_in: int, d_out: int) -> int:
    return sum(int(np.prod(s.shape))
               for s in leaves(_gnn_spec(cfg, d_in, d_out)))


def init_gnn_params(cfg: GNNConfig, d_in: int, d_out: int, *,
                    generator: torch.Generator,
                    device: DeviceLike = None) -> dict:
    """Random float32 parameters (``nn.Parameter`` leaves) with the law of
    the JAX ``init_gnn_params``: matrices ``normal / sqrt(fan_in)``
    (SchNet's embedding ``normal * 0.1``), biases and LayerNorm shifts
    zeros, LayerNorm gains ones; blocks stacked on a leading L axis."""
    dev = resolve_device(device)

    def make(s: _Init):
        if s.scale is None:
            t = torch.full(s.shape, s.fill, dtype=torch.float32, device=dev)
        elif dev.type == "meta":                # the dry run: shapes only
            t = torch.empty(s.shape, dtype=torch.float32, device=dev)
        else:
            t = torch.randn(s.shape, generator=generator, device=dev,
                            dtype=torch.float32).mul_(s.scale)
        return nn.Parameter(t)

    return tree_map(make, _gnn_spec(cfg, d_in, d_out))


def gnn_params_from_jax(tree, cfg: GNNConfig, *,
                        device: DeviceLike = None) -> dict:
    """The port's parameter tree carrying a JAX ``init_gnn_params`` tree's
    weights (leaves as numpy arrays), float32 ``nn.Parameter`` leaves on
    ``device``."""
    dev = resolve_device(device)
    want = {"graphsage": {"layers", "out"},
            "schnet": {"embed", "in_proj", "blocks", "out1", "out2"}}.get(
        cfg.kind, {"node_enc", "edge_enc", "blocks", "node_dec"})
    if set(tree) != want:
        raise ValueError(f"{cfg.name}: parameter names {sorted(tree)}, "
                         f"expected {sorted(want)}")
    return tree_map(lambda a: nn.Parameter(torch.from_numpy(
        np.array(a, dtype=np.float32)).to(dev)), tree)


def gnn_param_logical(params) -> Any:
    """GNN params are small -> replicated (one device: no sharding)."""
    return tree_map(lambda p: tuple(None for _ in p.shape), params)


# ----------------------------------------------------------------------
# forward and loss
# ----------------------------------------------------------------------

def gnn_forward(params, batch: dict, cfg: GNNConfig) -> torch.Tensor:
    """batch: ``nodes`` (N, d_in), ``edge_src`` / ``edge_dst`` (E,), an
    optional ``edge_mask`` (E,), and the kind's extras (``edge_feat``
    (E, 4), ``edge_rbf`` (E, n_rbf), ``atom_types`` (N,)) -> (N, d_out)."""
    nodes = batch["nodes"]
    N = nodes.shape[0]
    ed = EdgeList(batch["edge_src"], batch["edge_dst"],
                  batch.get("edge_mask"), N)
    op = cfg.aggregator

    if cfg.kind == "graphsage":
        h = nodes
        for lp in params["layers"]:
            nbr = ed.aggregate(ed.gather_src(h), "mean")
            h = torch.relu(h @ lp["w_self"] + nbr @ lp["w_nbr"] + lp["b"])
            h = h / torch.clamp(torch.linalg.vector_norm(
                h, dim=-1, keepdim=True), min=1e-6)
        return h @ params["out"]

    blocks = params["blocks"]
    L = leaves(blocks)[0].shape[0]

    def at(i):
        return tree_map(lambda t: t[i], blocks)

    if cfg.kind in ("meshgraphnet", "graphcast"):
        h = _mlp(params["node_enc"], nodes)
        ef = batch.get("edge_feat")
        ef = (torch.zeros((ed.src.shape[0], 4), dtype=nodes.dtype,
                          device=nodes.device) if ef is None else ed.take(ef))
        e = _mlp(params["edge_enc"], ef)

        def block(h, e, i):
            bp = at(i)
            msg_in = torch.cat([e, ed.gather_src(h),
                                ed.gather_dst(h)], -1)
            e = e + _mlp(bp["edge_mlp"], msg_in)
            agg = ed.aggregate(e, op)
            h = h + _mlp(bp["node_mlp"], torch.cat([h, agg], -1))
            return h, e

        for i in range(L):
            h, e = _remat(block, h, e, i)
        return _mlp(params["node_dec"], h)

    if cfg.kind == "schnet":
        if "atom_types" in batch:
            h = gather_rows(params["embed"], batch["atom_types"])
        else:
            h = nodes @ params["in_proj"]
        rbf = ed.take(batch["edge_rbf"])            # (E, n_rbf) precomputed

        def sblock(h, i):
            bp = at(i)
            w = _ssp(rbf @ bp["filter1"]) @ bp["filter2"]   # (E, d) cfconv
            msg = ed.gather_src(h @ bp["w_in"]) * w
            agg = ed.aggregate(msg, "sum")
            return h + _ssp(agg @ bp["w_out1"]) @ bp["w_out2"]

        for i in range(L):
            h = _remat(sblock, h, i)
        return _ssp(h @ params["out1"]) @ params["out2"]  # per-atom energy

    raise ValueError(cfg.kind)


def graph_losses(out: torch.Tensor, batch: dict, cfg: GNNConfig,
                 lead: int = 0) -> torch.Tensor:
    """Each graph's loss, as the JAX ``gnn_loss`` computes it from the
    forward's output: ``out`` (*G, N, d_out) and the batch's labels,
    targets and node mask with the same ``lead`` leading graph axes ->
    (*G,)."""
    nmask = batch.get("node_mask")
    m = None if nmask is None else nmask.to(out.dtype)
    if cfg.kind == "graphsage":                     # node classification
        logp = torch.log_softmax(out, dim=-1)
        nll = -logp.gather(-1, batch["labels"].long()[..., None])[..., 0]
        if m is not None:
            return (nll * m).sum(-1) / torch.clamp(m.sum(-1), min=1.0)
        return nll.mean(-1)
    if cfg.kind == "schnet":                        # energy regression
        energy = (out * m[..., None] if m is not None else out).sum((-2, -1))
        t = batch["targets"]
        if t.dim() > lead:
            t = t.sum(tuple(range(lead, t.dim())))
        return (energy - t) ** 2
    # node regression (meshgraphnet / graphcast)
    err = (out - batch["targets"]) ** 2
    if m is not None:
        return (err * m[..., None]).sum((-2, -1)) / torch.clamp(
            m.sum(-1) * out.shape[-1], min=1.0)
    return err.mean((-2, -1))


def gnn_loss(params, batch: dict, cfg: GNNConfig) -> torch.Tensor:
    """The JAX ``gnn_loss`` of one graph: masked cross-entropy
    (GraphSAGE), squared error of the summed energy (SchNet), masked mean
    squared error (MGN / GraphCast)."""
    return graph_losses(gnn_forward(params, batch, cfg), batch, cfg)


# the per-node and per-edge inputs of a molecule batch
_NODE_KEYS = ("nodes", "atom_types")
_EDGE_KEYS = ("edge_mask", "edge_feat", "edge_rbf")


def flatten_molecules(batch: dict) -> dict:
    """A batch of B molecules (a leading axis on every input: nodes (B, N,
    d_in), edges (B, E)) as one graph of B disjoint parts: nodes (B * N,
    d_in), edge ids offset by b * N; every node's output then depends on
    its own molecule alone."""
    B, N = batch["nodes"].shape[:2]
    off = (torch.arange(B, device=batch["edge_src"].device) * N)[:, None]
    flat = {"edge_src": (batch["edge_src"] + off).reshape(-1),
            "edge_dst": (batch["edge_dst"] + off).reshape(-1)}
    for k in _NODE_KEYS + _EDGE_KEYS:
        if k in batch:
            x = batch[k]
            flat[k] = x.reshape(-1, *x.shape[2:])
    return flat


def gnn_molecule_loss(params, batch: dict, cfg: GNNConfig) -> torch.Tensor:
    """The mean over a batch of B molecules of each one's
    :func:`gnn_loss`, as the JAX bundle's ``vmap``: one forward over
    :func:`flatten_molecules`, then each molecule's loss."""
    B, N = batch["nodes"].shape[:2]
    out = gnn_forward(params, flatten_molecules(batch), cfg)
    return graph_losses(out.reshape(B, N, -1), batch, cfg, lead=1).mean()
