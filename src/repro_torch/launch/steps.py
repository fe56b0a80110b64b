"""Step builder: (arch, shape) -> the step function and its analytic
roofline meta.

A port of ``repro/launch/steps.py``'s LM, GNN and recsys bundles
(``_lm_bundle``, ``_gnn_bundle``, ``_recsys_bundle`` and their meta). A
train step takes and returns the parameter tree and the optimizer state
(updated in place) on one device, a prefill step an
:class:`~..models.transformer.LM` and tokens, a decode step the model, a
token and its cache (``LM.init_cache``, which follows
``RunOptions.kv_cache_dtype``: float8 under ``"f8"``, as the JAX bundle's
abstract cache). The LM serving bundles take ``mesh``, a layout of slots,
as the JAX ``_lm_bundle`` takes its ``Rules``: their steps run the model
over it (``LM.with_mesh(mesh, opts)``: the parameters cut by
``lm_param_logical`` under ``serve_param_sharding``, the cache by
``cache_logical``, the layer tensor- and sequence-parallel, decode with or
without ``flash_decode``); a train bundle over a layout is the next slice
(the sharded train step) and raises. A recsys serve step takes the
parameters, histories and items, a retrieval step the parameters, one
history and the padded candidates, and the engine's step one superstep of
the paper's engine (:class:`EngineSuperstep`). ``StepBundle.inputs`` gives
the batch's padded shapes where the JAX bundle's abstract inputs fix them
(GNN, recsys, engine).
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Callable, Optional, Union

import torch

from .. import configs as config_registry
from ..config import (GNNConfig, LMConfig, PathEngineConfig, RecsysConfig,
                      RunOptions, ShapeSpec)
from ..core.enumerate import expand_level
from ..kernels.msbfs_expand.ops import msbfs_step, pack_bits
from ..models import gnn, recsys, transformer
from ..models.sharding import Rules
from ..optim import adamw_update, cosine_schedule
from ..pytree import leaves, unflatten
from .mesh import Layout

__all__ = ["StepBundle", "TRAIN_KINDS", "build_bundle", "lm_bundle",
           "gnn_bundle", "recsys_bundle", "engine_bundle", "engine_dims",
           "EngineSuperstep", "visited_words", "gnn_dims", "shape_of"]

# the shape kinds whose bundle is a train step
TRAIN_KINDS = ("train", "gnn_full", "gnn_mini", "gnn_mol", "recsys_train")


@dataclasses.dataclass
class StepBundle:
    arch: str
    shape: str
    kind: str                       # the shape's kind: train | prefill |
                                    # decode | gnn_full | gnn_mini | gnn_mol
                                    # | recsys_train | recsys_serve |
                                    # recsys_retrieval | engine_batch
    step_fn: Callable
    cfg: Union[LMConfig, GNNConfig, RecsysConfig, PathEngineConfig]
    opts: RunOptions
    meta: dict                      # analytic roofline terms
    spec: ShapeSpec                 # the shape, overrides applied
    # the batch's padded input shapes, name -> (shape, dtype) (GNN,
    # recsys, engine)
    inputs: dict = dataclasses.field(default_factory=dict)
    # the layout an LM serving step runs over (None: one device)
    mesh: Optional[Layout] = None

    @property
    def dims(self) -> dict:
        return dict(self.spec.dims)


def shape_of(mod, shape_name: str, overrides: dict | None) -> ShapeSpec:
    """The arch's shape ``shape_name`` with ``overrides`` of its dims."""
    shape = mod.SHAPES[shape_name]
    if overrides:
        shape = ShapeSpec(shape.name, shape.kind,
                          tuple(dict(dict(shape.dims), **overrides).items()))
    return shape


def build_bundle(arch: str, shape_name: str, opts: RunOptions | None = None,
                 reduced: bool = False, overrides: dict | None = None,
                 mesh: Optional[Layout] = None) -> StepBundle:
    """The bundle of ``arch`` at ``shape_name``; ``mesh``: the layout an
    LM serving bundle runs over (the other families take none yet)."""
    opts = RunOptions() if opts is None else opts
    mod = config_registry.get(arch)
    cfg = mod.REDUCED if reduced else mod.CONFIG
    shape = shape_of(mod, shape_name, overrides)
    if mod.FAMILY == "lm":
        return lm_bundle(arch, cfg, shape, opts, mesh=mesh)
    if mesh is not None:
        raise NotImplementedError(
            f"{arch}: a {mod.FAMILY} bundle over a layout needs the GNN and "
            f"recsys parameter splits, a later slice of the sharded model "
            f"code (ROADMAP.md queue 1, item 7)")
    build = {"gnn": gnn_bundle, "recsys": recsys_bundle,
             "engine": engine_bundle}[mod.FAMILY]
    return build(arch, cfg, shape, opts)


def _lm_meta(cfg: LMConfig, shape: ShapeSpec) -> dict:
    S, B = shape.dim("seq_len"), shape.dim("global_batch")
    N, Na = cfg.param_count(), cfg.active_param_count()
    tokens = B * S if shape.kind in ("train", "prefill") else B
    mult = 6 if shape.kind == "train" else 2
    kv_read = 0
    if shape.kind == "decode":
        # 2 bytes a value whatever kv_cache_dtype is: the JAX meta's
        # formula, kept for parity (ROADMAP.md queue 3)
        kv_read = (cfg.n_layers * B * S * cfg.n_kv_heads * cfg.hd * 2) * 2
    return {
        "family": "lm", "kind": shape.kind,
        "params": N, "active_params": Na,
        "tokens": tokens,
        "model_flops": mult * Na * tokens,
        "weight_bytes": Na * 2,
        "kv_cache_bytes": kv_read,
        "seq_len": S, "global_batch": B,
        "n_layers": cfg.n_layers,
    }


def lm_bundle(arch: str, cfg: LMConfig, shape: ShapeSpec,
              opts: RunOptions, mesh: Optional[Layout] = None) -> StepBundle:
    """The bundle of an LM config (e.g. one cut in depth) at ``shape``;
    its serving step over ``mesh`` where given: the model it is handed
    runs there (``LM.with_mesh(mesh, opts)``, the weights shared, unless
    it is placed so already)."""
    S, B = shape.dim("seq_len"), shape.dim("global_batch")
    meta = _lm_meta(cfg, shape)
    dp = 1 if mesh is None else Rules(mesh).size("batch")
    if cfg.moe is not None and dp > 1 and opts.moe_groups != dp:
        opts = dataclasses.replace(opts, moe_groups=dp)

    def bundle(step_fn):
        return StepBundle(arch=arch, shape=shape.name, kind=shape.kind,
                          step_fn=step_fn, cfg=cfg, opts=opts, meta=meta,
                          spec=shape, mesh=mesh)

    if shape.kind == "train":
        if mesh is not None:
            raise NotImplementedError(
                f"{arch} {shape.name} over a layout: the sharded train step "
                f"(FSDP gradient reduce-scatters, the optimizer state cut "
                f"as the parameters) is the next slice of the sharded model "
                f"code (ROADMAP.md queue 1, item 7); the port trains on one "
                f"device")
        transformer.check_trainable(opts)
        A = max(opts.grad_accum, 1)
        if B % A:
            raise ValueError(f"global_batch {B} must divide grad_accum {A}")

        def train_step(params, opt_state, tokens, targets):
            masters = leaves(params)

            def value_and_grad(tk, tg):
                loss = transformer.lm_loss(params, tk, tg, cfg, opts)
                return loss.detach(), torch.autograd.grad(loss, masters)

            if A == 1:
                loss, grads = value_and_grad(tokens, targets)
            else:  # gradient accumulation over A microbatches (f32 sums)
                tks = tokens.reshape(A, B // A, S)
                tgs = targets.reshape(A, B // A, S)
                grads = [torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device) for p in masters]
                loss = torch.zeros((), dtype=torch.float32,
                                   device=tokens.device)
                for a in range(A):
                    la, ga = value_and_grad(tks[a], tgs[a])
                    grads = [g + x.float() for g, x in zip(grads, ga)]
                    loss = loss + la
                grads = [g / A for g in grads]
                loss = loss / A
            lr = cosine_schedule(opt_state.count)
            params, opt_state, m = adamw_update(
                unflatten(params, grads), opt_state, params, lr=lr)
            return params, opt_state, {"loss": loss, **m}

        return bundle(train_step)

    transformer.check_supported(cfg, opts)
    step = (transformer.prefill if shape.kind == "prefill"
            else transformer.decode_step)
    if mesh is None:
        return bundle(step)

    def placed(model, *args):
        if model.mesh != mesh or model.opts != opts:
            model = model.with_mesh(mesh, opts)
        return step(model, *args)

    return bundle(placed)


def _train_step(loss_fn: Callable) -> Callable:
    """The GNN and recsys train step: ``loss_fn(params, batch)``'s value
    and gradients (zeros for a parameter the loss does not reach, as
    SchNet's ``in_proj`` on molecules), AdamW at the JAX bundles' settings
    (cosine schedule at base lr 1e-3, no weight decay)."""
    def train_step(params, opt_state, b):
        loss = loss_fn(params, b)
        grads = torch.autograd.grad(loss, leaves(params),
                                    materialize_grads=True)
        lr = cosine_schedule(opt_state.count, base_lr=1e-3)
        params, opt_state, m = adamw_update(
            unflatten(params, grads), opt_state, params, lr=lr,
            weight_decay=0.0)
        return params, opt_state, {"loss": loss.detach(), **m}
    return train_step


# ======================================================================
# GNN family
# ======================================================================

def gnn_dims(cfg: GNNConfig, shape: ShapeSpec) -> tuple[int, int]:
    """(d_in, d_out) of a GNN config at a shape."""
    d_feat = shape.dim("d_feat", 16)
    if cfg.kind == "graphsage":
        return d_feat, cfg.extra("n_classes", 41)
    return d_feat, cfg.extra("d_out", 3)


def _gnn_batch_shapes(cfg: GNNConfig, shape: ShapeSpec) -> dict:
    """The JAX ``_gnn_batch_abstract``: name -> (shape, dtype) of a graph
    batch of this shape (flat batches padded to multiples of 512)."""
    d_feat, d_out = gnn_dims(cfg, shape)
    rbf = cfg.extra("rbf", 300)
    I32, F32, B8 = torch.int32, torch.float32, torch.bool
    if shape.kind == "gnn_mol":
        B = shape.dim("batch")
        N, E = shape.dim("n_nodes"), shape.dim("n_edges")
        b = {"nodes": ((B, N, d_feat), F32), "edge_src": ((B, E), I32),
             "edge_dst": ((B, E), I32), "edge_mask": ((B, E), B8),
             "node_mask": ((B, N), B8)}
        if cfg.kind == "schnet":
            b.update(atom_types=((B, N), I32), edge_rbf=((B, E, rbf), F32),
                     targets=((B,), F32))
        elif cfg.kind == "graphsage":
            b["labels"] = ((B, N), I32)
        else:
            b.update(edge_feat=((B, E, 4), F32),
                     targets=((B, N, d_out), F32))
        return b
    if shape.kind == "gnn_mini":
        roots, fo = shape.dim("batch_nodes"), shape.dim("fanout")
        n_nodes = min(shape.dim("n_nodes"),
                      roots * (1 + fo[0] + fo[0] * fo[1]))
        n_edges = roots * fo[0] + roots * fo[0] * fo[1]
    else:
        n_nodes, n_edges = shape.dim("n_nodes"), shape.dim("n_edges")
    N = -(-n_nodes // 512) * 512
    E = -(-n_edges // 512) * 512
    b = {"nodes": ((N, d_feat), F32), "edge_src": ((E,), I32),
         "edge_dst": ((E,), I32), "edge_mask": ((E,), B8),
         "node_mask": ((N,), B8)}
    if cfg.kind == "schnet":
        b.update(edge_rbf=((E, rbf), F32), targets=((N,), F32))
    elif cfg.kind == "graphsage":
        b["labels"] = ((N,), I32)
    else:
        b.update(edge_feat=((E, 4), F32), targets=((N, d_out), F32))
    return b


def _gnn_meta(cfg: GNNConfig, shape: ShapeSpec) -> dict:
    n_params = gnn.gnn_param_count(cfg, *gnn_dims(cfg, shape))
    if shape.kind == "gnn_mol":
        E = shape.dim("n_edges") * shape.dim("batch")
        N = shape.dim("n_nodes") * shape.dim("batch")
    elif shape.kind == "gnn_mini":
        roots, fo = shape.dim("batch_nodes"), shape.dim("fanout")
        E = roots * fo[0] + roots * fo[0] * fo[1]
        N = min(shape.dim("n_nodes"), roots * (1 + fo[0] + fo[0] * fo[1]))
    else:
        E, N = shape.dim("n_edges"), shape.dim("n_nodes")
    d = cfg.d_hidden
    # per message-passing block: edge MLP ~ edges x d^2 terms, node MLP ~ nodes
    flops = 6 * cfg.n_layers * (E * (6 * d * d) + N * (6 * d * d))
    return {"family": "gnn", "kind": shape.kind, "params": n_params,
            "edges": E, "nodes": N, "model_flops": flops,
            "weight_bytes": n_params * 4, "n_layers": cfg.n_layers,
            "d_hidden": d}


def gnn_bundle(arch: str, cfg: GNNConfig, shape: ShapeSpec,
               opts: RunOptions) -> StepBundle:
    """The train bundle of a GNN config at ``shape``: a molecule batch's
    loss is the mean of each molecule's (``gnn.gnn_molecule_loss``)."""
    loss = gnn.gnn_molecule_loss if shape.kind == "gnn_mol" else gnn.gnn_loss
    return StepBundle(
        arch=arch, shape=shape.name, kind=shape.kind,
        step_fn=_train_step(lambda p, b: loss(p, b, cfg)), cfg=cfg,
        opts=opts, meta=_gnn_meta(cfg, shape), spec=shape,
        inputs=_gnn_batch_shapes(cfg, shape))


# ======================================================================
# recsys
# ======================================================================

def _recsys_meta(cfg: RecsysConfig, shape: ShapeSpec) -> dict:
    B = shape.dim("batch")
    mlp_flops = 2 * sum(cfg.tower_mlp[i] * cfg.tower_mlp[i + 1]
                        for i in range(len(cfg.tower_mlp) - 1))
    mlp_flops += 2 * cfg.embed_dim * cfg.tower_mlp[0]
    per_ex = 2 * mlp_flops  # two towers
    if shape.kind == "recsys_train":
        flops = 3 * (B * per_ex + 2 * B * B * cfg.tower_mlp[-1])
    elif shape.kind == "recsys_retrieval":
        Nc = shape.dim("n_candidates")
        flops = Nc * (mlp_flops + 2 * cfg.tower_mlp[-1]) + mlp_flops
    else:
        flops = B * (per_ex + 2 * cfg.tower_mlp[-1])
    emb_bytes = (cfg.n_users + cfg.n_items) * cfg.embed_dim * 4
    return {"family": "recsys", "kind": shape.kind,
            "params": recsys.recsys_param_count(cfg), "batch": B,
            "model_flops": flops, "weight_bytes": emb_bytes}


# the retrieval step's top k, and the multiple its candidates are padded to
RETRIEVAL_K = 100
RETRIEVAL_PAD = 512


def recsys_bundle(arch: str, cfg: RecsysConfig, shape: ShapeSpec,
                  opts: RunOptions) -> StepBundle:
    """The train, serve or retrieval bundle of the two-tower model."""
    B, H = shape.dim("batch"), cfg.n_user_hist
    meta = _recsys_meta(cfg, shape)
    I32, F32 = torch.int32, torch.float32

    def bundle(step_fn, inputs):
        return StepBundle(arch=arch, shape=shape.name, kind=shape.kind,
                          step_fn=step_fn, cfg=cfg, opts=opts, meta=meta,
                          spec=shape, inputs=inputs)

    if shape.kind == "recsys_train":
        return bundle(
            _train_step(lambda p, b: recsys.recsys_loss(p, b, cfg)),
            {"hist_ids": ((B, H), I32), "item_ids": ((B,), I32),
             "sampling_logq": ((B,), F32)})

    if shape.kind == "recsys_serve":
        @torch.no_grad()
        def serve_step(params, hist_ids, item_ids):
            return recsys.score_candidates(params, hist_ids, item_ids)

        return bundle(serve_step, {"hist_ids": ((B, H), I32),
                                   "item_ids": ((B,), I32)})

    # retrieval: 1 query vs n_candidates, padded with -1 ids to a multiple
    # of RETRIEVAL_PAD, masked to -inf before the top k
    Nc = shape.dim("n_candidates")
    Nc_pad = -(-Nc // RETRIEVAL_PAD) * RETRIEVAL_PAD

    @torch.no_grad()
    def retrieval_step(params, hist_ids, cand_ids):
        u = recsys.user_tower(params, hist_ids)
        v = recsys.item_tower(params, torch.clamp(cand_ids, min=0))
        scores = (v @ u[0]).float()
        scores = torch.where(cand_ids >= 0, scores, float("-inf"))
        vals, idx = recsys.topk_stable(scores, RETRIEVAL_K)
        return vals, cand_ids[idx]

    return bundle(retrieval_step, {"hist_ids": ((1, H), I32),
                                   "cand_ids": ((Nc_pad,), I32)})


# ======================================================================
# the paper's engine: one superstep at billion scale
# ======================================================================

# the enumeration half's working set (the JAX bundle's): the index-pruned
# subgraph's vertices at most, and the expand's output rows
ENGINE_PRUNED_MAX = 1 << 22
ENGINE_OUT_CAP = 1 << 20
# rows of dist a pass when visited words are derived from it: a (V, 512)
# bool temporary would be 34 GB at batch_1b
VISITED_CHUNK = 1 << 20
# a dist entry no BFS source has reached
UNREACHED = 127


def engine_dims(cfg: PathEngineConfig, shape: ShapeSpec) -> dict:
    """The engine bundle's sizes: V vertices, Q queries of k hops, the
    ELL capacity, W packed words, Vp pruned vertices, the expand's output
    rows and path width."""
    V, Q, k = shape.dim("n_vertices"), shape.dim("n_queries"), shape.dim("k")
    return {"V": V, "Q": Q, "k": k, "cap": cfg.ell_cap, "W": -(-Q // 32),
            "Vp": min(V, ENGINE_PRUNED_MAX), "out_cap": ENGINE_OUT_CAP,
            "width": (k + 1) // 2 + 1,
            "edges": V * shape.dim("avg_degree")}


def visited_words(dist: torch.Tensor, chunk: int = VISITED_CHUNK
                  ) -> torch.Tensor:
    """``pack_bits(dist != 127)``: the (V, ceil(S/32)) int32 words of the
    (V, S) int8 distances' reached entries, packed ``chunk`` rows a pass."""
    V, S = dist.shape
    out = torch.empty((V, -(-S // 32)), dtype=torch.int32, device=dist.device)
    for r0 in range(0, V, chunk):
        out[r0:r0 + chunk] = pack_bits(dist[r0:r0 + chunk] != UNREACHED)
    return out


class EngineSuperstep:
    """The engine bundle's step: one index hop (bit-packed MS-BFS over the
    whole graph) and one enumeration expand on the index-pruned subgraph,
    the JAX ``engine_superstep``:

        (ell_idx, frontier, dist, hop, pruned_ell, prune_tbl, paths,
         count) -> (frontier, dist, verts, count)

    ell_idx (V, cap) int32 in-neighbours, pad V; frontier (V, W) int32
    words of the last hop (``pack_bits`` layout; JAX's uint32 words
    bitcast); dist (V, Q) int8, 127 = unreached; hop a Python int;
    pruned_ell (Vp + 1, cap) int32 and prune_tbl (Vp + 1, 2) int8
    (``enumerate.prune_table``); paths (out_cap, width) int32 level-1
    paths; count their number, a 0-d int64 tensor on the paths' device.

    The hop is one ``msbfs_step`` (on the card one launch of
    ``csrc/msbfs_step.cu``), the expand one ``enumerate.expand_level`` at
    level 1 (on the card one fused ``expand_level_kernel``). Both need
    state the JAX function rebuilds each call, kept here instead:

    * the kernel's frontier has a zero sentinel row V. The returned
      frontier is the ``[:V]`` view of the (V+1, W) buffer it made; given
      back as the next superstep's input, that buffer is used as it is.
      Any other frontier is copied into a new one (its bits past Q
      cleared).
    * the kernel takes visited words, ``pack_bits(dist != 127)``. They are
      derived once from a dist (:func:`visited_words`) and carried while
      the same dist comes back unchanged since the last superstep wrote it.
      :meth:`prime` makes both ahead of the first superstep.
    * the kernel's dist is (V, 32W) and is updated in place (at batch_1b
      there is no room for a second 34 GB copy). Where Q == 32W and dist
      is contiguous, the dist given is updated and returned; otherwise it
      is copied once into a (V, 32W) buffer (pad columns unreached) and
      the ``[:, :Q]`` view of that buffer returned and, given back,
      carried.
    """

    def __init__(self, dims: dict):
        self.Q, self.W = dims["Q"], dims["W"]
        self.width, self.out_cap = dims["width"], dims["out_cap"]
        self._frontier_buf = None       # the (V+1, W) buffer made last
        self._dist_buf = None           # the padded (V, 32W) dist, if any
        self._visited = None            # (dist buffer ref, version, words)

    @staticmethod
    def _carried(view: torch.Tensor, buf, shape: tuple) -> bool:
        """Whether ``view`` is a leading slice of ``buf``, a ``shape``
        buffer made here."""
        return (buf is not None and view._base is buf
                and tuple(buf.shape) == shape
                and view.data_ptr() == buf.data_ptr()
                and view.stride() == buf.stride())

    def _frontier_buffer(self, frontier: torch.Tensor) -> torch.Tensor:
        V, W = frontier.shape
        buf = self._frontier_buf
        if self._carried(frontier, buf, (V + 1, W)):
            return buf
        if frontier.dtype != torch.int32 or W != self.W:
            raise TypeError(f"engine frontier: expected ({V}, {self.W}) "
                            f"int32 words, got {tuple(frontier.shape)} "
                            f"{frontier.dtype}")
        buf = torch.empty((V + 1, W), dtype=torch.int32,
                          device=frontier.device)
        buf[:V] = frontier
        buf[V] = 0
        if self.Q % 32:          # the last word's bits past Q
            # repro-lint: waive[RPL005] a mask of the last word's query bits, not shape math
            buf[:V, -1] &= (1 << (self.Q % 32)) - 1
        return buf

    def _dist_buffer(self, dist: torch.Tensor) -> torch.Tensor:
        V, Q = dist.shape
        cols = 32 * self.W
        if dist.dtype != torch.int8 or Q != self.Q:
            raise TypeError(f"engine dist: expected ({V}, {self.Q}) int8, "
                            f"got {tuple(dist.shape)} {dist.dtype}")
        if Q == cols and dist.is_contiguous():
            return dist
        if self._carried(dist, self._dist_buf, (V, cols)):
            return self._dist_buf
        buf = torch.full((V, cols), UNREACHED, dtype=torch.int8,
                         device=dist.device)
        buf[:, :Q] = dist
        self._dist_buf = buf
        return buf

    def _visited_words(self, buf: torch.Tensor) -> torch.Tensor:
        held = self._visited
        if held is not None and held[0]() is buf and held[1] == buf._version:
            return held[2]
        self._visited = None            # free the old words first
        return visited_words(buf)

    def _dist_view(self, buf: torch.Tensor) -> torch.Tensor:
        return buf if buf.shape[1] == self.Q else buf[:, :self.Q]

    def prime(self, frontier: torch.Tensor, dist: torch.Tensor) -> tuple:
        """The state a first superstep on ``frontier`` and ``dist`` would
        make, made now: the sentinel frontier buffer, the dist buffer
        where one is needed, and the visited words. Returns the frontier
        and dist to pass, which the next call carries."""
        fr = self._frontier_buf = self._frontier_buffer(frontier)
        buf = self._dist_buffer(dist)
        vis = self._visited_words(buf)
        self._visited = (weakref.ref(buf), buf._version, vis)
        return fr[:frontier.shape[0]], self._dist_view(buf)

    def __call__(self, ell_idx, frontier, dist, hop, pruned_ell, prune_tbl,
                 paths, count):
        V = ell_idx.shape[0]
        fr = self._frontier_buffer(frontier)
        buf = self._dist_buffer(dist)
        vis = self._visited_words(buf)
        new = self._frontier_buf = msbfs_step(ell_idx, fr, vis, buf,
                                              int(hop))
        self._visited = (weakref.ref(buf), buf._version, vis)
        out = expand_level(paths, count, pruned_ell, prune_tbl, -2,
                           level=1, budget=self.width - 1,
                           out_cap=self.out_cap)
        return new[:V], self._dist_view(buf), out.frontier.verts, \
            out.frontier.count

    @property
    def visited(self):
        """The visited words carried for the last dist, or None."""
        return None if self._visited is None else self._visited[2]


def _engine_meta(d: dict) -> dict:
    P, cap, width = d["out_cap"], d["cap"], d["width"]
    return {"family": "engine", "kind": "engine_batch",
            "vertices": d["V"], "edges": d["edges"], "queries": d["Q"],
            # one hop touches E edge-words + expand touches P_CAP*cap cells
            "model_flops": float(d["edges"]) * d["W"]
            + float(P) * cap * width,
            "weight_bytes": d["V"] * cap * 4}


def engine_bundle(arch: str, cfg: PathEngineConfig, shape: ShapeSpec,
                  opts: RunOptions) -> StepBundle:
    """The engine bundle at ``shape``: a fresh :class:`EngineSuperstep`
    and its inputs' shapes (``hop``, a Python int, is not among them)."""
    d = engine_dims(cfg, shape)
    V, W, cap, Vp = d["V"], d["W"], d["cap"], d["Vp"]
    I32, I8 = torch.int32, torch.int8
    inputs = {"ell_idx": ((V, cap), I32), "frontier": ((V, W), I32),
              "dist": ((V, d["Q"]), I8),
              "pruned_ell": ((Vp + 1, cap), I32),
              "prune_tbl": ((Vp + 1, 2), I8),
              "paths": ((d["out_cap"], d["width"]), I32),
              "count": ((), torch.int64)}
    return StepBundle(arch=arch, shape=shape.name, kind=shape.kind,
                      step_fn=EngineSuperstep(d), cfg=cfg, opts=opts,
                      meta=_engine_meta(d), spec=shape, inputs=inputs)
