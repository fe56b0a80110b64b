"""Dense and MoE decoder-only transformer: serving and training.

Counterpart of ``repro/models/transformer.py``: GQA attention (optional
QKV bias, as Qwen), RoPE, RMSNorm, a SwiGLU FFN or the MoE FFN
(:mod:`.moe`), tied or untied embeddings; serving (``lm_forward``,
``prefill``, ``init_cache``, ``decode_step``) and training
(``forward_hidden``, ``lm_loss``). Attention goes through
:func:`repro_torch.kernels.flash_attention.ops.gqa_attention`, whose arm
follows the tensors' device: on a CUDA model every layer of every call
runs the hand-written kernel (``RunOptions.kernel_backend`` picks nothing
here), and in training its backward kernel; on a CPU model the plain
versions.

Serving: :class:`LM` holds the parameters per layer under the JAX
package's names (``wq``, ``wk``, ``wv``, ``wo``, ``attn_norm``,
``ffn_norm``, ``w_gate``, ``w_up``, ``w_down`` or ``router``, ``e_gate``,
``e_up``, ``e_down``, ``bq``/``bk``/``bv``; ``embed``, ``final_norm``,
``unembed``), in the working type (``cfg.dtype``: bfloat16 for the
published configs, float32 for the reduced ones;
``dataclasses.replace(cfg, dtype=...)`` for another), and so does the KV
cache; a layer's casts to the working type are no-ops there.

Training: as the JAX ``lm_forward`` does, float32 masters (a parameter
tree in the JAX layout, layers stacked on L: :func:`train_params`, whose
leaves are ``nn.Parameter`` objects) cast to the working type at each use.
``RunOptions.remat`` checkpoints each group of ``layer_group`` layers
(``torch.utils.checkpoint``, non-reentrant) under ``remat_policy``:
``"nothing"`` (the JAX ``nothing_saveable``: the backward recomputes the
whole group) or ``"dots"`` (the JAX ``dots_with_no_batch_dims_saveable``:
a selective checkpoint that keeps the outputs of the products without a
batch dimension, ``aten.mm`` / ``aten.addmm`` -- the projections, the
SwiGLU and the router -- and recomputes the rest, the attention and the
MoE experts' batched products included; the same values, more memory).
``cast_params_early`` casts the stacked layers once before the loop,
``loss_chunk`` cuts the cross-entropy into checkpointed chunks so that
the (B, S, vocab) logits never exist, and ``moe_groups`` is the MoE
dispatch's group count. ``seq_parallel`` cuts the residual stream over
a layout's ``model`` axis (serving, below); on one device it changes
nothing, and is ignored.

The KV cache (``init_cache``) is in the working type, or in float8
(``torch.float8_e4m3fn``) under ``RunOptions(kv_cache_dtype="f8")`` as
the JAX decode bundle makes it: each step's keys and values go in through
:func:`quantize_f8`, which rounds as the JAX ``astype(float8_e4m3fn)``
does (to nearest even, NaN past the largest finite value, where torch's
own cast saturates), and the attention reads the float8 cache directly
(``gqa_attention``: a float8 variant of the decode kernel on the card,
the values dequantised to bf16 in the plain version).

Sharded serving (the JAX package's ``_lm_bundle`` under ``Rules``):
``LM(cfg, params, mesh=layout, opts=...)`` over a layout of slots
(``launch/mesh.py``; a card may repeat, each slot on its own stream) cuts
the parameters by :func:`lm_param_logical` under
``opts.serve_param_sharding`` (``sharding.serve_logical``: ``"2d"`` rows
over the data axes (FSDP), gathered at each use, a layer at a time; and
``"tp_only"`` replicated over them), heads, FFN columns, the vocab and
the experts over ``model``. A tree drawn for a tensor axis pads its q
heads (:func:`padded_heads`, ``init_lm_params(..., tp=...)``): padding
regroups GQA (q head h reads KV head ``h // (Hq / Hkv)`` of the padded
Hq), so a padded tree is another function than the unpadded one, equal
to the JAX package's at the same tp. ``prefill`` and ``decode_step``
then run as :class:`_Slots` sets out: attention tensor-parallel by heads
(each slot's heads on the attention kernel), the SwiGLU column- then
row-parallel, ``wo`` row-parallel, embedding and unembedding
vocab-parallel, MoE experts expert-parallel, the residual stream cut
along the sequence under ``seq_parallel`` (bit-equal to the unsplit
stream). ``init_cache`` returns the cache as one piece a slot, by the JAX
``cache_logical`` (batch over ``batch``, the sequence over ``model``; at
batch 1 ``seq_kv_wide``, the sequence over every axis), views of one
tensor where every slot is on one device. ``decode_step`` writes the new
position's keys and values into the slot that holds it; with
``flash_decode`` its attention is :func:`flash_decode_attention`, the
JAX ``shard_map`` program (each slot attends over its own keys and the
partials merge by log-sum-exp across the slots), without it (the JAX
default) each slot gathers its KV heads of the cut cache and attends
over them. A model with no layout runs ``flash_decode`` as one slot, as
a (1, 1) JAX mesh does.
"""
from __future__ import annotations

import copy
import dataclasses
import functools
import math
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from ..config import LMConfig, RunOptions
from ..kernels.flash_attention.ops import (F8, attention_partial,
                                           gqa_attention)
from ..kernels.registry import resolve_device
from ..launch.collectives import (all_gather, pmax, psum, reduce_scatter,
                                  run_slots)
from ..launch.mesh import Layout, make_host_mesh
from .moe import moe_combine, moe_dispatch, moe_experts, moe_ffn, moe_route
from .sharding import Rules, serve_logical, shard_tree

__all__ = ["LM", "init_lm_params", "params_from_jax", "train_params",
           "padded_heads", "lm_param_logical",
           "lm_forward", "forward_hidden", "lm_loss", "prefill",
           "decode_step", "init_cache", "cache_logical", "shard_cache",
           "flash_decode_attention", "quantize_f8", "working_dtype",
           "rmsnorm", "rope", "rope_tables", "swiglu"]

BIAS_PARAMS = ("bq", "bk", "bv")
REMAT_POLICIES = ("nothing", "dots")
KV_CACHE_DTYPES = ("bf16", "f8")
# float8_e4m3fn: its largest finite value is 448 = 1.75 * 2**8; the next
# step, 480, is its NaN pattern, so rounding to nearest (ties to even)
# gives 448 up to 464 and NaN above
F8_LARGEST_ROUNDED = 464.0

DeviceLike = Union[torch.device, str, None]


def working_dtype(cfg: LMConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def check_supported(cfg: LMConfig, opts: Optional[RunOptions] = None) -> None:
    """Refuse the options whose code is not ported (every LM config of
    the registry, dense or MoE, is)."""
    if opts is None:
        return
    if opts.kv_cache_dtype not in KV_CACHE_DTYPES:
        raise ValueError(f"kv_cache_dtype={opts.kv_cache_dtype!r}: one of "
                         f"{KV_CACHE_DTYPES}")


def check_trainable(opts: RunOptions) -> None:
    """Refuse a remat policy that is not one of :data:`REMAT_POLICIES`."""
    if opts.remat and opts.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy={opts.remat_policy!r}: one of "
                         f"{REMAT_POLICIES}")


def quantize_f8(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32 or bf16) as ``torch.float8_e4m3fn`` with the JAX
    ``astype`` semantics: rounded to the nearest value, ties to even
    (subnormals included), and NaN where ``|x| > 464`` (it rounds past
    448, the largest finite value), at +-inf and at NaN; torch's own cast
    saturates those to +-448, so they are made NaN first (four ops: a
    decode step writes its keys and values through this)."""
    keep = x.abs() <= F8_LARGEST_ROUNDED              # NaN compares False
    return torch.where(keep, x, float("nan")).to(F8)


def _remat_context(policy: str):
    """The ``context_fn`` of ``checkpoint`` for a remat policy."""
    if policy == "dots":
        return functools.partial(create_selective_checkpoint_contexts,
                                 _dots_saveable)
    return noop_context_fn


# the products without a batch dimension: x @ W with x (B, S, D) folds to
# mm; the attention's and the MoE experts' products are bmm (batched), as
# their JAX dot_generals have batch dimensions
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_saveable(ctx, op, *args, **kwargs):
    """The JAX ``dots_with_no_batch_dims_saveable`` policy: keep the
    outputs of mm / addmm, recompute every other op. The attention
    kernel, launched into a ``torch.empty`` buffer the policy never saves,
    is launched again by the recompute."""
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


# ----------------------------------------------------------------------
# parameters
# ----------------------------------------------------------------------

def padded_heads(cfg: LMConfig, tp: int) -> int:
    """The q heads of a tree drawn for a ``tp``-way tensor axis:
    ``cfg.n_heads`` rounded up to a multiple of ``tp`` (the JAX
    ``padded_heads``)."""
    return -(-cfg.n_heads // tp) * tp


def _param_shapes(cfg: LMConfig, tp: int = 1) -> tuple[dict, dict]:
    """JAX ``init_lm_params`` shapes at ``tp``, top level and per layer:
    name -> (shape, fan_in, or None for ones / zeros)."""
    L, D, hd = cfg.n_layers, cfg.d_model, cfg.hd
    Hq, Hkv = padded_heads(cfg, tp), cfg.n_kv_heads
    layers = {
        "attn_norm": ((L, D), None), "ffn_norm": ((L, D), None),
        "wq": ((L, D, Hq * hd), D), "wk": ((L, D, Hkv * hd), D),
        "wv": ((L, D, Hkv * hd), D), "wo": ((L, Hq * hd, D), Hq * hd),
    }
    if cfg.moe is None:
        layers.update(w_gate=((L, D, cfg.d_ff), D), w_up=((L, D, cfg.d_ff), D),
                      w_down=((L, cfg.d_ff, D), cfg.d_ff))
    else:
        E, Fe = cfg.moe.n_experts, cfg.moe.d_ff_expert
        layers.update(router=((L, D, E), D), e_gate=((L, E, D, Fe), D),
                      e_up=((L, E, D, Fe), D), e_down=((L, E, Fe, D), Fe))
    if cfg.qkv_bias:
        layers.update(bq=((L, Hq * hd), None), bk=((L, Hkv * hd), None),
                      bv=((L, Hkv * hd), None))
    # the JAX law takes fan_in = shape[-2]: for embed that is the vocab
    top = {"embed": ((cfg.vocab, D), cfg.vocab), "final_norm": ((D,), None)}
    if not cfg.tie_embeddings:
        top["unembed"] = ((D, cfg.vocab), D)
    return top, layers


def init_lm_params(cfg: LMConfig, *, generator: torch.Generator,
                   device: DeviceLike = None,
                   dtype: Optional[torch.dtype] = None, tp: int = 1) -> dict:
    """Random parameters with the law of the JAX ``init_lm_params``: each
    matrix ``normal / sqrt(fan_in)`` (fan_in = its second-to-last
    dimension), norms ones, biases zeros; layers stacked on a leading L
    axis. Drawn from ``generator`` in float32 one layer at a time, so the
    tree, in ``dtype`` (default the working type of ``cfg``; float32 for
    training masters), is the only full-size copy. On ``meta`` (the dry
    run) nothing is drawn. ``tp``: the q heads padded to
    :func:`padded_heads` for a ``tp``-way tensor axis, wq's extra columns
    and wo's extra rows zero (the padded heads add nothing), as the JAX
    function pads them."""
    dev = resolve_device(device)
    dt = working_dtype(cfg) if dtype is None else dtype
    top, layers = _param_shapes(cfg, tp)

    def make(name, shape, fan_in):
        out = torch.empty(shape, dtype=dt, device=dev)
        if fan_in is None:                      # norms ones, biases zeros
            return out.fill_(0.0 if name in BIAS_PARAMS else 1.0)
        if dev.type == "meta":                  # the dry run: shapes only
            return out
        for part in (out.unbind(0) if len(shape) >= 3 else (out,)):
            draw = torch.randn(part.shape, generator=generator, device=dev,
                               dtype=torch.float32)
            part.copy_(draw.div_(math.sqrt(fan_in)))
        return out

    params = {name: make(name, *spec) for name, spec in top.items()}
    params["layers"] = lay = {name: make(name, *spec)
                              for name, spec in layers.items()}
    real = cfg.n_heads * cfg.hd
    if padded_heads(cfg, tp) != cfg.n_heads:
        lay["wq"][..., real:] = 0.0
        lay["wo"][:, real:] = 0.0
    return params


def lm_param_logical(cfg: LMConfig) -> dict:
    """The parameter tree's logical axes (the JAX ``lm_param_logical``):
    rows over ``fsdp`` and heads, FFN columns and the vocab over
    ``tensor``, the experts over ``expert``; wk / wv and their biases
    replicated over ``tensor`` (KV heads are fewer than a tensor axis's
    slots)."""
    lay = {
        "attn_norm": (None, None),
        "ffn_norm": (None, None),
        "wq": (None, "fsdp", "tensor"),
        "wk": (None, "fsdp", None),
        "wv": (None, "fsdp", None),
        "wo": (None, "tensor", "fsdp"),
    }
    if cfg.qkv_bias:
        lay.update({"bq": (None, "tensor"), "bk": (None, None),
                    "bv": (None, None)})
    if cfg.moe is None:
        lay.update({"w_gate": (None, "fsdp", "tensor"),
                    "w_up": (None, "fsdp", "tensor"),
                    "w_down": (None, "tensor", "fsdp")})
    else:
        lay.update({"router": (None, "fsdp", None),
                    "e_gate": (None, "expert", "fsdp", None),
                    "e_up": (None, "expert", "fsdp", None),
                    "e_down": (None, "expert", None, "fsdp")})
    out = {"embed": ("tensor", "fsdp"), "final_norm": (None,), "layers": lay}
    if not cfg.tie_embeddings:
        out["unembed"] = ("fsdp", "tensor")
    return out


class Layer(nn.Module):
    """One transformer block's parameters under the JAX names."""

    def __init__(self, tensors: dict):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))

    def tensors(self) -> dict:
        """name -> parameter, the mapping :func:`_layer` reads."""
        return self._parameters


class LM(nn.Module):
    """A dense or MoE decoder-only LM for serving: its weights and KV
    cache on one device, or cut over the slots of ``mesh``.

    ``LM(cfg, generator=g)`` draws random weights (:func:`init_lm_params`)
    from ``g``, a ``torch.Generator`` on the model's device; ``LM(cfg,
    params)`` takes a parameter tree in the JAX layout (tensors, layers
    stacked on L; :func:`params_from_jax` builds one from the JAX
    package's), its q heads possibly padded for a tensor axis
    (``init_lm_params(..., tp=...)``; ``n_heads`` is the tree's count).
    ``device`` defaults to ``"cuda"`` and raises where there is no CUDA:
    the CPU runs only when asked (``device="cpu"``). The weights are held
    in the working type of ``cfg``. ``opts.moe_groups`` is the MoE
    dispatch's group count (prefill; a decode step of B tokens groups them
    by ``gcd(B, moe_groups)``, as the JAX ``decode_step`` does).

    ``mesh``: a :class:`~repro_torch.launch.mesh.Layout` whose slots are
    of the model's device type (``ValueError`` otherwise). The model then
    holds one piece tree a slot (``pieces``), the parameters cut by
    ``serve_logical(lm_param_logical(cfg), opts)`` (views of its own
    weights where a slot is on its device), and serves over the slots
    (module docstring); the tree's q heads must split over the tensor
    axis (``ValueError``: nothing is padded here), and the MoE dispatch
    groups by the data axes' size where it is above 1, as the JAX
    ``_lm_bundle`` sets ``moe_groups``. :meth:`with_mesh` gives the same
    weights another layout and options. ``rules``: the layout's
    :class:`Rules` (None without one); ``decode_rules``: the slots of the
    decode attention, the layout's or, under ``flash_decode`` with no
    layout, one slot of the model's device (None: the attention over the
    whole cache).
    """

    def __init__(self, cfg: LMConfig, params: Optional[dict] = None, *,
                 generator: Optional[torch.Generator] = None,
                 opts: Optional[RunOptions] = None, device: DeviceLike = None,
                 mesh: Optional[Layout] = None):
        super().__init__()
        check_supported(cfg, opts)
        self.cfg = cfg
        self.opts = RunOptions() if opts is None else opts
        self.device = resolve_device(device)
        self.dtype = working_dtype(cfg)
        if params is None:
            if generator is None:
                raise ValueError("LM needs a parameter tree or a "
                                 "torch.Generator to draw one from")
            params = init_lm_params(cfg, generator=generator,
                                    device=self.device)
        top, layers = _param_shapes(cfg)
        got_layers = set(params.get("layers", {}))
        if set(params) != set(top) | {"layers"} or got_layers != set(layers):
            raise ValueError(
                f"{cfg.name}: parameter names {sorted(params)} / layers "
                f"{sorted(got_layers)} do not match the config's "
                f"{sorted(top)} / {sorted(layers)}")
        self.n_heads = params["layers"]["wq"].shape[-1] // cfg.hd
        if self.n_heads < cfg.n_heads or self.n_heads % cfg.n_kv_heads:
            raise ValueError(f"{cfg.name}: the tree's wq holds "
                             f"{self.n_heads} heads of {cfg.hd}, not "
                             f"n_heads {cfg.n_heads} or a padding of them "
                             f"over {cfg.n_kv_heads} KV heads")

        def to(t):
            return torch.as_tensor(t).to(device=self.device, dtype=self.dtype)

        for name in top:
            self.register_parameter(
                name, nn.Parameter(to(params[name]), requires_grad=False))
        stacked = {name: to(t) for name, t in params["layers"].items()}
        self.layers = nn.ModuleList(
            Layer({name: t[i] for name, t in stacked.items()})
            for i in range(cfg.n_layers))
        self._set_layout(mesh)

    def _set_layout(self, mesh: Optional[Layout]) -> None:
        self.rules = self.decode_rules = self.pieces = None
        if mesh is not None:
            types = {mesh.device(i).type for i in range(mesh.size)}
            if types != {self.device.type}:
                raise ValueError(f"the layout's slots are on "
                                 f"{sorted(types)}, the model on "
                                 f"{self.device.type}")
            rules = Rules(mesh)
            tp = rules.size("tensor")
            if self.n_heads % tp:
                raise ValueError(
                    f"{self.cfg.name}: the tree's {self.n_heads} q heads do "
                    f"not split over the {tp} slots of the tensor axis; draw "
                    f"it at tp={tp} (init_lm_params(..., tp={tp}) pads them "
                    f"to {padded_heads(self.cfg, tp)})")
            dp = rules.size("batch")
            if self.cfg.moe is not None and dp > 1 \
                    and self.opts.moe_groups != dp:
                self.opts = dataclasses.replace(self.opts, moe_groups=dp)
            self.logical = serve_logical(lm_param_logical(self.cfg),
                                         self.opts)
            layer_lg = {n: ax[1:] for n, ax in self.logical["layers"].items()}
            top = {n: getattr(self, n) for n in self.logical if n != "layers"}
            pieces = shard_tree(rules, top, self.logical)
            per_layer = [shard_tree(rules, dict(layer.tensors()), layer_lg)
                         for layer in self.layers]
            for s, p in enumerate(pieces):
                p["layers"] = [cut[s] for cut in per_layer]
            self.rules = self.decode_rules = rules
            self.pieces = pieces
        elif self.opts.flash_decode:
            dev = self.device
            if dev.type == "cuda" and dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            self.decode_rules = Rules(make_host_mesh(devices=[dev]))

    @property
    def mesh(self) -> Optional[Layout]:
        return None if self.rules is None else self.rules.layout

    def with_mesh(self, mesh: Optional[Layout],
                  opts: Optional[RunOptions] = None) -> "LM":
        """This model's weights (shared, not copied) under another layout
        (``None``: one device) and options."""
        opts = self.opts if opts is None else opts
        check_supported(self.cfg, opts)
        other = copy.copy(self)
        other.opts = opts
        other._set_layout(mesh)
        return other

    def unembed_weight(self) -> torch.Tensor:
        """(D, vocab): the unembedding (the embedding's transpose when
        tied)."""
        return self.embed.T if self.cfg.tie_embeddings else self.unembed

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def param_bytes(self) -> int:
        return sum(p.numel() * p.element_size() for p in self.parameters())

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    def forward(self, tokens) -> torch.Tensor:
        """(B, S) tokens -> final-normed hidden states (B, S, D)."""
        return lm_forward(self, self._tokens(tokens))

    def prefill(self, tokens) -> torch.Tensor:
        """(B, S) prompt -> last-position logits (B, 1, vocab) float32."""
        return prefill(self, self._tokens(tokens))

    def decode_step(self, token, cache: dict):
        """(B, 1) token -> (logits (B, 1, vocab) float32, cache)."""
        return decode_step(self, self._tokens(token), cache)

    def init_cache(self, batch: int, max_len: int) -> dict:
        """An empty KV cache on the model's device, or cut over its
        layout: float8 under ``opts.kv_cache_dtype == "f8"``, else in the
        model's type."""
        dtype = F8 if self.opts.kv_cache_dtype == "f8" else None
        return init_cache(self.cfg, batch, max_len, dtype=dtype,
                          device=self.device, rules=self.rules)


def params_from_jax(tree: dict, cfg: LMConfig, *, device: DeviceLike = None,
                    opts: Optional[RunOptions] = None,
                    mesh: Optional[Layout] = None) -> LM:
    """The port's :class:`LM` carrying the weights of a JAX
    ``transformer.init_lm_params`` tree (leaves as numpy arrays, layers
    stacked on the leading L axis; drawn at any ``tp``, its padded heads
    kept), cast to the working type of ``cfg`` on ``device``, over
    ``mesh`` where given."""
    def conv(a):
        return torch.from_numpy(np.array(a))         # a writable copy

    params = {name: ({k: conv(v) for k, v in sub.items()}
                     if name == "layers" else conv(sub))
              for name, sub in tree.items()}
    return LM(cfg, params, opts=opts, device=device, mesh=mesh)


# ----------------------------------------------------------------------
# building blocks
# ----------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w.to(x.dtype)


def rope_tables(positions: torch.Tensor, hd: int, theta: float):
    """The (B, S, 1, hd / 2) float32 cos and sin tables of ``positions``
    ((B, S) integers). Every layer rotates by the same positions, so the
    forward passes build them once per call, not once per layer."""
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang = positions[..., None].float() * freqs            # (B, S, half)
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Rotate x (B, S, H, hd) by the tables of :func:`rope_tables`."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (B, S, H, hd); positions: (B, S) integers."""
    return apply_rope(x, *rope_tables(positions, x.shape[-1], theta))


def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


# ----------------------------------------------------------------------
# forward
# ----------------------------------------------------------------------

def _layer(x: torch.Tensor, lp, cfg: LMConfig, tables, cache=None,
           moe_groups: int = 16, rules: Optional[Rules] = None):
    """One transformer block; ``lp`` maps the JAX names to this layer's
    tensors, each cast to x's (the working) type at use; ``tables``: the
    RoPE (cos, sin) of the tokens' positions. cache: None, or (ck, cv, pos)
    with ck, cv this layer's (B, max_len, Hkv, hd) views of the cache,
    written in place at ``pos``; with ``rules`` (one slot: a one-token
    step under ``flash_decode`` with no layout) the attention is
    :func:`flash_decode_attention` over the cache as the slot's piece.
    Returns ``(x, aux)``, aux the MoE load-balance loss (0.0 for a dense
    layer)."""
    B, S, _ = x.shape
    dt = x.dtype
    hd, Hkv = cfg.hd, cfg.n_kv_heads
    Hq = lp["wq"].shape[-1] // hd

    def w(name):
        return lp[name].to(dt)

    h = rmsnorm(x, lp["attn_norm"])
    q, k, v = h @ w("wq"), h @ w("wk"), h @ w("wv")
    if cfg.qkv_bias:
        q, k, v = q + w("bq"), k + w("bk"), v + w("bv")
    q = apply_rope(q.reshape(B, S, Hq, hd), *tables)
    k = apply_rope(k.reshape(B, S, Hkv, hd), *tables)
    v = v.reshape(B, S, Hkv, hd)

    if cache is None:
        attn = gqa_attention(q, k, v, causal=True, q_offset=0)
    else:
        ck, cv, pos = cache
        if ck.dtype == F8:          # not torch's saturating cast
            k, v = quantize_f8(k), quantize_f8(v)
        ck[:, pos:pos + S] = k
        cv[:, pos:pos + S] = v
        if rules is None:
            attn = gqa_attention(q, ck, cv, causal=True, q_offset=pos,
                                 kv_valid_len=pos + S)
        else:
            attn = flash_decode_attention([q], [ck], [cv], pos, rules,
                                          B == 1)[0]
    x = x + attn.reshape(B, S, Hq * hd) @ w("wo")
    h = rmsnorm(x, lp["ffn_norm"])
    if cfg.moe is None:
        return x + swiglu(h, w("w_gate"), w("w_up"), w("w_down")), 0.0
    f, aux = moe_ffn(h, lp, cfg, groups=moe_groups)
    return x + f, aux


@torch.no_grad()
def lm_forward(model: LM, tokens: torch.Tensor) -> torch.Tensor:
    """tokens: (B, S) integers at positions 0..S-1 -> final-normed hidden
    states (B, S, D). (The JAX function also returns the MoE auxiliary
    loss, which serving does not use; :func:`forward_hidden` returns it.)
    """
    if model.rules is not None:
        return _Slots(model, tokens.shape).forward(tokens)
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    tables = rope_tables(positions, model.cfg.hd, model.cfg.rope_theta)
    x = model.embed[tokens]
    for layer in model.layers:
        x, _ = _layer(x, layer.tensors(), model.cfg, tables,
                      moe_groups=model.opts.moe_groups)
    return rmsnorm(x, model.final_norm)


# ----------------------------------------------------------------------
# training
# ----------------------------------------------------------------------

def _master(t, device: torch.device, copy: bool) -> nn.Parameter:
    """A float32 master on ``device``: a copy of ``t`` (a tensor or a numpy
    array) when ``copy``, else ``t`` itself where it is one already."""
    if isinstance(t, torch.Tensor):
        t = t.detach().to(device)
    else:
        t, copy = torch.from_numpy(np.array(t)).to(device), False
    return nn.Parameter(t.to(torch.float32, copy=copy))


def train_params(cfg: LMConfig, params: Optional[dict] = None, *,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None) -> dict:
    """The float32 masters of training: a parameter tree in the JAX
    layout (``{"embed", "final_norm", ["unembed"], "layers": {name: (L,
    ...)}}``) whose leaves are ``nn.Parameter`` objects on ``device`` (default
    ``"cuda"``), copied from ``params`` (tensors or numpy arrays, e.g. a
    JAX ``init_lm_params`` tree) or drawn from ``generator``."""
    dev = resolve_device(device)
    copy = params is not None
    if params is None:
        if generator is None:
            raise ValueError("train_params needs a parameter tree or a "
                             "torch.Generator to draw one from")
        params = init_lm_params(cfg, generator=generator, device=dev,
                                dtype=torch.float32)
    top, layers = _param_shapes(cfg)
    if set(params) != set(top) | {"layers"} \
            or set(params["layers"]) != set(layers):
        raise ValueError(f"{cfg.name}: parameter names {sorted(params)} / "
                         f"layers {sorted(params.get('layers', {}))} do not "
                         f"match the config's {sorted(top)} / "
                         f"{sorted(layers)}")

    def master(t):
        return _master(t, dev, copy)

    tree = {name: master(params[name]) for name in top}
    tree["layers"] = {name: master(t) for name, t in params["layers"].items()}
    return tree


def forward_hidden(params: dict, tokens: torch.Tensor, cfg: LMConfig,
                   opts: RunOptions):
    """The JAX ``lm_forward`` on a parameter tree (float32 masters cast to
    the working type at use): tokens (B, S) -> (final-normed hidden states
    (B, S, D) in the working type, summed MoE aux loss float32)."""
    check_trainable(opts)
    dt = working_dtype(cfg)
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    tables = rope_tables(positions, cfg.hd, cfg.rope_theta)
    x = F.embedding(tokens, params["embed"].to(dt))
    layers = params["layers"]
    if opts.cast_params_early:
        layers = {name: t.to(dt) if t.dtype == torch.float32 else t
                  for name, t in layers.items()}
    L = cfg.n_layers
    g = opts.layer_group if (opts.layer_group
                             and L % opts.layer_group == 0) else 1

    def group(x, aux, first):
        for i in range(first, first + g):
            x, a = _layer(x, {name: t[i] for name, t in layers.items()}, cfg,
                          tables, moe_groups=opts.moe_groups)
            aux = aux + a
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    context_fn = _remat_context(opts.remat_policy)
    for first in range(0, L, g):
        if opts.remat:
            x, aux = checkpoint(group, x, aux, first, use_reentrant=False,
                                context_fn=context_fn)
        else:
            x, aux = group(x, aux, first)
    return rmsnorm(x, params["final_norm"]), aux


def _chunk_loss(xc: torch.Tensor, tc: torch.Tensor,
                unemb: torch.Tensor) -> torch.Tensor:
    logits = (xc @ unemb).float()                       # (B, C, V)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, tc[..., None])[..., 0]
    return torch.sum(lse - gold)


def lm_loss(params: dict, tokens: torch.Tensor, targets: torch.Tensor,
            cfg: LMConfig, opts: RunOptions) -> torch.Tensor:
    """Mean next-token cross-entropy (float32 scalar) of a parameter tree,
    as the JAX ``lm_loss``: chunks of ``C = min(loss_chunk, S)`` positions,
    each checkpointed (its (B, C, vocab) float32 logits are recomputed in
    the backward), plus ``router_aux_weight * aux / n_layers`` for MoE."""
    x, aux = forward_hidden(params, tokens, cfg, opts)
    dt = working_dtype(cfg)
    unemb = (params["embed"].T if cfg.tie_embeddings
             else params["unembed"]).to(dt)
    B, S, _ = x.shape
    C = min(opts.loss_chunk, S)
    if S % C:
        raise ValueError(f"lm_loss: seq_len {S} is not a multiple of the "
                         f"loss chunk {C}")
    targets = targets.long()
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, S, C):
        tot = tot + checkpoint(_chunk_loss, x[:, c0:c0 + C],
                               targets[:, c0:c0 + C], unemb,
                               use_reentrant=False)
    loss = tot / (B * S)
    if cfg.moe is not None:
        loss = loss + cfg.moe.router_aux_weight * aux / max(cfg.n_layers, 1)
    return loss


@torch.no_grad()
def prefill(model: LM, tokens: torch.Tensor) -> torch.Tensor:
    """Full forward over the prompt; last-position logits (B, 1, vocab)
    in float32 (over a layout: assembled from the slots' vocab blocks on
    the model's device)."""
    if model.rules is not None:
        return _Slots(model, tokens.shape).prefill(tokens)
    x = lm_forward(model, tokens)
    return (x[:, -1:] @ model.unembed_weight()).float()


def init_cache(cfg: LMConfig, batch: int, max_len: int, *,
               dtype: Optional[torch.dtype] = None,
               device: DeviceLike = None,
               rules: Optional[Rules] = None) -> dict:
    """``{"k", "v": (L, batch, max_len, Hkv, hd) zeros, "pos": 0}`` in
    ``dtype``: the working type of ``cfg`` by default, or
    ``torch.float8_e4m3fn`` (the cache of ``RunOptions(kv_cache_dtype=
    "f8")``, one byte a value), as the JAX function takes its type.

    With ``rules``, ``k`` and ``v`` are lists of one piece a slot of its
    layout, cut by :func:`cache_logical` (:func:`shard_cache`): views of
    one tensor on ``device`` where every slot is there, else zeros made
    on each slot's device."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    dev = resolve_device(device)
    dt = working_dtype(cfg) if dtype is None else dtype
    layout = None if rules is None else rules.layout
    if layout is None or {layout.device(i) for i in range(layout.size)} \
            == {dev}:
        cache = {"k": torch.zeros(shape, dtype=dt, device=dev),
                 "v": torch.zeros(shape, dtype=dt, device=dev), "pos": 0}
        return cache if rules is None else shard_cache(cache, rules)
    local = rules.local_shape(shape, *cache_logical(batch == 1)["k"])
    return {name: [torch.zeros(local, dtype=dt, device=layout.device(i))
                   for i in range(layout.size)] for name in ("k", "v")} \
        | {"pos": 0}


def cache_logical(wide: bool = False) -> dict:
    """The logical axes of the cache's ``k`` and ``v``, (L, B, S, Hkv,
    hd), as the JAX ``cache_logical``: batch over ``batch`` and the
    sequence over ``model``; ``wide`` (batch 1, long context): the
    sequence over every axis."""
    seq = "seq_kv_wide" if wide else "seq_kv"
    b = None if wide else "batch"
    return {"k": (None, b, seq, None, None),
            "v": (None, b, seq, None, None), "pos": ()}


def shard_cache(cache: dict, rules: Rules) -> dict:
    """A one-device cache (``k``, ``v`` tensors) cut over ``rules``'
    layout by :func:`cache_logical` (wide at batch 1): one piece a slot,
    a view of the tensor where the slot is on its device."""
    lg = cache_logical(cache["k"].shape[1] == 1)["k"]
    return {"k": rules.shard(cache["k"], *lg),
            "v": rules.shard(cache["v"], *lg), "pos": int(cache["pos"])}


def flash_decode_attention(qs: list, ck: list, cv: list, pos: int,
                           rules: Rules, wide: bool) -> list:
    """Decode attention over a cache cut along its sequence, without
    gathering it (the JAX ``flash_decode_attention``'s ``shard_map``).

    qs: one (B_loc, 1, Hq, hd) a slot, every q head of the slot's block of
    the batch (all of it at batch 1, ``wide``); ck, cv: this layer's cache
    pieces (B_loc, S_loc, Hkv, hd), one a slot, by :func:`cache_logical`
    (``wide``). On its stream each slot attends over its keys ``[0,
    valid)``, ``valid = clip(pos + 1 - offset, 0, S_loc)`` with ``offset``
    its block's first position
    (:func:`~repro_torch.kernels.flash_attention.ops.attention_partial`:
    the kernel on the card, its float32 output and each row's lse; a slot
    with no valid key gives zeros and -inf). The merge over the sequence's
    axes: the ``pmax`` of the lse, each slot's weight ``w = exp(lse -
    max)``, the ``psum`` of ``(w out, w)`` in slot order, ``out = sum w
    out / sum w`` rounded to q's type once, on each group's first slot.
    Returns one (B_loc, 1, Hq, hd) a slot, on the slot's device."""
    layout = rules.layout
    lg_kv = cache_logical(wide)["k"][1:]
    axes = rules.axes(lg_kv[1])
    S_loc = ck[0].shape[1]

    def partial(s):
        off = rules.blocks(s, *lg_kv)[1][0] * S_loc
        return attention_partial(qs[s], ck[s], cv[s],
                                 min(max(pos + 1 - off, 0), S_loc))

    parts = run_slots(layout, partial)
    top = pmax([lse for _, lse in parts], layout, axes)
    lowest = torch.finfo(torch.float32).min

    def weigh(s):
        out, lse = parts[s]                        # (B, 1, Hq, hd), (B, Hq, 1)
        w = torch.exp(lse - top[s].clamp(min=lowest))     # 0 for a -inf lse
        w = w.transpose(1, 2)[..., None]           # (B, 1, Hq, 1)
        return torch.cat([out * w, w], dim=-1)

    sums = psum(run_slots(layout, weigh), layout, axes)

    def divide(s):
        acc, w = sums[s][..., :-1], sums[s][..., -1:]
        tiny = torch.finfo(torch.float32).tiny
        return torch.where(w > 0, acc / w.clamp(min=tiny), 0.0) \
            .to(qs[s].dtype)

    groups = layout.groups(axes)
    outs = run_slots(layout, divide, [g[0] for g in groups])
    pieces = [None] * layout.size          # a group's members: replicas
    for g, out in zip(groups, outs):
        for m in g:
            dev = layout.device(m)
            pieces[m] = out if out.device == dev else out.to(dev)
    return pieces


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (a (..., K), b (K, N)) with a float32 result: a
    row-parallel product's partial, summed over the tensor axis in float32
    and rounded to the working type once, as the one-device product
    rounds its float32 accumulator once. A bf16 pair on the card goes
    through cuBLAS with a float32 output (``torch.mm(..., out_dtype=)``);
    elsewhere the float32 operands' product."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        flat = torch.mm(a.reshape(-1, a.shape[-1]), b,
                        out_dtype=torch.float32)
        return flat.reshape(*a.shape[:-1], b.shape[-1])
    return a.float() @ b.float()


def _kv_block(h0: int, n: int, group: int):
    """The KV heads ``[k0, k1)`` that q heads ``[h0, h0 + n)`` read (q head
    h reads KV head ``h // group``), and ``None`` where the kernel's own
    grouping maps them (``n`` a multiple of ``group``, or a divisor of it:
    no q head of the block straddles two groups), else the KV head of each
    q head, relative to ``k0`` (the keys are then expanded per q head)."""
    k0, k1 = h0 // group, (h0 + n - 1) // group + 1
    if n % group == 0 or group % n == 0:
        return k0, k1, None
    return k0, k1, torch.tensor([(h0 + j) // group - k0 for j in range(n)])


class _Slots:
    """One serving call over the layout of ``model.rules``: the JAX
    package's GSPMD program of ``_lm_bundle``, written out per slot.

    Each slot holds its block of the batch of the residual stream (all of
    it at decode batch 1, or where the data axes do not divide the batch)
    and, under ``seq_parallel`` (prefill, S a multiple of 16 and of the
    tensor axis), its block of the sequence along ``model``; its weights
    are its pieces, those cut over ``fsdp`` gathered over the data axes
    at each use (``all_gather``, one layer at a time). The layer: rmsnorm
    on the slot's block, the blocks gathered along S under
    ``seq_parallel``; q, k, v and the SwiGLU's gate and up products
    column-parallel (the slot's heads and FFN columns; the KV heads its q
    heads read); the slot's heads on ``gqa_attention``; ``wo`` and
    ``w_down`` row-parallel, their float32 partials summed over ``model``
    in slot order (``psum``, or ``reduce_scatter`` along S under
    ``seq_parallel``: the same sums) and rounded to the working type
    once; MoE experts expert-parallel (:meth:`moe`). Embedding and
    unembedding are vocab-parallel."""

    def __init__(self, model: LM, shape: tuple, wide: bool = False):
        B, S = shape
        rules = self.rules = model.rules
        self.model, self.cfg, self.dt = model, model.cfg, model.dtype
        self.layout = rules.layout
        self.n = self.layout.size
        self.devs = [self.layout.device(s) for s in range(self.n)]
        self.tp = rules.size("tensor")
        self.model_axes = rules.axes("tensor")
        self.data_axes = rules.axes("fsdp")
        self.wide = wide
        self.batch = (None if wide or B % rules.size("batch")
                      else "batch")
        self.B_loc = B // rules.size(self.batch)
        self.sp = (model.opts.seq_parallel and self.tp > 1 and S > 1
                   and S % 16 == 0 and S % self.tp == 0)
        self.S_loc = S // self.tp if self.sp else S
        self.hq = model.n_heads // self.tp
        group = model.n_heads // self.cfg.n_kv_heads
        self.m = [rules.blocks(s, "tensor")[0][0] for s in range(self.n)]
        self.kv = [_kv_block(m * self.hq, self.hq, group) for m in self.m]
        self.kv = [(k0, k1, idx if idx is None else idx.to(d))
                   for (k0, k1, idx), d in zip(self.kv, self.devs)]

    # -- slots and collectives ------------------------------------------

    def run(self, fn) -> list:
        return run_slots(self.layout, fn)

    def rows(self, s: int) -> slice:
        """The slot's block of the batch."""
        i = self.rules.blocks(s, self.batch)[0][0]
        return slice(i * self.B_loc, (i + 1) * self.B_loc)

    def seq_block(self, x: torch.Tensor, s: int) -> torch.Tensor:
        """The slot's block of x's sequence (dim 1) under seq_parallel."""
        if not self.sp:
            return x
        return x.narrow(1, self.m[s] * self.S_loc, self.S_loc)

    def gather_seq(self, xs: list) -> list:
        if not self.sp:
            return xs
        return all_gather(xs, self.layout, self.model_axes, dim=1)

    def psum_model(self, parts: list) -> list:
        """The row-parallel partials' sum over ``model`` (each slot's
        block of it along S under seq_parallel)."""
        if self.tp == 1:
            return parts
        if self.sp:
            return reduce_scatter(parts, self.layout, self.model_axes, dim=1)
        return psum(parts, self.layout, self.model_axes)

    def add(self, xs: list, parts: list, norm: Optional[str] = None,
            W: Optional[list] = None):
        """The residual plus the row-parallel partials' sum, rounded to
        the working type; with ``norm``, also ``rmsnorm`` of it by
        ``W[s][norm]`` in the same pass over the slots."""
        sums = self.psum_model(parts)

        def step(s):
            x = xs[s] + sums[s].to(self.dt)
            return x if norm is None else (x, rmsnorm(x, W[s][norm]))

        out = self.run(step)
        if norm is None:
            return out
        return [x for x, _ in out], [h for _, h in out]

    def gathered(self, pieces: list, logical: dict) -> list:
        """Each slot's weights, those cut over ``fsdp`` gathered over the
        data axes in one pass (a new dict a slot; the others as they
        are)."""
        out = [dict(p) for p in pieces]
        names = [n for n, axes in logical.items()
                 if "fsdp" in axes and n in out[0]]
        if self.rules.size("fsdp") == 1 or not names:
            return out
        whole = all_gather([tuple(p[n] for n in names) for p in pieces],
                           self.layout, self.data_axes,
                           dim=tuple(logical[n].index("fsdp")
                                     for n in names))
        for s in range(self.n):
            out[s].update(zip(names, whole[s]))
        return out

    def layer_weights(self, i: int) -> list:
        lg = {n: ax[1:] for n, ax in self.model.logical["layers"].items()}
        return self.gathered([p["layers"][i] for p in self.model.pieces],
                             lg)

    def tables(self, positions: torch.Tensor) -> list:
        """Each slot's RoPE tables of ``positions`` (1, S)."""
        cos, sin = rope_tables(positions, self.cfg.hd, self.cfg.rope_theta)
        return [(cos.to(d), sin.to(d)) for d in self.devs]

    # -- the model ------------------------------------------------------

    def embed(self, tokens: torch.Tensor) -> list:
        """The vocab-parallel lookup: each slot's vocab block (rows of
        other blocks zero), summed over ``model`` (exact: one addend is
        not zero), then gathered over the data axes along D where the
        embedding's columns are cut there; each slot's rows and block of
        the sequence."""
        pieces = [p["embed"] for p in self.model.pieces]
        V_loc, D_loc = pieces[0].shape
        cut = D_loc != self.cfg.d_model

        def look(s):
            tok = (tokens if cut else tokens[self.rows(s)]).to(self.devs[s])
            local = tok - self.m[s] * V_loc
            inside = (local >= 0) & (local < V_loc)
            e = pieces[s][local.clamp(0, V_loc - 1)]
            return torch.where(inside[..., None], e, 0.0)

        xs = self.run(look)
        if self.tp > 1:
            xs = psum(xs, self.layout, self.model_axes)
        if cut:
            xs = all_gather(xs, self.layout, self.data_axes, dim=-1)
            xs = [x[self.rows(s)] for s, x in enumerate(xs)]
        return [self.seq_block(x, s) for s, x in enumerate(xs)]

    def layer(self, i: int, xs: list, tabs: list, cache=None) -> list:
        W = self.layer_weights(i)
        hs = self.gather_seq(self.run(
            lambda s: rmsnorm(xs[s], W[s]["attn_norm"])))
        if cache is None:
            parts = self.run(lambda s: self.attend(s, W[s], hs[s], tabs[s]))
        else:
            parts = self.decode_attention(W, hs, tabs, *cache)
        xs, hs = self.add(xs, parts, "ffn_norm", W)
        hs = self.gather_seq(hs)
        if self.cfg.moe is not None:
            fs = self.moe(W, hs)
            return self.run(lambda s: xs[s] + self.seq_block(fs[s], s))

        def ffn(s):
            w, h = W[s], hs[s]
            return _mm_f32(F.silu(h @ w["w_gate"]) * (h @ w["w_up"]),
                           w["w_down"])

        return self.add(xs, self.run(ffn))

    def qkv(self, s: int, w: dict, h: torch.Tensor, tab, all_kv: bool):
        """The slot's q heads (B_loc, S, hq, hd), and the keys and values
        (B_loc, S, ., hd) of every KV head (``all_kv``: a decode step
        writes them into the cache) or of the slot's block, RoPE applied."""
        hd = self.cfg.hd
        B_, S_, _ = h.shape
        k0, k1, _ = self.kv[s]
        cols = slice(None) if all_kv else slice(k0 * hd, k1 * hd)
        q, k, v = h @ w["wq"], h @ w["wk"][:, cols], h @ w["wv"][:, cols]
        if self.cfg.qkv_bias:
            q, k, v = q + w["bq"], k + w["bk"][cols], v + w["bv"][cols]
        q = apply_rope(q.reshape(B_, S_, self.hq, hd), *tab)
        k = apply_rope(k.reshape(B_, S_, -1, hd), *tab)
        return q, k, v.reshape(B_, S_, -1, hd)

    def grouped(self, s: int, k: torch.Tensor, v: torch.Tensor):
        """The slot's KV heads as its q heads read them: as they are, or
        one a q head where its block straddles two groups."""
        idx = self.kv[s][2]
        if idx is None:
            return k, v
        return k.index_select(2, idx), v.index_select(2, idx)

    def attend(self, s: int, w: dict, h: torch.Tensor, tab) -> torch.Tensor:
        """Prefill: the slot's heads on the attention kernel, then its
        float32 partial of the row-parallel wo."""
        q, k, v = self.qkv(s, w, h, tab, all_kv=False)
        k, v = self.grouped(s, k, v)
        attn = gqa_attention(q, k, v, causal=True, q_offset=0)
        return _mm_f32(attn.reshape(*h.shape[:2], -1), w["wo"])

    def decode_attention(self, W, hs, tabs, ck: list, cv: list, pos: int):
        """A decode step's attention: each slot computes its q heads and
        every KV head's keys and values, the slot whose block of the cache
        holds ``pos`` writes them there; then with ``flash_decode`` the q
        heads are gathered over ``model`` and :func:`flash_decode_attention`
        merges the slots' partials over the cut cache, each slot taking its
        heads of the result; without it (the JAX default, GSPMD gathering
        the cut cache) each slot gathers its KV heads of the layer's cache
        along the sequence axes and attends over it with its q heads. Each
        slot's float32 partial of the row-parallel wo."""
        lg = cache_logical(self.wide)["k"][1:]
        S_loc = ck[0].shape[1]
        f8 = ck[0].dtype == F8

        def step(s):
            q, k, v = self.qkv(s, W[s], hs[s], tabs[s], all_kv=True)
            si = self.rules.blocks(s, *lg)[1][0]
            if si * S_loc <= pos < (si + 1) * S_loc:
                if f8:                  # not torch's saturating cast
                    k, v = quantize_f8(k), quantize_f8(v)
                ck[s][:, pos - si * S_loc] = k[:, 0]
                cv[s][:, pos - si * S_loc] = v[:, 0]
            return q

        qs = self.run(step)
        hd = self.cfg.hd
        if self.model.opts.flash_decode:
            if self.tp > 1:
                qs = all_gather(qs, self.layout, self.model_axes, dim=2)
            outs = flash_decode_attention(qs, ck, cv, pos, self.rules,
                                          self.wide)

            def project(s):
                a = outs[s][:, :, self.m[s] * self.hq:(self.m[s] + 1)
                            * self.hq]
                return _mm_f32(a.reshape(a.shape[0], 1, -1), W[s]["wo"])

            return self.run(project)
        axes = self.rules.axes(lg[1])

        def heads(s, piece):
            k0, k1, _ = self.kv[s]
            return piece[:, :, k0:k1]

        kvs = all_gather(list(zip(ck, cv)), self.layout, axes, dim=1,
                         select=heads)

        def attend(s):
            k, v = self.grouped(s, *kvs[s])
            attn = gqa_attention(qs[s], k, v, causal=True, q_offset=pos,
                                 kv_valid_len=pos + 1)
            return _mm_f32(attn.reshape(attn.shape[0], 1, self.hq * hd),
                           W[s]["wo"])

        return self.run(attend)

    def moe(self, W: list, hs: list) -> list:
        """Expert parallelism: each slot routes and dispatches the groups
        of its tokens (``moe_route``, ``moe_dispatch``: the one-device
        groups, the router FSDP-gathered), runs the products of its block
        of experts on its slice of the dispatch buffer, the expert outputs
        are gathered over ``model`` (GSPMD's all-to-all) and each slot
        combines its tokens in the one-device order. Returns each slot's
        (B_loc, S, D) FFN output."""
        cfg = self.cfg
        T = self.B_loc * hs[0].shape[1] * self.rules.size(self.batch)
        G = math.gcd(T, max(self.model.opts.moe_groups, 1))
        G_loc = G // self.rules.size(self.batch)
        E_loc = W[0]["e_gate"].shape[0]

        def experts(s):
            w = W[s]
            r = moe_route(hs[s], w["router"], cfg, G_loc)
            e0 = self.m[s] * E_loc
            eo = moe_experts(moe_dispatch(r, cfg)[:, e0:e0 + E_loc],
                             w["e_gate"], w["e_up"], w["e_down"])
            return r, eo

        done = self.run(experts)
        eos = [eo for _, eo in done]
        if self.tp > 1:
            eos = all_gather(eos, self.layout, self.model_axes, dim=1)
        return self.run(lambda s: moe_combine(eos[s], done[s][0],
                                              cfg.moe.top_k)
                        .reshape(hs[s].shape))

    def hidden(self, tokens: torch.Tensor, cache=None, pos: int = 0):
        """The residual stream after the last layer and the final norm,
        one block a slot."""
        S = tokens.shape[1]
        positions = torch.arange(pos, pos + S, device=tokens.device)[None]
        tabs = self.tables(positions)
        xs = self.embed(tokens)
        for i in range(self.cfg.n_layers):
            layer_cache = None if cache is None else (
                [p[i] for p in cache[0]], [p[i] for p in cache[1]], pos)
            xs = self.layer(i, xs, tabs, layer_cache)
        norms = [p["final_norm"] for p in self.model.pieces]
        return self.run(lambda s: rmsnorm(xs[s], norms[s]))

    def logits(self, xs: list) -> torch.Tensor:
        """The vocab-parallel unembedding of each slot's (B_loc, 1, D)
        rows: float32 logits cut over the vocab, assembled (B, 1, vocab)
        on the model's device."""
        if self.cfg.tie_embeddings:
            lg = {"embed": self.model.logical["embed"]}
            W = [w["embed"].T for w in self.gathered(self.model.pieces, lg)]
        else:
            lg = {"unembed": self.model.logical["unembed"]}
            W = [w["unembed"] for w in self.gathered(self.model.pieces, lg)]
        parts = self.run(lambda s: (xs[s] @ W[s]).float())
        return self.rules.assemble(parts, self.batch, None, "tensor",
                                   device=self.model.device)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        xs = self.hidden(tokens)
        return self.rules.assemble(xs, self.batch,
                                   "seq" if self.sp else None, None,
                                   device=self.model.device)

    def prefill(self, tokens: torch.Tensor) -> torch.Tensor:
        xs = self.hidden(tokens)
        if self.sp:             # the last position is on the last block
            xs = all_gather([x[:, -1:] for x in xs], self.layout,
                            self.model_axes, dim=1)
        return self.logits([x[:, -1:] for x in xs])


@torch.no_grad()
def decode_step(model: LM, token: torch.Tensor, cache: dict):
    """One token with the KV cache. token: (B, 1) integers.

    Returns ``(logits (B, 1, vocab) float32, cache)``. The cache is updated
    in place (``ck[:, pos:pos + 1] = k`` where the JAX package makes a new
    array with ``dynamic_update_slice``): the returned dict holds the same
    ``k`` / ``v`` tensors with ``pos`` advanced by one, and the dict passed
    in must not be used again. Attention reads only the first ``pos + 1``
    cache positions (``kv_valid_len``). The cache is in the model's type
    or float8 (``torch.float8_e4m3fn``: the step's keys and values go in
    through :func:`quantize_f8`); on a model with a layout, its pieces
    (:meth:`LM.init_cache`, :func:`shard_cache`).
    """
    B, S = token.shape
    pos = int(cache["pos"])
    ck, cv = cache["k"], cache["v"]
    if S != 1:
        raise ValueError(f"decode_step takes one token per row, got {S}")
    _check_cache(model, ck, cv, B, pos + S)
    if model.rules is not None:
        slots = _Slots(model, (B, S), wide=B == 1)
        logits = slots.logits(slots.hidden(token, (ck, cv), pos))
        return logits, {"k": ck, "v": cv, "pos": pos + 1}
    positions = torch.full((B, S), pos, dtype=torch.long, device=token.device)
    tables = rope_tables(positions, model.cfg.hd, model.cfg.rope_theta)
    x = model.embed[token]
    for i, layer in enumerate(model.layers):
        x, _ = _layer(x, layer.tensors(), model.cfg, tables,
                      cache=(ck[i], cv[i], pos),
                      moe_groups=model.opts.moe_groups,
                      rules=model.decode_rules)
    x = rmsnorm(x, model.final_norm)
    logits = (x @ model.unembed_weight()).float()
    return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}


def _check_cache(model: LM, ck, cv, B: int, end: int) -> None:
    """Refuse a cache whose type, shape or layout does not take a (B, 1)
    step ending at position ``end``."""
    L = model.cfg.n_layers
    if model.rules is None:
        if isinstance(ck, list) or isinstance(cv, list):
            raise ValueError("a cache cut over a layout needs a model with "
                             "that layout (LM(..., mesh=...))")
        ks, vs, want_b, max_len = [ck], [cv], B, ck.shape[2]
    else:
        layout = model.rules.layout
        if not isinstance(ck, list) or len(ck) != layout.size \
                or not isinstance(cv, list) or len(cv) != layout.size:
            raise ValueError(f"the cache of a model over {layout.size} "
                             f"slots is one piece a slot (LM.init_cache)")
        ks, vs = ck, cv
        b, seq = cache_logical(B == 1)["k"][1:3]
        want_b = B // model.rules.size(b)
        max_len = ck[0].shape[2] * model.rules.size(seq)
    for k, v in zip(ks, vs):
        if k.dtype != v.dtype or k.dtype not in (model.dtype, F8):
            raise ValueError(f"KV cache type {k.dtype} / {v.dtype} differs "
                             f"from the model's {model.dtype} and from {F8}")
        if k.shape[:2] != (L, want_b) or end > max_len:
            raise ValueError(f"cache of shape {tuple(k.shape)} at pos "
                             f"{end - 1} cannot take a ({B}, 1) step")
