"""Dense decoder-only transformer: the serving path (prefill + KV-cache decode).

Counterpart of the serving subset of ``repro/models/transformer.py``: GQA
attention (optional QKV bias, as Qwen), RoPE, RMSNorm, a SwiGLU FFN,
tied or untied embeddings; ``lm_forward``, ``prefill``, ``init_cache`` and
``decode_step``. Attention goes through
:func:`repro_torch.kernels.flash_attention.ops.gqa_attention`, whose arm
follows the tensors' device: on a CUDA model every layer of every call
runs the hand-written kernel (``RunOptions.kernel_backend`` picks nothing
here), on a CPU model its plain version.

:class:`LM` holds the parameters per layer under the JAX package's names
(``wq``, ``wk``, ``wv``, ``wo``, ``attn_norm``, ``ffn_norm``, ``w_gate``,
``w_up``, ``w_down``, ``bq``/``bk``/``bv``; ``embed``, ``final_norm``,
``unembed``). Unlike the JAX package, which keeps float32 masters and
casts them per layer, the serving weights and the KV cache are held in the
working type (``cfg.dtype``: bfloat16 for the published configs, float32
for the reduced ones; ``dataclasses.replace(cfg, dtype=...)`` for
another). The functions below take the module and plain tensors; one
device, so no sharding constraints and no tensor-parallel head padding
(the JAX ``padded_heads`` at tp = 1 is ``cfg.n_heads``).

Not ported here (refused with ``NotImplementedError`` where an option asks
for them): MoE layers (``models/moe.py``), ``flash_decode`` (needs a mesh)
and a float8 KV cache (``kv_cache_dtype="f8"``). ``lm_loss``, remat,
``layer_group``, ``seq_parallel`` and ``cast_params_early`` belong to
training and wait for it.
"""
from __future__ import annotations

import math
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import LMConfig, RunOptions
from ..kernels.flash_attention.ops import gqa_attention
from ..kernels.registry import resolve_device

__all__ = ["LM", "init_lm_params", "params_from_jax", "lm_forward",
           "prefill", "decode_step", "init_cache", "working_dtype",
           "rmsnorm", "rope", "rope_tables", "swiglu"]

BIAS_PARAMS = ("bq", "bk", "bv")

DeviceLike = Union[torch.device, str, None]


def working_dtype(cfg: LMConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def check_supported(cfg: LMConfig, opts: Optional[RunOptions] = None) -> None:
    """Refuse the configurations and options whose code is not ported."""
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: MoE layers (models/moe.py) are not ported yet "
            f"(ROADMAP.md queue 1, 'models/moe.py')")
    if opts is None:
        return
    if opts.flash_decode:
        raise NotImplementedError(
            "flash_decode shards the KV cache over a mesh; the port runs on "
            "one device (ROADMAP.md queue 1, the substrate's mesh options)")
    if opts.kv_cache_dtype == "f8":
        raise NotImplementedError(
            "kv_cache_dtype='f8' (a float8 KV cache) is not ported yet "
            "(ROADMAP.md queue 1, the substrate's mesh options)")


# ----------------------------------------------------------------------
# parameters
# ----------------------------------------------------------------------

def _param_shapes(cfg: LMConfig) -> tuple[dict, dict]:
    """JAX ``init_lm_params`` shapes (tp = 1), top level and per layer:
    name -> (shape, fan_in, or None for ones / zeros)."""
    L, D, hd = cfg.n_layers, cfg.d_model, cfg.hd
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    layers = {
        "attn_norm": ((L, D), None), "ffn_norm": ((L, D), None),
        "wq": ((L, D, Hq * hd), D), "wk": ((L, D, Hkv * hd), D),
        "wv": ((L, D, Hkv * hd), D), "wo": ((L, Hq * hd, D), Hq * hd),
        "w_gate": ((L, D, cfg.d_ff), D), "w_up": ((L, D, cfg.d_ff), D),
        "w_down": ((L, cfg.d_ff, D), cfg.d_ff),
    }
    if cfg.qkv_bias:
        layers.update(bq=((L, Hq * hd), None), bk=((L, Hkv * hd), None),
                      bv=((L, Hkv * hd), None))
    # the JAX law takes fan_in = shape[-2]: for embed that is the vocab
    top = {"embed": ((cfg.vocab, D), cfg.vocab), "final_norm": ((D,), None)}
    if not cfg.tie_embeddings:
        top["unembed"] = ((D, cfg.vocab), D)
    return top, layers


def init_lm_params(cfg: LMConfig, *, generator: torch.Generator,
                   device: DeviceLike = None) -> dict:
    """Random parameters with the law of the JAX ``init_lm_params``: each
    matrix ``normal / sqrt(fan_in)`` (fan_in = its second-to-last
    dimension), norms ones, biases zeros; layers stacked on a leading L
    axis. Drawn from ``generator`` in float32 one layer at a time, so the
    working type of ``cfg`` is the only full-size copy."""
    check_supported(cfg)
    dev = resolve_device(device)
    dt = working_dtype(cfg)
    top, layers = _param_shapes(cfg)

    def make(name, shape, fan_in):
        out = torch.empty(shape, dtype=dt, device=dev)
        if fan_in is None:                      # norms ones, biases zeros
            return out.fill_(0.0 if name in BIAS_PARAMS else 1.0)
        for part in (out.unbind(0) if len(shape) == 3 else (out,)):
            draw = torch.randn(part.shape, generator=generator, device=dev,
                               dtype=torch.float32)
            part.copy_(draw.div_(math.sqrt(fan_in)))
        return out

    params = {name: make(name, *spec) for name, spec in top.items()}
    params["layers"] = {name: make(name, *spec)
                        for name, spec in layers.items()}
    return params


class Layer(nn.Module):
    """One transformer block's parameters under the JAX names."""

    def __init__(self, tensors: dict):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))


class LM(nn.Module):
    """A dense decoder-only LM for serving, on one device.

    ``LM(cfg, generator=g)`` draws random weights (:func:`init_lm_params`)
    from ``g``, a ``torch.Generator`` on the model's device; ``LM(cfg,
    params)`` takes a parameter tree in the JAX layout (tensors, layers
    stacked on L; :func:`params_from_jax` builds one from the JAX
    package's). ``device`` defaults to ``"cuda"`` and raises where there is
    no CUDA: the CPU runs only when asked (``device="cpu"``). The weights
    are held in the working type of ``cfg``.
    """

    def __init__(self, cfg: LMConfig, params: Optional[dict] = None, *,
                 generator: Optional[torch.Generator] = None,
                 opts: Optional[RunOptions] = None, device: DeviceLike = None):
        super().__init__()
        check_supported(cfg, opts)
        self.cfg = cfg
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

        def to(t):
            return torch.as_tensor(t).to(device=self.device, dtype=self.dtype)

        for name in top:
            self.register_parameter(
                name, nn.Parameter(to(params[name]), requires_grad=False))
        stacked = {name: to(t) for name, t in params["layers"].items()}
        self.layers = nn.ModuleList(
            Layer({name: t[i] for name, t in stacked.items()})
            for i in range(cfg.n_layers))

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
        """An empty KV cache in the model's type on its device."""
        return init_cache(self.cfg, batch, max_len, device=self.device)


def params_from_jax(tree: dict, cfg: LMConfig, *, device: DeviceLike = None,
                    opts: Optional[RunOptions] = None) -> LM:
    """The port's :class:`LM` carrying the weights of a JAX
    ``transformer.init_lm_params`` tree (leaves as numpy arrays, layers
    stacked on the leading L axis), cast to the working type of ``cfg``
    on ``device``."""
    def conv(a):
        return torch.from_numpy(np.array(a))         # a writable copy

    params = {name: ({k: conv(v) for k, v in sub.items()}
                     if name == "layers" else conv(sub))
              for name, sub in tree.items()}
    return LM(cfg, params, opts=opts, device=device)


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

def _layer(x: torch.Tensor, lp: Layer, cfg: LMConfig,
           tables, cache=None) -> torch.Tensor:
    """One transformer block; ``tables``: the RoPE (cos, sin) of the
    tokens' positions. cache: None, or (ck, cv, pos) with ck, cv this
    layer's (B, max_len, Hkv, hd) views of the cache, written in place at
    ``pos``."""
    B, S, _ = x.shape
    hd, Hkv = cfg.hd, cfg.n_kv_heads
    Hq = lp.wq.shape[-1] // hd

    h = rmsnorm(x, lp.attn_norm)
    q, k, v = h @ lp.wq, h @ lp.wk, h @ lp.wv
    if cfg.qkv_bias:
        q, k, v = q + lp.bq, k + lp.bk, v + lp.bv
    q = apply_rope(q.reshape(B, S, Hq, hd), *tables)
    k = apply_rope(k.reshape(B, S, Hkv, hd), *tables)
    v = v.reshape(B, S, Hkv, hd)

    if cache is None:
        attn = gqa_attention(q, k, v, causal=True, q_offset=0)
    else:
        ck, cv, pos = cache
        ck[:, pos:pos + S] = k
        cv[:, pos:pos + S] = v
        attn = gqa_attention(q, ck, cv, causal=True, q_offset=pos,
                             kv_valid_len=pos + S)
    x = x + attn.reshape(B, S, Hq * hd) @ lp.wo
    return x + swiglu(rmsnorm(x, lp.ffn_norm), lp.w_gate, lp.w_up, lp.w_down)


@torch.no_grad()
def lm_forward(model: LM, tokens: torch.Tensor) -> torch.Tensor:
    """tokens: (B, S) integers at positions 0..S-1 -> final-normed hidden
    states (B, S, D).

    (The JAX function also returns the MoE auxiliary loss, always 0 for
    the dense models the port runs.)
    """
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    tables = rope_tables(positions, model.cfg.hd, model.cfg.rope_theta)
    x = model.embed[tokens]
    for lp in model.layers:
        x = _layer(x, lp, model.cfg, tables)
    return rmsnorm(x, model.final_norm)


@torch.no_grad()
def prefill(model: LM, tokens: torch.Tensor) -> torch.Tensor:
    """Full forward over the prompt; last-position logits (B, 1, vocab)
    in float32."""
    x = lm_forward(model, tokens)
    return (x[:, -1:] @ model.unembed_weight()).float()


def init_cache(cfg: LMConfig, batch: int, max_len: int, *,
               device: DeviceLike = None) -> dict:
    """``{"k", "v": (L, batch, max_len, Hkv, hd) zeros, "pos": 0}`` in the
    working type of ``cfg`` (the JAX function takes the type as an
    argument; a float8 cache, ``RunOptions(kv_cache_dtype="f8")``, is not
    ported)."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    dev, dt = resolve_device(device), working_dtype(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev), "pos": 0}


@torch.no_grad()
def decode_step(model: LM, token: torch.Tensor, cache: dict):
    """One token with the KV cache. token: (B, 1) integers.

    Returns ``(logits (B, 1, vocab) float32, cache)``. The cache is updated
    in place (``ck[:, pos:pos + 1] = k`` where the JAX package makes a new
    array with ``dynamic_update_slice``): the returned dict holds the same
    ``k`` / ``v`` tensors with ``pos`` advanced by one, and the dict passed
    in must not be used again. Attention reads only the first ``pos + 1``
    cache positions (``kv_valid_len``).
    """
    B, S = token.shape
    pos = int(cache["pos"])
    ck, cv = cache["k"], cache["v"]
    if S != 1:
        raise ValueError(f"decode_step takes one token per row, got {S}")
    if ck.dtype != model.dtype or cv.dtype != model.dtype:
        raise ValueError(f"KV cache type {ck.dtype} differs from the "
                         f"model's {model.dtype}")
    if ck.shape[:2] != (model.cfg.n_layers, B) or pos + S > ck.shape[2]:
        raise ValueError(f"cache of shape {tuple(ck.shape)} at pos {pos} "
                         f"cannot take a ({B}, {S}) step")
    positions = torch.full((B, S), pos, dtype=torch.long, device=token.device)
    tables = rope_tables(positions, model.cfg.hd, model.cfg.rope_theta)
    x = model.embed[token]
    for i, lp in enumerate(model.layers):
        x = _layer(x, lp, model.cfg, tables, cache=(ck[i], cv[i], pos))
    x = rmsnorm(x, model.final_norm)
    logits = (x @ model.unembed_weight()).float()
    return logits, {"k": ck, "v": cv, "pos": pos + 1}
