"""MoE FFN (moonshot-v1-16b-a3b: 64 experts top-6; olmoe-1b-7b: 64 top-8).

Counterpart of ``repro/models/moe.py``, as plain functions on tensors:
grouped sort-based dispatch with a static capacity (no (T, E, C) one-hot
tensors). The T tokens are split into ``G = gcd(T, groups)`` groups of
``Tg`` and each group dispatches locally:

  router top-k -> flat (Tg * k) expert ids -> stable argsort -> rank in
  expert by searchsorted -> capacity mask -> scatter to (G, E, C, D) ->
  grouped expert products -> gather back -> gate-weighted combine (drops
  give 0).

with ``C = max(int(Tg * k / E * capacity_factor), 1)`` in the same Python
float arithmetic as the JAX function: :func:`moe_route`,
:func:`moe_dispatch`, :func:`moe_experts` and :func:`moe_combine`, which
:func:`moe_ffn` composes on one device. Over a layout
(``transformer.LM(..., mesh=...)``) each slot routes and dispatches the
groups of its tokens, runs the products of its block of experts on its
slice of the dispatch buffer, and combines after the expert outputs are
gathered over the ``model`` axis, the same functions in the same order;
the groups are the JAX package's all the same, so the same tokens are
dropped. Where the JAX function relies on an order, the port
fixes it:

* top-k: ``jax.lax.top_k`` puts the lower expert id first on ties; here a
  stable descending sort of the probabilities, whose first k are the same
  ids in the same order (ties are real in bf16, where the router logits
  are made in the working type);
* the dispatch sort is stable (``jnp.argsort`` is), and each slot's rank
  comes from ``searchsorted(..., side="left")``;
* the combine adds each token's k contributions onto 0 in ascending
  expert id, in the working type, as the JAX scatter-add applies the
  expert-sorted updates: a gather by token (no atomics) and k sequential
  adds, so the result is deterministic on the card and equal to the JAX
  one in float32.

The backward is as deterministic: every gather that autograd reverses
reads each source row once (the tokens are expanded k-fold before the
sort, and a dropped assignment reads an appended zero row).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..config import LMConfig

__all__ = ["moe_ffn", "moe_ffn_dense_ref", "capacity", "dropped_share",
           "top_k", "Routing", "moe_route", "moe_dispatch", "moe_experts",
           "moe_combine"]


def capacity(T: int, cfg: LMConfig, groups: int) -> tuple[int, int, int]:
    """``(G, Tg, C)``: the groups, tokens per group and expert capacity of
    ``T`` tokens, as ``moe.py:36-39`` computes them."""
    mc = cfg.moe
    G = math.gcd(T, max(groups, 1))
    Tg = T // G
    C = max(int(Tg * mc.top_k / mc.n_experts * mc.capacity_factor), 1)
    return G, Tg, C


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest of the last axis and their indices, the lower index
    first among equal values (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(x: torch.Tensor, router: torch.Tensor, cfg: LMConfig):
    """Router probabilities (float32) and the normalised top-k gates and
    expert ids of the tokens ``x`` (..., D), logits in x's type."""
    logits = (x @ router.to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    gates, eids = top_k(probs, cfg.moe.top_k)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gates, eids


def _dispatch(eids: torch.Tensor, Tg: int, k: int, E: int, C: int):
    """Per group: the stable expert-sorted order of the (Tg * k) flat
    assignments, their expert ids, and each one's slot ``e * C + rank``
    (``E * C`` for an assignment past its expert's capacity)."""
    G = eids.shape[0]
    flat_e = eids.reshape(G, Tg * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    first = torch.searchsorted(se, se, side="left")
    rank = torch.arange(Tg * k, device=eids.device) - first
    keep = rank < C
    slot = torch.where(keep, se * C + rank, torch.full_like(se, E * C))
    return order, slot, keep


class Routing(NamedTuple):
    """One call's routing: the tokens as (G, Tg, D) groups, the router's
    float32 probabilities, the normalised top-k gates and expert ids (G,
    Tg, k), the expert capacity C; then, of the (Tg * k) flat assignments
    of each group, their stable expert-sorted order and each one's slot
    ``e * C + rank`` (``E * C``: dropped past the capacity)."""
    x: torch.Tensor
    probs: torch.Tensor
    gates: torch.Tensor
    eids: torch.Tensor
    C: int
    order: torch.Tensor
    slot: torch.Tensor


def moe_route(h: torch.Tensor, router: torch.Tensor, cfg: LMConfig,
              groups: int) -> Routing:
    """Route the tokens of ``h`` (..., D) in ``G = gcd(T, groups)`` groups
    (:func:`capacity`): the router's top-k and the dispatch order."""
    mc = cfg.moe
    D = h.shape[-1]
    T = h.numel() // D
    G, Tg, C = capacity(T, cfg, groups)
    x = h.reshape(G, Tg, D)
    probs, gates, eids = _route(x, router, cfg)            # (G, Tg, k)
    order, slot, _ = _dispatch(eids, Tg, mc.top_k, mc.n_experts, C)
    return Routing(x, probs, gates, eids, C, order, slot)


def moe_dispatch(r: Routing, cfg: LMConfig) -> torch.Tensor:
    """The (G, E, C, D) dispatch buffer of a routing: each kept
    assignment's token in its expert's slot, zeros elsewhere."""
    G, Tg, D = r.x.shape
    k, E = cfg.moe.top_k, cfg.moe.n_experts
    # the tokens expanded k-fold (assignment t * k + j is token t), then
    # sorted by expert: x[st] of the JAX function
    xk = r.x[:, :, None, :].expand(G, Tg, k, D).reshape(G, Tg * k, D)
    xs = torch.gather(xk, 1, r.order[..., None].expand(G, Tg * k, D))
    disp = r.x.new_zeros((G, E * r.C + 1, D)).scatter(
        1, r.slot[..., None].expand(G, Tg * k, D), xs)
    return disp[:, :-1].reshape(G, E, r.C, D)


def moe_experts(disp: torch.Tensor, e_gate: torch.Tensor,
                e_up: torch.Tensor, e_down: torch.Tensor) -> torch.Tensor:
    """The grouped expert products of a dispatch buffer (G, E', C, D)
    with E' experts' weights (any float type, cast to the buffer's):
    (G, E', C, D)."""
    dt = disp.dtype
    g = F.silu(torch.einsum("gecd,edf->gecf", disp, e_gate.to(dt)))
    u = torch.einsum("gecd,edf->gecf", disp, e_up.to(dt))
    return torch.einsum("gecf,efd->gecd", g * u, e_down.to(dt))


def moe_combine(eo: torch.Tensor, r: Routing, k: int) -> torch.Tensor:
    """The gate-weighted combine of the expert outputs (G, E, C, D) back
    onto the tokens: (G, Tg, D)."""
    G, Tg, D = r.x.shape
    dt = eo.dtype
    EC = eo.shape[1] * eo.shape[2]
    # each sorted assignment's expert output (the zero row for a drop)
    # times its gate, in the working type ...
    flat_out = torch.cat([eo.reshape(G, EC, D), eo.new_zeros((G, 1, D))],
                         dim=1)
    back = torch.gather(flat_out, 1, r.slot[..., None].expand(G, Tg * k, D))
    sg = torch.gather(r.gates.reshape(G, Tg * k), 1, r.order)
    contrib = back * sg[..., None].to(dt)
    # ... then per token its k assignments in sorted position (ascending
    # expert id), added onto 0 one at a time
    st = torch.div(r.order, k, rounding_mode="floor")
    by_token = torch.argsort(st, dim=-1, stable=True).reshape(G, Tg, k)
    parts = torch.gather(contrib, 1, by_token.reshape(G, Tg * k, 1)
                         .expand(G, Tg * k, D)).reshape(G, Tg, k, D)
    out = torch.zeros((G, Tg, D), dtype=dt, device=eo.device)
    for j in range(k):
        out = out + parts[:, :, j]
    return out


def moe_ffn(h: torch.Tensor, lp, cfg: LMConfig, groups: int = 16):
    """h: (B, S, D) -> ((B, S, D), aux loss float32 scalar).

    ``lp`` maps ``router`` (D, E), ``e_gate`` / ``e_up`` (E, D, F) and
    ``e_down`` (E, F, D) to tensors of any float type (cast to h's type at
    use, as the JAX function casts its float32 masters)."""
    mc = cfg.moe
    E, k = mc.n_experts, mc.top_k
    r = moe_route(h, lp["router"], cfg, groups)
    T = h.numel() // h.shape[-1]

    # aux load-balance loss (Switch): E * sum_e f_e * p_e
    me = r.probs.mean(dim=(0, 1))
    ce = (r.eids.reshape(-1, 1) == torch.arange(E, device=h.device)) \
        .sum(0).float() / (T * k)
    aux = E * torch.sum(me * ce)

    eo = moe_experts(moe_dispatch(r, cfg), lp["e_gate"], lp["e_up"],
                     lp["e_down"])
    return moe_combine(eo, r, k).reshape(h.shape), aux


def dropped_share(h: torch.Tensor, lp, cfg: LMConfig,
                  groups: int = 16) -> float:
    """The share of the (T * k) top-k assignments of ``h`` (B, S, D) that
    :func:`moe_ffn` drops at its capacity (they give 0)."""
    B, S, D = h.shape
    G, Tg, C = capacity(B * S, cfg, groups)
    _, _, eids = _route(h.reshape(G, Tg, D), lp["router"], cfg)
    _, _, keep = _dispatch(eids, Tg, cfg.moe.top_k, cfg.moe.n_experts, C)
    return float((~keep).float().mean())


def moe_ffn_dense_ref(h: torch.Tensor, lp, cfg: LMConfig) -> torch.Tensor:
    """Oracle: every expert evaluated densely in float32, weighted by the
    router's normalised top-k gates (routing in float32 too); no capacity,
    so nothing is dropped. Cast to h's type."""
    mc = cfg.moe
    B, S, D = h.shape
    x = h.reshape(B * S, D).float()
    logits = x @ lp["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gates, eids = top_k(probs, mc.top_k)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    w = torch.zeros_like(probs).scatter(1, eids, gates)
    g = F.silu(torch.einsum("td,edf->tef", x, lp["e_gate"].float()))
    u = torch.einsum("td,edf->tef", x, lp["e_up"].float())
    eo = torch.einsum("tef,efd->ted", g * u, lp["e_down"].float())
    out = torch.einsum("ted,te->td", eo, w)
    return out.reshape(B, S, D).to(h.dtype)
