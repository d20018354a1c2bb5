"""Top-k Mixture-of-Experts FFN (counterpart of ``repro/nn/moe.py``).

Dispatch is sort-based: the (token, slot) assignments are flattened,
sorted by expert id (stably, as ``jnp.argsort`` sorts), run through each
expert's gated FFN as one product per expert group (``jax.lax.ragged_dot``
in the JAX package; here ``torch.matmul`` over each group's rows, whose
sizes are read back to the host once a layer), and combined weighted by
the router probabilities.

The combine is written without an accumulating scatter.  JAX adds the k
rows of each token with ``out.at[t].add``; ``index_add_`` on CUDA (and an
accumulating ``index_put_`` on several CPU threads) adds repeats in an
order that changes from run to run.  Every token has exactly k rows, so
the sort is inverted instead: each token's k rows are gathered back (a
permutation) and summed in ascending expert order, the order in which
JAX's scatter meets them.  The rows enter the sort as k expanded copies of
each token, so that gather's backward is a permutation too, and the
expand's sums each token's k copies in a fixed order.  Two runs give the
same bits.

Three entry points:
  * ``moe_ffn``        the sorted dispatch, one device, no token dropping;
  * ``moe_dense_ffn``  every expert on every token, the router weights
    zeroing the ones not chosen (granite's training profile: fine-grained
    experts too small to win from the sort);
  * ``moe_ffn_ep``     ``moe_ffn`` without a mesh, as the JAX package's is;
    its expert-parallel branch comes with the LM across ranks.

The padded experts (``n_experts_padded``) carry weights, so both packages'
params have one shape, but their router logits are masked to -1e30 and no
row is ever routed to them.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.nn.module import Params, dense_init
from repro_torch.parallel.sharding import data_axis_size

EP_ITEM = "the LM across ranks (ROADMAP A.18)"


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                  # per-expert hidden
    n_experts: int             # logical experts
    top_k: int
    n_experts_padded: int = 0  # 0 => n_experts
    capacity_factor: float = 1.25
    act: str = "swiglu"
    router_dtype: str = "float32"
    impl: str = "ep"           # "ep" (sorted dispatch here) | "dense" (moe_dense_ffn)

    @property
    def e_pad(self) -> int:
        return self.n_experts_padded or self.n_experts


def init_moe(generator: torch.Generator, cfg: MoEConfig) -> Params:
    E, D, Fd = cfg.e_pad, cfg.d_model, cfg.d_ff
    return {
        "router": dense_init(generator, (D, E)),
        "w_gate": dense_init(generator, (E, D, Fd)),
        "w_up": dense_init(generator, (E, D, Fd)),
        "w_down": dense_init(generator, (E, Fd, D)),
    }


def _topk_argmax(probs: torch.Tensor, k: int):
    """top-k as k rounds of argmax and mask: ties go to the first index, as
    ``jnp.argmax`` breaks them (``torch.topk`` does not promise an order)."""
    ws, ids = [], []
    p = probs
    for _ in range(k):
        i = torch.argmax(p, dim=-1)
        ws.append(torch.amax(p, dim=-1))
        ids.append(i)
        p = p * (1.0 - F.one_hot(i, p.shape[-1]).to(p.dtype))
    return torch.stack(ws, -1), torch.stack(ids, -1)


def router_probs(params: Params, x: torch.Tensor, cfg: MoEConfig):
    """x (T, D) -> (weights (T, k) in x's dtype, expert ids (T, k) int64).
    Softmax over the real experts (the padded ones at -1e30), top-k
    renormalised."""
    rdt = getattr(torch, cfg.router_dtype)
    logits = x.to(rdt) @ params["router"].to(rdt)
    if cfg.e_pad != cfg.n_experts:
        pad = torch.arange(cfg.e_pad, device=x.device) >= cfg.n_experts
        logits = logits.masked_fill(pad, -1e30)
    probs = torch.softmax(logits, dim=-1)
    w, idx = _topk_argmax(probs, cfg.top_k)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return w.to(x.dtype), idx


def _expert_ffn(xs: torch.Tensor, wg, wu, wd, act: str) -> torch.Tensor:
    """One expert's FFN over its rows (rows, D); weights cast to xs's dtype."""
    dt = xs.dtype
    if act == "swiglu":
        h = F.silu(xs @ wg.to(dt)) * (xs @ wu.to(dt))
    else:
        h = F.gelu(xs @ wu.to(dt), approximate="tanh")
    return h @ wd.to(dt)


def _grouped_ffn(xs: torch.Tensor, group_sizes, params: Params, cfg: MoEConfig) -> torch.Tensor:
    """xs (R, D) rows sorted by expert; ``group_sizes`` host ints, one an
    expert.  One product per non-empty group; the rows are split and the
    weights unbound once, so their backwards concatenate and stack once."""
    wg = params["w_gate"].unbind(0) if cfg.act == "swiglu" else [None] * cfg.e_pad
    wu, wd = params["w_up"].unbind(0), params["w_down"].unbind(0)
    return torch.cat([_expert_ffn(rows, wg[e], wu[e], wd[e], cfg.act)
                      for e, rows in enumerate(xs.split(group_sizes)) if rows.shape[0]],
                     dim=0)


def moe_ffn(params: Params, x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """One device, no dropping.  x (T, D) -> (T, D)."""
    T, D = x.shape
    k = cfg.top_k
    w, idx = router_probs(params, x, cfg)
    order = torch.argsort(idx.reshape(-1), stable=True)          # (T*k,) flat (t, slot)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=x.device)
    # the k copies of each token in sorted order: a permutation of the
    # expanded rows, so the backward sums each token's k copies in a fixed order
    xs = x[:, None, :].expand(T, k, D).reshape(T * k, D).index_select(0, order)
    sizes = torch.bincount(idx.reshape(-1), minlength=cfg.e_pad).tolist()
    ys = _grouped_ffn(xs, sizes, params, cfg)
    ys = ys * w.reshape(-1).index_select(0, order)[:, None]
    # each token's rows back, in ascending sorted position (ascending expert)
    pos = inv.reshape(T, k).sort(dim=1).values
    rows = ys.index_select(0, pos.reshape(-1)).reshape(T, k, D)
    out = rows[:, 0]
    for j in range(1, k):
        out = out + rows[:, j]
    return out


def moe_dense_ffn(params: Params, x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """Every real expert on every token; the router weights zero the ones
    not chosen.  FLOPs are E/top_k times the sorted dispatch's, with no
    host read-back and no gather.  The (T, E, F) hidden is the largest
    tensor held, as in the JAX version's ``"tef,te,efd->td"``: it is
    weighted first, then one (T, E*F) x (E*F, D) product sums the experts."""
    E, D, Fd = cfg.n_experts, cfg.d_model, cfg.d_ff
    dt = x.dtype
    T = x.shape[0]
    w, idx = router_probs(params, x, cfg)
    wfull = torch.zeros((T, E), dtype=dt, device=x.device).scatter(1, idx, w)

    def experts_in(name):          # (E, D, F) -> (D, E*F)
        return params[name][:E].to(dt).permute(1, 0, 2).reshape(D, E * Fd)

    if cfg.act == "swiglu":
        h = F.silu(x @ experts_in("w_gate")) * (x @ experts_in("w_up"))
    else:
        h = F.gelu(x @ experts_in("w_up"), approximate="tanh")
    h = (h.reshape(T, E, Fd) * wfull[:, :, None]).reshape(T, E * Fd)
    return h @ params["w_down"][:E].to(dt).reshape(E * Fd, D)


def moe_ffn_ep(params: Params, x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """Expert-parallel MoE.  Without an active mesh of more than one rank it
    is ``moe_ffn``, as the JAX package's is without a mesh; across ranks it
    raises until the LM's sharding rules are ported."""
    if data_axis_size() == 1:
        return moe_ffn(params, x, cfg)
    raise NotImplementedError(f"expert-parallel MoE comes with {EP_ITEM}")
