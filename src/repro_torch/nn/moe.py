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
  * ``moe_ffn_ep``     expert parallelism under a ``ShardPlan`` whose model
    axis splits the experts: each model rank runs only the assignments
    routed to its experts, at most ``cap_e`` rows an expert (GShard-style
    dropping, the capacity counted against the rank's own rows), and the
    ranks' partial outputs are added over ``model`` in rank order; without
    such a plan, ``moe_ffn``, as the JAX package's is without a mesh.
    ``moe_ffn_ep_reference`` is its plain one-process version: the same
    partials for every data and expert shard, added in rank order.

Each expert's window of the rows sorted by local expert is ``cap_e`` rows
from the expert's first row, its start clamped to ``T*k - cap_e`` as
``jax.lax.dynamic_slice`` clamps it: a late expert's window shifts left,
the rows in it that belong to another expert are masked, and an expert's
rows past ``cap_e`` are dropped, as in JAX.  The masked rows are read from
and added to a zero row past the tokens, so every other row of the output
is added to once an expert, and two runs give the same bits.

The padded experts (``n_experts_padded``) carry weights, so both packages'
params have one shape, but their router logits are masked to -1e30 and no
row is ever routed to them.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.nn.module import Params, dense_init
from repro_torch.parallel.tensor import ordered_sum


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
    if params["w_up"].shape[0] != cfg.e_pad:
        raise NotImplementedError("dense-dispatch MoE over a rank's experts: it runs with "
                                  "all experts (Strategy(dp_over_model=True))")
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


def _dense_expert_ffn(xs: torch.Tensor, wg_e, wu_e, wd_e, cfg: MoEConfig) -> torch.Tensor:
    """One expert's FFN over its capacity window (rows, D)."""
    return _expert_ffn(xs, wg_e, wu_e, wd_e, cfg.act)


def ep_capacity(t_local: int, cfg: MoEConfig, e_local: int) -> int:
    """A shard's capacity against its own ``t_local`` rows: its experts'
    share of the rank's ``t_local * top_k`` assignments times the capacity
    factor, plus one, at most all of them (the JAX package's formula)."""
    rows_local = t_local * cfg.top_k
    capacity = int(rows_local * e_local / cfg.e_pad * cfg.capacity_factor) + 1
    return min(capacity, rows_local)


def _ep_local_ffn(x: torch.Tensor, w: torch.Tensor, idx: torch.Tensor, params_local: Params,
                  cfg: MoEConfig, e_local: int, capacity: int, shard: int) -> torch.Tensor:
    """One EP shard's partial output (T, D): experts [shard * e_local, (shard
    + 1) * e_local), each one dense product over its window of ``cap_e =
    capacity // e_local`` rows."""
    T, D = x.shape
    k = cfg.top_k
    n = T * k
    dev = x.device
    e_flat = idx.reshape(-1) - shard * e_local                 # local ids
    t_flat = torch.arange(T, device=dev).repeat_interleave(k)
    w_flat = w.reshape(-1)
    local = (e_flat >= 0) & (e_flat < e_local)
    e_key = torch.where(local, e_flat, torch.full_like(e_flat, e_local))
    order = torch.argsort(e_key, stable=True)
    e_s, t_s = e_key[order], t_flat[order]
    w_s = torch.where(e_s < e_local, w_flat[order], torch.zeros_like(w_flat))
    cap_e = max(1, capacity // e_local)
    # the rows a local id holds (bincount's values; its output shape is
    # data-dependent, this one's is not)
    sizes = torch.zeros(e_local + 1, dtype=e_s.dtype, device=dev).scatter_add_(
        0, e_s, torch.ones_like(e_s))
    starts = torch.clamp(torch.cumsum(sizes, 0) - sizes, max=n - cap_e)[:e_local]
    win = starts[:, None] + torch.arange(cap_e, device=dev)[None, :]   # (e_local, cap_e)
    rows_t, rows_w, rows_e = t_s[win], w_s[win], e_s[win]
    valid = rows_e == torch.arange(e_local, device=dev)[:, None]
    rows = torch.where(valid, rows_t, torch.full_like(rows_t, T))     # masked: the zero row
    weight = rows_w * valid.to(rows_w.dtype)
    x_pad = torch.cat([x, x.new_zeros(1, D)])
    wg = params_local["w_gate"].unbind(0) if cfg.act == "swiglu" else [None] * e_local
    wu, wd = params_local["w_up"].unbind(0), params_local["w_down"].unbind(0)
    out = x.new_zeros(T + 1, D)
    for e in range(e_local):
        ys = _dense_expert_ffn(x_pad.index_select(0, rows[e]), wg[e], wu[e], wd[e], cfg)
        out = out.index_add(0, rows[e], ys * weight[e][:, None])
    return out[:T]


def moe_ffn_ep(params: Params, x: torch.Tensor, cfg: MoEConfig, plan=None) -> torch.Tensor:
    """Expert-parallel MoE.  ``moe_ffn`` without a plan or where the model
    axis does not split the experts (``params`` hold all ``e_pad``); else
    ``params`` hold this rank's experts (their FSDP dim gathered), ``x``
    this rank's rows: the router runs on every model rank, each rank runs
    its experts on the rows routed to them, and the partial outputs are
    added over ``model``."""
    e_local = params["w_up"].shape[0]
    if plan is None or e_local == cfg.e_pad:
        return moe_ffn(params, x, cfg)
    w, idx = router_probs(params, x, cfg)
    capacity = ep_capacity(x.shape[0], cfg, e_local)
    out = _ep_local_ffn(plan.enter(x), plan.enter(w), idx, params, cfg, e_local,
                        capacity, plan.tp_index)
    return plan.exit(out)


def moe_ffn_ep_reference(params: Params, x: torch.Tensor, cfg: MoEConfig, ep: int,
                         data_shards: int) -> torch.Tensor:
    """``moe_ffn_ep``'s plain one-process version: ``x`` (T, D) split in
    ``data_shards`` blocks of rows, each routed on its own, each block's
    partial outputs of the ``ep`` expert shards added in rank order, the
    blocks concatenated.  ``params`` hold all experts."""
    T = x.shape[0]
    t_local = T // data_shards
    e_local = cfg.e_pad // ep
    capacity = ep_capacity(t_local, cfg, e_local)
    outs = []
    for d in range(data_shards):
        xd = x[d * t_local:(d + 1) * t_local]
        w, idx = router_probs(params, xd, cfg)
        parts = [_ep_local_ffn(xd, w, idx, {name: params[name][s * e_local:(s + 1) * e_local]
                                            for name in ("w_gate", "w_up", "w_down")},
                               cfg, e_local, capacity, s) for s in range(ep)]
        outs.append(ordered_sum(parts))
    return torch.cat(outs)
