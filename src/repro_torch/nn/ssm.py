"""Mamba2 mixer through the chunked SSD (state-space duality) form
(Dao & Gu, arXiv:2405.21060), counterpart of ``repro/nn/ssm.py``.

The chunked form is matmuls: the intra-chunk term a masked (L x L)
product, the chunk states an einsum, and a short loop over the chunks
carries the (H, N, P) state (``lax.scan`` in the JAX package).  The JAX
package runs it as plain XLA, with no Pallas kernel, and so does the port
in plain PyTorch.

Recurrence (per head h, state N, head channels P):
    S_t = exp(dt_t * A_h) * S_{t-1} + (dt_t * x_t) outer B_t
    y_t = C_t . S_t + D_h * x_t

Shapes: x (B, S, d_inner) viewed as (B, S, H, P); B_t / C_t (B, S, N),
shared across heads (one group); dt (B, S, H); A (H,) negative.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.nn.kvcache import SSMCache
from repro_torch.nn.module import Params, dense_init


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_state: int = 128          # N
    headdim: int = 64           # P
    expand: int = 2
    conv_width: int = 4
    chunk: int = 128            # SSD chunk length L
    dt_min: float = 0.001
    dt_max: float = 0.1

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        assert self.d_inner % self.headdim == 0
        return self.d_inner // self.headdim

    @property
    def conv_channels(self) -> int:
        return self.d_inner + 2 * self.d_state


def init_ssm(generator: torch.Generator, cfg: SSMConfig) -> Params:
    """The JAX package's layout: the projections stored per component
    (``w_z``, ``w_x``, ``w_b``, ``w_c``, ``w_dt``) and two depthwise convs
    (x, and B and C together).  dt's bias is drawn so that softplus of it
    spans [dt_min, dt_max] on a log scale."""
    D, DI, N, H = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.n_heads
    dev = generator.device
    conv_scale = 1.0 / cfg.conv_width ** 0.5
    p = {
        "w_z": dense_init(generator, (D, DI)),
        "w_x": dense_init(generator, (D, DI)),
        "w_b": dense_init(generator, (D, N)),
        "w_c": dense_init(generator, (D, N)),
        "w_dt": dense_init(generator, (D, H)),
        "conv_x_w": dense_init(generator, (cfg.conv_width, DI), scale=conv_scale),
        "conv_x_b": torch.zeros(DI, device=dev),
        "conv_bc_w": dense_init(generator, (cfg.conv_width, 2 * N), scale=conv_scale),
        "conv_bc_b": torch.zeros(2 * N, device=dev),
        "A_log": torch.log(torch.arange(1, H + 1, dtype=torch.float32, device=dev)),
        "D_skip": torch.ones(H, device=dev),
    }
    u = torch.rand(H, generator=generator, device=dev)
    lo, hi = math.log(cfg.dt_min), math.log(cfg.dt_max)
    dt_init = torch.exp(u * (hi - lo) + lo)
    p["dt_bias"] = dt_init + torch.log(-torch.expm1(-dt_init))   # inverse softplus
    p["norm_scale"] = torch.ones(DI, device=dev)
    p["w_out"] = dense_init(generator, (DI, D))
    return p


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: Optional[torch.Tensor] = None):
    """Depthwise causal conv along time.  x (B, S, C); w (W, C).  Returns
    (y (B, S, C), new tail (B, W-1, C): the last W-1 inputs)."""
    W = w.shape[0]
    S = x.shape[1]
    if tail is None:
        tail = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([tail.to(x.dtype), x], dim=1)                 # (B, S+W-1, C)
    y = xp[:, 0:S] * w[0].to(x.dtype)
    for i in range(1, W):
        y = y + xp[:, i:i + S] * w[i].to(x.dtype)
    return y + b.to(x.dtype), xp[:, xp.shape[1] - (W - 1):]


def ssd_chunked(X: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bc: torch.Tensor,
                Cc: torch.Tensor, chunk: int, init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.  X (B, S, H, P) f32; dt (B, S, H) f32 (after the
    softplus); A (H,) negative; Bc / Cc (B, S, N).  Returns (Y (B, S, H, P),
    the final state (B, H, N, P))."""
    B, S, H, Pd = X.shape
    N = Bc.shape[-1]
    L = min(chunk, S)
    assert S % L == 0, (S, L)
    nc = S // L

    la = dt * A[None, None, :]                                   # (B, S, H) <= 0
    cs = torch.cumsum(la.reshape(B, nc, L, H), dim=2)            # inclusive
    Xd = (X * dt[..., None]).reshape(B, nc, L, H, Pd)
    Br = Bc.reshape(B, nc, L, N)
    Cr = Cc.reshape(B, nc, L, N)

    # intra-chunk: the masked product
    G = torch.einsum("bcin,bcjn->bcij", Cr, Br)                  # (B, nc, L, L)
    dec = cs[:, :, :, None, :] - cs[:, :, None, :, :]            # (B, nc, L, L, H) i, j
    # above the diagonal dec >= 0 and exp(dec) can overflow (JAX takes the
    # exp of the whole block, then masks: a NaN gradient at mamba2's 80
    # heads, 0 * inf in the backward); masked to -inf first, the same values
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool, device=X.device))
    M = torch.exp(dec.masked_fill(~causal[None, None, :, :, None], -math.inf))
    scores = G[..., None] * M
    Y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores, Xd)

    # each chunk's own state
    decay_to_end = torch.exp(cs[:, :, -1:, :] - cs)              # (B, nc, L, H)
    S_chunk = torch.einsum("bcln,bclhp->bchnp", Br, Xd * decay_to_end[..., None])

    # across chunks: the state before each chunk
    T_c = torch.exp(cs[:, :, -1, :])                             # (B, nc, H)
    state = (init_state if init_state is not None
             else torch.zeros((B, H, N, Pd), dtype=X.dtype, device=X.device))
    before = []
    for c in range(nc):
        before.append(state)
        state = T_c[:, c, :, None, None] * state + S_chunk[:, c]
    S_prev = torch.stack(before, dim=1)                          # (B, nc, H, N, P)

    Y_inter = torch.einsum("bcln,bchnp->bclhp", Cr, S_prev) * torch.exp(cs)[..., None]
    return (Y_intra + Y_inter).reshape(B, S, H, Pd), state


def ssm_forward(params: Params, x: torch.Tensor, cfg: SSMConfig,
                cache: Optional[SSMCache] = None
                ) -> Tuple[torch.Tensor, Optional[SSMCache]]:
    """The whole mixer.  x (B, S, D).  With a cache and S == 1, the
    single-step recurrence; with a cache and S > 1 (a prefill), the chunked
    scan from the cache's state.  Returns (y (B, S, D), the new cache or
    None)."""
    Bb, S, _ = x.shape
    dt_all = x.dtype
    DI, N = cfg.d_inner, cfg.d_state
    z = x @ params["w_z"].to(dt_all)
    xc = x @ params["w_x"].to(dt_all)
    Bc = x @ params["w_b"].to(dt_all)
    Cc = x @ params["w_c"].to(dt_all)
    dt = x @ params["w_dt"].to(dt_all)

    tail = cache.conv if cache is not None else None
    tail_x = tail[..., :DI] if tail is not None else None
    tail_bc = tail[..., DI:] if tail is not None else None
    conv_x, new_tail_x = _causal_conv(xc, params["conv_x_w"], params["conv_x_b"], tail_x)
    conv_bc, new_tail_bc = _causal_conv(torch.cat([Bc, Cc], dim=-1), params["conv_bc_w"],
                                        params["conv_bc_b"], tail_bc)
    xc = F.silu(conv_x)
    conv_bc = F.silu(conv_bc)
    Bc, Cc = conv_bc[..., :N], conv_bc[..., N:]
    new_tail = torch.cat([new_tail_x, new_tail_bc], dim=-1) if cache is not None else None

    dt = F.softplus(dt.float() + params["dt_bias"][None, None])
    A = -torch.exp(params["A_log"])                              # (H,) < 0
    H, Pd = cfg.n_heads, cfg.headdim
    X = xc.reshape(Bb, S, H, Pd).float()
    Bf, Cf = Bc.float(), Cc.float()

    if cache is not None and S == 1:
        a = torch.exp(dt[:, 0] * A[None, :])                     # (B, H)
        Xd0 = X[:, 0] * dt[:, 0][..., None]                      # (B, H, P)
        state = (cache.state * a[:, :, None, None]
                 + torch.einsum("bn,bhp->bhnp", Bf[:, 0], Xd0))
        y = torch.einsum("bn,bhnp->bhp", Cf[:, 0], state)[:, None]   # (B, 1, H, P)
        new_cache = SSMCache(state=state, conv=new_tail)
    else:
        init = cache.state if cache is not None else None
        y, final_state = ssd_chunked(X, dt, A, Bf, Cf, cfg.chunk, init)
        new_cache = SSMCache(state=final_state, conv=new_tail) if cache is not None else None

    y = y + params["D_skip"].to(y.dtype)[None, None, :, None] * X
    y = y.reshape(Bb, S, DI).to(dt_all)

    # gated RMSNorm (mamba2): norm(y * silu(z)) * scale
    y = y * F.silu(z)
    yf = y.float()
    var = yf.square().mean(dim=-1, keepdim=True)
    y = (yf * torch.rsqrt(var + 1e-6) * params["norm_scale"]).to(dt_all)
    return y @ params["w_out"].to(dt_all), new_cache


def ssd_reference(X, dt, A, Bc, Cc) -> torch.Tensor:
    """The plain per-step recurrence, O(S) steps: the tests' oracle."""
    B, S, H, Pd = X.shape
    N = Bc.shape[-1]
    state = torch.zeros((B, H, N, Pd), dtype=torch.float32, device=X.device)
    ys = []
    for t in range(S):
        a = torch.exp(dt[:, t] * A[None, :])                     # (B, H)
        state = state * a[:, :, None, None] + torch.einsum(
            "bn,bhp->bhnp", Bc[:, t], X[:, t] * dt[:, t][..., None])
        ys.append(torch.einsum("bn,bhnp->bhp", Cc[:, t], state))
    return torch.stack(ys, dim=1)
