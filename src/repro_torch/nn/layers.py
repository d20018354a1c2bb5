"""Basic layers: linear, RMSNorm, LayerNorm, gated and plain MLPs
(counterpart of ``repro/nn/layers.py``, same params and casts)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.nn.module import Params, dense_init


def init_linear(generator: torch.Generator, d_in: int, d_out: int,
                bias: bool = False) -> Params:
    p = {"w": dense_init(generator, (d_in, d_out))}
    if bias:
        p["b"] = torch.zeros(d_out, device=generator.device)
    return p


def linear(params: Params, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """``x @ w (+ b)``: w cast to ``dtype``, the bias to the product's."""
    w = params["w"]
    if dtype is not None:
        w = w.to(dtype)
    y = x @ w
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


def init_rmsnorm(generator: torch.Generator, d: int) -> Params:
    return {"scale": torch.ones(d, device=generator.device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """In f32, then cast back to x's dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * params["scale"]).to(x.dtype)


def init_layernorm(generator: torch.Generator, d: int) -> Params:
    return {"scale": torch.ones(d, device=generator.device),
            "bias": torch.zeros(d, device=generator.device)}


def layernorm(params: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"] + params["bias"]).to(x.dtype)


def init_norm(generator: torch.Generator, d: int, kind: str) -> Params:
    return init_layernorm(generator, d) if kind == "layernorm" else init_rmsnorm(generator, d)


def norm(params: Params, x: torch.Tensor, kind: str) -> torch.Tensor:
    return layernorm(params, x) if kind == "layernorm" else rmsnorm(params, x)


def init_mlp(generator: torch.Generator, d_model: int, d_ff: int,
             act: str = "swiglu") -> Params:
    dev = generator.device
    if act == "swiglu":
        return {"w_gate": dense_init(generator, (d_model, d_ff)),
                "w_up": dense_init(generator, (d_model, d_ff)),
                "w_down": dense_init(generator, (d_ff, d_model))}
    return {"w_up": dense_init(generator, (d_model, d_ff)),
            "b_up": torch.zeros(d_ff, device=dev),
            "w_down": dense_init(generator, (d_ff, d_model)),
            "b_down": torch.zeros(d_model, device=dev)}


def mlp(params: Params, x: torch.Tensor, act: str = "swiglu") -> torch.Tensor:
    dt = x.dtype
    if act == "swiglu":
        g = x @ params["w_gate"].to(dt)
        u = x @ params["w_up"].to(dt)
        return (F.silu(g) * u) @ params["w_down"].to(dt)
    h = F.gelu(x @ params["w_up"].to(dt) + params["b_up"].to(dt), approximate="tanh")
    return h @ params["w_down"].to(dt) + params["b_down"].to(dt)
