"""Plain PyTorch reference of the LM training cells, in float32 (TF32 off):
Algorithm 1 over the vocabulary's co-occurrence matrix, the compressed
embedding (codebook sum and decoder MLP), RMSNorm, grouped-query causal
attention under rotary positions, the top-k mixture of experts (a
softmax over the real experts, the top k renormalised, each expert's
SwiGLU on the tokens routed to it), the head, the next-token
cross-entropy over the real vocabulary, the gradients, the global-norm
clip, the warm-up and cosine schedule, and AdamW with its moments stored
in the configuration's dtype.  Each layer is checkpointed so the
backward fits beside the weights.  It imports nothing of the program
and takes nothing it made: it is handed the benchmark's co-occurrence
matrix, projections, weights and batches.

``mm`` is every matrix product's: ``exact_mm`` in float32, or
``fp8_mm``, the control, whose operands are rounded to float8 e4m3 (each
scaled by its largest magnitude to 448 first) in the forward and in both
products of the backward: the precision below the configuration's
bfloat16.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Weights = Dict[str, torch.Tensor]
E4M3_MAX = 448.0


def exact_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x at float8 e4m3's precision, scaled to its range and back."""
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, E4M3_MAX / amax, torch.ones_like(amax))
    return ((x.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(x.dtype)


class _FP8Product(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return fp8_round(a) @ fp8_round(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = fp8_round(g)
        return g @ fp8_round(b).transpose(-1, -2), fp8_round(a).transpose(-1, -2) @ g


def fp8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _FP8Product.apply(a, b)


def lsh_codes(aux: torch.Tensor, V: torch.Tensor, c: int, m: int) -> torch.Tensor:
    """Algorithm 1: U = A V (in float64); bit k is U[:, k] above its median
    over the rows (the mean of the two middle values for an even count);
    code j is bits b j .. b j + b - 1, most significant first, b = log2 c.
    (rows, m) int64."""
    U = aux.double() @ V.double()
    n = U.shape[0]
    s = torch.sort(U, dim=0).values
    median = (s[(n - 1) // 2] + s[n // 2]) * 0.5
    b = int(c).bit_length() - 1
    bits = (U > median).to(torch.int64).reshape(n, m, b)
    return (bits * 2 ** torch.arange(b - 1, -1, -1, device=U.device)).sum(-1)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half rotary embedding of x (B, S, heads, Dh) at positions 0..S-1."""
    S, Dh = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, Dh, 2, dtype=torch.float32, device=x.device) / Dh)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def layer(x, w: Weights, cfg: dict, mm: Callable):
    B, S, D = x.shape
    H, K = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    Dh, eps = D // H, cfg["rms_norm_eps"]
    h = rmsnorm(x, w["norm1.scale"], eps)
    q = rope(mm(h, w["attn.wq.w"]).reshape(B, S, H, Dh), cfg["rope_theta"])
    k = rope(mm(h, w["attn.wk.w"]).reshape(B, S, K, Dh), cfg["rope_theta"])
    v = mm(h, w["attn.wv.w"]).reshape(B, S, K, Dh)
    g = H // K
    q = q.reshape(B, S, K, g, Dh).permute(0, 2, 3, 1, 4)           # (B, K, g, S, Dh)
    k = k.permute(0, 2, 1, 3)[:, :, None].expand(B, K, g, S, Dh)
    v = v.permute(0, 2, 1, 3)[:, :, None].expand(B, K, g, S, Dh)
    scores = mm(q, k.transpose(-1, -2)) / math.sqrt(Dh)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    p = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    o = mm(p, v).permute(0, 3, 1, 2, 4).reshape(B, S, H * Dh)
    x = x + mm(o, w["attn.wo.w"])

    h = rmsnorm(x, w["norm2.scale"], eps).reshape(B * S, D)
    E, k_top = cfg["num_local_experts"], cfg["num_experts_per_tok"]
    probs = torch.softmax(mm(h, w["moe.router"])[:, :E], dim=-1)
    top, idx = probs.topk(k_top, dim=-1)
    top = top / top.sum(-1, keepdim=True)
    y = torch.zeros_like(h)
    for e in range(E):
        rows, slot = (idx == e).nonzero(as_tuple=True)
        if rows.numel():
            xe = h[rows]
            he = F.silu(mm(xe, w["moe.w_gate"][e])) * mm(xe, w["moe.w_up"][e])
            y = y.index_add(0, rows, mm(he, w["moe.w_down"][e]) * top[rows, slot, None])
    return x + y.reshape(B, S, D)


def loss(w: Weights, codes: torch.Tensor, batch: dict, cfg: dict, mm: Callable) -> torch.Tensor:
    e = cfg["embedding"]
    tok_codes = codes[batch["tokens"].long()]                       # (B, S, m)
    h = w["embed.decoder.codebooks"][0][tok_codes[..., 0]]
    for j in range(1, e["m"]):
        h = h + w["embed.decoder.codebooks"][j][tok_codes[..., j]]
    for i in range(e["n_layers"]):
        h = mm(h, w[f"embed.decoder.mlp.w{i}"]) + w[f"embed.decoder.mlp.b{i}"]
        if i < e["n_layers"] - 1:
            h = torch.relu(h)
    x = h
    for i in range(cfg["num_hidden_layers"]):
        lw = {k[len("blocks."):]: v[i] for k, v in w.items() if k.startswith("blocks.")}
        x = checkpoint(layer, x, lw, cfg, mm, use_reentrant=False)
    x = rmsnorm(x, w["final_norm.scale"], cfg["rms_norm_eps"])
    logits = mm(x, w["head"])[..., :cfg["vocab_size"]]
    return F.cross_entropy(logits.reshape(-1, cfg["vocab_size"]),
                           batch["labels"].reshape(-1).long())


def lr_scale(step: int, warmup: int, total: int, final_frac: float = 0.1) -> float:
    """Linear warm-up from 1/warmup at step 0, then a cosine to final_frac."""
    if step < warmup:
        return (step + 1.0) / max(warmup, 1)
    t = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return final_frac + (1 - final_frac) * 0.5 * (1 + math.cos(math.pi * t))


def leaf_norm(x: torch.Tensor, y=None, part: int = 1 << 26) -> float:
    """||x - y|| (or ||x||) in float64, a slice at a time."""
    xs = x.reshape(-1).split(part)
    ys = [None] * len(xs) if y is None else y.reshape(-1).split(part)
    total = 0.0
    for a, b in zip(xs, ys):
        d = a.float() if b is None else a.float() - b.float()
        total += float(d.double().square().sum())
    return math.sqrt(total)


def _adamw(p, g, mu, nu, clip: float, lr: float, b1t: float, b2t: float, o: dict,
           part: int = 1 << 26) -> None:
    """One leaf's AdamW update in place, a slice of ``part`` elements at a
    time: the moments read into float32, the parameter stepped from them,
    the moments stored back in their own dtype."""
    for ps, gs, ms, vs in zip(*(t.view(-1).split(part) for t in (p, g, mu, nu))):
        gs = gs * clip
        m_f = ms.float().mul_(o["b1"]).add_(gs, alpha=1 - o["b1"])
        v_f = vs.float().mul_(o["b2"]).addcmul_(gs, gs, value=1 - o["b2"])
        upd = (m_f / b1t).div_(torch.sqrt(v_f / b2t).add_(o["eps"]))
        upd.add_(ps, alpha=o["weight_decay"])
        ps.sub_(upd, alpha=lr)
        ms.copy_(m_f)
        vs.copy_(v_f)


def train(w: Weights, codes: torch.Tensor, batches: List[dict], cfg: dict, steps: int,
          initial: Callable[[str], torch.Tensor], mm: Callable = exact_mm) -> dict:
    """``steps`` steps from ``w`` (updated in place): each step's loss, each
    leaf's first gradient norm as the moments hold it (mu / (1 - b1)) and
    each leaf's change after the steps (``initial(name)`` draws a leaf's
    starting value again)."""
    o = cfg["optimizer"]
    mdt = getattr(torch, cfg["port"]["moments_dtype"])
    mu = {k: torch.zeros_like(v, dtype=mdt) for k, v in w.items()}
    nu = {k: torch.zeros_like(v, dtype=mdt) for k, v in w.items()}
    losses, grad_norms = [], {}
    for t in range(steps):
        leaves = {k: v.requires_grad_(True) for k, v in w.items()}
        value = loss(leaves, codes, batches[t], cfg, mm)
        grads = dict(zip(leaves, torch.autograd.grad(value, list(leaves.values()))))
        losses.append(float(value.detach()))
        with torch.no_grad():
            for v in w.values():
                v.requires_grad_(False)
            gn = math.sqrt(sum(leaf_norm(g) ** 2 for g in grads.values()))
            clip = min(o["clip_norm"] / (gn + 1e-9), 1.0)
            lr = o["lr"] * lr_scale(t, o["warmup_steps"], o["total_steps"])
            b1t, b2t = 1 - o["b1"] ** (t + 1), 1 - o["b2"] ** (t + 1)
            for k in list(grads):
                _adamw(w[k], grads.pop(k), mu[k], nu[k], clip, lr, b1t, b2t, o)
            if t == 0:
                grad_norms = {k: leaf_norm(mu[k]) / (1 - o["b1"]) for k in mu}
    deltas = {k: leaf_norm(w[k], initial(k)) for k in w}
    return {"losses": losses, "grad_norms": grad_norms, "delta_norms": deltas}
