"""Plain PyTorch reference of the full-graph GCN cells: Algorithm 1 over
the graph, the decode, the decoder MLP, the two GCN layers with their
sparse products, the loss, the gradients and AdamW.  It imports nothing of
the program and takes nothing the program made: it is handed the
benchmark's edge list, labels, weights and LSH projections, and works
out the codes, the normalised adjacency and the split again.

``mm`` is the matrix product every dense layer goes through:
``exact_mm`` in float32 (TF32 off), or ``tf32_mm``, the control, whose
operands are rounded to TF32's 10-bit mantissa in the forward and in
both products of the backward, as the tensor cores round them.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]


def exact_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties to even), still as float32."""
    bits = x.contiguous().view(torch.int32)
    bias = 0xFFF + ((bits >> 13) & 1)
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


class _TF32Product(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32_round(a) @ tf32_round(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32_round(g)
        return g @ tf32_round(b).t(), tf32_round(a).t() @ g


def tf32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _TF32Product.apply(a, b)


def split(seed: int, n: int, frac) -> List[np.ndarray]:
    """Train, val and test node ids: one permutation of the nodes from
    ``seed``, cut at ``int(frac[0] * n)`` and ``int(frac[1] * n)``."""
    perm = np.random.default_rng(seed).permutation(n)
    a, b = int(frac[0] * n), int(frac[1] * n)
    return [perm[:a], perm[a:a + b], perm[a + b:]]


def lsh_codes(src: torch.Tensor, dst: torch.Tensor, n: int, V: torch.Tensor,
              c: int, m: int) -> torch.Tensor:
    """Algorithm 1 with A the 0/1 adjacency: U = A V; bit k of a node is
    U[:, k] above its median over the nodes (the mean of the two middle
    values for an even count); code j is bits 8j .. 8j+7, most significant
    first (for c = 256).  (n, m) int64."""
    U = torch.zeros(n, V.shape[1], dtype=torch.float32, device=V.device)
    U.index_add_(0, src, V[dst])
    U.index_add_(0, dst, V[src])
    s = torch.sort(U, dim=0).values
    median = (s[(n - 1) // 2] + s[n // 2]) * 0.5
    b = int(c).bit_length() - 1
    bits = (U > median).to(torch.int64).reshape(n, m, b)
    weights = 2 ** torch.arange(b - 1, -1, -1, device=V.device)
    return (bits * weights).sum(-1)


def gcn_adjacency(src: torch.Tensor, dst: torch.Tensor, n: int):
    """D^-1/2 (A + I) D^-1/2 as (rows, cols, values), the degrees counted
    with the self loop, each value 1 / sqrt(d_i d_j) in float32."""
    loops = torch.arange(n, device=src.device)
    rows = torch.cat([src, dst, loops])
    cols = torch.cat([dst, src, loops])
    deg = torch.bincount(rows, minlength=n).to(torch.float32)
    return rows, cols, 1.0 / torch.sqrt(deg[rows] * deg[cols])


def propagate(adj, X: torch.Tensor) -> torch.Tensor:
    rows, cols, vals = adj
    return torch.zeros_like(X).index_add(0, rows, vals[:, None] * X[cols])


def forward(w: Weights, codes: torch.Tensor, adj, n_layers: int,
            mm: Callable = exact_mm) -> torch.Tensor:
    """Logits of every node: decode, MLP, two GCN layers, output layer."""
    h = w["codebooks"][0][codes[:, 0]]
    for j in range(1, codes.shape[1]):
        h = h + w["codebooks"][j][codes[:, j]]
    for i in range(n_layers):
        h = mm(h, w[f"dec.w{i}"]) + w[f"dec.b{i}"]
        if i < n_layers - 1:
            h = torch.relu(h)
    h = torch.relu(mm(propagate(adj, h), w["gcn.w1"]) + w["gcn.b1"])
    h = mm(propagate(adj, h), w["gcn.w2"]) + w["gcn.b2"]
    return mm(h, w["out.w"]) + w["out.b"]


def train(w0: Weights, codes: torch.Tensor, adj, ids: torch.Tensor, labels: torch.Tensor,
          n_layers: int, opt: dict, steps: int, mm: Callable = exact_mm) -> dict:
    """``steps`` AdamW steps from ``w0`` (left unchanged) on the mean
    cross-entropy of the nodes ``ids``: each step's loss, every leaf's
    first gradient norm and every leaf's change norm after the steps."""
    w = {k: v.detach().clone() for k, v in w0.items()}
    mu = {k: torch.zeros_like(v) for k, v in w.items()}
    nu = {k: torch.zeros_like(v) for k, v in w.items()}
    losses, grad_norms = [], {}
    for t in range(1, steps + 1):
        leaves = {k: v.detach().requires_grad_(True) for k, v in w.items()}
        logits = forward(leaves, codes, adj, n_layers, mm)
        loss = F.cross_entropy(logits[ids], labels[ids])
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        losses.append(float(loss.detach()))
        if t == 1:
            grad_norms = {k: float(torch.linalg.vector_norm(g.double())) for k, g in grads.items()}
        with torch.no_grad():
            for k, g in grads.items():
                mu[k] = opt["b1"] * mu[k] + (1 - opt["b1"]) * g
                nu[k] = opt["b2"] * nu[k] + (1 - opt["b2"]) * g * g
                upd = (mu[k] / (1 - opt["b1"] ** t)) / (
                    torch.sqrt(nu[k] / (1 - opt["b2"] ** t)) + opt["eps"])
                w[k] = w[k] - opt["lr"] * (upd + opt["weight_decay"] * w[k])
    deltas = {k: float(torch.linalg.vector_norm((w[k] - w0[k]).double())) for k in w}
    return {"losses": losses, "grad_norms": grad_norms, "delta_norms": deltas}

