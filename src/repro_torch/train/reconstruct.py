"""Decoder training on pre-trained embedding reconstruction (paper §5.1,
Fig. 1 and Table 5); counterpart of ``benchmarks/fig1_reconstruction.py``'s
``_train_decoder_on_reconstruction``, with the port's own copies of the
benchmark's k-means and NMI (``benchmarks/common.py``, numpy, paper
§B.1.4's evaluation).

The decoder is a ``random_full`` embedding whose codes are injected (random,
hashing or learned), looked up with ``lookup_impl="auto"``: on a CUDA card
the decode and its backward are the ``hash_decode`` kernel and its
``torch.autograd.Function``.  Loss: mean squared error against the target
rows; optimizer: AdamW (lr 1e-3, weight decay 0.01, paper §B.2); 512
random ids a step, drawn from the generator or injected (``ids``), which is
how the parity tests hand both packages the same batches.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.decoder import Params
from repro_torch.core.embedding import EmbeddingConfig, embed_lookup, init_embedding
from repro_torch.nn.module import value_and_grad
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update

BATCH = 512


def reconstruction_config(n: int, d_e: int, c: int, m: int, d_c: int,
                          d_m: int) -> EmbeddingConfig:
    return EmbeddingConfig(kind="random_full", n_entities=n, d_e=d_e, c=c, m=m,
                           d_c=d_c, d_m=d_m, lookup_impl="auto",
                           compute_dtype="float32")


def train_decoder_on_reconstruction(
    generator: torch.Generator, emb_target: torch.Tensor, codes: torch.Tensor,
    cfg: EmbeddingConfig, steps: int = 300, *,
    params: Optional[Params] = None,
    ids: Optional[Sequence[torch.Tensor]] = None,
) -> Tuple[Params, List[float]]:
    """Train the decoder of ``cfg`` (codes ``codes`` injected) to
    reconstruct ``emb_target`` (n, d_e); returns (params, per-step losses,
    each taken before its step's update).  The init and the ids come from
    ``generator`` unless ``params`` or ``ids`` (one (512,) entry per step)
    are given."""
    if params is None:
        params = init_embedding(generator, cfg, codes=codes)
    ostate = adamw_init(params)
    ocfg = AdamWConfig(lr=1e-3, weight_decay=0.01)
    n, dev = emb_target.shape[0], emb_target.device
    losses = []
    for i in range(steps):
        idx = (ids[i].to(dev, torch.int64) if ids is not None else torch.randint(
            0, n, (BATCH,), generator=generator, device=dev))
        tgt = emb_target[idx]
        loss, grads = value_and_grad(
            lambda p: torch.mean((embed_lookup(p, idx, cfg) - tgt) ** 2), params)
        adamw_update(params, grads, ostate, ocfg)
        losses.append(loss)
    return params, [float(x) for x in losses]


def kmeans(x: np.ndarray, k: int, iters: int = 30, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centers = x[rng.choice(x.shape[0], k, replace=False)].copy()
    assign = np.zeros(x.shape[0], np.int64)
    for _ in range(iters):
        d = ((x[:, None, :] - centers[None]) ** 2).sum(-1)
        new_assign = d.argmin(1)
        if (new_assign == assign).all():
            break
        assign = new_assign
        for j in range(k):
            pts = x[assign == j]
            if len(pts):
                centers[j] = pts.mean(0)
    return assign


def nmi(a: np.ndarray, b: np.ndarray) -> float:
    """Normalized mutual information (sqrt normalisation)."""
    a = np.asarray(a)
    b = np.asarray(b)
    n = a.shape[0]
    ua, ub = np.unique(a), np.unique(b)
    cont = np.zeros((len(ua), len(ub)))
    for i, x in enumerate(ua):
        for j, y in enumerate(ub):
            cont[i, j] = np.sum((a == x) & (b == y))
    p = cont / n
    pa = p.sum(1, keepdims=True)
    pb = p.sum(0, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        mi = np.nansum(p * np.log(p / (pa @ pb)))
        ha = -np.nansum(pa * np.log(pa))
        hb = -np.nansum(pb * np.log(pb))
    return float(mi / max(np.sqrt(ha * hb), 1e-12))
