"""Embedding-reconstruction front door (paper §5.1, Fig. 1 and Table 5);
counterpart of ``examples/reconstruction_demo.py`` and of one entity count
of ``benchmarks/fig1_reconstruction.run``.

It generates Gaussian-mixture "pre-trained embeddings"
(``clustered_embeddings``, the offline stand-in for GloVe or metapath2vec),
codes them with each scheme, trains the decoder to reconstruct them, and
prints the last step's MSE and the k-means NMI of the reconstruction on a
fixed 2,000-entity subset, per scheme:

  random   ALONE's uniform codes (the paper's baseline)
  hashing  Algorithm 1 on the embeddings (dense A: on a card, the
           ``lsh_encode`` kernel)
  graph    Algorithm 1 on an SBM adjacency with the embeddings' communities
  learn    the autoencoder's codes (Shu & Nakayama, paper Fig. 1 "learn")

Runs on the CUDA card unless ``--device cpu``.  The defaults are the JAX
benchmark's CPU scale (c=m=16, d_c=d_m=128, dim 64, 300 steps); the
paper's full decoder at GloVe's width is
``--n 200000 --dim 300 --c 256 --m 16 --d-c 512 --d-m 512``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.reconstruct [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core import lsh
from repro_torch.core.autoencoder import (AutoencoderConfig, extract_codes,
                                          train_autoencoder)
from repro_torch.core.decoder import DecoderConfig
from repro_torch.core.embedding import decode_all
from repro_torch.core.memory import compression_ratio
from repro_torch.device import disable_tf32, make_generator, resolve_device
from repro_torch.graph.generate import clustered_embeddings, sbm_graph
from repro_torch.train.reconstruct import (kmeans, nmi, reconstruction_config,
                                           train_decoder_on_reconstruction)

SCHEMES = ("random", "hashing", "graph", "learn")
N_CLUSTERS = 8
NOISE = 0.35
EVAL_N = 2000


def encode(scheme: str, seed: int, emb: torch.Tensor, labels: np.ndarray,
           c: int, m: int, d_c: int, d_m: int, steps: int) -> torch.Tensor:
    """Packed codes (n, n_words) of one scheme, drawn from ``seed``."""
    n, dim = emb.shape
    generator = make_generator(seed, emb.device)
    if scheme == "random":
        return lsh.encode_random(generator, n, c, m)
    if scheme == "hashing":
        return lsh.encode_lsh(emb, c, m, generator=generator)
    if scheme == "graph":
        # the adjacency encodes the SAME latent communities as the embeddings
        adj, _ = sbm_graph(seed + 1, n, n_classes=N_CLUSTERS, p_in=0.04, p_out=0.002,
                           labels=labels)
        return lsh.encode_lsh(adj, c, m, generator=generator)
    if scheme == "learn":
        acfg = AutoencoderConfig(
            d_in=dim, c=c, m=m, d_h=d_c,
            decoder=DecoderConfig(c=c, m=m, d_c=d_c, d_m=d_m, d_e=dim,
                                  compute_dtype="float32"))
        params, _ = train_autoencoder(generator, emb, acfg, steps=steps)
        return extract_codes(params, emb, acfg)
    raise ValueError(f"unknown scheme {scheme!r}; known: {SCHEMES}")


def run(n: int = 2000, dim: int = 64, c: int = 16, m: int = 16, d_c: int = 128,
        d_m: int = 128, steps: int = 300, schemes: Sequence[str] = SCHEMES,
        seed: int = 0, device=None, log: Callable[[str], None] = print) -> dict:
    """The experiment at one entity count on ``device`` (default: the CUDA
    card).  Returns the raw embeddings' NMI, the Table 4/6 compression
    ratio, and per scheme the losses, NMI and encode / train seconds."""
    dev = resolve_device(device)
    disable_tf32()
    emb_np, labels = clustered_embeddings(seed, n, dim, N_CLUSTERS, noise=NOISE)
    emb = torch.from_numpy(emb_np).to(dev)
    ev = min(EVAL_N, n)
    out = {"raw_nmi": nmi(kmeans(emb_np[:ev], N_CLUSTERS), labels[:ev]),
           "compression_ratio": compression_ratio(n, dim, c, m, d_c, d_m),
           "schemes": {}}
    log(f"[reconstruct] n={n} dim={dim} c={c} m={m} d_c={d_c} d_m={d_m} on {dev}: "
        f"raw nmi={out['raw_nmi']:.4f}, compression ratio "
        f"{out['compression_ratio']:.2f}")
    cfg = reconstruction_config(n, dim, c, m, d_c, d_m)
    for scheme in schemes:
        t0 = time.perf_counter()
        codes = encode(scheme, seed, emb, labels, c, m, d_c, d_m, steps)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        params, losses = train_decoder_on_reconstruction(
            make_generator(seed + 1, dev), emb, codes, cfg, steps)
        rec = decode_all(params, cfg)[:ev].cpu().numpy()
        t2 = time.perf_counter()
        q = nmi(kmeans(rec, N_CLUSTERS), labels[:ev])
        out["schemes"][scheme] = dict(mse=losses[-1], nmi=q, losses=losses,
                                      encode_s=t1 - t0, train_s=t2 - t1)
        log(f"[reconstruct] {scheme}: mse={losses[-1]:.5f} nmi={q:.4f} "
            f"encode {t1 - t0:.3f} s, train + decode {t2 - t1:.3f} s")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--c", type=int, default=16)
    ap.add_argument("--m", type=int, default=16)
    ap.add_argument("--d-c", type=int, default=128)
    ap.add_argument("--d-m", type=int, default=128)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--schemes", default=",".join(SCHEMES))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    args = ap.parse_args(argv)
    return run(args.n, args.dim, args.c, args.m, args.d_c, args.d_m, args.steps,
               [s for s in args.schemes.split(",") if s], args.seed, args.device)


if __name__ == "__main__":
    main()
