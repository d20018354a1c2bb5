"""End-to-end LM training driver (counterpart of ``repro/launch/train.py``).

Wires: config -> codes from the data pipeline's co-occurrence pass
(Algorithm 1 on the vocabulary) -> model init -> train loop with
checkpointing and auto-resume.  Runs on the CUDA card unless ``--device
cpu``; ``--preset tiny`` is the reduced config.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --preset tiny --steps 200 --ckpt-dir /tmp/run1 [--device cpu]

Unlike the JAX driver, ``--lr`` reaches the optimizer (its default is the
JAX driver's learning rate, so default runs match).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs import LMConfig, get_config, reduced
from repro_torch.core import lsh
from repro_torch.core.codes import count_collisions
from repro_torch.data import TokenStream, TokenStreamConfig, cooccurrence_matrix
from repro_torch.device import disable_tf32, make_generator, resolve_device
from repro_torch.nn.module import param_count
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import (CheckpointManager, LoopConfig, TrainHyper,
                               init_train_state, make_train_step, run_training)


def vocab_aux(cfg: LMConfig, *, batch: int, seq: int, cooc_batches: int,
              seed: int) -> np.ndarray:
    """The vocabulary's auxiliary matrix (n_entities, <=512) f32: a
    co-occurrence pass over its own token stream (seed + 1), rows padded to
    the padded vocabulary."""
    aux_stream = TokenStream(TokenStreamConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, batch_size=batch, seed=seed + 1))
    aux = cooccurrence_matrix(aux_stream, cooc_batches,
                              projection_dim=min(512, cfg.vocab_size))
    aux_pad = np.zeros((cfg.embedding_config().n_entities, aux.shape[1]), np.float32)
    aux_pad[: cfg.vocab_size] = aux
    return aux_pad


def encode_vocab(cfg: LMConfig, generator: torch.Generator, *, batch: int,
                 seq: int, cooc_batches: int, seed: int,
                 log: Callable[[str], None] = print) -> Optional[torch.Tensor]:
    """Packed vocabulary codes for hash kinds (None for the others):
    Algorithm 1 on ``vocab_aux`` on the generator's device (a dense A: on a
    card, through the ``lsh_encode`` kernel)."""
    if not cfg.embedding.kind.startswith("hash"):
        return None
    log(f"[encode] co-occurrence pass ({cooc_batches} batches) + "
        f"Algorithm 1 (c={cfg.embedding.c}, m={cfg.embedding.m})")
    aux = vocab_aux(cfg, batch=batch, seq=seq, cooc_batches=cooc_batches, seed=seed)
    ecfg = cfg.embedding_config()
    codes = lsh.encode_lsh(aux, ecfg.c, ecfg.m, generator=generator)
    log(f"[encode] codes {tuple(codes.shape)} uint32 words, "
        f"collisions={count_collisions(codes[:cfg.vocab_size])}")
    return codes


def train(cfg: LMConfig, *, steps: int, batch: int, seq: int, lr: float = 1e-3,
          cooc_batches: int = 8, seed: int = 0, device=None, log_every: int = 20,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 100,
          log: Callable[[str], None] = print):
    """The whole chain on ``device`` (default: the CUDA card); returns the
    loop's ``LoopResult`` (``.state`` holds the trained params).  With
    ``ckpt_dir`` the loop saves every ``ckpt_every`` steps and at the end,
    and resumes from the newest checkpoint there (``steps`` is then the
    absolute target)."""
    dev = resolve_device(device)
    disable_tf32()
    generator = make_generator(seed, dev)
    stream = TokenStream(TokenStreamConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, batch_size=batch, seed=seed))
    codes = encode_vocab(cfg, generator, batch=batch, seq=seq,
                         cooc_batches=cooc_batches, seed=seed, log=log)
    state = init_train_state(generator, cfg, codes=codes)
    log(f"[init] {cfg.name} ({cfg.family}) params={param_count(state['params']):,} "
        f"embedding={cfg.embedding.kind} on {dev}")
    hyper = TrainHyper(optimizer=AdamWConfig(lr=lr, weight_decay=0.01, clip_norm=1.0),
                       total_steps=steps)
    to_dev = lambda b: {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
    ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
    return run_training(
        make_train_step(cfg, hyper), state, stream,
        LoopConfig(total_steps=steps, ckpt_every=ckpt_every, log_every=log_every),
        ckpt=ckpt, to_device=to_dev,
        on_metrics=lambda s, m: log(
            f"[step {s:5d}] loss={m['loss']:.4f} dt={m['step_time']*1e3:.0f}ms"))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--preset", choices=["tiny", "full"], default="tiny")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--embedding-kind", default=None,
                    help="dense | hash_full | hash_light | random_full | random_light")
    ap.add_argument("--cooc-batches", type=int, default=8,
                    help="co-occurrence pass batches for the LSH auxiliary")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.preset == "tiny":
        cfg = reduced(cfg)
    if args.embedding_kind:
        cfg = dataclasses.replace(
            cfg, embedding=dataclasses.replace(cfg.embedding, kind=args.embedding_kind))
    t0 = time.time()
    res = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
                cooc_batches=args.cooc_batches, seed=args.seed, device=args.device,
                ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    span = f"loss {res.losses[0]:.4f} -> {res.losses[-1]:.4f} " if res.losses else ""
    print(f"[done] steps={len(res.losses)} {span}wall={time.time() - t0:.1f}s "
          f"stragglers={res.stragglers}"
          + (f" resumed_from={res.resumed_from}" if res.resumed_from else ""))
    return res


if __name__ == "__main__":
    main()
