"""Analytic per-rank HBM traffic of one step (counterpart of
``repro/launch/hbm_model.py``, the same formula).

Every count is per rank per step; a tensor counts once per write and once
per read (factor 2), with pass multipliers:

  train:   forward + backward + remat recompute: 3 passes over the
           activations, the weights read forward, backward and recompute
           per microbatch, the optimizer's 7 f32 passes over the trainable
           params (read p, mu, nu, g; write p, mu, nu)
  prefill: one forward pass, the cache written once
  decode:  the weights read once, the cache read once and one slot written

Attention scores are not counted (the flash kernel keeps them on chip);
``attn_scores_hbm=True`` adds them back.  The mesh is any object with a
``shape`` dict (a ``MeshSpec`` for the production layouts).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.configs.base import LMConfig
from repro_torch.launch.shapes import ShapeSpec
from repro_torch.nn.module import leaves_with_path

BF16 = 2
F32 = 4


def _mesh_size(mesh) -> int:
    return int(np.prod(list(mesh.shape.values())))


def _local_param_bytes(cfg: LMConfig, mesh, dtype_bytes: int,
                       trainable_only=False, strategy=None) -> float:
    """Per-rank bytes of the param tree under the policy."""
    from repro_torch.parallel.policy import DEFAULT_STRATEGY, abstract_params, params_shardings
    from repro_torch.parallel.sharding import shard_shape
    tpl = abstract_params(cfg)
    specs = params_shardings(cfg, tpl, mesh, strategy or DEFAULT_STRATEGY)
    total = 0.0
    for path, leaf in leaves_with_path(tpl):
        if trainable_only and not leaf.is_floating_point():
            continue
        spec = specs
        for k in path:
            spec = spec[k]
        shard = shard_shape(tuple(leaf.shape), spec, mesh)
        total += float(np.prod(shard)) * dtype_bytes if shard else float(dtype_bytes)
    return total


def _layer_boundary_bytes_per_token(cfg: LMConfig, model_sz: int) -> float:
    """bf16 bytes crossing HBM per token per layer at fusion boundaries."""
    D, F = cfg.d_model, cfg.d_ff
    H, K, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    heads_ok = H and H % model_sz == 0
    hdiv = model_sz if heads_ok else 1
    fdiv = model_sz if F and F % model_sz == 0 else 1
    b = 0.0
    if cfg.family in ("dense", "moe", "audio", "vlm"):
        qkv = (H * Dh + 2 * K * Dh) / hdiv
        attn_out = (H * Dh) / hdiv + D
        if cfg.family == "moe":
            k = cfg.moe_top_k
            ep = model_sz if cfg.n_experts_padded % model_sz == 0 else 1
            ffn = k * 3 * F / ep + k * D / ep + D   # dispatched rows + combine
        else:
            ffn = 3 * F / fdiv + D
        b = (2 * D + qkv + attn_out + ffn) * BF16   # + two norm outputs
    if cfg.family in ("ssm", "hybrid"):
        DI = cfg.ssm_expand * D
        N = cfg.ssm_state
        Hs = DI // cfg.ssm_headdim
        hs_div = model_sz if Hs % model_sz == 0 else 1
        L = cfg.ssm_chunk
        proj = (2 * DI + 2 * N + Hs)
        conv = (DI + 2 * N)
        ssd_scores = L * (Hs / hs_div) * F32        # intra-chunk (L, L, H) rows
        ssd_states = (Hs / hs_div) * N * F32 / max(L, 1) * cfg.ssm_headdim
        ssm_b = (D + proj + conv + 2 * DI) * BF16 + ssd_scores + ssd_states
        if cfg.family == "ssm":
            b = ssm_b
        else:  # hybrid: mamba layers + 1/attn_every share of the shared block
            qkv = (H * Dh + 2 * K * Dh) / hdiv
            attn_out = (H * Dh) / hdiv + D
            ffn = 3 * F / fdiv + D
            attn_b = (2 * D + qkv + attn_out + ffn) * BF16
            b = ssm_b + attn_b / max(cfg.attn_every, 1)
    return 2.0 * b      # write + read per boundary tensor


def _embed_head_bytes_per_token(cfg: LMConfig, model_sz: int, train: bool) -> float:
    e = cfg.embedding
    V_local = cfg.vocab_padded / (model_sz if cfg.vocab_padded % model_sz == 0 else 1)
    logits = V_local * F32 * (3 if train else 1) * 2
    if e.kind == "dense":
        emb = cfg.d_model * BF16 * 2
    else:
        # packed code row + decoder boundary tensors
        emb = e.m * (e.c.bit_length() - 1) / 8 \
            + (e.d_c + e.d_m + cfg.d_model) * BF16 * 2
        if train:
            emb *= 3
    return logits + emb


def analytic_hbm_bytes(cfg: LMConfig, shape: ShapeSpec, mesh,
                       microbatches: int = 1,
                       attn_scores_hbm: bool = False,
                       strategy=None) -> Dict[str, float]:
    from repro_torch.parallel.policy import DEFAULT_STRATEGY
    strategy = strategy or DEFAULT_STRATEGY
    model_sz = mesh.shape.get("model", 1) if not strategy.dp_over_model else 1
    mb = max(1, microbatches)

    dp = int(np.prod([mesh.shape[a] for a in strategy.batch_mesh_axes(mesh)]))
    if shape.kind == "decode":
        # one token per sequence; batch shards over the data axes when it can
        tokens_local = shape.batch / dp if shape.batch % dp == 0 else float(shape.batch)
    else:
        tokens_local = shape.batch * shape.seq / dp

    w_bf16 = _local_param_bytes(cfg, mesh, BF16, strategy=strategy)
    w_f32_train = _local_param_bytes(cfg, mesh, F32, trainable_only=True,
                                     strategy=strategy)
    act_per_tok = _layer_boundary_bytes_per_token(cfg, model_sz)
    n_layers = cfg.n_layers
    eh_per_tok = _embed_head_bytes_per_token(cfg, model_sz, shape.kind == "train")

    out: Dict[str, float] = {}
    if shape.kind == "train":
        out["weights"] = 3.0 * mb * w_bf16            # fwd+bwd+remat, per microbatch
        out["optimizer"] = 7.0 * w_f32_train          # p,μ,ν,g reads + p,μ,ν writes
        out["grad_accum"] = (2.0 * (mb - 1)) * w_f32_train
        out["activations"] = 3.0 * tokens_local * act_per_tok * n_layers
        out["embed_head"] = tokens_local * eh_per_tok
        if attn_scores_hbm and cfg.n_heads:
            H_loc = cfg.n_heads / (model_sz if cfg.n_heads % model_sz == 0 else 1)
            per_mb_rows = tokens_local / mb
            sites = n_layers if cfg.family != "hybrid" else n_layers // cfg.attn_every
            out["attn_scores"] = (3.0 * 2.0 * sites * mb
                                  * per_mb_rows * shape.seq * H_loc * F32) / 2
    elif shape.kind == "prefill":
        out["weights"] = w_bf16
        out["activations"] = 1.0 * tokens_local * act_per_tok * n_layers
        out["embed_head"] = tokens_local * eh_per_tok
        out["cache_write"] = _cache_local_bytes(cfg, shape, mesh)
        if attn_scores_hbm and cfg.n_heads:
            H_loc = cfg.n_heads / (model_sz if cfg.n_heads % model_sz == 0 else 1)
            sites = n_layers if cfg.family != "hybrid" else n_layers // cfg.attn_every
            out["attn_scores"] = 2.0 * sites * tokens_local * shape.seq * H_loc * F32 / 2
    else:  # decode
        out["weights"] = w_bf16
        out["cache_read"] = _cache_local_bytes(cfg, shape, mesh)
        out["activations"] = tokens_local * act_per_tok * n_layers
        out["embed_head"] = tokens_local * eh_per_tok
    out["total"] = sum(out.values())
    return out


def _cache_local_bytes(cfg: LMConfig, shape: ShapeSpec, mesh) -> float:
    """Per-rank bytes of a bf16 cache of ``shape`` under the default policy."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models.lm import init_cache
    from repro_torch.parallel.policy import cache_shardings_policy
    from repro_torch.parallel.sharding import shard_shape
    with FakeTensorMode():
        tpl = init_cache(cfg, shape.batch, shape.seq, torch.bfloat16, device="cpu")
    specs = cache_shardings_policy(cfg, tpl, mesh)
    total = 4.0                      # pos: one int32, whole on every rank
    for name in ("kv_k", "kv_v", "ssm_state", "conv"):
        leaf = getattr(tpl, name)
        if leaf is None:
            continue
        total += float(np.prod(shard_shape(tuple(leaf.shape), getattr(specs, name), mesh))) \
            * leaf.element_size()
    return total
