"""The LM serving engine behind the ``Engine`` protocol (counterpart of
``repro/serving/engine.py``).

Two engines share the serving surface: the LM ``DecodeEngine`` (prefill,
then one decode step a token against the per-site KV caches and, for the
ssm and hybrid families, the per-layer SSM states) and the GNN
``GraphInferenceEngine`` (``serving.gnn``).  Both freeze params at
construction, fail fast on unknown decode-backend names and expose one
batched ``serve(requests)`` entry point, which is what the ``Engine``
protocol pins down.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.configs.base import LMConfig
from repro_torch.core import backend as backend_mod
from repro_torch.device import DeviceLike, make_generator, resolve_device
from repro_torch.models.lm import NEG_INF
from repro_torch.nn.module import map_tree
from repro_torch.stages import stage
from repro_torch.train.step import make_prefill_step, make_serve_step


@runtime_checkable
class Engine(Protocol):
    """Shared serving surface: frozen params and fixed-shape steps behind
    one batched request entry point.

    ``serve(requests, **kwargs)`` takes one request batch (token prompts
    for the LM engine, node ids for the GNN engine) and returns a result
    dataclass; engines may add richer typed methods beside it
    (``generate``, ``embed``, ``predict``), but ``serve`` is the common
    denominator the protocol guarantees."""

    def serve(self, requests, **kwargs): ...


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray      # (B, prompt + generated)
    steps: int


class DecodeEngine:
    """``decode_backend`` pins the embedding decode path for serving
    (compressed vocabularies re-decode token embeddings every step, so the
    backend choice is on the serving hot path).  ``None`` keeps the config's
    ``lookup_impl``; ``"auto"`` resolves for ``device`` (the hand-written
    ``hash_decode`` kernel on a CUDA device).  Unknown names fail here, at
    engine construction, not on the first request.  ``device=None`` is the
    CUDA card; params elsewhere are copied to ``device``."""

    def __init__(self, cfg: LMConfig, params, s_max: int = 1024,
                 decode_backend: Optional[str] = None, device: DeviceLike = None):
        self.device = resolve_device(device)
        if decode_backend is not None:
            resolved = (backend_mod.resolve_auto(self.device)
                        if decode_backend == "auto" else decode_backend)
            backend_mod.get_backend(resolved, device=self.device)  # fail fast on unknown names
            cfg = dataclasses.replace(cfg, embedding=dataclasses.replace(
                cfg.embedding, lookup_impl=resolved))
        self.cfg = cfg
        self.decode_backend = cfg.embedding.lookup_impl
        self.params = map_tree(lambda _, t: t.to(self.device), params)
        self.s_max = s_max
        self._prefill = make_prefill_step(cfg, s_max)
        self._serve = make_serve_step(cfg)

    def _sample(self, logits: torch.Tensor, generator: torch.Generator,
                temperature: float) -> torch.Tensor:
        """(B, Vpad) f32 -> (B,) int32 on the device (audio: (B, nq, Vpad)
        -> (B, nq), one token a codebook).  Temperature 0 is the
        argmax (ties to the first index, as ``jnp.argmax``); above 0 a
        Gumbel-max draw from ``generator``: the categorical distribution of
        JAX's ``jax.random.categorical``, but not its threefry draws, so
        sampled tokens differ from the JAX engine's at the same seed."""
        with stage("sample"):
            pad = torch.arange(logits.shape[-1], device=logits.device) >= self.cfg.vocab_size
            logits = logits.masked_fill(pad, NEG_INF)
            if temperature <= 0:
                return logits.argmax(dim=-1).to(torch.int32)
            u = torch.rand(logits.shape, generator=generator, device=logits.device)
            gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
            return (logits / temperature + gumbel).argmax(dim=-1).to(torch.int32)

    def generate(self, prompts, max_new_tokens: int, temperature: float = 0.0,
                 seed: int = 0) -> GenerationResult:
        """prompts: (B, S0) int (audio: (B, S0, nq)).  The sampled tokens
        stay on the device and are copied to the host once, at the end."""
        generator = make_generator(seed, self.device)
        tokens = torch.as_tensor(prompts, dtype=torch.int32, device=self.device)
        if tokens.shape[1] + max_new_tokens > self.s_max:
            raise ValueError(f"prompt {tokens.shape[1]} + {max_new_tokens} new tokens "
                             f"> s_max {self.s_max}")
        chunk = self.cfg.ssm_chunk
        if self.cfg.family in ("ssm", "hybrid") and tokens.shape[1] > chunk \
                and tokens.shape[1] % chunk:
            raise ValueError(f"a {self.cfg.family} prompt of {tokens.shape[1]} tokens: the "
                             f"chunked scan takes at most {chunk} or a multiple of it")
        last_logits, cache = self._prefill(self.params, {"tokens": tokens})
        out = [tokens]
        for _ in range(max_new_tokens):
            nxt_tok = self._sample(last_logits, generator, temperature)[:, None]   # (B, 1[, nq])
            out.append(nxt_tok)
            last_logits, cache = self._serve(self.params, cache, {"tokens": nxt_tok})
        return GenerationResult(tokens=torch.cat(out, dim=1).cpu().numpy(),
                                steps=max_new_tokens)

    def serve(self, requests, max_new_tokens: int = 32, temperature: float = 0.0,
              seed: int = 0, **_ignored) -> GenerationResult:
        """``Engine``-protocol entry point: one batch of prompts in, a
        ``GenerationResult`` out (an alias of ``generate``).  Unknown kwargs
        are ignored, so protocol-level callers can pass engine-agnostic
        options."""
        return self.generate(requests, max_new_tokens, temperature=temperature, seed=seed)
