"""Learning-based coding baseline (paper Fig. 1 "learn"; Shu & Nakayama
2018); counterpart of ``repro/core/autoencoder.py``.

An encoder MLP maps a pre-trained embedding to ``m`` categorical
distributions over ``c`` codes; discrete codes are taken by Gumbel-softmax
with straight-through argmax; the shared decoder (``core/decoder.py``)
reconstructs the embedding.  After training, codes are frozen with a final
argmax pass and only the decoder is kept.  It needs a pre-training pass
over the whole embedding table, which is what makes it inapplicable at
industrial scale (paper §2), but it is the strongest reconstruction
baseline of Fig. 1.

The soft codebook sum ``einsum("bmc,mcd->bd")`` is a plain product, as in
the JAX package: its gradient flows through the soft one-hot, which no
decode kernel carries.  The Gumbel noise comes from a ``torch.Generator``
or is passed in (``noise``), which is how the parity tests hand both
packages the same draw.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core import codes as codes_lib
from repro_torch.core.decoder import DecoderConfig, Params, init_decoder
from repro_torch.nn.module import dense_init, value_and_grad
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update


@dataclasses.dataclass(frozen=True)
class AutoencoderConfig:
    d_in: int
    c: int = 256
    m: int = 16
    d_h: int = 512
    decoder: DecoderConfig = dataclasses.field(default_factory=DecoderConfig)
    tau: float = 1.0  # Gumbel-softmax temperature


def init_autoencoder(generator: torch.Generator, cfg: AutoencoderConfig) -> Params:
    dev = generator.device
    return {
        "enc": {
            "w1": dense_init(generator, (cfg.d_in, cfg.d_h)),
            "b1": torch.zeros(cfg.d_h, device=dev),
            "w2": dense_init(generator, (cfg.d_h, cfg.m * cfg.c)),
            "b2": torch.zeros(cfg.m * cfg.c, device=dev),
        },
        "decoder": init_decoder(generator, cfg.decoder),
    }


def encode_logits(params: Params, x: torch.Tensor, cfg: AutoencoderConfig) -> torch.Tensor:
    enc = params["enc"]
    h = torch.relu(x @ enc["w1"] + enc["b1"])
    logits = h @ enc["w2"] + enc["b2"]
    return logits.reshape(*x.shape[:-1], cfg.m, cfg.c)


def gumbel(generator: torch.Generator, shape) -> torch.Tensor:
    """Standard Gumbel noise, -log(-log(u)) with u uniform in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def _straight_through_onehot(logits: torch.Tensor, noise: torch.Tensor,
                             tau: float) -> torch.Tensor:
    y_soft = torch.softmax((logits + noise) / tau, dim=-1)
    idx = torch.argmax(y_soft, dim=-1)
    y_hard = torch.nn.functional.one_hot(idx, logits.shape[-1]).to(logits.dtype)
    return y_hard + y_soft - y_soft.detach()


def reconstruct(params: Params, x: torch.Tensor, cfg: AutoencoderConfig, *,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable forward: x -> codes (straight-through Gumbel) ->
    decoder -> x_hat.  ``noise`` (B, m, c) replaces the draw from
    ``generator``."""
    logits = encode_logits(params, x, cfg)
    if noise is None:
        noise = gumbel(generator, logits.shape)
    onehot = _straight_through_onehot(logits, noise, cfg.tau)     # (B, m, c)
    dec = cfg.decoder
    cb = params["decoder"].get("codebooks", params["decoder"].get("codebooks_buf"))
    h = torch.einsum("bmc,mcd->bd", onehot, cb)
    if dec.variant == "light":
        h = h * params["decoder"]["w0"][None, :]
    mlp = params["decoder"]["mlp"]
    for i in range(dec.n_layers):
        h = h @ mlp[f"w{i}"] + mlp[f"b{i}"]
        if i < dec.n_layers - 1:
            h = torch.relu(h)
    return h


@torch.no_grad()
def extract_codes(params: Params, x: torch.Tensor, cfg: AutoencoderConfig) -> torch.Tensor:
    """Post-training hard codes, packed storage layout (int64 words)."""
    codes = torch.argmax(encode_logits(params, x, cfg), dim=-1).to(torch.int32)
    return codes_lib.pack_codes(codes, cfg.c, cfg.m)


def train_autoencoder(
    generator: torch.Generator, emb: torch.Tensor, cfg: AutoencoderConfig,
    steps: int = 300, batch: int = 512, lr: float = 1e-3, *,
    params: Optional[Params] = None,
    ids: Optional[Sequence[torch.Tensor]] = None,
    noise: Optional[Sequence[torch.Tensor]] = None,
) -> Tuple[Params, float]:
    """AdamW (weight decay 0.01) on the reconstruction MSE (paper §5.1.2);
    returns (params, last step's loss).  The init, each step's ids and each
    step's Gumbel noise come from ``generator`` unless ``params``, ``ids``
    or ``noise`` (one entry per step) are given."""
    if params is None:
        params = init_autoencoder(generator, cfg)
    ocfg = AdamWConfig(lr=lr, weight_decay=0.01)
    ostate = adamw_init(params)
    n = emb.shape[0]
    loss = torch.tensor(float("inf"))
    for i in range(steps):
        idx = ids[i] if ids is not None else torch.randint(
            0, n, (batch,), generator=generator, device=emb.device)
        xb = emb[idx.to(emb.device, torch.int64)]
        g = noise[i] if noise is not None else gumbel(generator, (xb.shape[0], cfg.m, cfg.c))
        loss, grads = value_and_grad(
            lambda p: torch.mean((reconstruct(p, xb, cfg, noise=g) - xb) ** 2), params)
        adamw_update(params, grads, ostate, ocfg)
    return params, float(loss)
