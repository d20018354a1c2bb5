"""Adapter for LM training configurations: ``repro_torch``'s
``make_train_step`` driven by ``train.loop.run_training``, the compressed
vocabulary embedding's codes from Algorithm 1 in set-up, as
``launch/train.py`` chains them.

The benchmark makes the inputs from the seed: the token batches and the
vocabulary's co-occurrence matrix (``perfbench.tokens``), the LSH
projections and the weights, each leaf from its own derived seed so the
check can draw it again one leaf at a time.  The program makes the codes
(``core.lsh.encode_lsh``, the ``lsh_encode`` kernel on the card), the
optimizer state and everything after.  Set-up drives the same step and
state through its first ``checked_steps`` steps, which the reference
follows; the window then runs ``run_training`` until the time is up.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from perfbench import inputs, tokens
from perfbench.compare import codes_gap, compare_train
from perfbench.reference import lm_train as ref


def weight_specs(cfg: dict) -> List[inputs.Spec]:
    """(dotted parameter path, shape, scale) of every weight: LeCun's
    scale over the fan-in for products, 1/sqrt(m) for codebooks, 0 for
    biases and norms (``inputs.draw`` gives zeros; norms are set to one)."""
    e = cfg["embedding"]
    L, D, F = cfg["num_hidden_layers"], cfg["hidden_size"], cfg["intermediate_size"]
    H, K, E = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["n_experts_padded"]
    Dh = D // H
    dims = [e["d_c"]] + [e["d_m"]] * (e["n_layers"] - 1) + [D]
    specs = [("embed.decoder.codebooks", (e["m"], e["c"], e["d_c"]), 1.0 / math.sqrt(e["m"]))]
    for i in range(e["n_layers"]):
        specs += [(f"embed.decoder.mlp.w{i}", (dims[i], dims[i + 1]), 1.0 / math.sqrt(dims[i])),
                  (f"embed.decoder.mlp.b{i}", (dims[i + 1],), 0.0)]
    lecun = 1.0 / math.sqrt(D)
    return specs + [
        ("final_norm.scale", (D,), 0.0),
        ("head", (D, cfg["vocab_padded"]), lecun),
        ("blocks.norm1.scale", (L, D), 0.0),
        ("blocks.attn.wq.w", (L, D, H * Dh), lecun),
        ("blocks.attn.wk.w", (L, D, K * Dh), lecun),
        ("blocks.attn.wv.w", (L, D, K * Dh), lecun),
        ("blocks.attn.wo.w", (L, H * Dh, D), 1.0 / math.sqrt(H * Dh)),
        ("blocks.norm2.scale", (L, D), 0.0),
        ("blocks.moe.router", (L, D, E), lecun),
        ("blocks.moe.w_gate", (L, E, D, F), lecun),
        ("blocks.moe.w_up", (L, E, D, F), lecun),
        ("blocks.moe.w_down", (L, E, F, D), 1.0 / math.sqrt(F)),
    ]


def draw_leaf(spec: inputs.Spec, seed: int, device) -> torch.Tensor:
    """One weight from its seed; a norm's scale is ones."""
    w = inputs.draw([spec], seed, device)[spec[0]]
    return w.fill_(1.0) if spec[0].endswith(".scale") else w


def _at(tree, name: str):
    for k in name.split("."):
        tree = tree[k]
    return tree


class System:
    """One cell of an LM training configuration."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic = config, traffic
        self.device = torch.device(device)
        self.mode = traffic["mode"]
        if self.mode != "train":
            raise ValueError(f"unknown traffic mode {self.mode!r}")
        names = ("tokens", "cooc", "lsh", "weights")
        self.seeds = dict(zip(names, inputs.derived_seeds(seed, len(names))))
        self.specs = weight_specs(config)
        self.leaf_seeds = dict(zip((s[0] for s in self.specs),
                                   inputs.derived_seeds(self.seeds["weights"], len(self.specs))))
        self.after_build: List[Callable[["System"], None]] = []
        self.log: Callable[[str], None] = lambda msg: None
        self.state = None
        self.observed: dict = {}
        self.window_losses: List[float] = []
        self.to_device = self._to_device

    # -- inputs ----------------------------------------------------------
    def _source(self) -> tokens.TokenSource:
        t = self.traffic
        return tokens.TokenSource(self.config["vocab_size"], t["batch"], t["seq"],
                                  self.seeds["tokens"], **t["stream"])

    def make_inputs(self) -> None:
        """The co-occurrence matrix (host), the projections (device); the
        batches come from a fresh ``_source`` on either side."""
        t, e = self.traffic, self.config["embedding"]
        cooc = tokens.TokenSource(self.config["vocab_size"], t["batch"], t["seq"],
                                  self.seeds["cooc"], **t["stream"])
        # the rows on a grid of 1/1024 and Gaussian directions on one of
        # 1/16 within +-8: every product is a multiple of 2**-14 and every
        # partial sum of a unit row stays under 2**9 in magnitude, so A V is
        # exact in float32 in any order and the program's codes and the
        # reference's cannot differ by a rounding at the median
        aux = tokens.cooccurrence(cooc, t["cooc_batches"], self.config["vocab_padded"])
        self.aux = np.round(aux * 1024.0) / 1024.0
        n_bits = e["m"] * (int(e["c"]).bit_length() - 1)
        V = inputs.draw([("V", (self.aux.shape[1], n_bits), 1.0)], self.seeds["lsh"],
                        self.device)["V"]
        self.V = torch.clamp(torch.round(V * 16.0), -128, 128) / 16.0

    def weights(self) -> Dict[str, torch.Tensor]:
        """Every weight drawn again from its seed."""
        return {s[0]: self._initial(s[0]) for s in self.specs}

    def _initial(self, name: str) -> torch.Tensor:
        spec = next(s for s in self.specs if s[0] == name)
        return draw_leaf(spec, self.leaf_seeds[name], self.device)

    def lm_config(self):
        """The program's config of the architecture with the configuration's
        sizes and the profile it trains on (the sizes are the registered
        ones at full size: the tests hold them so)."""
        import dataclasses
        from repro_torch.configs import get_config
        cfg, p = self.config, self.config["port"]
        lm = get_config(
            cfg["arch"], n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
            n_heads=cfg["num_attention_heads"], n_kv_heads=cfg["num_key_value_heads"],
            d_ff=cfg["intermediate_size"], n_experts=cfg["num_local_experts"],
            moe_top_k=cfg["num_experts_per_tok"], vocab_size=cfg["vocab_size"],
            rope_theta=float(cfg["rope_theta"]), attn_impl=p["attn_impl"],
            moe_impl=p["moe_impl"], remat=p["remat"], compute_dtype=cfg["compute_dtype"])
        lm = dataclasses.replace(lm, embedding=dataclasses.replace(
            lm.embedding, **cfg["embedding"]))
        if (lm.vocab_padded, lm.n_experts_padded) != (cfg["vocab_padded"],
                                                       cfg["n_experts_padded"]):
            raise ValueError(f"padded vocabulary and experts {lm.vocab_padded}, "
                             f"{lm.n_experts_padded} against the configuration's")
        return lm

    # -- set-up ----------------------------------------------------------
    def _phase(self, name: str) -> None:
        now = time.perf_counter()
        self.log(f"[setup] {name} {now - self._t:.3f} s")
        self._t = now

    def _to_device(self, batch):
        return {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}

    def setup(self) -> None:
        from repro_torch.core import codes as codes_lib
        from repro_torch.core import lsh
        from repro_torch.optim.adamw import AdamWConfig, adamw_init
        from repro_torch.train import TrainHyper, make_train_step
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
        self._t = time.perf_counter()
        lm = self.lm_config()
        self.make_inputs()
        self._phase("inputs (co-occurrence, projections)")
        e = self.config["embedding"]
        aux = torch.from_numpy(self.aux).to(self.device)
        codes = lsh.encode_lsh(aux, e["c"], e["m"],
                               projections=list(self.V.split(codes_lib.WORD_BITS, dim=1)))
        del aux
        self._phase("Algorithm 1 (encode_lsh)")
        params: dict = {}
        for name, w in self.weights().items():
            parent = params
            *path, leaf = name.split(".")
            for k in path:
                parent = parent.setdefault(k, {})
            parent[leaf] = w
        params["embed"]["codes_buf"] = codes_lib.from_uint32(codes).to(self.device)
        self.named_rows = self._named(codes_lib.unpack_codes(params["embed"]["codes_buf"],
                                                             e["c"], e["m"]))
        o = self.config["optimizer"]
        moments = getattr(torch, self.config["port"]["moments_dtype"])
        self.state = {"params": params, "step": 0, "opt": adamw_init(params, moments)}
        hyper = TrainHyper(optimizer=AdamWConfig(lr=o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                                                 weight_decay=o["weight_decay"],
                                                 clip_norm=o["clip_norm"]),
                           warmup_steps=o["warmup_steps"], total_steps=o["total_steps"])
        self.step = make_train_step(lm, hyper)
        self.source = self._source()
        self._phase("weights and state")
        for hook in self.after_build:
            hook(self)
        self._checked_steps()
        self._phase("first train units")

    def _checked_steps(self) -> None:
        """The first steps through the program's loop: each loss, the first
        gradient from the moments after step 1 (mu / (1 - b1)), and every
        leaf's change after the last checked step, each initial leaf drawn
        again from its seed."""
        from repro_torch.train import LoopConfig, run_training
        steps, b1 = self.traffic["checked_steps"], self.config["optimizer"]["b1"]
        obs = {}
        state = self.state

        def record(step, _metrics):
            if step == 0:
                obs["grad_norms"] = {s[0]: ref.leaf_norm(_at(state["opt"]["mu"], s[0])) / (1 - b1)
                                     for s in self.specs}
            if step == steps - 1:
                obs["delta_norms"] = {
                    s[0]: ref.leaf_norm(_at(state["params"], s[0]), self._initial(s[0]))
                    for s in self.specs}

        res = run_training(self.step, state, self.source,
                           LoopConfig(total_steps=steps, log_every=1),
                           to_device=self.to_device, on_metrics=record)
        obs["losses"] = list(res.losses)
        self.observed = obs

    # -- the window ------------------------------------------------------
    def window(self, until: float) -> int:
        from repro_torch.train import LoopConfig, run_training
        from repro_torch.train.loop import FenceInterrupt

        def fence(_step):
            if time.perf_counter() >= until:
                raise FenceInterrupt

        res = run_training(self.step, self.state, self.source,
                           LoopConfig(total_steps=1 << 40, log_every=1 << 40),
                           to_device=self.to_device, fence=fence)
        self.window_losses += res.losses
        return len(res.losses)

    def _named(self, codes: torch.Tensor) -> int:
        """How many codebook rows the codes name."""
        e = self.config["embedding"]
        return int(torch.unique(codes.long() + torch.arange(e["m"], device=codes.device)
                                * e["c"]).numel())

    def work(self) -> Dict[str, List[dict]]:
        """The kernel calls of one step, with the shapes their work is
        counted from: the embedding's decode and codebook gradient over the
        batch's tokens, and flash attention once a layer in the forward and
        once more in the remat recompute."""
        cfg, t, e = self.config, self.traffic, self.config["embedding"]
        rows = t["batch"] * t["seq"]
        named = self.named_rows
        elem = 2 if cfg["compute_dtype"] in ("bfloat16", "float16") else 4   # codebooks as stored
        decode = dict(rows=rows, m=e["m"], c=e["c"], d_c=e["d_c"], elem=elem, named=min(
            named, rows * e["m"]))
        H, K = cfg["num_attention_heads"], cfg["num_key_value_heads"]
        attn = dict(batch=t["batch"], seq=t["seq"], heads=H, kv_heads=K,
                    head_dim=cfg["hidden_size"] // H, elem=2, causal=True)
        calls = cfg["num_hidden_layers"] * (2 if cfg["port"]["remat"] else 1)
        return {"hash_decode": [decode], "hash_decode_bwd": [decode],
                "flash_attention": [attn] * calls}

    @property
    def attempted(self) -> int:
        return len(self.window_losses)

    @property
    def failed(self) -> int:
        return sum(not math.isfinite(x) for x in self.window_losses)

    # -- correctness -----------------------------------------------------
    def release(self) -> None:
        """Keep the codes the program trained with, then drop its state so
        the reference has the card."""
        if self.state is not None:
            from repro_torch.core import codes as codes_lib
            e = self.config["embedding"]
            self.program_codes = codes_lib.unpack_codes(
                self.state["params"]["embed"]["codes_buf"], e["c"], e["m"]).cpu()
        self.state = self.step = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, mm: Callable = ref.exact_mm) -> dict:
        """The reference's first steps from the same inputs."""
        cfg, t, e = self.config, self.traffic, self.config["embedding"]
        codes = self.ref_codes = ref.lsh_codes(torch.from_numpy(self.aux).to(self.device),
                                               self.V, e["c"], e["m"])
        source = self._source()
        batches = [{k: torch.from_numpy(v).to(self.device) for k, v in source.next_batch().items()}
                   for _ in range(t["checked_steps"])]
        return ref.train(self.weights(), codes, batches, cfg, t["checked_steps"], self._initial,
                         mm)

    # -- faults (perfbench.faults) -----------------------------------------
    def faults(self):
        return ("frozen", "half_batch", "altered", "codebook_grad")

    def plant(self, fault: str) -> None:
        """``half_batch``: every step's batch cut to its first half of
        rows.  ``altered``: one bit of the first token's codes flipped in
        the code buffer the step reads, where Algorithm 1's answer is
        kept."""
        if fault == "altered":
            self.state["params"]["embed"]["codes_buf"][0, 0] ^= 1
            return
        whole = self._to_device
        self.to_device = lambda batch: whole({k: v[: v.shape[0] // 2] for k, v in batch.items()})

    def control(self) -> dict:
        """The control's readings: the reference with its products in
        float8, in the program's place."""
        return self.reference(ref.fp8_mm)

    def compare(self, want: dict, got=None) -> Dict[str, float]:
        """The cell's numbers: the program's readings (or ``got``, a
        control's, whose codes are the reference's own) against the
        reference's ``want``."""
        if got is not None:
            return dict(compare_train(got, want), codes_gap=0.0)
        return dict(compare_train(self.observed, want),
                    codes_gap=codes_gap(self.program_codes, self.ref_codes))
