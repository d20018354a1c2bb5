"""Roofline terms on the H100's constants (counterpart of
``repro/launch/roofline.py``).

  compute    = FLOPs / bf16 peak
  memory     = HBM bytes / HBM bandwidth
  collective = wire bytes / one NVLink direction

``model_flops`` is the analytic useful work of a cell (6·N_active·tokens
for training, 2·N_active·tokens forward, with the attention's quadratic
term); ``decode_hbm_bytes`` and ``decode_roofline`` model one fused
``hash_decode`` forward.  The JAX module's two readers of compiled HLO
have counting twins: ``collective_bytes`` takes a ``VirtualMesh``'s
recorded calls (the JAX one parses the collectives out of the HLO text),
and ``calibrate_counter`` checks ``launch.opanalysis.OpAnalyzer`` on a
sharded matmul as ``calibrate_cost_analysis`` checks XLA's cost analysis.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Tuple

from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16


@dataclasses.dataclass
class RooflineTerms:
    flops: float                  # per-card FLOPs
    bytes_accessed: float         # per-card HBM bytes
    coll_bytes: float             # per-card wire bytes
    coll_breakdown: Dict[str, float]
    model_flops_per_chip: float   # analytic useful FLOPs
    chips: int

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS_BF16

    @property
    def memory_s(self) -> float:
        return self.bytes_accessed / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll_bytes / NVLINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """The step's floor: the largest of the three terms (all overlapped;
        their sum is the bound without overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops_per_chip / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful FLOPs over (peak · the floor's step time)."""
        if self.step_s == 0:
            return 0.0
        return self.model_flops_per_chip / (PEAK_FLOPS_BF16 * self.step_s)

    def as_dict(self) -> Dict:
        return {
            "flops_per_chip": self.flops,
            "bytes_per_chip": self.bytes_accessed,
            "coll_bytes_per_chip": self.coll_bytes,
            "coll_breakdown": self.coll_breakdown,
            "model_flops_per_chip": self.model_flops_per_chip,
            "chips": self.chips,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "step_s": self.step_s,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops(cfg, shape, n_chips: int) -> float:
    """Analytic model FLOPs of the cell, per card, in the JAX package's
    order of operations (so the floats are its bits).

    train: 6·N_active·tokens + 12·L·H·Dh·S²·B/2 (causal, forward and
    backward); prefill: 2·N_active·tokens + 4·L·H·Dh·S²·B/2; decode:
    2·N_active·batch + 4·L·H·Dh·S·B (one token a sequence).  The hybrid's
    attention term counts its shared block's sites, one every
    ``attn_every`` layers."""
    n_active = cfg.active_param_count()
    L, H, Dh, S, B = cfg.n_layers, cfg.n_heads, cfg.head_dim, shape.seq, shape.batch
    if shape.kind == "train":
        total = 6.0 * n_active * (B * S)
        att = 12.0 * L * H * Dh * S**2 * B / 2
    elif shape.kind == "prefill":
        total = 2.0 * n_active * (B * S)
        att = 4.0 * L * H * Dh * S**2 * B / 2
    else:
        total = 2.0 * n_active * B
        att = 4.0 * L * H * Dh * S * B
    if H:
        total += att / cfg.attn_every if cfg.family == "hybrid" else att
    return total / n_chips


def collective_bytes(calls: Iterable[Tuple[str, str, int, int]]) -> Dict[str, float]:
    """Wire bytes a rank by collective, under JAX's names, from the
    (primitive, axes, result bytes, group size) calls a
    ``parallel.sharding.VirtualMesh`` recorded, through the ring model:

      all-gather      result R gathered over p: R·(p−1)/p
      all-reduce      2·R·(p−1)/p
      reduce-scatter  result r = R/p: r·(p−1)
      all-to-all      R·(p−1)/p
      collective-permute  R

    The port issues all-gathers, all-to-alls and shifts only (its sums
    over ranks are a gather and a sum in rank order), so those three keys
    carry its bytes; ``total`` sums them."""
    from repro_torch.launch.opanalysis import coll_from_calls
    out = coll_from_calls(calls)
    out["total"] = sum(out.values())
    return out


def calibrate_counter(mesh) -> float:
    """Counts a 1024² f32 matmul, the rows of A over the data axes and the
    columns of B over ``model``, as the virtual rank at coordinate 0 of
    ``mesh`` (a ``MeshSpec``) runs it, and returns counted / (2n³ / chips):
    1.0 when the counter reads one rank's FLOPs."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.opanalysis import OpAnalyzer
    from repro_torch.parallel.policy import shard_leaf
    from repro_torch.parallel.sharding import VirtualMesh
    n = 1024
    vmesh = VirtualMesh(mesh)
    axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    with FakeTensorMode():
        a = shard_leaf(torch.empty(n, n), (axes if len(axes) > 1 else axes[0], None), vmesh)
        b = shard_leaf(torch.empty(n, n), (None, "model"), vmesh)
        with OpAnalyzer() as counter:
            a @ b
    return counter.flops / (2.0 * n * n * n / mesh.size)


# Storage bytes a codebook element by decode precision; int8's f32 absmax
# scales (one a (codebook, code) row) are counted apart.
DECODE_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "int8": 1}


def decode_hbm_bytes(B: int, c: int, m: int, d_c: int,
                     dtype: str = "float32", w0: bool = False) -> Dict[str, float]:
    """HBM bytes of one fused hash-decode forward, each operand read once
    and the output written once:

      codes      B·m·4              (int32)
      codebooks  m·c·d_c·bytes(dtype)
      scales     m·c·4              (int8 only)
      w0         d_c·bytes(dtype)   (light variant only)
      out        B·d_c·4            (f32)
    """
    db = DECODE_DTYPE_BYTES[dtype]
    parts = {
        "codes": B * m * 4.0,
        "codebooks": float(m * c * d_c * db),
        "scales": m * c * 4.0 if dtype == "int8" else 0.0,
        "w0": float(d_c * db) if w0 else 0.0,
        "out": B * d_c * 4.0,
    }
    parts["total"] = sum(parts.values())
    return parts


def decode_roofline(B: int, c: int, m: int, d_c: int, dtype: str = "float32",
                    w0: bool = False,
                    measured_us: Optional[float] = None) -> Dict[str, float]:
    """Roofline terms of the fused hash-decode at one shape and dtype.

    FLOPs are the JAX package's one-hot formulation, 2·B·m·c·d_c, kept for
    parity: on the H100 that makes ``step_us`` compute-bound, where the
    gather kernel does B·m·d_c adds.  Read a bound for the port's kernel
    from ``memory_us``.  With ``measured_us``, ``achieved_vs_roofline =
    step_us / measured_us``."""
    bytes_ = decode_hbm_bytes(B, c, m, d_c, dtype, w0=w0)
    flops = 2.0 * B * m * c * d_c
    compute_s = flops / PEAK_FLOPS_BF16
    memory_s = bytes_["total"] / HBM_BW
    step_s = max(compute_s, memory_s)
    out = {
        "flops": flops,
        "hbm_bytes": bytes_["total"],
        "hbm_bytes_codebooks": bytes_["codebooks"] + bytes_["scales"],
        "arithmetic_intensity": flops / bytes_["total"],
        "compute_us": compute_s * 1e6,
        "memory_us": memory_s * 1e6,
        "step_us": step_s * 1e6,
        "bound": "compute" if compute_s >= memory_s else "memory",
        "roofline_fraction": flops / (PEAK_FLOPS_BF16 * step_s),
    }
    if measured_us is not None:
        out["achieved_vs_roofline"] = out["step_us"] / max(measured_us, 1e-9)
    return out
