"""Mesh builders and the card's constants (counterpart of
``repro/launch/mesh.py``, whose constants are a TPU v5e's).

``make_production_mesh`` is the JAX package's production layout as a shape
only (``MeshSpec``): (16, 16) = (data, model), or (2, 16, 16) = (pod, data,
model) for two pods; the policy and ``hbm_model`` read it as they read a
JAX mesh, and ``make_production_mesh(live=True)`` raises unless the world
holds its 256 or 512 ranks.  ``make_host_mesh`` is the live mesh of this
rank over the world's ranks (tests, examples, ``chip_smoke.py``).

The constants are NVIDIA's data sheet for the NVIDIA H100 80GB HBM3 (SXM
part, dense rates without sparsity) at its full power limit of 700 W; a
card set below that runs slower under load.
"""

from __future__ import annotations

PEAK_FLOPS_BF16 = 989e12      # FLOP/s, bf16 on the tensor cores (NVIDIA H100 80GB HBM3, 700 W; data sheet)
HBM_BW = 3.35e12              # B/s of HBM3 (NVIDIA H100 80GB HBM3, 700 W; data sheet)
F32_FLOPS = 67e12             # FLOP/s, f32 outside the tensor cores, an FMA as 2 (NVIDIA H100 80GB HBM3, 700 W; data sheet)
NVLINK_BW = 450e9             # B/s each direction, NVLink 4 (NVIDIA H100 80GB HBM3 SXM, 700 W; data sheet: 900 GB/s both ways)


def make_production_mesh(*, multi_pod: bool = False, live: bool = False, device=None):
    """(16, 16) = (data, model), or (2, 16, 16) = (pod, data, model): a
    ``MeshSpec``, or with ``live`` this rank's ``Mesh`` (the world must
    hold 256 or 512 ranks)."""
    from repro_torch.parallel.sharding import Mesh, MeshSpec
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    spec = MeshSpec(axes, shape)
    return Mesh(spec, device=device) if live else spec


def make_host_mesh(data: int = 2, model: int = 2, pod: int = 0, device=None):
    """This rank's live (data, model) mesh, or (pod, data, model) with
    ``pod``, over the initialised process group (``data * model`` ranks,
    times ``pod``)."""
    from repro_torch.parallel.sharding import make_mesh
    if pod:
        return make_mesh((pod, data, model), ("pod", "data", "model"), device=device)
    return make_mesh((data, model), ("data", "model"), device=device)
