"""The card's constants for the roofline (counterpart of the constants of
``repro/launch/mesh.py``, which are a TPU v5e's).

All four are NVIDIA's data sheet for the NVIDIA H100 80GB HBM3 (SXM part,
dense rates without sparsity) at its full power limit of 700 W; a card set
below that runs slower under load.  The JAX package's mesh builders come
with the LM across ranks (ROADMAP A.18.1).
"""

PEAK_FLOPS_BF16 = 989e12      # FLOP/s, bf16 on the tensor cores (NVIDIA H100 80GB HBM3, 700 W; data sheet)
HBM_BW = 3.35e12              # B/s of HBM3 (NVIDIA H100 80GB HBM3, 700 W; data sheet)
F32_FLOPS = 67e12             # FLOP/s, f32 outside the tensor cores, an FMA as 2 (NVIDIA H100 80GB HBM3, 700 W; data sheet)
NVLINK_BW = 450e9             # B/s each direction, NVLink 4 (NVIDIA H100 80GB HBM3 SXM, 700 W; data sheet: 900 GB/s both ways)
