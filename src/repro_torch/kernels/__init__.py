"""Hand-written CUDA kernels for Hopper (sm_90a).

hash_decode       compositional-code decode as a row gather-sum (replaces
                  the Pallas kernel ``repro/kernels/hash_decode/kernel.py``):
                  codebook slices staged in shared memory from 6,144 rows
                  on, a direct gather below; a deterministic autograd
                  backward in plain PyTorch
flash_attention   online-softmax attention with native GQA (replaces the
                  Pallas kernel ``repro/kernels/flash_attention/kernel.py``):
                  bf16 on the tensor cores (wgmma on TMA-fed tiles), f32 on
                  the CUDA cores; its backward recomputes the plain version
lsh_encode        Algorithm 1's project-binarise-pack for a dense auxiliary
                  matrix, up to four 32-bit code words per entity in one
                  pass over A (replaces the Pallas kernel
                  ``repro/kernels/lsh_encode/kernel.py``): a projection, a
                  pack, and the two fused; ``core.lsh.encode_lsh`` sends
                  dense A through them

Each package: ``csrc/*.cu`` (the kernel, plain C entry point), ``ops.py``
(checks, launch through ctypes, launch counter), ``ref.py`` (the plain
PyTorch version).  ``build.py`` compiles the sources with nvcc at first use.
Importing these modules builds nothing.
"""
