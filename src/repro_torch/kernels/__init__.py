"""Hand-written CUDA kernels for Hopper (sm_90a).

hash_decode       compositional-code decode as a row gather-sum (replaces
                  the Pallas kernel ``repro/kernels/hash_decode/kernel.py``),
                  with a deterministic autograd backward in plain PyTorch
flash_attention   online-softmax attention with native GQA (replaces the
                  Pallas kernel ``repro/kernels/flash_attention/kernel.py``):
                  bf16 on the tensor cores (wgmma on TMA-fed tiles), f32 on
                  the CUDA cores; its backward recomputes the plain version
lsh_encode        Algorithm 1's project-binarise-pack for a dense auxiliary
                  matrix, one 32-bit code word per entity (replaces the
                  Pallas kernel ``repro/kernels/lsh_encode/kernel.py``);
                  ``core.lsh.encode_lsh`` sends dense A through it

Each package: ``csrc/*.cu`` (the kernel, plain C entry point), ``ops.py``
(checks, launch through ctypes, launch counter), ``ref.py`` (the plain
PyTorch version).  ``build.py`` compiles the sources with nvcc at first use.
Importing these modules builds nothing.
"""
