"""PyTorch + CUDA port of ``repro`` (hash-compressed embeddings, Yeh et al.,
KDD 2022) for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors its layout
and names so each module has an obvious counterpart, and it imports neither
JAX nor anything of ``repro``.  What is ported so far is the serving path
of the paper's hash-compressed GraphSAGE:

core      LSH coding (Algorithm 1), packed codes, decode backends, decoder,
          embedding layer
kernels   hand-written CUDA kernels for Hopper (``hash_decode``)
graph     CSR graphs, generators, neighbour sampling, model entry point,
          ``GraphRuntime``
models    GraphSAGE forward and node-classification heads
serving   ``GraphInferenceEngine`` (hot-node cache off)
configs   ``EmbeddingSpec``, ``GNNConfig``, the paper's GNN configs
interop   params of the JAX package's ``init_gnn`` -> port params

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (``repro_torch.device.resolve_device``).
"""

__version__ = "0.1.0"
