"""PyTorch + CUDA port of ``repro`` (hash-compressed embeddings, Yeh et al.,
KDD 2022) for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors its layout
and names so each module has an obvious counterpart, and it imports neither
JAX nor anything of ``repro``.  What is ported so far is the serving path
of the paper's hash-compressed GraphSAGE and LM training of the dense
family (``qwen1.5-0.5b``, its vocabulary hash-compressed):

core      LSH coding (Algorithm 1), packed codes, decode backends, decoder,
          embedding layer
kernels   hand-written CUDA kernels for Hopper (``hash_decode`` with its
          autograd backward, ``flash_attention``)
graph     CSR graphs, generators, neighbour sampling, model entry point,
          ``GraphRuntime``
models    GraphSAGE forward and node-classification heads; the dense
          decoder LM (``models.lm``)
nn        parameter conventions, layers, RoPE, attention (no KV cache)
optim     AdamW and learning-rate schedules
train     the LM train step and the training loop
data      the synthetic token stream and its co-occurrence pass
launch    ``launch.train``, the LM training front door
serving   ``GraphInferenceEngine`` (hot-node cache off)
configs   ``EmbeddingSpec``, ``GNNConfig``, ``LMConfig`` and the registry,
          the paper's GNN configs, ``qwen1.5-0.5b``
interop   params of the JAX package's ``init_gnn`` / ``init_lm`` -> port
          params

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (``repro_torch.device.resolve_device``).
"""

__version__ = "0.1.0"
