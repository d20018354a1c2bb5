"""PyTorch + CUDA port of ``repro`` (hash-compressed embeddings, Yeh et al.,
KDD 2022) for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors its layout
and names so each module has an obvious counterpart, and it imports neither
JAX nor anything of ``repro``.  What is ported so far is the paper's
hash-compressed GraphSAGE (training, on one device or across N ranks,
serving, the hot-node cache and the batching tier), its full-graph GCN,
SGC and GIN (training, evaluation,
link prediction), the consumer × merchant graph, the embedding
reconstruction, and LM training and serving of every family of the JAX
package (dense, moe, ssm, hybrid, audio, vlm) on one device:

core      LSH coding (Algorithm 1), packed codes, decode backends, the
          hot-node decode cache, decoder, embedding layer
kernels   hand-written CUDA kernels for Hopper (``hash_decode`` with its
          autograd backward, ``flash_attention``, ``lsh_encode``)
graph     CSR graphs (and their device-resident product), generators,
          neighbour sampling, the sharded batch source and owner plan,
          model entry point, ``GraphRuntime``
parallel  N ranks over ``torch.distributed`` (``DataMesh``, ``spawn``)
          and a stacked frontier's placement on them
models    the GraphSAGE and full-graph GCN / SGC / GIN forwards,
          node-classification heads, link scores and losses, hits@K and
          hit@k; the decoder LM of six families (``models.lm``)
nn        parameter conventions, layers, RoPE and M-RoPE, attention and
          its KV cache, MoE, the Mamba2 SSD
optim     AdamW and learning-rate schedules
train     the LM and GNN train steps, the training loop, checkpoints
data      the synthetic token stream and its co-occurrence pass
launch    ``launch.train``, the LM training front door; the shape set and
          the roofline on the H100's constants (``shapes``, ``roofline``,
          ``mesh``)
serving   ``GraphInferenceEngine`` (hot-node cached by default), the
          continuous-batching ``ServingBatcher`` and the LM ``DecodeEngine``
configs   ``EmbeddingSpec``, ``GNNConfig``, ``LMConfig`` and the registry,
          the paper's GNN configs and the JAX package's ten LM archs
interop   params of the JAX package's ``init_gnn`` / ``init_lm`` and its
          ``CacheState`` -> the port's

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (``repro_torch.device.resolve_device``).
"""

__version__ = "0.1.0"
