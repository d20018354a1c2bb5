#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100 for the numbers
in PERF.md):

    python3 chip_smoke.py

from the root of a checkout.  It builds the port's CUDA kernels from the
sources in ``src/repro_torch`` (one nvcc per source, all at once), checks
in the built libraries' SASS that the bf16 and f16 flash_attention
kernel runs its products on the tensor cores (HGMMA) and the f32 and panel
ones on the CUDA cores (FFMA, no HMMA or HGMMA), that lsh_encode's
products are fused (FFMA) and that hash_decode's sums are not (no FFMA),
holds each kernel against its plain PyTorch version at the shapes its
paths give it and at the inputs no config gives it (flash in f16, at
head dims 4 to 320 and on strided and unaligned operands; f16 codebooks;
12-bit codes in the backward),
and drives these paths through the port's entry points, with random
weights and data from a seed:

  serve  the paper's full-width hash-compressed GraphSAGE
         (``paper_gnn_config("sage")``: c=256, m=16, d_c=d_m=512, 3-layer
         decoder, d_e=64, 2 SAGE layers x 128, fanout 15, f32) on a
         169,343-node power-law graph (the size of ogbn-arxiv):
         ``GraphRuntime.from_spec`` -> ``rt.serve(cache_capacity=0)`` -> 8
         requests of 256 nodes and one ``serve_many`` of 4 (the uncached
         reference);
  serve_cached  ``rt.serve()`` with no arguments: the hot-node cache at the
         JAX default capacity (all 169,343 nodes), miss-only decode; the
         same 12 requests and 8 repeats, each call's miss rows held bitwise
         against the uncached decode, its outputs against the uncached
         engine's, its bookkeeping against a CPU replay, and a
         ``serve_many`` of 4's peak memory against the uncached one's;
  serve_batched  ``rt.serve(batching=BatchingSpec(max_batch=4))`` with 16
         requests from 4 threads, against a sequential cached engine;
  gnn_train  the same model trained on the same graph through
         ``GraphRuntime.train`` (batch 256, AdamW, prefetched batches): 300
         steps, one forward and one backward ``hash_decode`` launch a step;
         steps timed with and without prefetch, one step's stage breakdown
         and profile, ``evaluate("val")``, and a run killed at step 10 and
         resumed with ``GraphRuntime.resume`` against a straight one, bit
         for bit;
  gnn_train_cached  the same training with the hot-node cache (96,256
         slots, serving's rule of 4 frontiers), 20 steps from the same
         init: staleness 0 against the uncached losses bit for bit;
         staleness 4, plain and with the miss planner, the host shadow
         held against the card's bookkeeping after every step; the
         planned run killed at 10 and resumed, bit for bit;
  fullgraph_gcn, fullgraph_sgc, fullgraph_gin  the paper's full-graph
         models (``paper_gnn_config(model)``, the same widths, hidden 128)
         on the serve graph through ``GraphRuntime.train`` (50 steps at lr
         1e-3; every step decodes all 169,343 nodes in one ``hash_decode``
         call and one backward call, and multiplies by the normalised
         adjacency uploaded once), ``evaluate("val")`` and ``embed``: step
         periods, one step's stage breakdown, peak memory; for GCN also two
         gradients of one step, a run killed at step 10 and resumed, bit
         for bit, and the sparse product's time at widths 64 and 128 beside
         ``torch.sparse.mm`` and its byte bound;
  link   Table 1's link protocol (``benchmarks/table1_gnn.py``):
         ``holdout_edges``, GCN with ``task="link"``, 60 steps of 512
         positive and 512 negative pairs through ``link_loss``, hits@50;
  merchant  Table 3's protocol (``benchmarks/table3_merchant.py``) on the
         consumer x merchant graph (6,000 x 4,000, 32 categories) at the
         §5.3.2 widths: naive SAGE on ``NeighborSampler.minibatches``, 4
         epochs, random and hash codes, accuracy, hit@5 and hit@10;
  families_hashemb, families_tt, families_int8  gnn_train's spec with
         one field changed by ``RuntimeSpec.with_updates``:
         ``lookup_impl="hashemb"`` (position hashes, pools folded with
         their per-position weights, decoded by the kernel),
         ``lookup_impl="tt", tt_rank=8`` (a core pair decoded in PyTorch:
         no ``hash_decode`` launch) and ``quantize="int8"`` (the kernel's
         int8 variant, the gradient straight through to the f32 masters):
         300 steps each, ``evaluate("val")``, ``rt.serve()`` against
         ``serve(cache_capacity=0)`` bit for bit, two gradients of one
         step, and for hashemb and tt a run killed at step 10 and resumed;
         the forward and the backward held bitwise at every row count the
         hashemb path (f32) and the int8 path (the int8 variant) decoded;
         TT's decode and the int8 kernel timed at the paths' frontiers,
         beside the f32 kernels at the same rows;
  codes_host, codes_host_serve, codes_host_int8  gnn_train's spec with
         ``codes_placement="host"`` (the packed codes stay in host RAM;
         the prefetch producer gathers each frontier's rows into the
         batch's pinned buffer) beside device placement from one init and
         one code buffer, each placement alone on the card: 50 steps at
         prefetch 2 and 20 at prefetch 0, ``evaluate("val")``, ``embed``,
         ``rt.serve()``, ``serve(cache_capacity=0)`` and the batching tier,
         a host run killed at step 10 and resumed, and int8 storage for 20
         steps, all bitwise the device placement's; the period, the
         producer's stages, the code bytes moved a batch and held on the
         card and the peak memory of each; then the same at a fixed
         61,696-row frontier on the serve graph and on one of 8x its nodes
         (random codes); the kernels held bitwise at every row count the
         host path decoded;
  sharded, owner, sharded_auto  gnn_train's spec with ``n_shards=4``: 4
         ranks of ``torch.distributed`` spawned from this script share the
         card over gloo (``repro_torch.parallel.sharding.spawn``), under
         ``lookup_impl`` ``sharded:pallas``, ``owner:pallas`` and ``auto``:
         20 steps, ``evaluate("val")``, 10 and a checkpoint (rank 0 writes),
         10 more in memory against 10 after ``GraphRuntime.resume``, and 20
         at Adam's eps 1, beside 1-shard runs from the same init; each
         rank's step-0 batch, the decoded rows against the 1-shard
         frontier's, every rank's params, the owner plans' distinct ids;
         the period, bytes exchanged, rows decoded and peak memory a rank;
         launches summed over the ranks; NCCL one card a rank where there
         are 4 cards;
  elastic, elastic_ckpt, elastic_grow  gnn_train's spec with
         ``n_shards=4`` and a global batch of 192 (48 a rank at 4, 64 at
         3), 4 ranks sharing the card over gloo: (a) ``ElasticManager``
         under ``sharded:pallas`` kills rank 2 at step 10 (lease 1, chunk 1
         of the 64 KiB wire corrupted once), recovers from the peers and
         goes on at 3 ranks, bitwise a never-failed run taken to 3 ranks by
         ``rescale(3)`` after 12 steps; (b) a 4-rank ``owner:pallas`` run
         (caps pinned) writes its step-0 checkpoint, which
         ``GraphRuntime.rescale_checkpoint`` takes to 2 ranks for one step,
         bitwise a native 2-rank run; (c) a native 2-rank ``sharded:pallas``
         runtime grown to 4 by ``rescale(4)`` at step 0 takes one step,
         bitwise a native 4-rank run; the refusals (a 2-rank spec on the
         4-rank checkpoint, ``rescale(5)``); the periods before and after
         the rescale, the recovery's wall time and bytes, peak memory a
         rank; the kernels held bitwise at every row count the phase
         decoded; (a) again over NCCL one card a rank where there are 4
         cards;
  train  full-width ``qwen1.5-0.5b`` (24 layers, d_model 1024, 16 heads,
         vocab 151,936, ``hash_full`` embedding, bf16 activations) with
         ``attn_impl="flash"`` and ``lookup_impl="auto"``, through the
         launcher's chain (``repro_torch.launch.train.train``: token stream
         -> co-occurrence pass -> Algorithm 1 -> init -> train step ->
         loop) for 5 steps of batch 4 x 2048 tokens; its vocabulary encode
         (Algorithm 1 over a dense 152,064 x 512 co-occurrence matrix, all
         128 bits in one projection and one pack) runs through
         ``lsh_encode``;
  serve_lm, serve_lm_chatglm3  full-width ``qwen1.5-0.5b`` (bf16
         activations, ``lookup_impl="auto"``) served through
         ``repro_torch.serving.DecodeEngine`` at ``s_max=1024``: 8 prompts
         of 512 tokens, 64 new tokens greedily (one prefill and 64 decode
         steps against the per-layer KV caches, each decoding its token
         embeddings through ``hash_decode``); the same engine on ``gather``
         from the same params, every step's logits and the tokens bitwise;
         ``lm_forward`` without a cache over the final sequences within a
         stated bound of the cached logits, in bf16 and in f32, where a
         cache off by one position must miss the bound; prefill and
         per-token times read from the engine's own ``generate``,
         the KV cache's bytes, peak memory, one decode step's stages and
         profile; then full-width ``chatglm3-6b`` (28 layers, d_model 4096,
         2 KV heads, half RoPE, QKV bias, ~6 B f32 parameters): 4 prompts
         of 256, 16 new tokens, the same bitwise check; and reduced qwen and
         chatglm3 served on the card and on the CPU.  Phase ``train`` also
         takes one loss and gradient with the chunked cross-entropy
         (``loss_vocab_chunk=19008``) against the plain one, and the
         chunked loss with its pad columns unmasked, which must miss the
         loss bound;
  moe_train, moe_sorted, moe_serve  full-width ``granite-moe-3b-a800m``
         (32 layers, d_model 1536, 24 heads on 8 KV heads, 40 experts of
         512 padded to 48, top-8, vocab 49,155, ``hash_full``): 3 steps of
         4 x 2048 tokens from the launcher's parts on the JAX package's
         profile for it (every expert on every token, ``moe_impl="dense"``;
         bf16 Adam moments; ``attn_impl="flash"``), two gradients of one
         step bit for bit, one step of the sorted dispatch from the same
         state against the dense loss, then the trained params served
         through ``DecodeEngine`` as ``serve_lm`` is (8 prompts of 512, 8
         greedy tokens, cut from 64 for the script's time; kernel engine bitwise the ``gather`` engine; an f32
         engine against ``lm_forward`` without a cache, each row up to its
         first position whose expert routing differs between the two);
  ssm_train, ssm_serve  full-width ``mamba2-2.7b`` (64 Mamba2 layers,
         d_model 2560, 80 SSD heads, state 128): the SSD mask control (the
         JAX order's NaN dt gradient at these heads), 3 steps on its JAX
         profile (bf16 moments, ``loss_vocab_chunk=6304``), then served
         the same way (the single-step recurrence against the chunked scan
         in f32);
  hybrid_train, hybrid_serve  full-width ``zamba2-7b`` (81 Mamba2
         layers in 13 groups of 6 and a tail of 3, one shared attention
         block of 32 heads of 112 called at 13 sites): 13 of its layers
         (two groups and a tail of one, the shared block at 2 sites;
         1,448,372,736 parameters) trained 2 steps of 4 x 2048 on its
         JAX profile (bf16 moments, ``loss_vocab_chunk=4000``) through
         flash at D = 112; then all 81 layers: ``init_lm``'s peak against
         its masters, then served the same way; and the three families'
         reduced configs trained and served on the card and on the CPU
         (zamba2's through the f32 flash kernel, its launches counted as
         the path ``families_reference``);
  musicgen_train, musicgen_hash, musicgen_serve  full-width
         ``musicgen-large`` (48 layers, d_model 2048, 32 heads of 64, 4
         codebooks of 2,048, its dense embedding, LayerNorm, GELU,
         sinusoidal positions; 2,436,890,624 parameters): 3 steps of 4 x
         2048 x 4 random codebook tokens on its JAX profile (f32 moments,
         flash attention), two gradients of one batch bit for bit; the
         ``hash_full`` ablation (Algorithm 1 over the 2,048-entry
         vocabulary through ``lsh_encode``, tiled over the 4 codebooks, the
         32,768 offset ids decoded in one ``hash_decode`` call): loss and
         codebook gradient on the kernel bitwise on ``gather``; then the
         trained params served (8 prompts of 512 x 4, 8 greedy tokens, one
         argmax a codebook; f32 cached against uncached within 1e-4, a
         cache off by one position outside it);
  vlm_train, vlm_serve  ``qwen2-vl-7b`` at full width (d_model 3584, 28
         heads on 4 KV heads of 128, d_ff 18,944, QKV bias, vocab 152,064,
         ``hash_full``, M-RoPE): 14 of its 28 layers trained 3 steps on its
         JAX profile (bf16 moments, ``loss_vocab_chunk=19008``, flash) on
         batches whose (3, 4, 2048) positions lay out a 32 x 32 image span
         a sequence; three equal streams against standard RoPE bit for bit;
         then all 28 layers served (8 x 512, 8 greedy tokens, kernel engine
         bitwise the ``gather`` engine); both families' reduced configs
         trained and served on the card and on the CPU.  Every LM training
         path prints its model-FLOPs share of the bf16 peak (``[mfu]``);
  lm_tp, lm_dp, moe_ep, ssm_tp, pipeline  the LM across 4 ranks of
         ``torch.distributed`` sharing the card over gloo on the (data 2,
         model 2) mesh, each rank holding its blocks of the state:
         ``qwen1.5-0.5b`` at full width under the JAX package's TP ⊗ FSDP
         (3 steps, then a second run of 2 that must repeat its losses) and
         under its profile's ``dp_over_model`` (3 steps), each against the
         one-rank step from the same init and batch (step-0 loss, every
         rank's step-0 gradient blocks and clip norm, params after one
         step); ``granite-moe-3b-a800m`` under expert parallelism (8 of
         its 32 layers, 2 steps; every layer's EP output bitwise
         ``moe_ffn_ep_reference``); ``mamba2-2.7b`` under TP over its SSD
         heads (32 of its 64 layers, f32, 2 steps; step-0 loss, gradient
         blocks and clip norm
         against the one-rank step);
         ``gpipe`` over 4 stages of 6 of qwen's
         blocks against ``pipeline_reference``; ``psum_compressed`` over
         lm_dp's gradient blocks bitwise its plain version on card and CPU;
         every replicated leaf equal on all ranks after every step; the
         period, bytes a rank by axes and operation, peak per rank and MFU
         on one chip; the reduced configs (qwen under TP ⊗ FSDP, granite
         under ``dp_over_model`` and under EP with nothing dropped) at 4
         ranks against one on card and CPU; NCCL one card a rank where
         there are 4 cards;
  serve_tp, serve_ssm_tp, serve_split_kv  prefill and greedy decode
         across the same 4 ranks (f32): qwen1.5-0.5b and mamba2-2.7b (32
         of its 64 layers) on (2, 2), chatglm3-6b cut to 4 layers on (1,
         4), whose 2 KV heads do not divide the model axis, so the cache's
         slots split over it;
         every rank the same logits bits, each step's logits against the
         one-rank steps on the same params and tokens;
  dryrun  ``launch/dryrun.py``'s ``build_cell`` at each 4-rank path's own
         mesh and shape, traced on the host (one low-priority worker beside the
         card's work): bytes by axes and operation equal to what the
         ranks' ``Mesh.stats`` read, peak a rank within 20% of the card's
         ``max_memory_allocated``, counted FLOPs beside ``model_flops``,
         the counter's calibration, one production cell timed;
  reconstruct  the paper's pre-trained embedding reconstruction (§5.1,
         Fig. 1, Table 5) at GloVe's shape: 200,000 x 300 Gaussian-mixture
         embeddings coded by random, hashing (Algorithm 1 through
         ``lsh_encode``) and learned (autoencoder) codes, each decoder
         (c=256, m=16, d_c=d_m=512, 3 layers, f32) trained 300 steps of
         512 through ``hash_decode`` and its backward
         (``repro_torch.launch.reconstruct.run``).

The ``hash_decode`` backward kernels (the codebook gradient: a stable
sort of each codebook's rows by code, then the sums) are held bitwise
against their plain versions at 64 uniform shapes, at skewed codes, at
the GNN run's real codes, at the full graph's 169,343 rows (uniform
and the full-graph GCN's codes; the sort against ``code_order`` too), in
f16 and at (m, c) = (16, 4096), and timed at a training frontier, at
61,696 rows (also at c = 4,096), at the LM step's 8,192 bf16 rows, at the
reconstruction's 512 (as a CUDA graph) and at 169,343 rows, beside the
one-hot contraction they replaced and ``embedding_bag``'s backward.

Each path is driven with the kernels' launch counts set to 0 just before
it and read just after, and so are the operands the wrappers copied on the
way (``[copies]``), which must stay 0 on every path.  A small version of each path (a 3,000-node
graph served, and trained by GCN, SGC and GIN and under each family and
int8; the reduced LM config, trained and served, the
reconstruction at the JAX benchmark's size) runs on the card and on the
CPU (plain versions), and the two must agree; the reduced LM's training
launches the f32 flash kernel, counted as the path ``lm_reference``.
Every check raises on failure, so the script exits nonzero; it prints the
``{"kernels": ...}`` line and then, as its last line, ``{"ok": true,
"device": {...}}`` only when every phase passed.  It needs one card and imports nothing of JAX;
phases ``sharded``, ``elastic`` and ``lm_ranks`` start 4 processes on it
and stop them.
"""

from __future__ import annotations

import contextlib
import json
import math
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# The card's rates, one source: ``repro_torch.launch.mesh`` (NVIDIA's data
# sheet for the H100 80GB HBM3 at 700 W).  Outside a checkout the import
# fails and ``main`` stops before any phase.
sys.path.insert(0, str(SRC))
try:
    from repro_torch.launch.mesh import F32_FLOPS
    from repro_torch.launch.mesh import HBM_BW as HBM_BYTES_PER_S
    from repro_torch.launch.mesh import PEAK_FLOPS_BF16 as BF16_FLOPS
except ImportError:
    HBM_BYTES_PER_S = BF16_FLOPS = F32_FLOPS = float("nan")
# The data sheet's f32 rate outside the tensor cores counts each FMA as two
# operations; a lone add runs at the FMA rate, so adds peak at half.
F32_ADDS_PER_S = F32_FLOPS / 2

N_NODES = 169_343
N_CLASSES = 40
REQUEST = 256

LM_ARCH = "qwen1.5-0.5b"
LM_BATCH, LM_SEQ, LM_STEPS = 4, 2048, 5

# the reconstruction path: Table 6's largest count at GloVe's width, the
# paper's full decoder (§B.2), the Fig. 1 benchmark's 300 steps
REC = dict(n=200_000, dim=300, c=256, m=16, d_c=512, d_m=512)
REC_STEPS, REC_SCHEMES = 300, ("random", "hashing", "learn")
REC_BATCH = 512                    # the reconstruction's decoder batch
TABLE6_RATIO = 18.11               # Table 6, GloVe, (c, m) = (256, 16), n = 200,000
VOCAB = 152_064                    # qwen1.5-0.5b's padded vocabulary
# (n, d, W): all four words of a (256, 16) code in one projection
LSH_PATH_SHAPES = [(REC["n"], REC["dim"], 128), (VOCAB, 512, 128)]
LSH_INT_SHAPES = [(2048, 512, 32), (1024, 256, 16), (512, 128, 32),  # test_kernels.py
                  (1000, 300, 32), (333, 7, 5), (1000, 300, 80), (777, 77, 9),
                  (129, 33, 64), (3001, 300, 128)] + LSH_PATH_SHAPES


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def _snapshot(tree, dev=None):
    """A copy of a tree (dicts of tensors, ``None`` moments of buffers and
    integer counters alike) on ``dev``, or where each tensor lies: the
    optimizer updates params in place, so a run that must start from them
    again takes a copy."""
    if isinstance(tree, dict):
        return {k: _snapshot(v, dev) for k, v in tree.items()}
    return tree.to(dev or tree.device, copy=True) if hasattr(tree, "to") else tree


def time_ms(fn, iters: int) -> tuple:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, by
    CUDA events, after a warm-up; and the mean host time to enqueue one
    call.  When the two are close, the host's enqueue rate, not the card,
    set the device time."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host_ms


def graph_time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` captured ``iters`` times into one CUDA
    graph and replayed, after a warm-up: the card's time alone, with no
    host enqueue between the launches (at small shapes the host takes
    longer to enqueue a launch than the card to run it)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    import torch
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"[device] {name} x{count}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    print(smi_query("name,power.limit"), flush=True)
    return name, count


def phase_build():
    """One nvcc per kernel source, all started together."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.hash_decode import ops as hd_ops
    from repro_torch.kernels.lsh_encode import ops as lsh_ops
    sources = (hd_ops, fa_ops, lsh_ops)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        built = list(pool.map(lambda m: (m.NAME, m.build()), sources))
    secs = time.perf_counter() - t0
    for name, (path, log) in built:
        print(f"[build] {name} -> {path.name} ({secs:.2f} s for all)", flush=True)
        for line in log.splitlines():
            if re.search(r"registers|spill|Compiling entry|setmaxnreg|warning", line):
                print(f"[build]   {line.strip()}", flush=True)
    libraries = dict(built)
    check_tensor_cores(libraries[fa_ops.NAME][0])
    check_cuda_cores(libraries[fa_ops.NAME][0])
    check_fma(libraries[lsh_ops.NAME][0], libraries[hd_ops.NAME][0])


def sass_counts(library: Path, opcode: str) -> dict:
    """{kernel function: number of ``opcode`` instructions} in the built
    library's SASS (cuobjdump beside nvcc)."""
    from repro_torch.kernels.build import find_nvcc
    cuobjdump = Path(find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(library)],
                          capture_output=True, text=True, timeout=120)
    check(sass.returncode == 0, f"cuobjdump failed: {sass.stderr}")
    counts, fn = {}, None
    for line in sass.stdout.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            fn = head.group(1)
            counts[fn] = 0
        elif fn is not None and re.search(rf"\b{re.escape(opcode)}\b", line):
            counts[fn] += 1
    return counts


def check_fma(lsh_library: Path, hd_library: Path) -> None:
    """lsh_encode's products must be fused (``__fmaf_rn`` survives
    ``--fmad=false``): every instantiation of its projection kernel holds
    FFMA.  hash_decode's sums must not be (its bits rest on separate
    ``__fmul_rn`` and ``__fadd_rn``): none of its kernels holds FFMA."""
    lsh = {fn: n for fn, n in sass_counts(lsh_library, "FFMA").items()
           if "lsh_project_kernel" in fn}
    check(len(lsh) == 12, f"expected 12 instantiations of lsh_project_kernel, found {len(lsh)}")
    print(f"[sass] lsh_encode lsh_project_kernel: FFMA in each of its {len(lsh)} "
          f"instantiations: {sorted(lsh.values())}", flush=True)
    check(all(n > 0 for n in lsh.values()), f"an lsh_encode projection without FFMA: {lsh}")
    hd = sass_counts(hd_library, "FFMA")
    print(f"[sass] hash_decode: FFMA in its {len(hd)} kernels: {sum(hd.values())}", flush=True)
    check(len(hd) >= 12 and sum(hd.values()) == 0,
          f"hash_decode kernels with FFMA (its sums must round each add): {hd}")


def check_tensor_cores(library: Path) -> None:
    """The bf16 and f16 flash_attention kernel must do its products on the
    tensor cores: count the HGMMA instructions in each of its
    instantiations' SASS and fail on any with none."""
    counts = {fn: n for fn, n in sass_counts(library, "HGMMA").items()
              if "flash_attention_wgmma" in fn}
    check(len(counts) == 8, f"expected the bf16 and f16 kernel at D = 32, 64, 128, 256 in "
                            f"{library.name}, found {sorted(counts)}")
    for fn, n in sorted(counts.items()):
        d = re.search(r"wgmmaILi(\d+)ELb([01])E", fn)
        what = f"{'f16' if d.group(2) == '1' else 'bf16'} kernel D={d.group(1)}" if d else fn
        print(f"[sass] flash_attention {what}: {n} HGMMA instructions", flush=True)
        check(n > 0, f"no HGMMA in {fn}: the 16-bit products are off the tensor cores")


def check_cuda_cores(library: Path) -> None:
    """The f32 flash_attention kernel must stay IEEE f32 on the CUDA cores:
    each of its four instantiations holds FFMA (its explicit ``fmaf``
    products, which ``--fmad=false`` keeps) and no HMMA or HGMMA (no TF32
    on the tensor cores); so must the panel kernel's three (f32, bf16 and
    f16 operands, f32 sums)."""
    ffma, hmma, hgmma = (sass_counts(library, op) for op in ("FFMA", "HMMA", "HGMMA"))
    fns = sorted(fn for fn in ffma if "cuda_core" in fn and "flash_attention_kernel" in fn)
    check(len(fns) == 4, f"expected the f32 kernel at DT = 32, 64, 128, 256 in "
                         f"{library.name}, found {fns}")
    panels = sorted(fn for fn in ffma if "flash_attention_panels" in fn)
    check(len(panels) == 3, f"expected the panel kernel in 3 dtypes, found {panels}")
    for fn in fns + panels:
        dt = re.search(r"kernelILi(\d+)E", fn)
        what = f"f32 kernel DT={dt.group(1)}" if dt else f"panel kernel {fn}"
        print(f"[sass] flash_attention {what}: {ffma[fn]} "
              f"FFMA, {hmma[fn]} HMMA, {hgmma[fn]} HGMMA", flush=True)
        check(ffma[fn] > 0 and hmma[fn] == 0 and hgmma[fn] == 0,
              f"{fn}: the f32 products must be FFMA on the CUDA cores")


def _operands(B, m, c, d_c, variant, seed):
    import numpy as np
    import torch
    from repro_torch.kernels.hash_decode import ops
    rng = np.random.default_rng(seed)
    codes = torch.from_numpy(rng.integers(0, c, (B, m)).astype(np.int32))
    cb = torch.from_numpy(rng.standard_normal((m, c, d_c)).astype(np.float32))
    w0 = torch.from_numpy(rng.standard_normal(d_c).astype(np.float32))
    dtype, _, with_w0 = variant.partition("+")
    scales = None
    if dtype in ("bfloat16", "float16"):
        half = getattr(torch, dtype)
        cb, w0 = cb.to(half), w0.to(half).float()
    elif dtype == "int8":
        cb, scales = ops.quantize_codebooks(cb)
    return [None if t is None else t.cuda()
            for t in (codes, cb, w0 if with_w0 else None, scales)]


def smi_query(field: str) -> str:
    smi = subprocess.run(["nvidia-smi", f"--query-gpu={field}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip().splitlines()[0]


def smem_ceiling_ms(B: int, m: int, d_c: int, elem: int = 4) -> tuple:
    """(ms, MHz): the staged decode's shared-memory reads, B*m*d_c*elem
    bytes (each output element sums m terms of ``elem``-byte storage), at
    128 B/clock/SM on every SM at the card's maximum SM clock as
    nvidia-smi reports it."""
    import torch
    mhz = float(smi_query("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return B * m * d_c * elem / (128 * sms * mhz * 1e6) * 1e3, mhz


def decode_bytes(B: int, m: int, c: int, d_c: int, storage: str, named: int) -> int:
    """The bytes one decode must move: the codes read, each codebook row
    (and int8 scale) that they name read once, f32 rows written.  Where
    every row is named this is ``roofline.decode_hbm_bytes``'s total, which
    is checked; a decode step's 8 rows name fewer, counted here."""
    from repro_torch.launch import roofline
    storage = "bfloat16" if storage == "float16" else storage   # the same 2 bytes a value
    elem = roofline.DECODE_DTYPE_BYTES[storage]
    nbytes = B * m * 4 + named * d_c * elem + B * d_c * 4 + (named * 4 if storage == "int8" else 0)
    if named == m * c:
        model = roofline.decode_hbm_bytes(B, c, m, d_c, storage)["total"]
        check(model == nbytes, f"decode bytes {nbytes} against roofline.decode_hbm_bytes' {model}")
    return nbytes


def time_at_shape(B: int, m: int, c: int, d_c: int, storage: str = "float32") -> dict:
    """Kernel, plain and ``embedding_bag`` times of the decode without w0
    at one shape from ``storage`` codebooks (f32, or int8 with its
    per-(codebook, code) scales), and the bound computed from this run's
    codes: bytes (the codes read, each codebook row and scale that they
    name read once, f32 rows written: a decode step's 8 rows name at most
    128 of the 4,096 rows) or operations (the adds, and under int8 a
    dequantising multiply a term).  int8 has no library call: none takes
    per-row scales."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.hash_decode import ops
    from repro_torch.kernels.hash_decode.ref import hash_decode_ref
    codes, cb, _, scales = _operands(B, m, c, d_c, storage, seed=0)
    kernel_ms, enqueue_ms = time_ms(lambda: ops.hash_decode(codes, cb, None, scales), 50)
    plain_ms, _ = time_ms(lambda: hash_decode_ref(codes, cb, None, scales), 10)
    library_ms, library = None, "none (no library call takes per-row scales)"
    if scales is None:
        idx = codes.long() + (torch.arange(m, device="cuda") * c)[None, :]
        table = cb.reshape(m * c, d_c)
        lib_err = float((F.embedding_bag(idx, table, mode="sum")
                         - ops.hash_decode(codes, cb)).abs().max())
        library_ms, _ = time_ms(lambda: F.embedding_bag(idx, table, mode="sum"), 50)
        library = f"embedding_bag {library_ms:.4f} ms (max diff to kernel {lib_err})"
    quantized = scales is not None
    named = int(torch.unique(codes.long() + torch.arange(m, device="cuda") * c).numel())
    bytes_moved = decode_bytes(B, m, c, d_c, storage, named)
    operations = B * (m - 1) * d_c + (B * m * d_c if quantized else 0)
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = operations / F32_ADDS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    smem_ms, mhz = smem_ceiling_ms(B, m, d_c, cb.element_size())
    variant = ops.launch_shape(B, m, c, d_c, cb.element_size(), quantized,
                               torch.cuda.get_device_properties(0).multi_processor_count).variant
    print(f"[kernel] shape ({B}, {m}, {c}, {d_c}) {storage}, {variant} variant: kernel "
          f"{kernel_ms:.4f} ms (host enqueues a launch in {enqueue_ms:.4f} "
          f"ms), plain {plain_ms:.4f} ms, {library}, bound "
          f"{bound_ms:.6f} ms by {bound_by} ({bytes_moved} B, {named} of {m * c} "
          f"codebook rows named, in "
          f"{bytes_ms:.4f} ms, {operations} {'multiplies and ' if quantized else ''}adds in "
          f"{ops_ms:.4f} ms), shared-memory ceiling {smem_ms:.4f} ms "
          f"({B * m * d_c * cb.element_size()} B at 128 B/clock/SM, {mhz:.0f} MHz); "
          f"{bytes_moved / kernel_ms / 1e6:.1f} GB/s of required traffic; "
          f"{B * m * d_c * cb.element_size() / kernel_ms / 1e6:.1f} GB/s of summed "
          f"codebook rows", flush=True)
    del codes, cb, scales
    torch.cuda.empty_cache()
    return dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, smem_ceiling_ms=smem_ms)


def time_variants() -> dict:
    """The staged and the direct variant in turns at the paths' batch sizes
    (the reconstruction's 512, the training's 8,192, one request's 61,696)
    and between, f32 and bf16, each as a CUDA graph of 20 launches (device
    time without the host's enqueue): where the staged variant starts to
    pay sets ``STAGED_MIN_ROWS``."""
    import torch
    from repro_torch.kernels.hash_decode import ops
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for dtype in ("float32", "bfloat16"):
        for B in (REC_BATCH, 2048, 4096, 6144, LM_BATCH * LM_SEQ, 61_696):
            codes, cb, _, _ = _operands(B, 16, 256, 512, dtype, seed=5)
            turns = {"staged": [], "direct": []}
            for variant in ("staged", "direct", "direct", "staged"):
                turns[variant].append(graph_time_ms(
                    lambda: ops._forward(codes, cb, None, None, variant), 20))
            chosen = ops.launch_shape(B, 16, 256, 512, cb.element_size(), False, sms).variant
            out[f"{dtype}/{B}"] = dict(staged_ms=min(turns["staged"]),
                                       direct_ms=min(turns["direct"]), chosen=chosen)
            print(f"[time] hash_decode B={B} m=16 c=256 d_c=512 {dtype}: staged "
                  f"{turns['staged'][0]:.4f} / {turns['staged'][1]:.4f} ms, direct "
                  f"{turns['direct'][0]:.4f} / {turns['direct'][1]:.4f} ms (CUDA graphs, "
                  f"in turns: staged, direct, direct, staged); the launcher takes {chosen}",
                  flush=True)
            del codes, cb
    torch.cuda.empty_cache()
    return out


def check_decode_case(shape, variant: str, seed: int) -> float:
    """hash_decode at one shape against its plain version, bitwise, through
    the launcher and in both variants; returns the largest error."""
    import torch
    from repro_torch.kernels.hash_decode import ops
    from repro_torch.kernels.hash_decode.ref import hash_decode_ref
    args = _operands(*shape, variant, seed=seed)
    ref = hash_decode_ref(*args)
    chosen = ops.launch_shape(shape[0], *args[1].shape, args[1].element_size(),
                              args[3] is not None,
                              torch.cuda.get_device_properties(0).multi_processor_count).variant
    before = ops.hash_decode.launches
    got = {chosen: ops.hash_decode(*args)}
    torch.cuda.synchronize()
    check(ops.hash_decode.launches == before + 1, "kernel did not launch")
    other = "direct" if chosen == "staged" else "staged"
    got[other] = ops._forward(*args, variant=other)     # both variants, bitwise
    max_err = 0.0
    for name, out in got.items():
        err = float((out - ref).abs().max())
        max_err = max(max_err, err)
        same = torch.equal(out, ref)
        print(f"[kernel] hash_decode {shape} {variant} {name} variant"
              f"{' (the launcher takes it)' if name == chosen else ''}: "
              f"bitwise={same} max_abs_err={err}", flush=True)
        check(same, f"hash_decode {shape} {variant} {name} differs from its plain version")
    return max_err


def phase_kernel_check(B_main: int):
    """hash_decode vs its plain version, bitwise, at the shapes the serving
    path gives it (one request's frontier, and the coalesced frontier of a
    ``serve_many`` of 4), at the training path's (batch x seq token rows,
    bf16 codebooks), at the full-graph models' (every node) and at ragged
    ones; times at both serving shapes and at the full graph."""
    import torch
    m, c, d_c = 16, 256, 512
    cases = [((B_main, m, c, d_c), v) for v in
             ("float32", "float32+w0", "bfloat16", "int8+w0", "float16", "float16+w0")]
    cases += [((4 * B_main, m, c, d_c), "float32"),
              ((LM_BATCH * LM_SEQ, m, c, d_c), "bfloat16")]
    cases += [((100, 8, 16, 96), "float32+w0"), ((33, 4, 4, 130), "int8"),
              ((7, 3, 8, 5), "bfloat16+w0"), ((REC_BATCH, m, c, d_c), "float32"),
              ((5000, m, c, 130), "int8+w0"), ((5000, 3, 8, 5), "bfloat16+w0"),
              ((N_NODES, m, c, d_c), "float32"),     # a full-graph step decodes every node
              ((4096, m, c, d_c), "float16+w0"), ((7, 3, 8, 5), "float16"),
              ((N_NODES, m, c, d_c), "float16")]
    errs = {case: check_decode_case(*case, seed=i) for i, case in enumerate(cases)}
    max_err = max(errs.values())
    timing = time_at_shape(B_main, m, c, d_c)
    time_at_shape(4 * B_main, m, c, d_c)
    full = time_at_shape(N_NODES, m, c, d_c)
    # each float16 timing carries the error checked at its own shape
    f16 = {rows: dict(time_at_shape(rows, m, c, d_c, "float16"),
                      max_abs_err=errs[((rows, m, c, d_c), "float16")])
           for rows in (B_main, N_NODES)}
    torch.cuda.empty_cache()
    return dict(max_abs_err=max_err, **timing, at_full_graph=full, float16=f16)


def _spec(lookup_impl: str, n_nodes: int, n_classes: int, model: str = "sage"):
    import dataclasses
    from repro_torch.configs.paper_gnn import paper_gnn_config
    from repro_torch.graph.runtime import GraphSource, RuntimeSpec
    cfg = paper_gnn_config(model, n_nodes=n_nodes, n_classes=n_classes)
    cfg = dataclasses.replace(cfg, embedding=dataclasses.replace(
        cfg.embedding, lookup_impl=lookup_impl))
    return RuntimeSpec(
        graph=GraphSource(kind="powerlaw", seed=0, n_nodes=n_nodes,
                          n_classes=n_classes, avg_degree=14, homophily=0.9),
        model=cfg)


def phase_slice():
    """The port's serving path at full width; returns its launch counts
    per kernel, the frontier cap and the graph."""
    import numpy as np
    import torch
    from repro_torch.core import embedding as emb_lib
    from repro_torch.device import make_generator
    from repro_torch.graph.runtime import GraphRuntime
    from repro_torch.kernels.hash_decode import ops

    spec = _spec("auto", N_NODES, N_CLASSES)
    t0 = time.perf_counter()
    rt = GraphRuntime.from_spec(spec)
    torch.cuda.synchronize()
    print(f"[slice] GraphRuntime.from_spec on {rt.device}: {rt.adj.nnz} "
          f"nonzeros, codes {tuple(rt.codes.shape)}, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    check(rt.device.type == "cuda", "runtime is not on the card")
    again = emb_lib.make_codes(make_generator(spec.init_seed, rt.device),
                               rt.cfg.embedding_config(), aux=rt.adj)
    check(torch.equal(again, rt.codes), "encoding the graph twice gave other codes")
    print("[slice] encoding the graph twice gives identical codes", flush=True)

    engine = rt.serve(cache_capacity=0)
    rng = np.random.default_rng(1)
    requests = [rng.choice(N_NODES, REQUEST, replace=False) for _ in range(12)]
    torch.cuda.reset_peak_memory_stats()

    zero_counts()                              # the serving path's run starts here
    results, times, per_request = [], [], []
    for ids in requests[:8]:
        before = ops.hash_decode.launches
        t0 = time.perf_counter()
        results.append(engine.serve(ids))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        per_request.append(ops.hash_decode.launches - before)
    t0 = time.perf_counter()
    many = engine.serve_many(requests[8:12])
    torch.cuda.synchronize()
    many_ms = (time.perf_counter() - t0) * 1e3
    launches = read_counts("serve")            # ... and ends here
    check(launches["hash_decode_backward"] == 0, "the serving path ran a backward")
    check(all(n >= 1 for n in per_request), f"a request decoded without the kernel: {per_request}")
    check(launches["hash_decode"] >= 9,
          f"kernel launched {launches['hash_decode']} times for 9 engine calls")
    stats = engine.stats()
    print(f"[slice] per-request ms (host clock, synchronised): "
          f"{[round(t, 3) for t in times]}; median of requests 3-8 "
          f"{float(np.median(times[2:])):.3f} ms", flush=True)
    print(f"[slice] serve_many(4): {many_ms:.3f} ms; launches "
          f"{launches}; rows decoded per request {stats['rows_decoded_per_request']}; "
          f"frontier cap {engine.frontier_cap}; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} B", flush=True)
    n_unique = [engine.frontier_for(ids).n_unique for ids in requests[:8]]
    print(f"[slice] unique frontier rows per request {n_unique} of "
          f"{engine.frontier_cap} decoded", flush=True)
    for r in results + many:
        check(r.embeddings.shape == (REQUEST, rt.cfg.hidden), "embedding shape")
        check(r.logits.shape == (REQUEST, N_CLASSES), "logits shape")
        check(bool(np.isfinite(r.embeddings).all() and np.isfinite(r.logits).all()),
              "non-finite output")

    # the same requests through the gather backend on the card
    gather = rt.serve(cache_capacity=0, decode_backend="gather")
    ecfg = rt.cfg.embedding_config()
    cb = rt.params["embed"]["decoder"]["codebooks"]
    worst = 0.0

    def decoded_bitwise(fb, what):
        fb = fb.to(rt.device)
        codes = emb_lib.lookup_codes(rt.params["embed"], fb.unique, ecfg)
        check(torch.equal(engine.model.backend.decode(codes, cb),
                          gather.model.backend.decode(codes, cb)),
              f"decoded rows of {what} differ between kernel and gather backends")

    for ids, r in zip(requests[:8], results):
        decoded_bitwise(engine.frontier_for(ids), "a request")
        worst = max(worst, float(np.abs(gather.serve(ids).embeddings - r.embeddings).max()))
    fb_many = engine.coalesced_frontier(requests[8:12])
    check(fb_many.unique.shape[0] == 4 * engine.frontier_cap,
          f"coalesced frontier of 4 has {fb_many.unique.shape[0]} rows")
    decoded_bitwise(fb_many, "the serve_many of 4")
    for ids, r in zip(requests[8:12], many):
        worst = max(worst, float(np.abs(gather.serve(ids).embeddings - r.embeddings).max()))
    print(f"[slice] kernel vs gather on the card: decoded rows bitwise for the "
          f"8 requests and the coalesced serve_many frontier "
          f"({fb_many.unique.shape[0]} rows), embeddings max abs diff {worst}",
          flush=True)
    check(worst <= 1e-6, f"embeddings differ from the gather path by {worst}")
    phase_breakdown(engine, requests[:8])
    return launches, engine.frontier_cap, (rt.adj, rt.labels), (rt, engine, requests,
                                                                 results + many)


def phase_breakdown(engine, requests, label: str = ""):
    """Where one request's time goes: ``engine.serve`` under a
    ``StageTimer``, which synchronises the card around each stage the
    serving path marks, so the stages do not overlap."""
    import numpy as np
    from repro_torch.stages import StageTimer
    with StageTimer() as timer:
        t0 = time.perf_counter()
        for ids in requests:
            engine.serve(ids)
        served_ms = (time.perf_counter() - t0) * 1e3 / len(requests)
    med = {s: float(np.median(v)) for s, v in timer.ms.items()}
    check(all(len(v) == len(requests) for v in timer.ms.values()),
          f"stages marked unevenly: { {s: len(v) for s, v in timer.ms.items()} }")
    total = sum(med.values())
    dev_ms = sum(med.get(s, 0.0) for s in ("unpack", "decode", "mlp", "sage", "logits"))
    print(f"[breakdown]{label} median ms per request over {len(requests)} timed "
          f"requests: " + ", ".join(f"{s} {v:.3f}" for s, v in med.items())
          + f"; sum {total:.3f}; device stages {dev_ms:.3f} "
          f"({100 * dev_ms / total:.1f}% of the sum); mean timed request "
          f"{served_ms:.3f} ms", flush=True)


def phase_small_reference():
    """A small graph served on the card (kernel) and on the CPU (plain
    version) with the same params: agreement within f32 matmul rounding."""
    import numpy as np
    import torch
    from repro_torch.graph.runtime import GraphRuntime
    spec = _spec("auto", 3000, 8)
    rt = GraphRuntime.from_spec(spec)
    rt_cpu = GraphRuntime.from_spec(spec, graph=(rt.adj, rt.labels), device="cpu",
                                    params=_snapshot(rt.params, "cpu"))
    ids = np.arange(0, 3000, 11)[:REQUEST]
    a = rt.serve(cache_capacity=0).serve(ids)
    b = rt_cpu.serve(cache_capacity=0).serve(ids)
    diff = float(np.abs(a.embeddings - b.embeddings).max())
    print(f"[reference] 3,000-node graph, card vs CPU plain path: embeddings "
          f"max abs diff {diff}", flush=True)
    check(diff <= 1e-4, f"card and CPU disagree by {diff}")


# ---------------------------------------------------------------------------
# slice 2: LM training through flash_attention and the hash_decode backward
# ---------------------------------------------------------------------------

FLASH_CASES = [  # (B, H, K, S, D, causal, dtype): the path's shape first
    (LM_BATCH, 16, 16, LM_SEQ, 64, True, "bfloat16"),
    (LM_BATCH, 16, 16, LM_SEQ, 64, True, "float32"),
    (2, 8, 2, LM_SEQ, 128, True, "bfloat16"),          # GQA
    (2, 16, 16, 1000, 64, True, "float32"),            # ragged S
    (2, 8, 8, 1024, 128, False, "bfloat16"),           # full attention
    (2, 4, 4, 333, 32, False, "float32"),              # the reduced config's D
    # the bf16 kernel's tile edges (128-row query and key tiles): S in
    # {1, 127, 129, 1000}, every D, GQA K = 1 and 2, causal and full
    (1, 4, 1, 1, 32, True, "bfloat16"),
    (1, 8, 2, 1, 128, False, "bfloat16"),
    (2, 4, 2, 127, 64, True, "bfloat16"),
    (1, 4, 2, 127, 32, False, "bfloat16"),
    (2, 4, 1, 129, 64, True, "bfloat16"),
    (2, 4, 2, 129, 128, False, "bfloat16"),
    (1, 4, 1, 1000, 128, True, "bfloat16"),
    (1, 4, 2, 1000, 32, True, "bfloat16"),
    # the audio and vlm training paths: musicgen-large's 32 heads of 64,
    # qwen2-vl-7b's 28 query heads on 4 KV heads of 128
    (LM_BATCH, 32, 32, LM_SEQ, 64, True, "bfloat16"),
    (LM_BATCH, 28, 4, LM_SEQ, 128, True, "bfloat16"),
    # the LM across ranks: a rank's heads, qwen's 8 of 16 and granite's 12
    # query heads on 4 of its 8 KV heads, 2 sequences a rank
    (2, 8, 8, LM_SEQ, 64, True, "bfloat16"),
    (2, 12, 4, LM_SEQ, 64, True, "bfloat16"),
    # zamba2-7b's shared block, 32 heads of 112 (the hybrid_train path's
    # shape), on both kernels; head dims a tile pads: 80 in the 128-wide
    # tile, 24 in the 32-wide, ragged and GQA, causal and full
    (LM_BATCH, 32, 32, LM_SEQ, 112, True, "bfloat16"),
    (LM_BATCH, 32, 32, LM_SEQ, 112, True, "float32"),
    (2, 8, 2, 1000, 80, True, "bfloat16"),
    (1, 4, 4, 129, 80, False, "float32"),
    (2, 4, 1, 333, 24, True, "float32"),
    (1, 4, 2, 127, 24, False, "bfloat16"),
    # float16 on the tensor cores at the training path's shape; then every
    # kind of head dim no config has, in each dtype: padded to the step (4,
    # 100), the 256-wide tile (136, 192, 256), panels (320); ragged S, GQA,
    # causal and full
    (LM_BATCH, 16, 16, LM_SEQ, 64, True, "float16"),
    *[(2, 8, 2 if causal else 8, 777 if causal else 300, D, causal, dtype)
      for D, causal in ((4, True), (100, False), (136, True), (192, False), (256, True),
                        (320, True))
      for dtype in ("bfloat16", "float16", "float32")],
]
# tests/test_kernels.py's tolerance: |kernel - plain| <= tol + tol * |plain|;
# float16's at its 2**-11 rounding
FLASH_TOL = {"bfloat16": 2e-2, "float16": 5e-3, "float32": 2e-5}
# operands the wrapper copies first, one counted copy each: a strided view
# (every other column of a wider tensor) and a bf16 q 2 bytes off a 16-byte
# boundary; each held bitwise to the contiguous call
FLASH_LAYOUTS = [("strided", (2, 8, 2, 1000, 64, True, "bfloat16")),
                 ("unaligned", (2, 8, 2, 1000, 128, True, "bfloat16")),
                 # k stored (B, K, D, S) and permuted: strides that look
                 # channels_last, at a D the wrapper pads
                 ("channels_last", (2, 8, 2, 1000, 100, True, "bfloat16"))]


def _qkv(B, H, K, S, D, dtype, seed=0):
    import torch
    from repro_torch.core.backend import torch_dtype
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda").to(torch_dtype(dtype))
            for shape in ((B, S, H, D), (B, S, K, D), (B, S, K, D))]


def phase_flash_check() -> tuple:
    """flash_attention vs its plain version on the card at the path's shape,
    a GQA, a ragged, a non-causal and the reduced config's shape, float16,
    every kind of head dim and two layouts the wrapper copies.  Returns the
    path's shape's error and, by kernel and tile width, the largest error of
    each instantiation and its launches here."""
    import torch
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    worst, by_instance = 0.0, {}
    layouts = [(None, case) for case in FLASH_CASES] + FLASH_LAYOUTS
    for i, (layout, (B, H, K, S, D, causal, dtype)) in enumerate(layouts):
        q, k, v = _qkv(B, H, K, S, D, dtype, seed=i)
        if layout is not None:
            want = ops.flash_attention(q, k, v, causal=causal)
            if layout == "strided":
                wide = torch.zeros(q.shape[:-1] + (2 * D,), dtype=q.dtype, device="cuda")
                q = wide[..., ::2].copy_(q)
            elif layout == "unaligned":
                moved = torch.empty(q.numel() + 1, dtype=q.dtype, device="cuda")[1:].view(q.shape)
                q = moved.copy_(q)
            else:
                k = torch.empty((B, K, D, S), dtype=k.dtype,
                                device="cuda").permute(0, 3, 1, 2).copy_(k)
        before, copies = ops.flash_attention.launches, ops.flash_attention.copies
        got = ops.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        check(ops.flash_attention.launches == before + 1, "flash kernel did not launch")
        kernel, width = ops.kernel_of(q.dtype, D)
        padded = D % ops.HEAD_DIM_STEP != 0
        want_copies = 4 if padded else (1 if layout else 0)
        check(ops.flash_attention.copies == copies + want_copies,
              f"flash_attention copied {ops.flash_attention.copies - copies} tensors, "
              f"not {want_copies}")
        ref = attention_ref(q, k, v, causal=causal).float()
        diff = (got.float() - ref).abs()
        err = float(diff.max())
        tol = FLASH_TOL[dtype]
        within = bool((diff <= tol + tol * ref.abs()).all())
        finite = bool(torch.isfinite(got).all())
        same = layout is None or torch.equal(got, want)
        print(f"[flash] B={B} H={H} K={K} S={S} D={D} causal={causal} {dtype}"
              f"{'' if layout is None else ' ' + layout}: {kernel} at width {width}, "
              f"max_abs_err={err}, within rtol=atol={tol}: {within}, finite={finite}, "
              f"copies {want_copies}" + ("" if layout is None else f", bitwise the "
                                         f"contiguous call: {same}"), flush=True)
        check(finite and within and same,
              f"flash_attention {(B, H, K, S, D, causal, dtype, layout)} off by {err}")
        if i == 0:
            worst = err
        row = by_instance.setdefault(f"{kernel}/{width}", {"max_abs_err": 0.0, "launches": 0})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["launches"] += 1
        del q, k, v, got, ref
    torch.cuda.empty_cache()
    return worst, by_instance


def phase_backward_check() -> float:
    """The hash_decode backward on the card at the training path's shape:
    two passes give the same bits, and they match autograd through the
    plain version to 1e-5 of the largest gradient (8e-3 for the bf16
    codebook gradient: one bf16 rounding of sums taken in another order)."""
    import torch
    from repro_torch.kernels.hash_decode import ops
    from repro_torch.kernels.hash_decode.ref import hash_decode_ref
    B = LM_BATCH * LM_SEQ
    worst = 0.0
    for variant in ("bfloat16", "float32+w0"):
        codes, cb, w0, _ = _operands(B, 16, 256, 512, variant, seed=7)
        g = torch.randn(B, 512, generator=torch.Generator(device="cuda").manual_seed(8),
                        device="cuda")
        with_w0 = variant.endswith("+w0")

        def grads(fn):
            c = cb.clone().requires_grad_(True)
            w = w0.clone().requires_grad_(True) if with_w0 else None
            (fn(codes, c, w) * g).sum().backward()
            return c.grad, (w.grad if with_w0 else None)

        a, b = grads(ops.hash_decode), grads(ops.hash_decode)
        same = all(x is None or torch.equal(x, y) for x, y in zip(a, b))
        plain = grads(hash_decode_ref)
        errs = []
        for name, mine, ref in zip(("d_cb", "d_w0"), a, plain):
            if mine is None:
                continue
            check(mine.dtype == ref.dtype, f"{name} dtype {mine.dtype} != {ref.dtype}")
            scale = float(ref.float().abs().max())
            bound = (8e-3 if name == "d_cb" and variant == "bfloat16" else 1e-5) * scale
            err = float((mine.float() - ref.float()).abs().max())
            errs.append(f"{name} max_abs_err={err} (bound {bound:.3g})")
            check(err <= bound, f"{name} {variant} off by {err} > {bound}")
            worst = max(worst, err / scale)
        print(f"[backward] hash_decode B={B} {variant}: two passes bitwise={same}; "
              + ", ".join(errs), flush=True)
        check(same, f"two hash_decode backward passes differ ({variant})")
    torch.cuda.empty_cache()
    return worst


def _lm_config():
    import dataclasses
    from repro_torch.configs import get_config
    base = get_config(LM_ARCH)
    return get_config(LM_ARCH, attn_impl="flash", embedding=dataclasses.replace(
        base.embedding, lookup_impl="auto"))


def phase_train():
    """Full-width qwen1.5-0.5b through the launcher's chain, 5 steps; the
    launch counts are read around exactly this run."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.hash_decode import ops as hd_ops
    from repro_torch.kernels.lsh_encode import ops as lsh_ops
    from repro_torch.launch.train import train
    from repro_torch.train.step import loss_and_grads
    cfg = _lm_config()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fa_ops.flash_attention.launches = 0
    by_kernel = fa_ops.flash_attention.launches_by_kernel
    by_kernel.update(dict.fromkeys(by_kernel, 0))
    lsh_ops.launches_by_kernel.update(dict.fromkeys(lsh_ops.KERNELS, 0))
    hd_ops.hash_decode_backward.launches = 0
    hd_ops.backward_kernel_launches(reset=True)
    hd_ops.hash_decode.launches = 0            # the training path's run starts here
    zero_copies()
    res = train(cfg, steps=LM_STEPS, batch=LM_BATCH, seq=LM_SEQ, device="cuda",
                log_every=1, log=lambda line: print(f"[train] {line}", flush=True))
    torch.cuda.synchronize()
    launches = {"hash_decode": hd_ops.hash_decode.launches,
                "hash_decode_backward": hd_ops.hash_decode_backward.launches,
                "hash_decode_backward_by_kernel": hd_ops.backward_kernel_launches(),
                "flash_attention": fa_ops.flash_attention.launches,
                "lsh_encode": sum(lsh_ops.launches_by_kernel.values())}  # ... and ends here
    check_backward_launches(launches, "train")
    check_no_copies("train")
    launches["flash_attention_by_kernel"] = dict(by_kernel)
    launches["lsh_encode_by_kernel"] = dict(lsh_ops.launches_by_kernel)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    print(f"[train] losses {res.losses}; step ms "
          f"{[round(t * 1e3, 3) for t in res.step_times]}; chain wall {wall:.2f} s; "
          f"max_memory_allocated {peak} B; launches {launches}", flush=True)
    check(all(np.isfinite(res.losses)), f"non-finite loss {res.losses}")
    print_mfu(cfg, res.step_times, "train")
    per_step = 2 * cfg.n_layers if cfg.remat else cfg.n_layers
    check(launches["flash_attention"] == LM_STEPS * per_step,
          f"flash_attention launched {launches['flash_attention']} times, "
          f"expected {LM_STEPS} steps x {per_step}")
    check(by_kernel == flash_want(bf16_wgmma=LM_STEPS * per_step),
          f"the bf16 training path's attention went to {by_kernel}, not only "
          f"to the tensor-core kernel")
    check(launches["hash_decode"] >= LM_STEPS, f"hash_decode launched {launches['hash_decode']} times")
    check(launches["hash_decode_backward"] == LM_STEPS,
          f"the hash_decode backward kernel launched {launches['hash_decode_backward']} times")
    # c=256, m=16: 128 bits, all four words in one pass over A
    check(launches["lsh_encode_by_kernel"] == {"project": 1, "pack": 1, "fused": 0},
          f"the vocabulary encode launched lsh_encode {launches['lsh_encode_by_kernel']}, "
          f"expected one projection and one pack")

    # the codebooks' gradient after training, on a fresh batch of the stream
    from repro_torch.data import TokenStream, TokenStreamConfig
    stream = TokenStream(TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=LM_SEQ,
                                           batch_size=LM_BATCH, seed=0))
    batch = {k: torch.from_numpy(v).cuda() for k, v in stream.next_batch().items()}
    params = res.state["params"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss, grads = loss_and_grads(params, batch, cfg)
    loss = float(loss)
    plain_peak = torch.cuda.max_memory_allocated()
    cb_norm = float(grads["embed"]["decoder"]["codebooks"].float().norm())
    n_cb = params["embed"]["decoder"]["codebooks"].numel()
    print(f"[train] codebook gradient norm {cb_norm} over {n_cb} entries", flush=True)
    check(cb_norm > 0 and math.isfinite(cb_norm), f"codebook gradient norm {cb_norm}")
    head_grad = grads["head"]
    del grads
    phase_chunked_loss(cfg, params, batch, loss, head_grad, plain_peak)
    del head_grad

    # where one step's time goes: the stage marks, each synchronised
    from repro_torch.train.step import TrainHyper, make_train_step
    step = make_train_step(cfg, TrainHyper(total_steps=LM_STEPS + 2))
    state = res.state
    state, _ = step(state, batch)               # warm, outside the timer
    train_breakdown(step, state, batch)
    del res, state, params, batch
    torch.cuda.empty_cache()
    return launches, peak


# the chunked cross-entropy against the plain one, bf16 head products in
# both.  On the H100 the two losses came out equal bit for bit and the head
# gradients 6.1e-5 apart, 1.5e-3 of the largest entry (a bf16 product may
# round otherwise where cuBLAS tiles 19,008 columns otherwise than
# 152,064): the loss within 1e-5 of its value, the head gradient within
# 5e-3 of its largest entry.  Leaving the 128 pad columns unmasked moves
# the loss by log(1 + 128/152,064), 7e-5 of it: the phase checks that this
# lands outside the loss bound.
CHUNK_LOSS_RTOL, CHUNK_GRAD_RTOL = 1e-5, 5e-3


def phase_chunked_loss(cfg, params, batch, loss: float, head_grad, plain_peak: int) -> None:
    """One loss-and-gradient from the trained state with
    ``loss_vocab_chunk=19008`` (the JAX qwen profile's: 152,064 in 8
    chunks) against the plain loss's, and both peaks; then the chunked
    loss with the pad columns left unmasked, which must miss the bound."""
    import dataclasses
    import torch
    from repro_torch.models.lm import _chunked_ce, lm_forward
    from repro_torch.train.step import loss_and_grads
    ccfg = dataclasses.replace(cfg, loss_vocab_chunk=19_008)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    closs, cgrads = loss_and_grads(params, batch, ccfg)
    closs = float(closs)
    peak = torch.cuda.max_memory_allocated()
    gap = float((cgrads["head"] - head_grad).abs().max())
    scale = float(head_grad.abs().max())
    del cgrads
    with torch.no_grad():
        x, _ = lm_forward(params, batch["tokens"], ccfg, positions=batch.get("positions"),
                          return_hidden=True)
        unmasked = float(_chunked_ce(x, params["head"], batch["labels"],
                                     dataclasses.replace(ccfg, vocab_size=ccfg.vocab_padded)))
        del x
    print(f"[train] chunked cross-entropy (8 chunks of 19,008): loss {closs} against plain "
          f"{loss} (diff {abs(closs - loss)}, bound {CHUNK_LOSS_RTOL} x |loss|); head gradient "
          f"max abs diff {gap} (bound {CHUNK_GRAD_RTOL} x its largest entry {scale}); the "
          f"pad columns unmasked: loss {unmasked} (diff {abs(unmasked - loss)}); peak "
          f"max_memory_allocated {peak} B chunked, {plain_peak} B plain; "
          f"{smi_query('name,power.limit')}", flush=True)
    check(abs(closs - loss) <= CHUNK_LOSS_RTOL * abs(loss), f"chunked loss {closs} vs {loss}")
    check(gap <= CHUNK_GRAD_RTOL * scale, f"chunked head gradient differs by {gap}")
    check(abs(unmasked - loss) > CHUNK_LOSS_RTOL * abs(loss),
          f"the unmasked pad columns moved the loss by only {abs(unmasked - loss)}")


def print_mfu(cfg, step_times, label: str) -> float:
    """The path's model-FLOPs share of the card's bf16 peak:
    ``roofline.model_flops`` of one LM_BATCH x LM_SEQ training step over
    the median of steps 2 on (step 1 warms cuBLAS and the allocator)."""
    from repro_torch.launch.roofline import model_flops
    from repro_torch.launch.shapes import ShapeSpec
    flops = model_flops(cfg, ShapeSpec("lm_step", "train", LM_SEQ, LM_BATCH), 1)
    warm = sorted(step_times[1:])
    med = warm[(len(warm) - 1) // 2]
    mfu = flops / (med * BF16_FLOPS)
    print(f"[mfu] {label} ({cfg.name}, {cfg.n_layers} layers): model FLOPs {flops:.6e} a step "
          f"of {LM_BATCH} x {LM_SEQ} (6 x {cfg.active_param_count()} active params x tokens + "
          f"causal attention), median step {med * 1e3:.3f} ms -> "
          f"{flops / med / 1e12:.1f} TFLOP/s, MFU {100 * mfu:.2f}% of {BF16_FLOPS / 1e12:.0f} "
          f"TFLOP/s bf16; {smi_query('name,power.limit')}", flush=True)
    return mfu


def train_breakdown(step, state, batch, label: str = "") -> None:
    """One (warm) training step under the stage timer, each mark
    synchronised, then one under the profiler."""
    import torch
    from repro_torch.stages import StageTimer
    torch.cuda.synchronize()
    with StageTimer() as timer:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        float(m["loss"])
        step_ms = (time.perf_counter() - t0) * 1e3
    med = {k: round(sum(v), 3) for k, v in timer.ms.items()}
    print(f"[breakdown] one {label + ' ' if label else ''}training step under the stage "
          f"timer: {step_ms:.3f} ms; stages (ms, nested: embed holds unpack/decode/mlp) "
          f"{med}", flush=True)
    profile_step(step, state, batch)


def profile_step(step, state, batch) -> None:
    """Device time of one training step by kernel, from torch.profiler."""
    profile_call("one step", lambda: float(step(state, batch)[1]["loss"]))


def profile_call(label: str, fn) -> None:
    """Device time of ``fn()`` (which ends by reading a result back) by
    kernel, from torch.profiler.  A profiler that cannot start is reported
    as not measured; a call that raises under it fails the run like any
    other phase."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.start()
    except Exception as exc:  # noqa: BLE001  (the profiler's own failure to start)
        print(f"[profile] torch.profiler did not start: {exc!r}; device time not "
              f"measured", flush=True)
        return
    try:
        t0 = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        prof.stop()
    # kernel rows only: an operator's row repeats the time of its kernels
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(r[1] for r in rows)
    if not rows:
        print("[profile] the profiler recorded no device time: not measured", flush=True)
        return
    print(f"[profile] {label}: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms "
          f"({100 * busy / wall_ms:.1f}%, sum of kernel times; {len(rows)} kernels)",
          flush=True)
    for name, ms, n in sorted(rows, key=lambda r: -r[1])[:20]:
        print(f"[profile]   {ms:10.3f} ms  x{n:<5d} {name[:110]}", flush=True)


def phase_lm_reference() -> dict:
    """The reduced config, 3 steps from one init on the card (kernels) and
    on the CPU (plain versions): losses within 1e-4 (f32 throughout; cuBLAS
    and the CPU's matmuls sum in other orders).  Its attention runs the f32
    flash kernel, once a layer a step (no remat): the launches, counted
    around the 3 steps."""
    import dataclasses
    import torch
    from repro_torch.configs import reduced
    from repro_torch.data import TokenStream, TokenStreamConfig
    from repro_torch.models.lm import init_lm
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train import TrainHyper, make_train_step
    cfg = reduced(_lm_config())
    cfg = dataclasses.replace(cfg, embedding=dataclasses.replace(
        cfg.embedding, lookup_impl="pallas"))
    params = init_lm(torch.Generator().manual_seed(0), cfg)
    states = {}
    for dev in ("cuda", "cpu"):
        p = _snapshot(params, dev)
        states[dev] = {"params": p, "opt": adamw_init(p), "step": 0}
    step = make_train_step(cfg, TrainHyper(warmup_steps=1, total_steps=3))
    stream = TokenStream(TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=256,
                                           batch_size=4, seed=3))
    worst, losses = 0.0, []
    zero_counts()
    for _ in range(3):
        b = stream.next_batch()
        pair = [float(step(states[dev], {k: torch.from_numpy(v).to(dev)
                                         for k, v in b.items()})[1]["loss"])
                for dev in ("cuda", "cpu")]
        losses.append(pair)
        worst = max(worst, abs(pair[0] - pair[1]))
    launches = _path_counts("lm_reference")
    print(f"[reference] reduced {LM_ARCH}, 3 steps, (card, CPU) losses {losses}; "
          f"max abs diff {worst}; flash launches {launches['flash_attention_by_kernel']}",
          flush=True)
    check(worst <= 1e-4, f"card and CPU losses differ by {worst}")
    want = flash_want(f32_cuda_core=3 * cfg.n_layers)
    check(launches["flash_attention_by_kernel"] == want,
          f"lm_reference launched flash {launches['flash_attention_by_kernel']}, expected {want}")
    return launches


# ---------------------------------------------------------------------------
# slice 14: LM serving (KV cache, prefill and decode steps, DecodeEngine)
# ---------------------------------------------------------------------------

# (batch, prompt tokens, new tokens): qwen at the JAX engine's default
# s_max; chatglm3-6b cut to fit its 23 GB of f32 masters in the phase's time
SERVE_LM = (8, 512, 64)
SERVE_GLM = (4, 256, 16)
SERVE_S_MAX = 1024
# cached (engine) against uncached logits.  In bf16 (the served model) 8
# bf16 ulps at the [4, 8) magnitude of the largest logits (ulp 2**-5): it
# catches a fault that moves logits by O(1), but at random weights the
# rounding of 24 bf16 layers hides a cache off by one position (on the
# H100: 0.094 against the healthy 0.070).  So the same engine also runs in
# f32 from the same params: there the healthy gap is products summed in
# another order (1.1e-5 on the H100) and a cache off by one position moved
# the logits by 0.058-0.061; the bound sits near ten times the first, and
# the phase checks that both faults land outside it.
SERVE_BOUND = 0.25
SERVE_F32_BOUND = 1e-4
SERVE_REF_BOUND = 1e-4             # reduced configs in f32, card against CPU


def _serve_cfg(arch: str, **fields):
    """The arch's config with ``fields`` replaced and its embedding (the
    arch's, or ``fields["embedding"]``) decoded by ``lookup_impl="auto"``."""
    import dataclasses
    from repro_torch.configs import get_config
    emb = fields.pop("embedding", get_config(arch).embedding)
    return get_config(arch, embedding=dataclasses.replace(emb, lookup_impl="auto"), **fields)


def _recorded_generate(eng, prompts, new: int, keep: bool = False,
                       timed: bool = False) -> dict:
    """``eng.generate(prompts, new)`` (greedy), the engine's own loop, with
    its prefill and decode steps wrapped: ``keep`` stacks each step's
    last-position logits, (B, 1 + new, Vpad); ``timed`` records a CUDA
    event before the prefill and after it and each step, no
    synchronisation between, so the device time of the prefill and of each
    step (its sampling included) is read from the engine's run."""
    import torch
    prefill, serve = eng._prefill, eng._serve
    kept, events, last = [], [], {}

    def mark():
        if timed:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()

    def wrap(step):
        def recorded(*args):
            logits, last["cache"] = out = step(*args)
            mark()
            if keep:
                kept.append(logits)
            return out
        return recorded

    eng._prefill, eng._serve = wrap(prefill), wrap(serve)
    try:
        if timed:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        mark()
        res = eng.generate(prompts, new)
        if timed:
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        eng._prefill, eng._serve = prefill, serve
    out = dict(res=res, cache_bytes=last["cache"].nbytes)
    if keep:
        out["logits"] = torch.stack(kept, dim=1)
    if timed:
        steps = [events[t + 1].elapsed_time(events[t + 2]) for t in range(new)]
        out.update(prefill_ms=events[0].elapsed_time(events[1]), step_ms=steps,
                   per_token_ms=float(sorted(steps[1:])[(len(steps) - 1) // 2]),
                   wall_ms=wall_ms)
    return out


def _serve_pair(cfg, params, prompts, new: int, label: str, decodes=None) -> tuple:
    """The engine on the kernel (``auto``) and on ``gather`` from the same
    params: tokens and every step's logits bitwise; the kernel engine's
    launches counted around its ``generate`` alone: ``decodes``
    ``hash_decode`` launches (by default ``new + 1``: one prefill and
    ``new`` decode steps; 0 for a dense embedding)."""
    import torch
    from repro_torch.serving import DecodeEngine
    eng = DecodeEngine(cfg, params, s_max=SERVE_S_MAX, decode_backend="auto")
    check(eng.decode_backend == "pallas", f"auto resolved to {eng.decode_backend}")
    eng.generate(prompts[:, :16], 2)                     # warm cuBLAS and the allocator
    torch.cuda.synchronize()
    zero_counts()
    run = _recorded_generate(eng, prompts, new, keep=True)   # the path's run
    torch.cuda.synchronize()
    launches = read_counts(label)
    decodes = new + 1 if decodes is None else decodes
    check(launches["hash_decode"] == decodes,
          f"{label}: hash_decode launched {launches['hash_decode']} times, expected "
          f"{decodes} (prefill and {new} decode steps)")
    ref = _recorded_generate(DecodeEngine(cfg, params, s_max=SERVE_S_MAX,
                                          decode_backend="gather"), prompts, new, keep=True)
    same = ((run["res"].tokens == ref["res"].tokens).all()
            and torch.equal(run["logits"], ref["logits"]))
    print(f"[serve_lm] {label}: kernel engine against gather engine, {new + 1} last-logit "
          f"tensors {tuple(run['logits'].shape)} and {run['res'].tokens.shape} tokens: "
          f"bitwise={same}; launches {launches}", flush=True)
    check(same, f"{label}: the kernel engine's logits or tokens differ from gather's")
    return eng, run, launches


def _faulted_gap(eng, tokens, s0: int, ref, shift: int) -> float:
    """The engine's decode steps teacher-forced along ``tokens`` from a
    cache whose ``pos`` is moved by ``shift`` after the prefill (+1: a slot
    left empty and every later position one ahead; -1: the prompt's last
    row overwritten and every later position one behind), against the
    uncached logits ``ref``: how far a cache off by one position moves
    them."""
    import dataclasses
    import torch
    as_dev = lambda a: torch.as_tensor(a, dtype=torch.int32, device=eng.device)  # noqa: E731
    _, cache = eng._prefill(eng.params, {"tokens": as_dev(tokens[:, :s0])})
    cache = dataclasses.replace(cache, pos=cache.pos + shift)
    gap = torch.zeros((), device=eng.device)
    for t in range(tokens.shape[1] - s0):
        logits, cache = eng._serve(eng.params, cache,
                                   {"tokens": as_dev(tokens[:, s0 + t:s0 + t + 1])})
        gap = torch.maximum(gap, (logits - ref[:, t + 1]).abs().amax())
    return float(gap)


def _check_cached_against_uncached(eng, run, s0: int, bound: float,
                                   controls: bool = False) -> float:
    """``lm_forward`` without a cache over the final sequences (the plain
    attention path) against the engine's per-step logits at positions
    s0-1 .. end, within ``bound``; with ``controls``, a cache off by one
    position either way must land outside it.  The engine's tokens against
    the uncached argmax wherever the uncached top-2 margin exceeds twice
    the bound, or, where no margin does, twice the measured gap (there no
    logit within the gap can change the argmax)."""
    import torch
    from repro_torch.models.lm import lm_forward
    tokens, cfg = run["res"].tokens, eng.cfg
    with torch.inference_mode():
        full, _ = lm_forward(eng.params, torch.as_tensor(tokens, device="cuda"), cfg)
        ref = full[:, s0 - 1:]
        del full
        gap = float((ref - run["logits"]).abs().max())
        faulted = ({shift: _faulted_gap(eng, tokens, s0, ref, shift) for shift in (1, -1)}
                   if controls else {})
        top2 = ref[..., :cfg.vocab_size].topk(2, dim=-1)
        margin = top2.values[..., 0] - top2.values[..., 1]
        margin = margin[:, :-1].cpu().numpy()               # the steps that chose a token
        agree = top2.indices[..., 0][:, :-1].cpu().numpy() == tokens[:, s0:]
        scale = float(ref.abs().max())
    print(f"[serve_lm] {cfg.compute_dtype}: cached against uncached ({tuple(ref.shape)} "
          f"logits): max abs diff {gap} (bound {bound}; largest |logit| {scale})"
          + "".join(f"; a cache off by {shift:+d} position: max abs diff {fgap}"
                    for shift, fgap in faulted.items()), flush=True)
    name, limit = "twice the bound", 2 * bound
    if not (margin > limit).any():
        name, limit = "twice the gap", 2 * gap
    sure = margin > limit
    print(f"[serve_lm] {cfg.compute_dtype}: tokens where the uncached top-2 margin > {name} "
          f"({limit}): {int((agree & sure).sum())} of {int(sure.sum())} agree (of "
          f"{agree.size} steps; {int(agree.sum())} agree in all)", flush=True)
    check(gap <= bound, f"{cfg.compute_dtype}: cached and uncached logits differ by {gap}")
    for shift, fgap in faulted.items():
        check(fgap > bound, f"a cache off by {shift:+d} position stays within the bound "
                            f"({fgap} <= {bound})")
    check(bool(agree[sure].all()), f"{int((~agree & sure).sum())} tokens with a margin above "
                                   f"{name} differ from uncached")
    return gap


def _serve_breakdown(eng, prompts) -> None:
    """One decode step under the stage timer (each mark synchronised) and
    under the profiler, from a fresh prefill."""
    import torch
    from repro_torch.device import make_generator
    from repro_torch.stages import StageTimer
    gen = make_generator(0, eng.device)
    logits, cache = eng._prefill(eng.params, {"tokens": torch.as_tensor(
        prompts, dtype=torch.int32, device=eng.device)})
    nxt = eng._sample(logits, gen, 0.0)[:, None]
    logits, cache = eng._serve(eng.params, cache, {"tokens": nxt})     # warm
    torch.cuda.synchronize()
    with StageTimer() as timer:
        t0 = time.perf_counter()
        nxt = eng._sample(logits, gen, 0.0)[:, None]
        logits, cache = eng._serve(eng.params, cache, {"tokens": nxt})
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
    stages = {k: round(sum(v), 3) for k, v in timer.ms.items()}
    print(f"[breakdown] one decode step ({eng.cfg.name}, B={prompts.shape[0]}, pos "
          f"{cache.pos - 1}) under the stage timer: {step_ms:.3f} ms; stages (ms, nested: "
          f"embed holds unpack/decode/mlp) {stages}; {smi_query('name,power.limit')}",
          flush=True)
    state = {"logits": logits, "cache": cache}

    def one_step():
        nxt = eng._sample(state["logits"], gen, 0.0)[:, None]
        state["logits"], state["cache"] = eng._serve(eng.params, state["cache"],
                                                     {"tokens": nxt})
        int(nxt.reshape(-1)[0])
    profile_call(f"one {eng.cfg.name} decode step", one_step)


def _served_on_card_and_cpu(cfg, params, label: str) -> float:
    """``cfg`` (f32, a reduced config) served from ``params`` on the card
    (the kernel) and on the CPU (plain versions), 4 prompts of 32 and 16
    greedy tokens: tokens equal and logits within ``SERVE_REF_BOUND``, in
    each row up to the first step whose CPU top-2 margin (the least over an
    audio config's codebooks) is under the bound (after it the two may
    choose apart).  Returns the largest gap."""
    import numpy as np
    from repro_torch.serving import DecodeEngine
    streams = (cfg.n_codebooks,) if cfg.input_mode == "audio_tokens" else ()
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size, (4, 32) + streams)
    got = {dev: _recorded_generate(DecodeEngine(cfg, params, s_max=64, device=dev),
                                   prompts, 16, keep=True) for dev in ("cuda", "cpu")}
    (card, lc), (cpu, lp) = ((got[d]["res"], got[d]["logits"].cpu().numpy())
                             for d in ("cuda", "cpu"))
    compared, worst = 0, 0.0
    for b in range(prompts.shape[0]):
        for t in range(lp.shape[1]):
            gap = float(np.abs(lc[b, t] - lp[b, t]).max())
            worst = max(worst, gap)
            compared += 1
            check(gap <= SERVE_REF_BOUND, f"{label} row {b} step {t}: card and CPU "
                                          f"logits differ by {gap}")
            if t == lp.shape[1] - 1:
                break
            top2 = np.sort(lp[b, t][..., :cfg.vocab_size], axis=-1)[..., -2:]
            if (top2[..., 1] - top2[..., 0]).min() <= SERVE_REF_BOUND:
                break
            check(np.array_equal(card.tokens[b, 32 + t], cpu.tokens[b, 32 + t]),
                  f"{label} row {b} step {t}: card and CPU chose other tokens")
    print(f"[reference] serve_lm reduced {label}: card (kernel) and CPU (plain) engines, "
          f"{compared} of {lp.shape[0] * lp.shape[1]} steps compared, max abs logit "
          f"diff {worst} (bound {SERVE_REF_BOUND}); tokens equal "
          f"{bool((card.tokens == cpu.tokens).all())}", flush=True)
    return worst


def _serve_reference() -> float:
    """Reduced qwen1.5-0.5b and chatglm3-6b (f32) served on the card and on
    the CPU from one init (``_served_on_card_and_cpu``)."""
    import dataclasses
    import torch
    from repro_torch.configs import reduced
    from repro_torch.models.lm import init_lm
    worst = 0.0
    for arch in (LM_ARCH, "chatglm3-6b"):
        cfg = reduced(_serve_cfg(arch))
        cfg = dataclasses.replace(cfg, embedding=dataclasses.replace(
            cfg.embedding, lookup_impl="pallas"))
        params = init_lm(torch.Generator().manual_seed(0), cfg)
        worst = max(worst, _served_on_card_and_cpu(cfg, params, arch))
    return worst


def phase_serve_lm() -> tuple:
    """Full-width qwen1.5-0.5b and chatglm3-6b served through
    ``DecodeEngine``; returns the launches of each path and the decode's
    row counts (each held bitwise)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.models.lm import init_lm
    from repro_torch.nn.module import param_count
    from repro_torch.serving import DecodeEngine
    t_phase = time.perf_counter()
    card = smi_query("name,power.limit")
    B, s0, new = SERVE_LM
    cfg = _serve_cfg(LM_ARCH)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    params = init_lm(torch.Generator("cuda").manual_seed(0), cfg)
    prompts = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, s0))
    eng, run, launches = _serve_pair(cfg, params, prompts, new, "serve_lm")
    gap = _check_cached_against_uncached(eng, run, s0, SERVE_BOUND)
    del run
    f32 = DecodeEngine(dataclasses.replace(cfg, compute_dtype="float32"), params,
                       s_max=SERVE_S_MAX, decode_backend="auto")
    gap_f32 = _check_cached_against_uncached(
        f32, _recorded_generate(f32, prompts, new, keep=True), s0, SERVE_F32_BOUND,
        controls=True)
    del f32
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    timed = _recorded_generate(eng, prompts, new, timed=True)
    peak = torch.cuda.max_memory_allocated() - base
    expect_kv = 2 * cfg.n_layers * B * SERVE_S_MAX * cfg.n_kv_heads * cfg.head_dim * 2
    check(timed["cache_bytes"] == expect_kv, f"KV cache {timed['cache_bytes']} B")
    print(f"[serve_lm] {LM_ARCH} B={B}, prompt {s0}, {new} new tokens, s_max {SERVE_S_MAX}, "
          f"bf16: prefill {timed['prefill_ms']:.3f} ms; per-token decode "
          f"{timed['per_token_ms']:.3f} ms (median of steps 2-{new}; steps "
          f"{[round(t, 3) for t in timed['step_ms']]}); {B / timed['per_token_ms'] * 1e3:.1f} "
          f"tokens/s; generate wall {timed['wall_ms']:.3f} ms; KV cache "
          f"{timed['cache_bytes']} B; params {_nbytes(params)} B; peak "
          f"max_memory_allocated over that generate {peak} B above the {base} B held "
          f"before the phase; {card}", flush=True)
    _serve_breakdown(eng, prompts)
    del eng, params
    torch.cuda.empty_cache()

    # the kernel at the path's row counts, and its time at one decode step's
    sizes = [B * s0, B]
    B_g, s0_g, new_g = SERVE_GLM
    sizes += [B_g * s0_g, B_g]
    err = max(check_decode_case((rows, 16, 256, 512), "float32", seed=40 + i)
              for i, rows in enumerate(sizes))
    at_step = time_at_shape(B, 16, 256, 512)
    from repro_torch.kernels.hash_decode import ops as hd_ops
    codes, cb, _, _ = _operands(B, 16, 256, 512, "float32", seed=0)
    at_step["graph_ms"] = graph_time_ms(lambda: hd_ops._forward(codes, cb, None, None), 20)
    print(f"[time] hash_decode B={B} (a decode step's rows): kernel {at_step['ms']:.4f} ms "
          f"back to back, {at_step['graph_ms']:.4f} ms as a CUDA graph "
          f"({at_step['graph_ms'] / at_step['bound_ms']:.1f}x its bound); bound "
          f"{at_step['bound_ms']:.6f} ms by {at_step['bound_by']}; embedding_bag "
          f"{at_step['library_ms']:.4f} ms; plain {at_step['plain_ms']:.4f} ms; {card}",
          flush=True)
    del codes, cb

    # chatglm3-6b at full width
    cfg_g = _serve_cfg("chatglm3-6b")
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = init_lm(torch.Generator("cuda").manual_seed(1), cfg_g)
    init_peak = torch.cuda.max_memory_allocated() - base
    n_params = param_count(params, trainable_only=True)
    prompts = np.random.default_rng(8).integers(0, cfg_g.vocab_size, (B_g, s0_g))
    torch.cuda.reset_peak_memory_stats()
    eng, run, glm_launches = _serve_pair(cfg_g, params, prompts, new_g, "serve_lm_chatglm3")
    check(bool(run["logits"].isfinite().all()), "non-finite chatglm3 logits")
    del run
    timed_g = _recorded_generate(eng, prompts, new_g, timed=True)
    peak_g = torch.cuda.max_memory_allocated() - base
    print(f"[serve_lm] chatglm3-6b ({cfg_g.n_layers} layers, d_model {cfg_g.d_model}, "
          f"{cfg_g.n_kv_heads} KV heads for {cfg_g.n_heads}, half RoPE, QKV bias; "
          f"{n_params} f32 parameters) B={B_g}, prompt {s0_g}, {new_g} new tokens: prefill "
          f"{timed_g['prefill_ms']:.3f} ms; per-token decode {timed_g['per_token_ms']:.3f} ms "
          f"(median of steps 2-{new_g}); {B_g / timed_g['per_token_ms'] * 1e3:.1f} tokens/s; "
          f"KV cache {timed_g['cache_bytes']} B; params {_nbytes(params)} B; peak "
          f"max_memory_allocated serving {peak_g} B and in init_lm {init_peak} B, above "
          f"the {base} B held before; {card}", flush=True)
    _serve_breakdown(eng, prompts)
    del eng, params
    torch.cuda.empty_cache()

    ref_err = _serve_reference()
    print(f"[serve_lm] phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return ({"serve_lm": launches, "serve_lm_chatglm3": glm_launches},
            dict(serve_lm_sizes=sizes, max_abs_err=err, cached_gap=gap, cached_gap_f32=gap_f32,
                 reference_gap=ref_err, at_decode_step=at_step,
                 qwen={k: v for k, v in timed.items() if k not in ("step_ms", "res")},
                 chatglm3={k: v for k, v in timed_g.items() if k not in ("step_ms", "res")},
                 peak=peak, peak_chatglm3=peak_g, init_peak_chatglm3=init_peak))


def _nbytes(tree) -> int:
    from repro_torch.nn.module import leaves_with_path
    return sum(t.numel() * t.element_size() for _, t in leaves_with_path(tree))


def time_lm_kernels() -> dict:
    """flash_attention at the path's shape: the bf16 tensor-core kernel
    (the path's) and the f32 CUDA-core kernel, and both at zamba2-7b's
    shape (32 heads of 112, the hybrid_train path's; D = 112 runs the
    128-wide tile), each beside its plain version,
    ``scaled_dot_product_attention`` in the same dtype and its bound
    (``kernels/flash_attention/sweep.py``); hash_decode forward and
    backward at the path's B = batch x seq rows."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.sweep import describe, time_flash
    from repro_torch.kernels.hash_decode import ops as hd_ops
    from repro_torch.kernels.hash_decode.ref import hash_decode_ref
    B, H, K, S, D, causal, _ = FLASH_CASES[0]
    shapes = {"bf16_wgmma": (B, H, K, S, D, causal, "bfloat16"),
              "f32_cuda_core": (B, H, K, S, D, causal, "float32"),
              "bf16_wgmma_zamba2": (LM_BATCH, 32, 32, LM_SEQ, 112, True, "bfloat16"),
              "f32_cuda_core_zamba2": (LM_BATCH, 32, 32, LM_SEQ, 112, True, "float32"),
              # the instantiations no config runs: f16 at the path's shape,
              # the 256-wide tile in each dtype, D = 320 in panels
              "f16_wgmma": (B, H, K, S, D, causal, "float16"),
              "bf16_wgmma_d256": (B, H, K, S, 256, causal, "bfloat16"),
              "f16_wgmma_d256": (B, H, K, S, 256, causal, "float16"),
              "f32_cuda_core_d256": (B, H, K, S, 256, causal, "float32"),
              "panels_d320": (B, H, K, S, 320, causal, "bfloat16")}
    variants = {}
    for name, shape in shapes.items():
        iters = 5 if name.startswith("panels") else 10 if shape[-1] == "float32" else 20
        variants[name] = row = time_flash(*shape, iters=iters)
        print(f"[time] {name}: {describe(row)}", flush=True)
        torch.cuda.empty_cache()
    main = variants["bf16_wgmma"]
    flash = dict(design="wgmma", variants=variants, **{
        key: main[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                                   "tflops")})

    rows, m, c, d_c = LM_BATCH * LM_SEQ, 16, 256, 512
    codes, cb, _, _ = _operands(rows, m, c, d_c, "bfloat16", seed=9)
    offsets = (torch.arange(m, device="cuda") * c)[None, :]
    table = cb.float().reshape(m * c, d_c)
    idx = codes.long() + offsets
    fwd_events_ms, fwd_enqueue_ms = time_ms(lambda: hd_ops.hash_decode(codes, cb), 50)
    fwd_ms = graph_time_ms(lambda: hd_ops._forward(codes, cb, None, None), 20)
    fwd_plain_ms, _ = time_ms(lambda: hash_decode_ref(codes, cb), 10)
    fwd_lib_ms, _ = time_ms(lambda: F.embedding_bag(idx, table, mode="sum"), 50)
    g = torch.randn(rows, d_c, generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda")
    bwd_ms, _ = time_ms(lambda: hd_ops.hash_decode_backward(codes, cb, None, g), 20)
    cbg = cb.clone().requires_grad_(True)
    bwd_plain_ms, _ = time_ms(
        lambda: torch.autograd.grad((hash_decode_ref(codes, cbg) * g).sum(), cbg), 10)
    fwd_bytes = decode_bytes(rows, m, c, d_c, "bfloat16", int(torch.unique(idx).numel()))
    fwd_bound = max(fwd_bytes / HBM_BYTES_PER_S, rows * (m - 1) * d_c / F32_ADDS_PER_S) * 1e3
    bwd_bytes = rows * m * 4 + rows * d_c * 4 + m * c * d_c * 2
    bwd_bound = bwd_bytes / HBM_BYTES_PER_S * 1e3
    print(f"[time] hash_decode B={rows} m={m} c={c} d_c={d_c} bf16 codebooks: forward "
          f"kernel {fwd_ms:.4f} ms as a CUDA graph ({fwd_events_ms:.4f} ms back to back, "
          f"the host enqueuing a call in {fwd_enqueue_ms:.4f} ms), plain "
          f"{fwd_plain_ms:.4f} ms, embedding_bag "
          f"{fwd_lib_ms:.4f} ms, bound {fwd_bound:.4f} ms by bytes ({fwd_bytes} B); "
          f"backward (the backward kernel) {bwd_ms:.4f} ms, plain autograd "
          f"{bwd_plain_ms:.4f} ms, bound {bwd_bound:.4f} ms by bytes ({bwd_bytes} B)",
          flush=True)
    torch.cuda.empty_cache()
    return dict(flash=flash, hash_lm=dict(
        rows=rows, ms=fwd_ms, events_ms=fwd_events_ms, plain_ms=fwd_plain_ms,
        library_ms=fwd_lib_ms,
        bound_ms=fwd_bound, backward_ms=bwd_ms, backward_plain_ms=bwd_plain_ms,
        backward_bound_ms=bwd_bound))


# ---------------------------------------------------------------------------
# slice 3: Algorithm 1 over dense auxiliary matrices through lsh_encode, and
# the paper's embedding-reconstruction path
# ---------------------------------------------------------------------------

def _lsh_inputs(n: int, d: int, w: int, kind: str, seed: int):
    """A (n, d), V (d, w) on the card, integer-valued in [-3, 3] (every f32
    sum exact, so any order gives the same bits) or Gaussian; t the column
    median of the plain product."""
    import torch
    from repro_torch.kernels.lsh_encode.ref import median0
    g = torch.Generator(device="cuda").manual_seed(seed)
    if kind == "integer":
        A = torch.randint(-3, 4, (n, d), generator=g, device="cuda").float()
        V = torch.randint(-3, 4, (d, w), generator=g, device="cuda").float()
    else:
        A = torch.randn(n, d, generator=g, device="cuda")
        V = torch.randn(d, w, generator=g, device="cuda")
    return A, V, median0(A @ V)


def lsh_flips(A, V, t, got, ref, t_got=None):
    """(differing bits, differing bits outside the rounding bound) between
    words ``got`` (against thresholds ``t_got``, default ``t``) and the
    plain words ``ref`` (against ``t``), (n,) or (n, k) for V (d, 32 k).  A
    bit may differ only where |U_ref - t| <= 2 d 2**-24 sum_k |A_rk V_kj| +
    |t_got - t|: each of the two f32 sums of d products lies within
    d 2**-24 sum_k |A_rk V_kj| of the exact sum, and the two thresholds lie
    |t_got - t| apart."""
    import torch
    t_got = t if t_got is None else t_got
    got, ref = got.reshape(got.shape[0], -1), ref.reshape(ref.shape[0], -1)
    shifts = torch.arange(32, device=A.device)
    differ = (((got ^ ref)[:, :, None] >> shifts) & 1).bool().reshape(got.shape[0], -1)
    differ = differ[:, :V.shape[1]]
    slack = 2 * A.shape[1] * 2.0 ** -24 * (A.abs() @ V.abs()) + (t_got - t).abs()[None, :]
    outside = differ & ((A @ V - t[None, :]).abs() > slack)
    return int(differ.sum()), int(outside.sum())


def lsh_launched(ops, before: dict, **expect) -> None:
    """The lsh_encode launches since ``before``, by kernel, are ``expect``
    (the kernels not named: none)."""
    since = {k: ops.launches_by_kernel[k] - before[k] for k in ops.KERNELS}
    want = {k: expect.get(k, 0) for k in ops.KERNELS}
    check(since == want, f"lsh_encode launched {since}, expected {want}")


def phase_lsh_check() -> dict:
    """lsh_encode's three kernels against their plain versions on the card:
    the projection's U bitwise and the fused and pack kernels' words
    bitwise at integer-valued inputs (the three shapes of
    tests/test_kernels.py, ragged n, d and W, w < 32, both path shapes);
    at Gaussian inputs at the two path shapes the words flip only within
    the rounding bound.  Where w <= 32 the TPU kernel's counterpart
    ``lsh_encode_word`` too."""
    import torch
    from repro_torch.kernels.lsh_encode import ops
    from repro_torch.kernels.lsh_encode.ref import lsh_encode_words_ref
    worst, flips = 0, {}
    cases = [(s, "integer") for s in LSH_INT_SHAPES] + [(s, "gaussian") for s in LSH_PATH_SHAPES]
    for i, ((n, d, w), kind) in enumerate(cases):
        A, V, t = _lsh_inputs(n, d, w, kind, seed=i)
        before = dict(ops.launches_by_kernel)
        U = ops.project(A, V)
        fused = ops.lsh_encode_words(A, V, t)
        packed = ops.pack(U, t)
        word = ops.lsh_encode_word(A, V, t) if w <= 32 else None
        torch.cuda.synchronize()
        lsh_launched(ops, before, project=1, pack=1, fused=1 if word is None else 2)
        ref = lsh_encode_words_ref(A, V, t)
        check(fused.dtype == torch.int64 and fused.shape == ref.shape,
              f"words {fused.dtype} {tuple(fused.shape)}")
        if kind == "integer":
            same = {"U": torch.equal(U, A @ V), "fused": torch.equal(fused, ref),
                    "pack": torch.equal(packed, ref)}
            if word is not None:
                same["lsh_encode_word"] = torch.equal(word, ref[:, 0])
            worst = max(worst, int((fused - ref).abs().max()), int((packed - ref).abs().max()))
            print(f"[lsh] n={n} d={d} w={w} integer: bitwise {same}", flush=True)
            check(all(same.values()), f"lsh_encode ({n}, {d}, {w}) differs from its plain version")
        else:
            result = {}
            for name, got in (("fused", fused), ("pack", packed)):
                differ, outside = lsh_flips(A, V, t, got, ref)
                result[name] = (differ, outside)
                check(outside == 0, f"lsh_encode {name} ({n}, {d}, {w}): {outside} bits "
                                    f"differ beyond rounding")
            flips[f"{n}x{d}x{w}"] = result["fused"][0]
            print(f"[lsh] n={n} d={d} w={w} gaussian: (differing, outside the rounding "
                  f"bound) bits of {n * w} against the plain version (cuBLAS): {result}",
                  flush=True)
        del A, V, t, U, fused, packed, ref
    torch.cuda.empty_cache()
    return dict(max_abs_err=worst, gaussian_differing_bits=flips)


def phase_lsh_packed_check() -> int:
    """Algorithm 1 on the LM path's own vocabulary auxiliary (152,064 x 512)
    on the card: ``lsh_encode_packed`` and ``core.lsh.encode_lsh`` from one
    generator state give the same words through one projection and one
    pack each, and against the plain version on the card (the row-blocked
    cuBLAS product, its column median, ``U > t``) every differing bit is
    within the rounding bound plus the two medians' distance."""
    import torch
    from repro_torch.core import lsh
    from repro_torch.device import make_generator
    from repro_torch.kernels.lsh_encode import ops
    from repro_torch.kernels.lsh_encode.ref import median0, pack_words, project_rows
    from repro_torch.launch.train import vocab_aux
    cfg = _lm_config()
    A = torch.from_numpy(vocab_aux(cfg, batch=LM_BATCH, seq=LM_SEQ, cooc_batches=8,
                                   seed=0)).cuda()
    c, m = cfg.embedding.c, cfg.embedding.m
    before = dict(ops.launches_by_kernel)
    packed = ops.lsh_encode_packed(A, c, m, generator=make_generator(0, A.device))
    core = lsh.encode_lsh(A, c, m, generator=make_generator(0, A.device))
    torch.cuda.synchronize()
    lsh_launched(ops, before, project=2, pack=2)
    check(torch.equal(packed, core), "lsh_encode_packed and core.lsh.encode_lsh differ")
    V, _ = ops.draw_projections(A.shape[1], c, m, generator=make_generator(0, A.device))
    U_plain = project_rows(A, V, ops.ROW_BLOCK)
    t_plain = median0(U_plain)
    t_kernel = median0(ops.project(A, V))
    differ, outside = lsh_flips(A, V, t_plain, packed, pack_words(U_plain, t_plain), t_kernel)
    moved = int((t_kernel != t_plain).sum())
    zero_rows = int((A.abs().sum(dim=1) == 0).sum())
    print(f"[lsh] vocabulary encode ({A.shape[0]} x {A.shape[1]}, c={c}, m={m}): "
          f"lsh_encode_packed == core.lsh.encode_lsh bitwise, one projection and one "
          f"pack each; against the plain version on the card {differ} of "
          f"{A.shape[0] * V.shape[1]} bits differ, {outside} outside the rounding bound; "
          f"{moved} of {V.shape[1]} column medians differ from the plain product's "
          f"(max {float((t_kernel - t_plain).abs().max())}); {zero_rows} all-zero rows",
          flush=True)
    check(outside == 0, f"{outside} vocabulary bits differ beyond rounding")
    del A, packed, core, U_plain
    torch.cuda.empty_cache()
    return differ


def phase_reconstruct() -> dict:
    """The reconstruction path at full width through
    ``launch.reconstruct.run``; the launch counts are read around exactly
    this run."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.hash_decode import ops as hd_ops
    from repro_torch.kernels.lsh_encode import ops as lsh_ops
    from repro_torch.launch.reconstruct import run
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fa_ops.flash_attention.launches = 0
    hd_ops.hash_decode.launches = 0
    hd_ops.hash_decode_backward.launches = 0
    hd_ops.backward_kernel_launches(reset=True)
    lsh_ops.launches_by_kernel.update(dict.fromkeys(lsh_ops.KERNELS, 0))  # the path starts here
    zero_copies()
    res = run(**REC, steps=REC_STEPS, schemes=REC_SCHEMES, device="cuda",
              log=lambda line: print(line, flush=True))
    torch.cuda.synchronize()
    launches = {"hash_decode": hd_ops.hash_decode.launches,
                "hash_decode_backward": hd_ops.hash_decode_backward.launches,
                "hash_decode_backward_by_kernel": hd_ops.backward_kernel_launches(),
                "lsh_encode": sum(lsh_ops.launches_by_kernel.values()),
                "flash_attention": fa_ops.flash_attention.launches}   # ... and ends here
    check_backward_launches(launches, "reconstruct")
    check_no_copies("reconstruct")
    launches["lsh_encode_by_kernel"] = dict(lsh_ops.launches_by_kernel)
    wall = time.perf_counter() - t0
    print(f"[reconstruct] schemes {list(res['schemes'])}: wall {wall:.2f} s, launches "
          f"{launches}, max_memory_allocated {torch.cuda.max_memory_allocated()} B; "
          f"hashing encode (Algorithm 1, 4 words) "
          f"{res['schemes']['hashing']['encode_s'] * 1e3:.3f} ms; compression ratio "
          f"{res['compression_ratio']:.4f} (Table 6: {TABLE6_RATIO})", flush=True)
    for name, r in res["schemes"].items():
        check(bool(np.isfinite(r["losses"]).all()), f"{name}: non-finite loss")
        check(0.0 <= r["nmi"] <= 1.0 + 1e-9, f"{name}: nmi {r['nmi']}")
    check(abs(res["compression_ratio"] - TABLE6_RATIO) <= 0.01,
          f"compression ratio {res['compression_ratio']} is not Table 6's {TABLE6_RATIO}")
    check(launches["lsh_encode_by_kernel"] == {"project": 1, "pack": 1, "fused": 0},
          f"the hashing encode launched lsh_encode {launches['lsh_encode_by_kernel']}, "
          f"expected one projection and one pack (one pass over A for 4 words)")
    check(launches["hash_decode"] >= len(REC_SCHEMES) * REC_STEPS,
          f"hash_decode launched {launches['hash_decode']} times")
    check(launches["flash_attention"] == 0, "the reconstruction path ran attention")
    torch.cuda.empty_cache()
    return launches


def phase_reconstruct_reference():
    """The reconstruction path at the JAX benchmark's size (n=2,000, dim 64,
    c=m=16, d_c=d_m=128) on the card (kernels) and on the CPU (plain
    versions): Algorithm 1 codes of integer-valued embeddings (round(8 x))
    with integer-valued projections bitwise equal; 5 decoder steps from one
    init with the same ids within 1e-4 (f32 throughout; cuBLAS and the
    CPU's matmuls and the kernel's and one-hot's sums round differently)."""
    import numpy as np
    import torch
    from repro_torch.core import lsh
    from repro_torch.core.embedding import init_embedding
    from repro_torch.graph.generate import clustered_embeddings
    from repro_torch.kernels.lsh_encode import ops as lsh_ops
    from repro_torch.train.reconstruct import (reconstruction_config,
                                               train_decoder_on_reconstruction)
    n, dim, c, m, d = 2000, 64, 16, 16, 128
    emb_np, _ = clustered_embeddings(0, n, dim)
    A = torch.from_numpy(np.round(8 * emb_np))
    g = torch.Generator().manual_seed(0)
    proj = [torch.round(2 * torch.randn(dim, 32, generator=g)) for _ in range(2)]
    before = dict(lsh_ops.launches_by_kernel)
    on_card = lsh.encode_lsh(A.cuda(), c, m, projections=[p.cuda() for p in proj])
    lsh_launched(lsh_ops, before, project=1, pack=1)      # both words in one pass
    on_cpu = lsh.encode_lsh(A, c, m, projections=proj)
    check(torch.equal(on_card.cpu(), on_cpu), "codes differ between the card and the CPU")
    cfg = reconstruction_config(n, dim, c, m, d, d)
    init = init_embedding(torch.Generator().manual_seed(0), cfg, codes=on_cpu)
    gi = torch.Generator().manual_seed(1)
    ids = [torch.randint(0, n, (512,), generator=gi) for _ in range(5)]
    emb = torch.from_numpy(emb_np)
    _, card = train_decoder_on_reconstruction(None, emb.cuda(), None, cfg, 5,
                                              params=_snapshot(init, "cuda"), ids=ids)
    _, cpu = train_decoder_on_reconstruction(None, emb, None, cfg, 5,
                                             params=_snapshot(init, "cpu"), ids=ids)
    worst = max(abs(a - b) for a, b in zip(card, cpu))
    print(f"[reference] reconstruction n={n}: codes card == CPU bitwise; 5 decoder "
          f"steps (card, CPU) losses {list(zip(card, cpu))}; max abs diff {worst}",
          flush=True)
    check(worst <= 1e-4, f"card and CPU reconstruction losses differ by {worst}")


def time_lsh() -> dict:
    """lsh_encode's kernels at both path shapes (W = 128, all four words):
    the projection beside its plain version (the row-blocked cuBLAS
    product) and ``torch.mm(A, V_all)`` (the same product in one call), the
    fused compare-and-pack kernel, and the pack kernel; each with its bound.
    Also the exact median over U's columns, by ``median0`` and by a sort
    (the same bits)."""
    import torch
    from repro_torch.kernels.lsh_encode import ops
    from repro_torch.kernels.lsh_encode.ref import (lsh_encode_words_ref, median0,
                                                    pack_words, project_rows)
    out = {}
    for i, (n, d, w) in enumerate(LSH_PATH_SHAPES):
        A, V, t = _lsh_inputs(n, d, w, "gaussian", seed=100 + i)
        nw = -(-w // 32)
        U = ops.project(A, V)
        flops = 2 * n * d * w
        ops_ms = flops / F32_FLOPS * 1e3
        row = {}
        for name, fn, plain, library, nbytes, iters in (
                ("project", lambda: ops.project(A, V), lambda: project_rows(A, V, ops.ROW_BLOCK),
                 lambda: torch.mm(A, V), (n * d + d * w + n * w) * 4, 20),
                ("fused", lambda: ops.lsh_encode_words(A, V, t),
                 lambda: lsh_encode_words_ref(A, V, t), lambda: torch.mm(A, V),
                 (n * d + d * w + w + n * nw) * 4, 20),
                ("pack", lambda: ops.pack(U, t), lambda: pack_words(U, t), None,
                 (n * w + w + n * nw) * 4, 50)):
            kernel_ms, enqueue_ms = time_ms(fn, iters)
            if name == "pack":      # the host enqueues it slower than the card runs it
                kernel_ms = graph_time_ms(fn, iters)
            plain_ms, _ = time_ms(plain, 5)
            library_ms = time_ms(library, iters)[0] if library is not None else None
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            k_ops_ms = ops_ms if name != "pack" else 0.0
            bound_ms = max(bytes_ms, k_ops_ms)
            row[name] = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                             bound_ms=bound_ms,
                             bound_by="bytes" if bytes_ms >= k_ops_ms else "operations")
            print(f"[time] lsh_encode {name} n={n} d={d} W={w}: kernel {kernel_ms:.4f} ms"
                  + (" (a CUDA graph of launches)" if name == "pack" else "")
                  + f" (host enqueues in {enqueue_ms:.4f} ms), plain {plain_ms:.4f} ms"
                  + (f", torch.mm(A, V_all) {library_ms:.4f} ms" if library else "")
                  + f"; bound {bound_ms:.4f} ms ({nbytes} B in {bytes_ms:.4f} ms"
                  + (f"; {flops} flops in {ops_ms:.4f} ms at the f32 peak" if k_ops_ms else "")
                  + f"); kernel at {nbytes / kernel_ms / 1e6:.1f} GB/s"
                  + (f", {flops / kernel_ms / 1e9:.2f} TFLOP/s "
                     f"({100 * ops_ms / kernel_ms:.1f}% of the f32 peak)" if k_ops_ms else ""),
                  flush=True)

        def sort_median():
            s = torch.sort(U, dim=0).values
            return (s[(n - 1) // 2] + s[n // 2]) * 0.5

        median_ms, _ = time_ms(lambda: median0(U), 5)
        sort_ms, _ = time_ms(sort_median, 5)
        same = torch.equal(sort_median(), median0(U))
        row["median"] = dict(median0_ms=median_ms, sort_ms=sort_ms)
        print(f"[time] lsh_encode median over U ({n}, {w}): median0 (two torch.kthvalue "
              f"on the transposed copy) {median_ms:.4f} ms, torch.sort over dim 0 "
              f"{sort_ms:.4f} ms (same bits: {same}); the projection "
              f"{row['project']['ms']:.4f} ms", flush=True)
        check(same, "median0 differs from the sorted midpoint")
        out[f"{n}x{d}x{w}"] = row
        del A, V, t, U
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# slice 6: GraphSAGE training through GraphRuntime and the hash_decode
# backward kernel
# ---------------------------------------------------------------------------

def check_backward_launches(launches: dict, path: str) -> None:
    """A path's backward calls (``hash_decode_backward.launches``, one a
    call) against the CUDA launches the library counted where it launched
    each of its kernels: every call launches the count, place and sum
    kernels once each."""
    by_kernel = launches["hash_decode_backward_by_kernel"]
    calls = launches["hash_decode_backward"]
    check(all(n == calls for n in by_kernel.values()),
          f"{path}: {calls} backward calls launched its kernels {by_kernel} times")


GNN_STEPS = 300                     # the main path's run, with prefetch
GNN_TIMED = 20                      # steps of each prefetch_depth timing run
# AdamW's rate for the GNN runs: at RuntimeSpec's default 1e-2 the loss
# spikes at step 2 and this width stays at the uniform predictor's loss
# (ln 40) for about 100 steps; at 1e-3 it learns within 300
GNN_LR = 1e-3
GNN_CKPT = ROOT / "build" / "gnn_ckpt"


def _bwd_operands(B, m, c, d_c, variant, seed, kind="uniform"):
    """codes (``ref.code_set``'s ``kind``), g, w0 (or None) on the card, and
    the codebooks' dtype.  Uniform codes are drawn here, as ``code_set``
    draws them, so that ``time_hd_backward`` also runs over an earlier
    commit's package, which has no ``code_set``."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        codes = rng.integers(0, c, (B, m)).astype(np.int32)
    else:
        from repro_torch.kernels.hash_decode.ref import code_set
        codes = code_set(kind, B, m, c, rng)
    codes = torch.from_numpy(codes).cuda()
    g = torch.from_numpy(rng.standard_normal((B, d_c)).astype(np.float32)).cuda()
    dtype, _, with_w0 = variant.partition("+")
    w0 = (torch.from_numpy(rng.standard_normal(d_c).astype(np.float32)).cuda()
          if with_w0 else None)
    return codes, g, w0, getattr(torch, dtype)


def phase_hd_backward_check(frontier_rows: int, gnn_codes, full_codes) -> tuple:
    """The hash_decode backward kernels (the codebook gradient) against
    their plain versions run on CPU copies of the same operands, bitwise,
    and two calls against each other: the sort alone (``code_order``) and
    the whole gradient, at B in {1, 512, a real training frontier, 61,696},
    m in {3, 16}, d_c in {130, 512} with uniform codes, then at skewed codes
    (every row one code, Zipf, c = 16 at 61,696 rows), the real codes of
    the GNN run's first batch (``gnn_codes``, its frontier with its padding
    rows), and at the full graph's 169,343 rows, uniform and the full-graph
    GCN's real codes (``full_codes``); each with and without w0, f32 and
    bf16 codebooks.  Returns the number of cases, the largest error and
    the largest error at each (m, c)."""
    import torch
    from repro_torch.kernels.hash_decode import ops
    from repro_torch.kernels.hash_decode.ref import code_order, hash_decode_backward_ref
    n, worst, worst_by_mc = 0, 0.0, {}
    cases = [("uniform", B, m, c, d_c) for B in (1, REC_BATCH, frontier_rows, 61_696)
             for m, c in ((16, 256), (3, 16)) for d_c in (512, 130)]
    cases += [("one_code", frontier_rows, 16, 256, 512), ("one_code", 61_696, 3, 16, 130),
              ("zipf", frontier_rows, 16, 256, 512), ("zipf", 61_696, 16, 256, 130),
              ("uniform", 61_696, 16, 16, 512), ("gnn", gnn_codes.shape[0], 16, 256, 512),
              ("uniform", N_NODES, 16, 256, 512), ("fullgraph", N_NODES, 16, 256, 512),
              # 12-bit codes, (m, c) = (16, 4096): the sort's blocks take the
              # codes in ranges (an (m, c) histogram passes 227 KiB)
              ("uniform", 61_696, 16, 4096, 512), ("zipf", 61_696, 16, 4096, 130)]
    real = {"gnn": gnn_codes, "fullgraph": full_codes}
    for kind, B, m, c, d_c in cases:
        variants = ("float32", "float32+w0", "bfloat16", "bfloat16+w0")
        if (B, m, c) == (61_696, 16, 256) and kind == "uniform":
            variants += ("float16", "float16+w0")
        for variant in variants:
            codes, g, w0, dtype = _bwd_operands(B, m, c, d_c, variant, seed=n,
                                                kind="uniform" if kind in real else kind)
            if kind in real:
                codes = real[kind].cuda()
            offsets, rows = ops.code_order(codes, c)
            want_offsets, want_rows = code_order(codes.cpu(), c)
            check(torch.equal(offsets.cpu(), want_offsets)
                  and torch.equal(rows.cpu(), want_rows),
                  f"the backward's sort {(kind, B, m, c)} differs from code_order")
            before = ops.hash_decode_backward.launches
            before_kernels = ops.backward_kernel_launches()
            a = ops.codebook_grad(codes, g, w0, c, dtype)
            b = ops.codebook_grad(codes, g, w0, c, dtype)
            torch.cuda.synchronize()
            after_kernels = ops.backward_kernel_launches()
            check(ops.hash_decode_backward.launches == before + 2
                  and all(after_kernels[k] == before_kernels[k] + 2 for k in after_kernels),
                  f"two backward calls launched its kernels {before_kernels} -> "
                  f"{after_kernels} times")
            ref = hash_decode_backward_ref(codes.cpu(), g.cpu(),
                                           None if w0 is None else w0.cpu(), c, dtype)
            same, again = torch.equal(a.cpu(), ref), torch.equal(a, b)
            err = float((a.cpu().float() - ref.float()).abs().max())
            worst = max(worst, err)
            worst_by_mc[m, c] = max(worst_by_mc.get((m, c), 0.0), err)
            shown = ((B in (frontier_rows, 61_696, N_NODES) and variant == "float32")
                     or kind != "uniform" or c > 256 or variant.startswith("float16"))
            if shown or not (same and again):
                longest = int((offsets[:, 1:] - offsets[:, :-1]).max())
                print(f"[backward] hash_decode_backward {kind} B={B} m={m} c={c} "
                      f"d_c={d_c} {variant}: sort equal to code_order (longest "
                      f"segment {longest} rows); bitwise={same} (max_abs_err {err}), "
                      f"two calls bitwise={again}", flush=True)
            check(same and again, f"hash_decode_backward {(kind, B, m, c, d_c, variant)} "
                                  f"differs from its plain version or itself")
            n += 1
            del codes, g, w0, a, b, ref, offsets, rows
    print(f"[backward] hash_decode_backward: {n} cases bitwise equal to the plain "
          f"version, two calls bitwise equal in each, the sort equal to code_order in "
          f"each", flush=True)
    torch.cuda.empty_cache()
    return n, worst, worst_by_mc


def check_gnn_frontiers(sizes, what: str = "frontier sizes of the run",
                        variant: str = "float32") -> float:
    """The forward and the backward kernel at every row count a GNN path
    gave them (m=16, c=256, d_c=512, no w0: the decode of the paper's
    GraphSAGE and of ``merchant_config``; the forward from ``variant``
    storage, f32 or int8, the backward's gradient f32, as for f32 or int8
    masters), each bitwise against its plain version; returns the
    forward's largest error."""
    import torch
    from repro_torch.kernels.hash_decode import ops
    from repro_torch.kernels.hash_decode.ref import hash_decode_backward_ref
    m, c, d_c = 16, 256, 512
    worst = 0.0
    for i, B in enumerate(sizes):
        worst = max(worst, check_decode_case((B, m, c, d_c), variant, seed=100 + i))
        codes, g, _, dtype = _bwd_operands(B, m, c, d_c, "float32", seed=100 + i)
        got = ops.codebook_grad(codes, g, None, c, dtype)
        ref = hash_decode_backward_ref(codes.cpu(), g.cpu(), None, c, dtype)
        check(torch.equal(got.cpu(), ref),
              f"hash_decode_backward at B={B} ({what}) differs from its plain version")
        del codes, g, got, ref
    print(f"[gnn_train] forward ({variant}, both variants) and backward kernels bitwise to "
          f"their plain versions at all {len(sizes)} {what}: {list(sizes)}", flush=True)
    torch.cuda.empty_cache()
    return worst


def time_hd_backward(rows: int, storage: str = "float32", graph: bool = False,
                     c: int = 256) -> dict:
    """The backward kernels at ``rows`` rows (m=16, c=256, d_c=512, no w0,
    ``storage`` codebooks) beside their bound, the one-hot contraction they
    replaced, their plain version (index_add_ on the card) and the backward
    of ``F.embedding_bag(mode="sum")`` over the flattened (m*c, d_c) table
    (in ``storage``, its cotangent cast to it).  ``graph``: the kernels timed
    as a CUDA graph (at small B the host enqueues a call slower than the
    card runs it).  ``c`` above 256 (12-bit codes at 4,096) leaves the
    one-hot out: its (B, m, c) f32 operand alone would take 16 GB."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.hash_decode import ops
    from repro_torch.kernels.hash_decode.ref import hash_decode_backward_ref
    m, d_c = 16, 512
    codes, g, _, dtype = _bwd_operands(rows, m, c, d_c, storage, seed=11)

    def kernel():
        return ops.codebook_grad(codes, g, None, c, dtype)

    events_ms, enqueue_ms = time_ms(kernel, 20)
    kernel_ms = graph_time_ms(kernel, 20) if graph else events_ms

    def onehot():
        iota = torch.arange(c, dtype=codes.dtype, device=codes.device)
        return torch.einsum("bmc,bd->mcd", (codes[:, :, None] == iota).float(), g).to(dtype)

    onehot_ms = onehot_err = None
    if c <= 256:
        onehot_ms, _ = time_ms(onehot, 5)
        onehot_err = float((onehot().float() - kernel().float()).abs().max())
    plain_ms, _ = time_ms(lambda: hash_decode_backward_ref(codes, g, None, c, dtype), 5)
    table = torch.zeros(m * c, d_c, device="cuda", dtype=dtype, requires_grad=True)
    idx = codes.long() + (torch.arange(m, device="cuda") * c)[None, :]
    out = F.embedding_bag(idx, table, mode="sum")
    g_lib = g.to(dtype)
    library_ms, _ = time_ms(lambda: torch.autograd.grad(out, table, g_lib, retain_graph=True), 20)
    lib_err = float((torch.autograd.grad(out, table, g_lib, retain_graph=True)[0].float()
                     .reshape(m, c, d_c) - kernel().float()).abs().max())
    nbytes = rows * d_c * 4 + rows * m * 4 + m * c * d_c * table.element_size()
    adds = rows * m * d_c
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    adds_ms = adds / F32_ADDS_PER_S * 1e3
    bound_ms = max(bytes_ms, adds_ms)
    bound_by = "bytes" if bytes_ms >= adds_ms else "operations"
    how = f"as a CUDA graph ({events_ms:.4f} ms back to back)" if graph else "back to back"
    onehot_text = ("not run" if onehot_ms is None
                   else f"{onehot_ms:.4f} ms (max diff {onehot_err})")
    print(f"[time] hash_decode_backward B={rows} m={m} c={c} d_c={d_c} {storage}: kernels "
          f"{kernel_ms:.4f} ms {how} (host enqueues a call in {enqueue_ms:.4f} ms), one-hot "
          f"contraction {onehot_text}, plain (index_add_ on "
          f"the card) {plain_ms:.4f} ms, embedding_bag backward {library_ms:.4f} ms (max "
          f"diff {lib_err}); bound {bound_ms:.4f} ms by {bound_by} ({nbytes} B in "
          f"{bytes_ms:.4f} ms, {adds} adds in {adds_ms:.4f} ms); kernels "
          f"{kernel_ms / bound_ms:.1f}x their bound", flush=True)
    del codes, g, table, out
    torch.cuda.empty_cache()
    return dict(rows=rows, ms=kernel_ms, plain_ms=plain_ms, onehot_ms=onehot_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)


def _gnn_spec(model: str = "sage", n_nodes: int = N_NODES, n_classes: int = N_CLASSES,
              **overrides):
    import dataclasses
    from repro_torch.optim.adamw import AdamWConfig
    return dataclasses.replace(_spec("auto", n_nodes, n_classes, model=model), log_every=1,
                               optimizer=AdamWConfig(lr=GNN_LR, weight_decay=0.0),
                               **overrides)


def _same_tree(a, b) -> bool:
    import torch
    from repro_torch.nn.module import leaves_with_path
    la, lb = dict(leaves_with_path(a)), dict(leaves_with_path(b))
    return la.keys() == lb.keys() and all(torch.equal(la[k], lb[k]) for k in la)


def _train_timed(rt, steps: int):
    """``rt.train(steps)`` with the host clock stamped at every step's
    metrics (log_every=1): the periods between stamps hold the batch fetch
    as well as the step."""
    stamps = []
    res = rt.train(steps, on_metrics=lambda s, m: stamps.append(time.perf_counter()))
    return res, [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]


def check_gnn_grads_deterministic(rt, batch, label: str = "") -> None:
    """Two gradients of the same loss on the same state and batch, leaf by
    leaf: every backward on the step's path must give the same bits."""
    import torch
    from repro_torch.graph.engine import batch_to
    from repro_torch.nn.module import leaves_with_path, value_and_grad
    from repro_torch.train.step import gnn_loss
    batch = batch_to(batch, rt.device)
    (la, ga), (lb, gb) = (value_and_grad(lambda p: gnn_loss(rt.model, p, batch), rt.params)
                          for _ in range(2))
    grads_a, grads_b = dict(leaves_with_path(ga)), dict(leaves_with_path(gb))
    differ = [("/".join(k), float((grads_a[k] - grads_b[k]).abs().max()))
              for k in grads_a if not torch.equal(grads_a[k], grads_b[k])]
    label = label or ("fullgraph" if "ids" in batch else "gnn_train")
    print(f"[{label}] two gradients of one step, "
          f"leaf by leaf: "
          f"{len(grads_a) - len(differ)} of {len(grads_a)} leaves bitwise equal; "
          f"differing {differ}; losses equal {torch.equal(la, lb)}", flush=True)
    check(not differ and torch.equal(la, lb), f"a backward on the GNN step is not "
                                              f"deterministic: {differ}")


def phase_gnn_train(graph):
    """The paper's GraphSAGE trained at full width through
    ``GraphRuntime.train`` with prefetch, on the serving phase's graph;
    then prefetch against none, one step's breakdown and profile,
    ``evaluate("val")`` and a killed-and-resumed run against a straight
    one.  Returns the path's launch counts, the breakdown step's frontier
    rows, the frontier rows of every step of the main run, and the codes
    of its first batch's frontier (padding rows included)."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.core.embedding import lookup_codes
    from repro_torch.graph.engine import batch_to
    from repro_torch.graph.runtime import GraphRuntime
    from repro_torch.stages import StageTimer
    shutil.rmtree(GNN_CKPT, ignore_errors=True)
    t0 = time.perf_counter()
    rt = GraphRuntime.from_spec(_gnn_spec(), graph=graph)
    torch.cuda.synchronize()
    print(f"[gnn_train] GraphRuntime.from_spec on {rt.device}: {time.perf_counter() - t0:.2f} s; "
          f"splits {[len(v) for v in rt.splits.values()]}; prefetch_depth "
          f"{rt.spec.prefetch_depth}; batch {rt.spec.batch_size}", flush=True)
    check(rt.device.type == "cuda", "the training runtime is not on the card")
    init = _snapshot(rt.params)
    # one batch through the prefetching iterator, which is then rewound:
    # load_state_dict stops the producer and drops what it had queued
    start = rt.data_iter.state_dict()
    first = rt.data_iter.next_batch()
    check_gnn_grads_deterministic(rt, first)
    rt.data_iter.load_state_dict(start)
    # the run's first batch's codes, at its frontier with its padding rows
    frontier = batch_to(first, rt.device)["frontier"]
    first_codes = lookup_codes(rt.params["embed"], frontier.unique,
                               rt.model.cfg.embedding_config()).cpu()
    print(f"[gnn_train] first batch: {first_codes.shape[0]} frontier rows "
          f"({frontier.n_unique} unique, the rest padding) for the backward check",
          flush=True)
    step, frontiers = rt.train_step, []

    def recording_step(state, batch):       # the frontier rows of each step
        frontiers.append(int(batch["frontier"].unique.shape[0]))
        return step(state, batch)
    rt.train_step = recording_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()                              # the training path's run starts here
    res, periods = _train_timed(rt, GNN_STEPS)
    torch.cuda.synchronize()
    rt.train_step = step
    launches = read_counts("gnn_train")        # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    losses = res.losses
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    uniform = float(np.log(N_CLASSES))        # the loss of the uniform predictor
    shown = {i + 1: losses[i] for i in sorted({*range(5), *range(24, GNN_STEPS, 25),
                                               *range(GNN_STEPS - 5, GNN_STEPS)})}
    print(f"[gnn_train] {GNN_STEPS} steps, prefetch_depth 2, lr {GNN_LR}: losses by step "
          f"{shown}; mean of the first 5 {first}, of the last 5 {last} (uniform predictor "
          f"{uniform}); launches {launches}; frontier rows a step {min(frontiers)}-{max(frontiers)} "
          f"({len(set(frontiers))} sizes); "
          f"max_memory_allocated {peak} B", flush=True)
    check(all(np.isfinite(losses)), f"non-finite GNN loss {losses}")
    check(last < uniform - 1.0, f"the GNN did not learn: the mean of the last 5 losses "
                                f"{last} is not 1 below the uniform predictor's {uniform}")
    check(len(frontiers) == GNN_STEPS, f"{len(frontiers)} frontiers for {GNN_STEPS} steps")
    check(launches == {"hash_decode": GNN_STEPS, "hash_decode_backward": GNN_STEPS,
                       "hash_decode_backward_by_kernel": dict.fromkeys(
                           ("count", "place", "sum"), GNN_STEPS),
                       "flash_attention": 0, "lsh_encode": 0},
          f"expected one forward and one backward hash_decode launch a step: {launches}")
    stats = rt.data_iter.stats()
    print(f"[gnn_train] producer: {stats['n_produced']} batches, sampling+dedup "
          f"{stats['sample_us'] / 1e3 / max(stats['n_produced'], 1):.3f} ms and the pinned "
          f"copy {stats['put_us'] / 1e3 / max(stats['n_produced'], 1):.3f} ms a batch",
          flush=True)

    ev = rt.evaluate("val")
    print(f"[gnn_train] evaluate('val'): accuracy {ev['accuracy']}, loss {ev['loss']}, "
          f"n {ev['n']} of {len(rt.splits['val'])} val nodes", flush=True)
    check(ev["n"] == len(rt.splits["val"]), "evaluate did not count every val node once")
    check(np.isfinite(ev["loss"]), "non-finite eval loss")
    check(ev["accuracy"] > 10 / N_CLASSES, f"val accuracy {ev['accuracy']} is not 10 times "
                                           f"chance ({1 / N_CLASSES})")

    # the step's period with prefetch (2) and without (0), from the same init
    timing = {2: periods[1:]}
    rt0 = GraphRuntime.from_spec(_gnn_spec(prefetch_depth=0), graph=graph,
                                 params=_snapshot(init))
    _, periods0 = _train_timed(rt0, GNN_TIMED)
    timing[0] = periods0[1:]
    rt2 = GraphRuntime.from_spec(_gnn_spec(), graph=graph, params=_snapshot(init))
    _, periods2 = _train_timed(rt2, GNN_TIMED)
    rt2.close()
    timing[2] = periods2[1:]
    med = {d: float(np.median(v)) for d, v in timing.items()}
    print(f"[gnn_train] step period (host clock, steps 2-{GNN_TIMED}; median): "
          f"prefetch_depth 2 {med[2]:.3f} ms {[round(t, 3) for t in timing[2]]}; "
          f"prefetch_depth 0 {med[0]:.3f} ms {[round(t, 3) for t in timing[0]]}", flush=True)

    # where one step's time goes (no prefetch: sampling in this thread)
    batch = None
    with StageTimer() as timer:
        t0 = time.perf_counter()
        batch = rt0.data_iter.next_batch()
        rt0.state, m = rt0.train_step(rt0.state, batch)
        float(m["loss"])
        step_ms = (time.perf_counter() - t0) * 1e3
    stages = {k: round(sum(v), 3) for k, v in timer.ms.items()}
    dev_ms = sum(stages.get(k, 0.0) for k in ("unpack", "decode", "mlp", "sage", "logits",
                                              "loss", "backward", "optimizer"))
    print(f"[breakdown] one GNN training step under the stage timer: {step_ms:.3f} ms; "
          f"stages (ms) {stages}; device stages {dev_ms:.3f} ms; frontier "
          f"{batch['frontier'].unique.shape[0]} rows ({batch['frontier'].n_unique} unique)",
          flush=True)
    frontier_rows = int(batch["frontier"].unique.shape[0])
    profile_step(rt0.train_step, rt0.state, rt0.data_iter.next_batch())

    # killed and resumed: B trains 10 steps, is dropped, resumes to 20
    straight = GraphRuntime.from_spec(
        _gnn_spec(ckpt_dir=str(GNN_CKPT / "a"), ckpt_every=10), graph=graph,
        params=_snapshot(init))
    run_a = straight.train(20)
    straight.close()
    killed = GraphRuntime.from_spec(
        _gnn_spec(ckpt_dir=str(GNN_CKPT / "b"), ckpt_every=10), graph=graph,
        params=_snapshot(init))
    run_b = killed.train(10)
    killed.close()
    del killed
    resumed = GraphRuntime.resume(str(GNN_CKPT / "b"), graph=graph)
    run_c = resumed.train(20)
    resumed.close()
    same_losses = run_b.losses + run_c.losses == run_a.losses
    same_params = _same_tree(resumed.params, straight.params)
    print(f"[gnn_train] kill and resume: straight losses 11-20 {run_a.losses[10:]}; resumed "
          f"from step {run_c.resumed_from}: {run_c.losses}; losses bitwise {same_losses}, "
          f"final params bitwise {same_params}", flush=True)
    check(run_c.resumed_from == 10 and same_losses and same_params,
          "the resumed run differs from the straight one")
    rt.close()
    shutil.rmtree(GNN_CKPT, ignore_errors=True)
    del rt, rt0, straight, resumed
    torch.cuda.empty_cache()
    uncached = dict(init=init, losses=res.losses[:CACHED_STEPS], period_ms=med[2])
    return launches, frontier_rows, sorted(set(frontiers)), first_codes, uncached


# -- the hot-node cache and the batching tier ---------------------------------

CACHED_CAP = 4 * 24_064             # training cache: serving's rule, 4 frontiers
CACHED_STEPS = 20
EARLY_STEPS = 5                     # the span of the port's bounds against JAX
CACHED_CKPT = ROOT / "build" / "gnn_ckpt_cached"
CACHE_FIELDS = ("node_ids", "values", "version", "last_used", "version_counter", "clock",
                "hits", "misses")


def flash_want(**counts) -> dict:
    """flash_attention's launches by kernel: ``counts``, 0 for every other
    kernel."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    return {k: counts.get(k, 0) for k in fa_ops.flash_attention.launches_by_kernel}


def zero_copies() -> None:
    """The operands the three wrappers copied (strided, unaligned, a head
    dim padded or 16 bits widened) to 0."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.hash_decode import ops as hd_ops
    from repro_torch.kernels.lsh_encode import ops as lsh_ops
    fa_ops.flash_attention.copies = hd_ops.hash_decode.copies = lsh_ops.copies = 0


def check_no_copies(path: str) -> None:
    """A model path hands every kernel its operands as they are: the
    wrappers copied none since ``zero_copies``."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.hash_decode import ops as hd_ops
    from repro_torch.kernels.lsh_encode import ops as lsh_ops
    copies = {"flash_attention": fa_ops.flash_attention.copies,
              "hash_decode": hd_ops.hash_decode.copies, "lsh_encode": lsh_ops.copies}
    print(f"[copies] {path}: {copies}", flush=True)
    check(not any(copies.values()), f"{path} copied operands on the way to a kernel: {copies}")


def zero_counts() -> None:
    """Every kernel's launch and copy counts to 0: a path's run starts here."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.hash_decode import ops as hd_ops
    from repro_torch.kernels.lsh_encode import ops as lsh_ops
    fa_ops.flash_attention.launches = 0
    by_kernel = fa_ops.flash_attention.launches_by_kernel
    by_kernel.update(dict.fromkeys(by_kernel, 0))
    lsh_ops.launches_by_kernel.update(dict.fromkeys(lsh_ops.KERNELS, 0))
    hd_ops.hash_decode.launches = 0
    hd_ops.hash_decode_backward.launches = 0
    hd_ops.backward_kernel_launches(reset=True)
    zero_copies()


def _counts(path: str) -> dict:
    """Every kernel's launch counts since ``zero_counts``; the path copied
    no operand (``check_no_copies``)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.hash_decode import ops as hd_ops
    from repro_torch.kernels.lsh_encode import ops as lsh_ops
    launches = {"hash_decode": hd_ops.hash_decode.launches,
                "hash_decode_backward": hd_ops.hash_decode_backward.launches,
                "hash_decode_backward_by_kernel": hd_ops.backward_kernel_launches(),
                "flash_attention": fa_ops.flash_attention.launches,
                "lsh_encode": sum(lsh_ops.launches_by_kernel.values())}
    check_backward_launches(launches, path)
    check_no_copies(path)
    return launches


def read_counts(path: str) -> dict:
    """Every kernel's launch counts since ``zero_counts``: a path's run ends
    here.  None of the cache's paths runs attention or an encode."""
    launches = _counts(path)
    check(launches["flash_attention"] == 0 and launches["lsh_encode"] == 0,
          f"{path} ran attention or an encode: {launches}")
    return launches


def _path_counts(path: str) -> dict:
    """``_counts`` with flash_attention's and lsh_encode's launches split by
    kernel: a training path's run ends here."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.lsh_encode import ops as lsh_ops
    launches = _counts(path)
    launches["flash_attention_by_kernel"] = dict(fa_ops.flash_attention.launches_by_kernel)
    launches["lsh_encode_by_kernel"] = dict(lsh_ops.launches_by_kernel)
    return launches


def _diff(a, b) -> float:
    import numpy as np
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def check_rows_against(results, reference, what: str) -> bool:
    """Embeddings and logits of two lists of served results: bitwise, or
    within 1e-6 (the bound the serving phase holds between backends) where
    cuBLAS rounds a row differently at another row count.  Prints the
    largest difference; returns whether every row was bitwise."""
    import numpy as np
    emb = max(_diff(r.embeddings, q.embeddings) for r, q in zip(results, reference))
    lg = max(_diff(r.logits, q.logits) for r, q in zip(results, reference))
    bitwise = all(np.array_equal(r.embeddings, q.embeddings)
                  and np.array_equal(r.logits, q.logits) for r, q in zip(results, reference))
    print(f"[cache] {what}: embeddings max abs diff {emb}, logits {lg}; bitwise {bitwise}",
          flush=True)
    check(emb <= 1e-6 and lg <= 1e-6, f"{what}: embeddings differ by {emb}, logits by {lg}")
    return bitwise


def phase_cached_serve(rt, plain, requests, uncached):
    """The serving path as ``rt.serve()`` gives it with no arguments: the
    hot-node cache at the JAX default capacity (the whole graph here),
    miss-only decode.  The uncached phase's 12 requests (8 ``serve`` and a
    ``serve_many`` of 4), then the first 8 again.  Returns the path's
    launch counts and the decode row counts it ran."""
    import numpy as np
    import torch
    from repro_torch.core import embedding as emb_lib
    from repro_torch.core.backend import CachedDecodeBackend, CacheState
    from repro_torch.kernels.hash_decode import ops
    engine = rt.serve()
    check(engine.cached and engine.cache_capacity == min(4 * engine.frontier_cap, N_NODES),
          f"rt.serve() has cache capacity {engine.cache_capacity}")
    calls = [[ids] for ids in requests[:8]] + [requests[8:12]] + [[ids] for ids in requests[:8]]
    planned, served, times, launched, counters, peak = [], [], [], [], [], None
    zero_counts()                              # the cached serving path's run starts here
    for i, reqs in enumerate(calls):
        planned.append(engine.planned_frontier(reqs))   # the host's plan, no launch
        if len(reqs) > 1:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        before = ops.hash_decode.launches
        t0 = time.perf_counter()
        served.append(engine.serve_many(reqs))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        launched.append(ops.hash_decode.launches - before)
        if len(reqs) > 1:
            peak = torch.cuda.max_memory_allocated()
        st = engine.stats()
        counters.append((st["hits"], st["misses"]))
    launches = read_counts("serve_cached")     # ... and ends here
    n_decode = [fb.n_decode for fb in planned]
    rows = [out[0].rows_decoded for out in served]
    hit_rate, prev = [], (0, 0)
    for h, m in counters:
        hit_rate.append(round((h - prev[0]) / max(h - prev[0] + m - prev[1], 1), 4))
        prev = (h, m)
    print(f"[cache] serve, capacity {engine.cache_capacity}: per call (8 serve, serve_many "
          f"of 4, 8 repeats) rows decoded {rows} of {[len(c) * engine.frontier_cap for c in calls]}"
          f"; hit rate {hit_rate}; host-clock ms {[round(t, 3) for t in times]}; launches "
          f"{launched}; stats {engine.stats()}", flush=True)
    check(rows == n_decode, f"rows decoded {rows} are not the plans' {n_decode}")
    check(launched == [int(n > 0) for n in n_decode],
          f"hash_decode launched {launched} times for calls decoding {n_decode} rows")
    check(all(n == 0 for n in n_decode[9:]), f"repeated requests decoded {n_decode[9:]} rows")

    results = [r for out in served for r in out]
    reference = uncached + uncached[:8]
    bitwise = check_rows_against(results, reference, "cached serve against the uncached engine")
    check_rows_against(uncached[8:], [plain.serve(ids) for ids in requests[8:12]],
                       "uncached serve_many of 4 against single uncached requests")

    # each call's miss rows through the kernel at the call's bucket, against
    # the uncached engine's decode of the whole frontier (B = cap, x4)
    ecfg = rt.cfg.embedding_config()
    cb = engine.params["embed"]["decoder"]["codebooks"]
    checked = 0
    for reqs, fb in zip(calls, planned):
        if not fb.n_decode:
            continue
        full = plain.coalesced_frontier(reqs)
        ids = torch.from_numpy(fb.unique[:fb.n_decode].astype(np.int64)).to(rt.device)
        keys = torch.from_numpy(full.unique[:full.n_unique].astype(np.int64)).to(rt.device)
        rows_full = plain.model.backend.decode(
            emb_lib.lookup_codes(plain.params["embed"],
                                 torch.from_numpy(full.unique).to(rt.device), ecfg), cb)
        rows_miss = engine.model.backend.decode(
            emb_lib.lookup_codes(engine.params["embed"], ids, ecfg), cb)
        check(torch.equal(rows_miss, rows_full[torch.searchsorted(keys, ids)]),
              f"miss rows decoded at {fb.n_decode} rows differ from the uncached decode")
        checked += 1
    print(f"[cache] the miss rows of {checked} calls decode bitwise as the uncached engine's "
          f"rows of the same nodes (kernel at {sorted({n for n in n_decode if n})} rows against "
          f"the whole frontier)", flush=True)

    # the card's bookkeeping against a CPU replay of the same lookups
    replay = CacheState.create(engine.cache_capacity, rt.cfg.d_e)
    cache = CachedDecodeBackend(staleness=0)
    for fb in planned:
        _, replay = cache.lookup_missonly(
            replay, torch.from_numpy(fb.unique), lambda i: torch.zeros(i.shape[0], rt.cfg.d_e),
            fb.n_decode, valid=torch.from_numpy(fb.valid))
    card = engine._cache_state
    same = [f for f in CACHE_FIELDS if f != "values"
            and torch.equal(getattr(card, f).cpu(), getattr(replay, f))]
    print(f"[cache] card CacheState against a CPU replay of the {len(planned)} lookups: "
          f"equal fields {same}; {int((card.node_ids >= 0).sum())} slots held", flush=True)
    check(len(same) == len(CACHE_FIELDS) - 1, "the card's cache bookkeeping is not the replay's")
    held = card.node_ids.cpu().numpy()
    check(not engine._held_stale and np.array_equal(np.flatnonzero(engine._held),
                                                    np.sort(held[held >= 0])),
          "the engine's host table of cached ids is not the card's slot ids")

    # peak memory of a serve_many of 4, cached (above) and uncached
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    plain.serve_many(requests[8:12])
    torch.cuda.synchronize()
    plain_peak = torch.cuda.max_memory_allocated()
    print(f"[cache] max_memory_allocated over a serve_many of 4: cached {peak} B, uncached "
          f"{plain_peak} B (a dense (U, C) compare would add 41.8 GB)", flush=True)
    check(peak <= plain_peak + (1 << 30), "the cached serve_many took over 1 GB more memory")

    # the plan's membership test: the engine's kept table of cached ids, a
    # table of bools built from the slot ids (the training planner's), and
    # np.isin, each with the same stable partition (median of 5, host clock)
    fb = planned[0]
    cached_ids = card.node_ids.cpu().numpy()

    def by_isin(ids, valid):
        return CachedDecodeBackend.partition(valid & ~np.isin(ids, cached_ids[cached_ids >= 0]))

    plan_ms = {}
    for name, fn in (("the engine's kept table",
                      lambda i, v: CachedDecodeBackend.partition(v & ~engine._held[i])),
                     ("a table built from the slot ids",
                      lambda i, v: CachedDecodeBackend.plan_missonly(cached_ids, i, v)),
                     ("np.isin", by_isin)):
        runs = []
        for _ in range(5):
            t0 = time.perf_counter()
            perm, n_miss = fn(fb.unique, fb.valid)
            runs.append((time.perf_counter() - t0) * 1e3)
        plan_ms[name] = (float(np.median(runs)), perm, n_miss)
    (_, k_perm, k_n) = plan_ms["np.isin"]
    same = all(np.array_equal(perm, k_perm) and n == k_n for _, perm, n in plan_ms.values())
    print(f"[cache] plan at {fb.unique.shape[0]} rows against {engine.cache_capacity} slots "
          f"(median of 5): membership by " + ", by ".join(
              f"{name} {ms:.3f} ms" for name, (ms, _, _) in plan_ms.items())
          + f"; same plan {same}", flush=True)
    check(same, "the membership tests disagree")

    rng = np.random.default_rng(7)
    phase_breakdown(engine, [rng.choice(N_NODES, REQUEST, replace=False) for _ in range(8)],
                    label=" cached")
    fresh, repeat = rng.choice(N_NODES, REQUEST, replace=False), requests[0]
    profile_call(f"one cached request ({engine.planned_frontier([fresh]).n_decode} rows "
                 f"decoded)", lambda: engine.serve(fresh))
    profile_call("one cached request (a repeat, 0 rows decoded)", lambda: engine.serve(repeat))
    profile_call("one uncached request", lambda: plain.serve(fresh))
    sizes = sorted({n for n in n_decode if n})
    for i, B in enumerate(sizes):
        check_decode_case((B, 16, 256, 512), "float32", seed=300 + i)
    return launches, bitwise, sizes


def phase_batching(rt, n_requests: int = 16, threads: int = 4):
    """The continuous-batching tier: ``rt.serve(batching=...)``, 16 requests
    (sharing 32 hub nodes) submitted from 4 threads, against the same ids
    through a sequential cached engine, and hash_decode held bitwise to its
    plain version at every microbatch's decode size.  Returns the path's
    launch counts, those sizes and the kernel's largest error there."""
    import numpy as np
    from repro_torch.serving import BatchingSpec
    rng = np.random.default_rng(11)
    hubs = rng.choice(N_NODES, 32, replace=False)
    requests = [np.concatenate([hubs, rng.choice(N_NODES, REQUEST - 32, replace=False)])
                for _ in range(n_requests)]
    zero_counts()                              # the batching path's run starts here
    t0 = time.perf_counter()
    tier = rt.serve(batching=BatchingSpec(max_batch=4, max_delay_ms=20.0))
    with ThreadPoolExecutor(threads) as ex:
        futures = [ex.submit(lambda chunk: [tier.serve(r) for r in chunk],
                             requests[i::threads]) for i in range(threads)]
        chunks = [f.result() for f in futures]
    stats = tier.stats()
    tier.close()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = read_counts("serve_batched")    # ... and ends here
    got = [None] * n_requests
    for i, chunk in enumerate(chunks):
        got[i::threads] = chunk
    print(f"[batching] {n_requests} requests from {threads} threads, max_batch 4: "
          f"{wall_ms:.3f} ms; stats {stats}; launches {launches}", flush=True)
    check(stats["completed"] == n_requests and stats["shed"] == 0,
          f"the batcher completed {stats['completed']} and shed {stats['shed']}")
    check(stats["microbatches"] < n_requests, "the batcher coalesced nothing")
    check(launches["hash_decode"] <= stats["microbatches"],
          "more hash_decode launches than microbatches")
    sequential = rt.serve()
    check_rows_against(got, [sequential.serve(r) for r in requests],
                       "batched responses against the sequential cached serve")
    # one response per request, each carrying its microbatch's decode size
    sizes = sorted({r.rows_decoded for r in got if r.rows_decoded})
    check(len(sizes) > 0, "no microbatch decoded a row")
    err = max(check_decode_case((B, 16, 256, 512), "float32", seed=400 + i)
              for i, B in enumerate(sizes))
    print(f"[batching] hash_decode bitwise to its plain version at the microbatches' decode "
          f"sizes {sizes}", flush=True)
    return launches, sizes, err


def _plain_against_planned(rt, state, batch):
    """From one state (params and cache), the step's loss and gradients
    through the plain cached lookup (every frontier row decoded) and
    through the planned miss-only lookup: (losses bitwise, the largest
    gradient difference over the largest gradient, leaf by leaf)."""
    import dataclasses
    import torch
    from repro_torch.graph.engine import batch_to
    from repro_torch.models import gnn
    from repro_torch.nn.module import leaves_with_path, value_and_grad
    batch = batch_to(batch, rt.device)
    out = []
    for fb in (dataclasses.replace(batch["frontier"], n_decode=None), batch["frontier"]):
        def loss_fn(p, fb=fb):
            h, _ = rt.model.apply_cached(p, fb, state["cache"])
            return gnn.node_loss(rt.model.logits(p, h), batch["labels"])
        out.append(value_and_grad(loss_fn, state["params"]))
    (la, ga), (lb, gb) = out
    ga, gb = dict(leaves_with_path(ga)), dict(leaves_with_path(gb))
    rel = max(float((ga[k] - gb[k]).abs().max() / ga[k].abs().max().clamp_min(1e-30))
              for k in ga)
    return torch.equal(la, lb), rel


def _param_gap(a, b) -> float:
    from repro_torch.nn.module import leaves_with_path
    a, b = dict(leaves_with_path(a)), dict(leaves_with_path(b))
    return max(float((a[k] - b[k]).abs().max()) for k in a)


class _ShuffledRows:
    """A batch source whose frontiers list the same rows in a seeded random
    order (index maps remapped, so the batch means the same): the control
    for what another row order alone does to training's rounding."""

    def __init__(self, source):
        self.source = source

    def next_batch(self):
        import numpy as np
        from repro_torch.graph.sampler import FrontierBatch
        step = self.source.step
        batch = dict(self.source.next_batch())
        fb = batch["frontier"]
        perm = np.random.default_rng(step).permutation(fb.unique.shape[0]).astype(np.int32)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(perm.shape[0], dtype=np.int32)
        batch["frontier"] = FrontierBatch(fb.unique[perm], tuple(inv[m] for m in fb.index_maps),
                                          fb.n_unique, valid=fb.valid_mask()[perm])
        return batch


def _permuted_control(graph, init, reference):
    """Loss gaps by step of an uncached run on shuffled frontiers against
    the uncached run's losses."""
    from repro_torch.graph.runtime import GraphRuntime
    rt = GraphRuntime.from_spec(_gnn_spec(prefetch_depth=0), graph=graph,
                                params=_snapshot(init))
    rt.data_iter = _ShuffledRows(rt.source)
    losses = rt.train(len(reference)).losses
    return [abs(a - b) for a, b in zip(losses, reference)]


def _cached_gnn_spec(**emb):
    import dataclasses
    spec = _gnn_spec(**{k: emb.pop(k) for k in ("ckpt_dir", "ckpt_every") if k in emb})
    return dataclasses.replace(spec, model=dataclasses.replace(
        spec.model, embedding=dataclasses.replace(spec.model.embedding,
                                                  cache_capacity=CACHED_CAP, **emb)))


def phase_gnn_cached(graph, uncached):
    """GraphSAGE trained with the hot-node cache (capacity 96,256, serving's
    rule of 4 frontiers) from the main run's init: (a) staleness 0 against
    the uncached run's first 20 losses; (b) staleness 4, plain and with the
    miss planner, 20 steps each, the shadow held against the card's
    bookkeeping after every step; (c) the planned run killed at 10 and
    resumed, against (b).  Returns the launch counts per run and the
    planned decode row counts."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.graph.runtime import GraphRuntime
    init = uncached["init"]
    counts = {}

    def run(name, steps=CACHED_STEPS, check_shadow=False, **emb):
        rt = GraphRuntime.from_spec(_cached_gnn_spec(**emb), graph=graph,
                                    params=_snapshot(init))
        step, per_step, early = rt.train_step, [], {}

        def recording(state, batch):
            fb = batch["frontier"]
            rec = dict(rows=fb.unique.shape[0] if fb.n_decode is None else fb.n_decode)
            if check_shadow:        # the step's inputs, compared after the run
                rec["inputs"] = ({"params": _snapshot(state["params"]),
                                  "cache": state["cache"]}, batch)
            state, m = step(state, batch)
            if len(per_step) + 1 == EARLY_STEPS:
                early.update(_snapshot(state["params"]))
            rec.update(hits=int(m["cache_hits"]), misses=int(m["cache_misses"]))
            if check_shadow:
                book = state["cache"].bookkeeping()
                shadow = rt.data_iter.state_dict()["miss_shadow"]
                rec["shadow"] = (all(np.array_equal(shadow[f], book[f])
                                     for f in ("node_ids", "version", "last_used"))
                                 and shadow["clock"] == book["clock"]
                                 and shadow["version_counter"] == book["version_counter"])
            per_step.append(rec)
            return state, m
        rt.train_step = recording
        zero_counts()                          # each cached run starts here
        res = rt.train(steps)
        counts[name] = read_counts(name)       # ... and ends here
        rt.close()
        return rt, res, per_step, early

    # (a) staleness 0: every entry is stale after the step's bump
    rt_a, res_a, steps_a, _ = run("gnn_train_cached_s0", cache_staleness=0)
    same = res_a.losses == uncached["losses"]
    print(f"[gnn_cached] (a) staleness 0, {CACHED_STEPS} steps: losses bitwise the uncached "
          f"run's {same}; hits {steps_a[-1]['hits']}, misses {steps_a[-1]['misses']}; "
          f"launches {counts['gnn_train_cached_s0']}", flush=True)
    check(same and steps_a[-1]["hits"] == 0, "staleness-0 cached training is not the uncached run")
    check(counts["gnn_train_cached_s0"]["hash_decode"] == CACHED_STEPS,
          "staleness 0 did not decode once a step")

    # (b) staleness 4, plain and planned
    rt_p, res_p, steps_p, early_p = run("gnn_train_cached_s4", cache_staleness=4)
    rt_q, res_q, steps_q, early_q = run("gnn_train_cached_s4_planned", cache_staleness=4,
                                        cache_plan_misses=True, check_shadow=True)
    for name, per in (("plain", steps_p), ("planned", steps_q)):
        print(f"[gnn_cached] (b) staleness 4 {name}: rows decoded a step "
              f"{[s['rows'] for s in per]}; cumulative hits {[s['hits'] for s in per]}, "
              f"misses {[s['misses'] for s in per]}", flush=True)
    check(steps_p[-1]["hits"] > 0 and steps_q[-1]["hits"] > 0, "staleness 4 never hit")
    check([(s["hits"], s["misses"]) for s in steps_p]
          == [(s["hits"], s["misses"]) for s in steps_q],
          "the planned run's hit and miss counters differ from the plain run's")
    check(all(s["shadow"] for s in steps_q), "the shadow left the card's cache bookkeeping")
    decoded = [s["rows"] for s in steps_q]
    check(counts["gnn_train_cached_s4_planned"]["hash_decode"] == sum(n > 0 for n in decoded),
          "the planned run did not decode exactly in the steps with misses")
    gaps = [abs(a - b) for a, b in zip(res_p.losses, res_q.losses)]
    early = _param_gap(early_p, early_q)
    control = _permuted_control(graph, init, uncached["losses"])
    print(f"[gnn_cached] (b) planned against plain: losses bitwise "
          f"{res_p.losses == res_q.losses}; loss gap by step {gaps}; param gap after step "
          f"{EARLY_STEPS} {early}, after step {CACHED_STEPS} "
          f"{_param_gap(rt_p.params, rt_q.params)}; control (no cache, each frontier's rows "
          f"shuffled) against the uncached run: loss gap by step {control}; the shadow equals "
          f"the card's bookkeeping after all {len(steps_q)} steps; launches plain "
          f"{counts['gnn_train_cached_s4']}, planned {counts['gnn_train_cached_s4_planned']}",
          flush=True)
    forced = [_plain_against_planned(rt_q, *s.pop("inputs")) for s in steps_q]
    worst_rel = max(rel for _, rel in forced)
    print(f"[gnn_cached] (b) from the planned run's own state at each step, the plain "
          f"lookup against the miss-only one: losses bitwise at {sum(eq for eq, _ in forced)} "
          f"of {len(forced)} steps; largest gradient difference over the largest gradient, "
          f"by step {[rel for _, rel in forced]}", flush=True)
    # the two runs sum the decoder's weight gradients over other row counts
    # and positions; where that rounds differently, Adam carries the
    # difference on (the control shows row order alone does the same), so
    # the step itself is held: the same loss bits from the same state, and
    # gradients within 1e-5 of the largest (a rounding bound)
    check(res_p.losses == res_q.losses
          or (all(eq for eq, _ in forced) and worst_rel <= 1e-5),
          f"the planned step differs from the plain one beyond rounding: {forced}")
    # ... and the trajectory over the first steps: within the port's loss
    # bound against JAX, and no further from the plain run than the
    # row-shuffled control is from the uncached run at the same step
    head = range(EARLY_STEPS)
    print(f"[gnn_cached] (b) first {EARLY_STEPS} steps: planned-plain loss gaps "
          f"{[gaps[i] for i in head]}, control gaps {[control[i] for i in head]}", flush=True)
    check(max(gaps[i] for i in head) <= 1e-5,
          f"planned against plain losses differ by over 1e-5 in the first {EARLY_STEPS} steps")
    check(all(gaps[i] <= control[i] for i in head),
          f"the planned run drifts from the plain one faster than the row-shuffled control "
          f"in the first {EARLY_STEPS} steps")

    # (c) planned, killed at 10 and resumed
    shutil.rmtree(CACHED_CKPT, ignore_errors=True)
    ck = dict(cache_staleness=4, cache_plan_misses=True, ckpt_dir=str(CACHED_CKPT),
              ckpt_every=CACHED_STEPS // 2)
    _, res_k, _, _ = run("gnn_train_cached_killed", CACHED_STEPS // 2, **ck)
    resumed = GraphRuntime.resume(str(CACHED_CKPT), graph=graph)
    zero_counts()                              # the resumed run starts here
    res_r = resumed.train(CACHED_STEPS)
    counts["gnn_train_cached_resumed"] = read_counts("gnn_train_cached_resumed")
    resumed.close()
    same_losses = res_k.losses + res_r.losses == res_q.losses
    same_params = _same_tree(resumed.params, rt_q.params)
    same_cache = all(torch.equal(getattr(resumed.state["cache"], f),
                                 getattr(rt_q.state["cache"], f)) for f in CACHE_FIELDS)
    a, b = (r.data_iter.state_dict()["miss_shadow"] for r in (resumed, rt_q))
    same_shadow = all(np.array_equal(a[k], b[k]) for k in a)
    print(f"[gnn_cached] (c) planned, killed at {CACHED_STEPS // 2} and resumed from step "
          f"{res_r.resumed_from}: losses bitwise {same_losses}, params {same_params}, "
          f"CacheState {same_cache}, shadow {same_shadow}", flush=True)
    check(res_r.resumed_from == CACHED_STEPS // 2 and same_losses and same_params
          and same_cache and same_shadow, "the resumed cached run differs from the straight one")
    shutil.rmtree(CACHED_CKPT, ignore_errors=True)

    # the step period with prefetch 2, planned (not recorded) against uncached
    rt_t = GraphRuntime.from_spec(_cached_gnn_spec(cache_staleness=4, cache_plan_misses=True),
                                  graph=graph, params=_snapshot(init))
    _, periods = _train_timed(rt_t, CACHED_STEPS)
    rt_t.close()
    print(f"[gnn_cached] step period (host clock, steps 2-{CACHED_STEPS}; median): planned "
          f"staleness 4 {float(np.median(periods[1:])):.3f} ms "
          f"{[round(t, 3) for t in periods[1:]]}; uncached {uncached['period_ms']:.3f} ms",
          flush=True)
    del rt_a, rt_p, rt_q, resumed, rt_t
    torch.cuda.empty_cache()
    return counts, sorted({n for n in decoded if n})


# ---------------------------------------------------------------------------
# slice 9: the full-graph models, link prediction and the merchant graph
# ---------------------------------------------------------------------------

FULL_MODELS = ("gcn", "sgc", "gin")
FULL_STEPS = 50                     # each full-graph model's run
FULL_CKPT = ROOT / "build" / "full_ckpt"
LINK_STEPS, LINK_PAIRS = 60, 512    # Table 1's link protocol (benchmarks/table1_gnn.py)
FREE_LRS = (1e-2, 1e-1)             # the eps = 1 reference's rates: ~lr·g a step
TABLE_LR = 1e-2                     # the Table 1 and Table 3 benchmarks' AdamW rate
MERCHANT = dict(n_consumers=6000, n_merchants=4000, n_categories=32)
MERCHANT_EPOCHS, MERCHANT_BATCH, MERCHANT_TEST = 4, 256, 800


def phase_fullgraph(graph):
    """The paper's GCN, SGC and GIN at full width trained on the serve
    graph through ``GraphRuntime.train`` (every step decodes all 169,343
    nodes in one ``hash_decode`` call and its backward in one backward
    call), then ``evaluate("val")`` and ``embed``; for GCN also two
    gradients of one step, a run killed at step 10 and resumed against a
    straight one, and ``embed`` against the evaluate forward's hidden.
    Returns the launch counts per model, the GCN's codes of all nodes and
    its runtime (for the sparse product's timing)."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.core.embedding import lookup_codes
    from repro_torch.graph.runtime import GraphRuntime
    from repro_torch.stages import StageTimer
    counts, gcn = {}, None
    for model in FULL_MODELS:
        t0 = time.perf_counter()
        rt = GraphRuntime.from_spec(_gnn_spec(model), graph=graph)
        torch.cuda.synchronize()
        check(rt.device.type == "cuda" and rt.fullgraph and rt.sampler is None,
              f"{model}: not a full-graph runtime on the card")
        print(f"[fullgraph] {model}: GraphRuntime.from_spec on {rt.device}: "
              f"{time.perf_counter() - t0:.2f} s; normalised adjacency {rt.full.adj.nnz} "
              f"nonzeros (self loops included) on the card; {len(rt.splits['train'])} "
              f"training nodes", flush=True)
        init = _snapshot(rt.params)
        if model == "gcn":
            check_gnn_grads_deterministic(rt, rt.data_iter.next_batch())
            rt.data_iter.load_state_dict({"step": 0})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()                          # the model's run starts here
        res, periods = _train_timed(rt, FULL_STEPS)
        torch.cuda.synchronize()
        trained = read_counts(f"fullgraph_{model}")
        peak = torch.cuda.max_memory_allocated()
        ev = rt.evaluate("val")
        ids = np.random.default_rng(3).choice(N_NODES, REQUEST, replace=False)
        emb = rt.embed(ids)
        counts[f"fullgraph_{model}"] = launches = read_counts(f"fullgraph_{model}")
        losses = res.losses
        check(trained == {"hash_decode": FULL_STEPS, "hash_decode_backward": FULL_STEPS,
                          "hash_decode_backward_by_kernel": dict.fromkeys(
                              ("count", "place", "sum"), FULL_STEPS),
                          "flash_attention": 0, "lsh_encode": 0},
              f"{model}: expected one forward and one backward hash_decode launch a step: "
              f"{trained}")
        check(launches["hash_decode"] == FULL_STEPS + 2
              and launches["hash_decode_backward"] == FULL_STEPS,
              f"{model}: evaluate and embed did not decode once each: {launches}")
        shown = {i + 1: losses[i] for i in sorted({*range(3), *range(9, FULL_STEPS, 10)})}
        print(f"[fullgraph] {model}: {FULL_STEPS} steps at lr {GNN_LR}: losses by step {shown}; "
              f"step period (host clock, synchronised, steps 2-{FULL_STEPS}; median) "
              f"{float(np.median(periods)):.3f} ms (min {min(periods):.3f}, max "
              f"{max(periods):.3f}); max_memory_allocated {peak} B; launches {launches}",
              flush=True)
        check(all(np.isfinite(losses)), f"{model}: non-finite loss {losses}")
        check(losses[-1] < losses[0], f"{model}: the last loss {losses[-1]} is not below the "
                                      f"first {losses[0]}")
        print(f"[fullgraph] {model}: evaluate('val'): accuracy {ev['accuracy']}, loss "
              f"{ev['loss']}, n {ev['n']} (chance {1 / N_CLASSES:.4f})", flush=True)
        check(ev["n"] == len(rt.splits["val"]) and np.isfinite(ev["loss"]),
              f"{model}: evaluate did not count every val node once with a finite loss")
        check(emb.shape == (REQUEST, rt.cfg.hidden) and np.isfinite(emb).all(),
              f"{model}: embed gave {emb.shape}")
        # where one step's time goes
        with StageTimer() as timer:
            t0 = time.perf_counter()
            rt.state, m = rt.train_step(rt.state, rt.data_iter.next_batch())
            float(m["loss"])
            step_ms = (time.perf_counter() - t0) * 1e3
        stages = {k: round(sum(v), 3) for k, v in timer.ms.items()}
        print(f"[breakdown] one {model} full-graph step under the stage timer: {step_ms:.3f} ms; "
              f"stages (ms) {stages} (spmm: {len(timer.ms.get('spmm', []))} forward sparse "
              f"products; their backward runs inside 'backward')", flush=True)
        if model != "gcn":
            rt.close()
            del rt
            torch.cuda.empty_cache()
            continue
        profile_step(rt.train_step, rt.state, rt.data_iter.next_batch())
        with torch.no_grad():
            hidden = rt.model.apply(rt.params, rt.full)
        same = np.array_equal(rt.embed(ids), hidden[torch.from_numpy(ids).cuda()].cpu().numpy())
        print(f"[fullgraph] gcn: embed(ids) bitwise the rows of the evaluate forward's hidden "
              f"{same}", flush=True)
        check(same, "embed differs from the full-graph forward's rows")
        full_codes = lookup_codes(rt.params["embed"], torch.arange(N_NODES, device=rt.device),
                                  rt.cfg.embedding_config()).cpu()
        # killed and resumed: B trains 10 steps, is dropped, resumes to 20
        shutil.rmtree(FULL_CKPT, ignore_errors=True)

        def run(d, steps):
            r = GraphRuntime.from_spec(_gnn_spec("gcn", ckpt_dir=str(FULL_CKPT / d),
                                                  ckpt_every=10), graph=graph,
                                       params=_snapshot(init))
            out = r.train(steps)
            r.close()
            return r, out

        straight, run_a = run("a", 20)
        _, run_b = run("b", 10)
        resumed = GraphRuntime.resume(str(FULL_CKPT / "b"), graph=graph)
        run_c = resumed.train(20)
        same_losses = run_b.losses + run_c.losses == run_a.losses
        same_params = _same_tree(resumed.params, straight.params)
        print(f"[fullgraph] gcn kill and resume: straight losses 11-20 {run_a.losses[10:]}; "
              f"resumed from step {run_c.resumed_from}: {run_c.losses}; losses bitwise "
              f"{same_losses}, final params bitwise {same_params}", flush=True)
        check(run_c.resumed_from == 10 and same_losses and same_params,
              "the resumed full-graph run differs from the straight one")
        shutil.rmtree(FULL_CKPT, ignore_errors=True)
        del straight, resumed, hidden
        gcn = rt
    torch.cuda.empty_cache()
    return counts, full_codes, gcn


def time_spmm(rt) -> dict:
    """The full-graph sparse product ``Â·X`` (``DeviceCSR.matmat``: a
    gather, a multiply and a segment sum) and its backward ``Âᵀ·G`` at
    widths 64 (d_e) and 128 (hidden) on the GCN's normalised adjacency,
    beside ``torch.sparse.mm`` with the same CSR arrays and the byte bound
    (values and column ids read once, X read once, the output written
    once)."""
    import numpy as np
    import torch
    from repro_torch.graph.csr import _rowwise
    adj = rt.full.adj
    host = rt.adj_norm
    order = np.lexsort((host.indices, host.row_ids()))   # cuSPARSE: columns sorted in a row
    lib = torch.sparse_csr_tensor(*(torch.from_numpy(a).cuda() for a in (
        host.indptr.astype(np.int64), host.indices[order].astype(np.int64), host.data[order])),
        size=host.shape, check_invariants=True)
    out = {}
    for width in (64, 128):
        rng = np.random.default_rng(width)
        X = torch.from_numpy(rng.standard_normal((N_NODES, width)).astype(np.float32)).cuda()
        fwd_ms, _ = time_ms(lambda: adj.matmat(X), 20)
        bwd_ms, _ = time_ms(lambda: _rowwise(*adj.t_arrays, X), 20)
        library_ms, _ = time_ms(lambda: torch.sparse.mm(lib, X), 20)
        lib_err = float((torch.sparse.mm(lib, X) - adj.matmat(X)).abs().max())
        nbytes = adj.nnz * 8 + 2 * N_NODES * width * 4
        flops = 2 * adj.nnz * width
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        moved = 5 * adj.nnz * width * 4 + adj.nnz * 12 + N_NODES * width * 4
        print(f"[spmm] width {width}, nnz {adj.nnz}: forward (gather, multiply, segment sum) "
              f"{fwd_ms:.4f} ms, backward over the transpose {bwd_ms:.4f} ms, torch.sparse.mm "
              f"(cuSPARSE) {library_ms:.4f} ms (max diff {lib_err}); bound {bound_ms:.4f} ms "
              f"by {bound_by} ({nbytes} B in {bytes_ms:.4f} ms, {flops} flops in "
              f"{ops_ms:.4f} ms); forward {fwd_ms / bound_ms:.1f}x its bound; the pipeline "
              f"moves about {moved} B (five passes over an (nnz, width) f32 array: the "
              f"gather read and written, the product read and written, the sum's read)",
              flush=True)
        out[width] = dict(ms=fwd_ms, backward_ms=bwd_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
        del X
    torch.cuda.empty_cache()
    return out


def phase_link(graph):
    """Table 1's link protocol (``benchmarks/table1_gnn.py``) at full width
    on the serve graph: ``holdout_edges(0, adj, 0.1)``, the paper's GCN with
    ``task="link"`` through ``GNNModel`` and a ``FullGraphBatch`` of the
    training adjacency, ``link_loss`` and AdamW, 60 steps of 512 positive
    and 512 uniform negative pairs, then hits@50 over the held-out edges;
    at the benchmark's lr 1e-2 and at gnn_train's 1e-3, from one init.
    Returns the path's launch counts."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core import embedding as emb_lib
    from repro_torch.device import make_generator
    from repro_torch.graph.engine import FullGraphBatch, GNNModel
    from repro_torch.graph.generate import holdout_edges
    from repro_torch.models import gnn
    from repro_torch.nn.module import value_and_grad
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
    adj, _ = graph
    train_adj, pos_eval = holdout_edges(0, adj, 0.1)
    cfg = dataclasses.replace(_spec("auto", N_NODES, N_CLASSES, model="gcn").model, task="link")
    model = GNNModel(cfg)
    full = FullGraphBatch(train_adj.with_self_loops().normalized("sym").on(model.device))
    rid, cid = train_adj.row_ids(), train_adj.indices
    chance = 50 / pos_eval.shape[0]     # hits@50 of a scorer that ignores the graph
    zero_counts()                              # the link path's run starts here
    for lr in (TABLE_LR, GNN_LR):
        gen = make_generator(0, model.device)
        params = model.init(gen, codes=emb_lib.make_codes(gen, cfg.embedding_config(),
                                                          aux=adj))
        check("w_out" not in params, "a link model has no classifier")
        rng = np.random.default_rng(0)
        opt, ocfg = adamw_init(params), AdamWConfig(lr=lr, weight_decay=0.0)
        losses, times = [], []
        for _ in range(LINK_STEPS):
            sel = rng.integers(0, rid.shape[0], LINK_PAIRS)
            pos = torch.from_numpy(np.stack([rid[sel], cid[sel]], 1)).cuda()
            neg = torch.from_numpy(rng.integers(0, N_NODES, (LINK_PAIRS, 2))).cuda()
            t0 = time.perf_counter()
            loss, grads = value_and_grad(
                lambda p: gnn.link_loss(model.apply(p, full), pos, neg), params)
            adamw_update(params, grads, opt, ocfg)
            losses.append(float(loss))
            times.append((time.perf_counter() - t0) * 1e3)
        with torch.no_grad():
            h = model.apply(params, full)
        neg_eval = rng.integers(0, N_NODES, pos_eval.shape)
        hits = gnn.hits_at_k(gnn.link_scores(h, pos_eval), gnn.link_scores(h, neg_eval), 50)
        print(f"[link] Table 1 protocol, GCN task='link', {train_adj.nnz} training nonzeros, "
              f"{pos_eval.shape[0]} held-out edges: {LINK_STEPS} steps of "
              f"{LINK_PAIRS}+{LINK_PAIRS} pairs at lr {lr}: losses by step "
              f"{ {i + 1: round(losses[i], 4) for i in sorted({0, 1, 2, *range(9, LINK_STEPS, 10)})} }; "
              f"step "
              f"(host clock, synchronised, median of 2-{LINK_STEPS}) "
              f"{float(np.median(times[1:])):.3f} ms; hits@50 {hits} (a scorer blind to the "
              f"graph: {chance:.5f})", flush=True)
        check(all(np.isfinite(losses)) and np.isfinite(h.cpu().numpy()).all(),
              f"non-finite link loss or hidden at lr {lr}")
        check(losses[-1] < losses[0], f"the link loss did not fall at lr {lr}: "
                                      f"{losses[0]} -> {losses[-1]}")
        del h, params, opt
    launches = read_counts("link")             # ... and ends here
    print(f"[link] launches {launches}", flush=True)
    check(launches["hash_decode"] == 2 * (LINK_STEPS + 1)
          and launches["hash_decode_backward"] == 2 * LINK_STEPS,
          f"the link path did not decode all nodes once a step: {launches}")
    del full
    torch.cuda.empty_cache()
    return launches


def phase_merchant():
    """Table 3's protocol (``benchmarks/table3_merchant.py``): the consumer
    × merchant graph ``bipartite_transaction_graph(0, 6000, 4000, 32)``,
    ``merchant_config`` at its §5.3.2 widths (c=256, m=16, d_c=d_m=512),
    the naive ``sage_forward`` on ``NeighborSampler.minibatches`` levels, 4
    epochs, random and hash codes; accuracy, hit@5 and hit@10
    on 800 test merchants; at the benchmark's lr 1e-2 and at gnn_train's
    1e-3.  Returns the path's launch counts and the row counts it decoded
    (each level of each training and test batch)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs.paper_gnn import merchant_config
    from repro_torch.core import embedding as emb_lib
    from repro_torch.device import make_generator
    from repro_torch.graph.engine import GNNModel
    from repro_torch.graph.generate import bipartite_transaction_graph, train_val_test_split
    from repro_torch.graph.sampler import NeighborSampler
    from repro_torch.models import gnn
    from repro_torch.nn.module import value_and_grad
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
    t0 = time.perf_counter()
    adj, labels, n_cons = bipartite_transaction_graph(
        0, MERCHANT["n_consumers"], MERCHANT["n_merchants"], MERCHANT["n_categories"])
    n_nodes = n_cons + MERCHANT["n_merchants"]
    merchants = np.arange(MERCHANT["n_merchants"]) + n_cons
    tr_i, _, te_i = train_val_test_split(0, MERCHANT["n_merchants"])
    print(f"[merchant] bipartite_transaction_graph(0, 6000, 4000, 32): {adj.nnz} nonzeros, "
          f"{time.perf_counter() - t0:.2f} s; {len(tr_i)} training and {len(te_i)} test "
          f"merchants", flush=True)
    results, steps, sizes = {}, 0, set()
    zero_counts()                              # the merchant path's run starts here
    for lr, kind in ((lr, kind) for lr in (TABLE_LR, GNN_LR)
                     for kind in ("random_full", "hash_full")):
        cfg = merchant_config(n_nodes, MERCHANT["n_categories"], kind)
        cfg = dataclasses.replace(cfg, embedding=dataclasses.replace(cfg.embedding,
                                                                     lookup_impl="auto"))
        model = GNNModel(cfg)
        gen = make_generator(0, model.device)
        params = model.init(gen, codes=emb_lib.make_codes(gen, cfg.embedding_config(),
                                                          aux=adj))
        sampler = NeighborSampler(adj, cfg.fanouts, max_deg=64, seed=0)
        opt, ocfg = adamw_init(params), AdamWConfig(lr=lr, weight_decay=0.0)
        losses, times = [], []
        for _ in range(MERCHANT_EPOCHS):
            for levels, batch in sampler.minibatches(merchants[tr_i], MERCHANT_BATCH):
                sizes.update(int(np.size(level)) for level in levels)
                y = torch.from_numpy(labels[batch - n_cons].astype(np.int64)).cuda()
                t1 = time.perf_counter()
                loss, grads = value_and_grad(
                    lambda p: gnn.node_loss(model.logits(p, model.apply(p, levels)), y), params)
                adamw_update(params, grads, opt, ocfg)
                losses.append(float(loss))
                times.append((time.perf_counter() - t1) * 1e3)
        steps += len(losses)
        levels, batch = next(sampler.minibatches(merchants[te_i], MERCHANT_TEST, shuffle=False))
        sizes.update(int(np.size(level)) for level in levels)
        with torch.no_grad():
            logits = model.logits(params, model.apply(params, levels))
        y = labels[batch - n_cons]
        res = dict(acc=gnn.accuracy(logits, y), hit5=gnn.hit_rate_at_k(logits, y, 5),
                   hit10=gnn.hit_rate_at_k(logits, y, 10))
        results[lr, kind] = res
        print(f"[merchant] {kind} at lr {lr}: {len(losses)} steps of {MERCHANT_BATCH} merchants "
              f"({MERCHANT_BATCH * (1 + 5 + 25)} decoded rows in 3 calls a step): losses "
              f"{[round(x, 4) for x in losses[:2]]} ... {[round(x, 4) for x in losses[-2:]]}; "
              f"step (host clock, median) {float(np.median(times[1:])):.3f} ms; acc "
              f"{res['acc']}, hit@5 {res['hit5']}, hit@10 {res['hit10']} (chance "
              f"{1 / MERCHANT['n_categories']:.4f})", flush=True)
        check(all(np.isfinite(losses)) and np.isfinite(logits.cpu().numpy()).all(),
              f"merchant {kind}: non-finite loss or logits")
        check(res["acc"] <= res["hit5"] <= res["hit10"], f"merchant {kind}: hit@k not monotone")
        del params, opt, model
    launches = read_counts("merchant")         # ... and ends here
    held = {lr: all(results[lr, "hash_full"][k] > results[lr, "random_full"][k]
                    for k in ("acc", "hit5", "hit10")) for lr in (TABLE_LR, GNN_LR)}
    print(f"[merchant] launches {launches}; Table 3's direction (Hash above Rand on every "
          f"metric) held at this cut, by lr: {held}", flush=True)
    check(launches["hash_decode"] == 3 * (steps + 4)
          and launches["hash_decode_backward"] == 3 * steps,
          f"the merchant path did not decode each level once a step: {launches}")
    torch.cuda.empty_cache()
    return launches, sorted(sizes)


def phase_fullgraph_reference():
    """GCN, SGC and GIN on a 3,000-node graph from one init on the card
    (kernels) and on the CPU (plain versions), at two Adam settings: 5
    steps left to run free, then 5 more, each from the card's state copied
    to the CPU.  At gnn_train's eps of 1e-8 (lr 1e-3) every step from one
    state within 1e-4 in loss; free-running, Adam's update g / (|g| + 1e-8)
    turns a rounding-level difference of a gradient entry near 1e-8 into
    one of O(lr), and the next forward carries it on, so those gaps are
    printed.  At eps 1 (an update of about lr·g, nothing amplified; lr
    1e-2 and 0.1, where the params move more) the 5 free steps within 1e-4
    in loss and params.  Each param gap names its leaf."""
    import dataclasses
    from repro_torch.graph.runtime import GraphRuntime
    from repro_torch.nn.module import leaves_with_path

    def param_gap(card, cpu):
        want = dict(leaves_with_path(card.params))
        return max((float((t - want[k].cpu()).abs().max()), "/".join(k))
                   for k, t in leaves_with_path(cpu.params))

    def trajectories(spec):
        card = GraphRuntime.from_spec(spec)
        cpu = GraphRuntime.from_spec(spec, graph=(card.adj, card.labels), device="cpu",
                                     params=_snapshot(card.params, "cpu"))
        init = dict(leaves_with_path(_snapshot(card.params)))
        a, b = card.train(5).losses, cpu.train(5).losses
        free = dict(losses=(a[0], a[-1]), loss_gaps=[abs(x - y) for x, y in zip(a, b)],
                    param_gap=param_gap(card, cpu),
                    moved=max(float((t - init[k]).abs().max())
                              for k, t in leaves_with_path(card.params)))
        gaps, pgaps = [], []
        for _ in range(5):
            cpu.state = _snapshot(card.state, "cpu")
            gaps.append(abs(card.train(1).losses[0] - cpu.train(1).losses[0]))
            pgaps.append(param_gap(card, cpu))
        card.close()
        cpu.close()
        return free, dict(loss_gaps=gaps, param_gaps=pgaps)

    for model in FULL_MODELS:
        spec = _gnn_spec(model, n_nodes=3000, n_classes=8)
        runs = {(1e-8, GNN_LR): trajectories(spec)}
        for lr in FREE_LRS:
            runs[1.0, lr] = trajectories(dataclasses.replace(spec, optimizer=dataclasses.replace(
                spec.optimizer, lr=lr, eps=1.0)))
        for (eps, lr), (free, stepped) in runs.items():
            print(f"[reference] 3,000-node {model}, card vs CPU plain path, Adam eps {eps}, lr "
                  f"{lr}: 5 free steps {free}; 5 steps each from the card's state {stepped}",
                  flush=True)
            check(max(stepped["loss_gaps"]) <= 1e-4,
                  f"{model}: a step on the card and on the CPU disagree: {stepped}")
            check(eps < 1.0 or max(free["loss_gaps"]) <= 1e-4 and free["param_gap"][0] <= 1e-4,
                  f"{model}: 5 free steps at Adam eps 1, lr {lr}, on the card and on the CPU "
                  f"part: {free}")


# ---------------------------------------------------------------------------
# slice 10: the hashemb and TT compression families, and int8 storage
# ---------------------------------------------------------------------------

FAMILY_PATHS = {"families_hashemb": dict(lookup_impl="hashemb"),
                "families_tt": dict(lookup_impl="tt", tt_rank=8),
                "families_int8": dict(lookup_impl="pallas", quantize="int8")}
FAMILY_CKPT = ROOT / "build" / "family_ckpt"
FAMILY_REQUESTS = 8


def _family_spec(path: str, n_nodes=None, n_classes: int = N_CLASSES, **overrides):
    """gnn_train's spec (lr 1e-3, batch 256, prefetch 2) with the path's
    one-field family or precision change; ``n_nodes`` None: the serve graph's."""
    return _gnn_spec(n_nodes=n_nodes or N_NODES, n_classes=n_classes).with_updates(
        **FAMILY_PATHS[path], **overrides)


def _table_bytes(rt) -> dict:
    """The decode stage's table in the params (f32 masters), what the decode
    reads of it (int8 values and scales under int8), and the codes: 4 uint32
    words a node (the port holds each word in an int64)."""
    from repro_torch.nn.module import leaves_with_path
    dec = rt.params["embed"]["decoder"]
    table = sum(t.numel() * t.element_size() for path, t in leaves_with_path(dec)
                if path[0] != "mlp")
    emb = rt.spec.model.embedding
    read = (emb.m * emb.c * emb.d_c + emb.m * emb.c * 4 if emb.quantize == "int8" else table)
    codes = rt.codes
    words = 0 if codes is None else codes.numel() * 4
    return dict(table=table, decode_reads=read, codes_uint32=words,
                codes_held=0 if codes is None else codes.numel() * codes.element_size())


def _serve_timed(engine, requests) -> tuple:
    """Each request through ``engine.serve``, host clock to the results'
    return (they are host arrays, so the card has finished)."""
    import torch
    outs, ms = [], []
    for ids in requests:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(engine.serve(ids))
        ms.append((time.perf_counter() - t0) * 1e3)
    return outs, ms


def _family_path(graph, path: str) -> dict:
    """One family path at full width: 300 steps of ``GraphRuntime.train``,
    ``evaluate("val")``, ``rt.serve()`` against ``serve(cache_capacity=0)``
    bitwise, two gradients of one step, and (hashemb, tt) a run killed at
    step 10 and resumed against a straight one."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.graph.runtime import GraphRuntime
    from repro_torch.kernels.hash_decode import ops as hd_ops
    t0 = time.perf_counter()
    rt = GraphRuntime.from_spec(_family_spec(path), graph=graph)
    torch.cuda.synchronize()
    emb = rt.spec.model.embedding
    sizes = _table_bytes(rt)
    print(f"[{path}] GraphRuntime.from_spec on {rt.device} with lookup_impl={emb.lookup_impl!r}, "
          f"quantize={emb.quantize!r}, tt_rank={emb.tt_rank}: "
          f"{time.perf_counter() - t0:.2f} s; decoder leaves "
          f"{sorted(k for k in rt.params['embed']['decoder'] if k != 'mlp')}; decode-stage "
          f"table {sizes['table']} B of params ({sizes['decode_reads']} B read a decode), codes "
          f"{sizes['codes_uint32']} B as uint32 ({sizes['codes_held']} B held as int64); "
          f"backend {rt.model.backend.name}"
          f"{'/' + rt.model.backend.base.name if hasattr(rt.model.backend, 'base') else ''}",
          flush=True)
    check(rt.device.type == "cuda", f"{path}: the runtime is not on the card")
    check((rt.codes is None) == (path == "families_hashemb"),
          f"{path}: codes {'missing' if rt.codes is None else 'present'}")
    init = _snapshot(rt.params)
    start = rt.data_iter.state_dict()
    check_gnn_grads_deterministic(rt, rt.data_iter.next_batch(), label=path)
    rt.data_iter.load_state_dict(start)
    step, frontiers = rt.train_step, []

    def recording_step(state, batch):
        frontiers.append(int(batch["frontier"].unique.shape[0]))
        return step(state, batch)
    rt.train_step = recording_step
    # every row count the path decodes (training, evaluate, serve), held
    # bitwise by ``phase_families`` afterwards
    decoded, forward = set(), hd_ops._forward

    def recording_forward(codes, *args, **kw):
        decoded.add(int(codes.shape[0]))
        return forward(codes, *args, **kw)
    hd_ops._forward = recording_forward
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()                              # the path's training run starts here
    res, periods = _train_timed(rt, GNN_STEPS)
    torch.cuda.synchronize()
    train_launches = read_counts(path)         # ... and ends here
    rt.train_step = step
    peak = torch.cuda.max_memory_allocated()
    losses = res.losses
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    med20, med_run = float(np.median(periods[1:GNN_TIMED])), float(np.median(periods[1:]))
    shown = {i + 1: losses[i] for i in sorted({*range(5), *range(49, GNN_STEPS, 50),
                                               *range(GNN_STEPS - 3, GNN_STEPS)})}
    print(f"[{path}] {GNN_STEPS} steps, prefetch_depth 2, lr {GNN_LR}: losses by step {shown}; "
          f"mean of the first 5 {first}, of the last 5 {last} (uniform predictor "
          f"{math.log(N_CLASSES)}); step period median {med20:.3f} ms (steps 2-{GNN_TIMED}), "
          f"{med_run:.3f} ms (steps 2-{GNN_STEPS}); frontier rows a step "
          f"{min(frontiers)}-{max(frontiers)}; training launches {train_launches}; "
          f"max_memory_allocated {peak} B", flush=True)
    check(all(np.isfinite(losses)), f"{path}: non-finite loss {losses}")
    check(len(frontiers) == GNN_STEPS, f"{path}: {len(frontiers)} frontiers for {GNN_STEPS} steps")
    n = 0 if path == "families_tt" else GNN_STEPS
    check(train_launches["hash_decode"] == n and train_launches["hash_decode_backward"] == n,
          f"{path}: expected {n} forward and {n} backward hash_decode launches: {train_launches}")

    zero_counts()                              # evaluate and serve through the front door
    ev = rt.evaluate("val")
    rng = np.random.default_rng(20)
    requests = [rng.choice(N_NODES, REQUEST, replace=False) for _ in range(FAMILY_REQUESTS)]
    engine = rt.serve()
    cached, cached_ms = _serve_timed(engine, requests)
    uncached, uncached_ms = _serve_timed(rt.serve(cache_capacity=0), requests)
    torch.cuda.synchronize()
    serve_launches = read_counts(path + "_serve")
    hd_ops._forward = forward
    bitwise = all(np.array_equal(a.embeddings, b.embeddings) and np.array_equal(a.logits, b.logits)
                  for a, b in zip(cached, uncached))
    print(f"[{path}] evaluate('val'): accuracy {ev['accuracy']}, loss {ev['loss']}, n {ev['n']} "
          f"(chance {1 / N_CLASSES}); serve: {FAMILY_REQUESTS} requests of {REQUEST}, cached "
          f"(rt.serve()) ms {[round(t, 3) for t in cached_ms]}, uncached ms "
          f"{[round(t, 3) for t in uncached_ms]}, median of requests 3-{FAMILY_REQUESTS} cached "
          f"{np.median(cached_ms[2:]):.3f} / uncached {np.median(uncached_ms[2:]):.3f} ms; rows "
          f"decoded {[r.rows_decoded for r in cached]} of {cached[0].rows_total}; cached and "
          f"uncached outputs bitwise {bitwise}; launches of evaluate and serve {serve_launches}",
          flush=True)
    check(ev["n"] == len(rt.splits["val"]) and np.isfinite(ev["loss"]),
          f"{path}: evaluate did not count every val node once, or its loss is not finite")
    check(all(np.isfinite(r.embeddings).all() and r.embeddings.shape == (REQUEST, 128)
              for r in cached), f"{path}: served embeddings not finite or of the wrong shape")
    check(bitwise, f"{path}: cached and uncached serving differ")
    check((serve_launches["hash_decode"] == 0) == (path == "families_tt")
          and serve_launches["hash_decode_backward"] == 0,
          f"{path}: evaluate and serve launched {serve_launches}")
    out = dict(train=train_launches, serve=serve_launches, frontiers=sorted(set(frontiers)),
               decoded=sorted(decoded),
               period_ms=med20, period_run_ms=med_run, accuracy=ev["accuracy"], peak=peak,
               serve_ms=float(np.median(cached_ms[2:])),
               serve_uncached_ms=float(np.median(uncached_ms[2:])), sizes=sizes,
               losses=(losses[0], last))

    if path != "families_int8":            # killed and resumed, bit for bit
        shutil.rmtree(FAMILY_CKPT, ignore_errors=True)
        straight = GraphRuntime.from_spec(
            _family_spec(path, ckpt_dir=str(FAMILY_CKPT / "a"), ckpt_every=10), graph=graph,
            params=_snapshot(init))
        run_a = straight.train(20)
        straight.close()
        killed = GraphRuntime.from_spec(
            _family_spec(path, ckpt_dir=str(FAMILY_CKPT / "b"), ckpt_every=10), graph=graph,
            params=_snapshot(init))
        run_b = killed.train(10)
        killed.close()
        del killed
        resumed = GraphRuntime.resume(str(FAMILY_CKPT / "b"), graph=graph)
        run_c = resumed.train(20)
        resumed.close()
        same_losses = run_b.losses + run_c.losses == run_a.losses
        same_params = _same_tree(resumed.params, straight.params)
        print(f"[{path}] kill and resume: resumed from step {run_c.resumed_from} with the "
              f"spec's family {resumed.spec.model.embedding.lookup_impl!r}; losses 11-20 "
              f"bitwise {same_losses}, final params bitwise {same_params}", flush=True)
        check(run_c.resumed_from == 10 and same_losses and same_params
              and resumed.spec.model.embedding == rt.spec.model.embedding,
              f"{path}: the resumed run differs from the straight one")
        shutil.rmtree(FAMILY_CKPT, ignore_errors=True)
        del straight, resumed
    if path == "families_tt":
        out["cores"] = tuple(rt.params["embed"]["decoder"][k].detach().clone()
                             for k in ("tt_g0", "tt_g1"))
    rt.close()
    del rt, engine
    torch.cuda.empty_cache()
    return out


def time_tt(cores, rows: int) -> dict:
    """TT's decode (two row gathers and one f32 batched product) and its
    backward at ``rows`` rows with the path's trained cores and uniform
    codes, each with its bound (bytes: codes and the cores read, the output
    or the gradients written; operations: the product's f32 multiply-adds);
    two backward passes bitwise."""
    import numpy as np
    import torch
    from repro_torch.core.backend import get_backend
    g0, g1 = (t.requires_grad_(True) for t in cores)
    m, c1, d1, r = g0.shape
    _, c2, _, d2 = g1.shape
    rng = np.random.default_rng(12)
    codes = torch.from_numpy(rng.integers(0, c1 * c2, (rows, m)).astype(np.int32)).cuda()
    g = torch.from_numpy(rng.standard_normal((rows, d1 * d2)).astype(np.float32)).cuda()
    be = get_backend("tt", device=codes.device)
    out = be.decode(codes, (g0, g1))
    fwd_ms, _ = time_ms(lambda: be.decode(codes, (g0, g1)), 20)
    bwd_ms, _ = time_ms(lambda: torch.autograd.grad(out, (g0, g1), g, retain_graph=True), 20)
    a, b = torch.autograd.grad(out, (g0, g1), g, retain_graph=True)
    a2, b2 = torch.autograd.grad(out, (g0, g1), g, retain_graph=True)
    deterministic = torch.equal(a, a2) and torch.equal(b, b2)
    core_bytes = (g0.numel() + g1.numel()) * 4
    flops = 2 * rows * m * d1 * r * d2
    fwd_bytes = rows * m * 4 + core_bytes + rows * d1 * d2 * 4
    bwd_bytes = rows * m * 4 + rows * d1 * d2 * 4 + 2 * core_bytes
    fwd_bound = max(fwd_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3
    bwd_bound = max(bwd_bytes / HBM_BYTES_PER_S, 2 * flops / F32_FLOPS) * 1e3
    inter = rows * m * (d1 * r + r * d2) * 4
    print(f"[time] tt decode B={rows} m={m} c1={c1} c2={c2} d1={d1} d2={d2} r={r} f32: forward "
          f"{fwd_ms:.4f} ms (bound {fwd_bound:.4f} ms: {fwd_bytes} B, {flops} flops), backward "
          f"{bwd_ms:.4f} ms (bound {bwd_bound:.4f} ms: {bwd_bytes} B, {2 * flops} flops), two "
          f"backward passes bitwise {deterministic}; the two row gathers write {inter} B",
          flush=True)
    check(deterministic, "tt: two backward passes of one decode differ")
    del out, a, b, a2, b2, codes, g
    torch.cuda.empty_cache()
    return dict(rows=rows, ms=fwd_ms, bound_ms=fwd_bound, backward_ms=bwd_ms,
                backward_bound_ms=bwd_bound)


def time_quantize(m: int = 16, c: int = 256, d_c: int = 512) -> float:
    """The int8 quantize pass a training step makes of the f32 masters."""
    import torch
    from repro_torch.kernels.hash_decode import ops
    _, cb, _, _ = _operands(1, m, c, d_c, "float32", seed=13)
    ms, _ = time_ms(lambda: ops.quantize_codebooks(cb), 20)
    print(f"[time] quantize_codebooks of the ({m}, {c}, {d_c}) f32 masters: {ms:.4f} ms",
          flush=True)
    del cb
    torch.cuda.empty_cache()
    return ms


def phase_families(graph) -> tuple:
    """The three family paths; then the kernels held bitwise at every row
    count the hashemb path (f32, its folded pools) and the int8 path (int8
    storage) decoded: training frontiers, evaluate's and serve's decodes,
    the forward in both variants and the backward; TT's decode timed at its
    largest training frontier beside the kernels at the same rows, and the
    int8 kernel at the int8 path's.  Returns the launches by path, the
    decode sizes by path, the forward's largest error there and the times."""
    runs = {path: _family_path(graph, path) for path in FAMILY_PATHS}
    sizes = {"hashemb": runs["families_hashemb"]["decoded"],
             "int8": runs["families_int8"]["decoded"]}
    for fam, decoded in sizes.items():
        check(set(runs[f"families_{fam}"]["frontiers"]) <= set(decoded),
              f"the {fam} path's training frontiers are missing from its decode sizes")
    check(not runs["families_tt"]["decoded"], "the tt path decoded through hash_decode")
    err = max(check_gnn_frontiers(sizes["hashemb"], "decode sizes of the hashemb path"),
              check_gnn_frontiers(sizes["int8"], "decode sizes of the int8 path",
                                  variant="int8"))
    tt_rows = max(runs["families_tt"]["frontiers"])
    int8_rows = max(runs["families_int8"]["frontiers"])
    f32 = {rows: time_at_shape(rows, 16, 256, 512) for rows in {tt_rows, int8_rows}}
    times = dict(tt=dict(**time_tt(runs["families_tt"].pop("cores"), tt_rows),
                         kernel_ms=f32[tt_rows]["ms"],
                         kernel_backward_ms=time_hd_backward(tt_rows)["ms"]),
                 int8=dict(rows=int8_rows, **time_at_shape(int8_rows, 16, 256, 512, "int8"),
                           f32_ms=f32[int8_rows]["ms"], quantize_ms=time_quantize()))
    print(f"[time] int8 kernel at B={int8_rows}: {times['int8']['ms']:.4f} ms against the f32 "
          f"kernel's {times['int8']['f32_ms']:.4f} (int8/f32 "
          f"{times['int8']['ms'] / times['int8']['f32_ms']:.2f}); tt at B={tt_rows}: forward "
          f"{times['tt']['ms']:.4f} / backward {times['tt']['backward_ms']:.4f} ms against the "
          f"kernels' {times['tt']['kernel_ms']:.4f} / {times['tt']['kernel_backward_ms']:.4f}",
          flush=True)
    launches = {}
    for path, run in runs.items():
        launches[path] = {k: (run["train"][k] + run["serve"][k] if isinstance(run["train"][k], int)
                              else {kk: run["train"][k][kk] + run["serve"][k][kk]
                                    for kk in run["train"][k]})
                          for k in run["train"]}
        print(f"[families] {path}: period {run['period_ms']:.3f} ms (run median "
              f"{run['period_run_ms']:.3f}), val accuracy {run['accuracy']}, serve "
              f"{run['serve_ms']:.3f} ms cached / {run['serve_uncached_ms']:.3f} uncached, peak "
              f"{run['peak']} B, table {run['sizes']}, launches {launches[path]}", flush=True)
    return launches, sizes, err, times


def phase_families_reference():
    """hashemb, tt and int8 (full and light) on a 3,000-node graph from one
    init on the card (kernels) and on the CPU (plain versions): 5 steps
    each from the card's state copied to the CPU, loss within 1e-5; and 5
    free steps at Adam eps 1, lr 1e-2 (an update of about lr·g, nothing
    amplified), losses and params within 1e-4.  Each param gap names its
    leaf."""
    import dataclasses
    from repro_torch.graph.runtime import GraphRuntime
    from repro_torch.nn.module import leaves_with_path

    def param_gap(card, cpu):
        want = dict(leaves_with_path(card.params))
        return max((float((t - want[k].cpu()).abs().max()), "/".join(k))
                   for k, t in leaves_with_path(cpu.params))

    def pair(spec):
        card = GraphRuntime.from_spec(spec)
        cpu = GraphRuntime.from_spec(spec, graph=(card.adj, card.labels), device="cpu",
                                     params=_snapshot(card.params, "cpu"))
        return card, cpu

    cases = [(path, {}) for path in FAMILY_PATHS] + [("families_int8", {"kind": "hash_light"})]
    for path, extra in cases:
        spec = _family_spec(path, n_nodes=3000, n_classes=8, prefetch_depth=0, **extra)
        card, cpu = pair(spec)
        gaps = []
        for _ in range(5):
            cpu.state = _snapshot(card.state, "cpu")
            gaps.append(abs(card.train(1).losses[0] - cpu.train(1).losses[0]))
        card.close()
        cpu.close()
        card, cpu = pair(dataclasses.replace(spec, optimizer=dataclasses.replace(
            spec.optimizer, lr=1e-2, eps=1.0)))
        a, b = card.train(5).losses, cpu.train(5).losses
        free = [abs(x - y) for x, y in zip(a, b)]
        pgap = param_gap(card, cpu)
        card.close()
        cpu.close()
        label = f"{path}{' light' if extra else ''}"
        print(f"[reference] 3,000-node {label}, card vs CPU plain path: each step from the card's "
              f"state, loss gaps {gaps}; 5 free steps at Adam eps 1, lr 1e-2: losses {a[0]} -> "
              f"{a[-1]}, loss gaps {free}, largest param gap {pgap}", flush=True)
        check(max(gaps) <= 1e-5, f"{label}: a step on the card and on the CPU disagree: {gaps}")
        check(max(free) <= 1e-4 and pgap[0] <= 1e-4,
              f"{label}: 5 free steps at Adam eps 1 on the card and on the CPU part: {free}, {pgap}")


# ---------------------------------------------------------------------------
# slice 11: the packed codes kept on the host
# ---------------------------------------------------------------------------

HOST_STEPS, HOST_STEPS0 = 50, 20    # the paired training runs at prefetch 2 and 0
HOST_CKPT = ROOT / "build" / "codes_host_ckpt"
SWEEP_NODES = 8 * N_NODES           # the sweep's larger graph, 1,354,744 nodes
SWEEP_CAP = 61_696                  # its fixed frontier: serve's cap
SWEEP_STEPS = 11                    # cut from 22 for the script's time


def _resident_code_bytes(rt) -> int:
    """Bytes of packed codes the params hold on the card (8 a word)."""
    buf = rt.params["embed"].get("codes_buf")
    return 0 if buf is None else buf.numel() * buf.element_size()


def _placed(spec, graph, init, codes, placement: str):
    """A runtime at ``placement`` from the params ``init`` (on the host, with
    their ``codes_buf``): device placement keeps it; host placement drops
    it and takes the packed uint32 ``codes`` as its buffer."""
    from repro_torch.graph.runtime import GraphRuntime
    params = _snapshot(init, "cuda")
    if placement == "device":
        return GraphRuntime.from_spec(spec, graph=graph, params=params)
    del params["embed"]["codes_buf"]
    rt = GraphRuntime.from_spec(spec.with_updates(codes_placement="host"), graph=graph,
                                params=params, codes=codes)
    check(rt.codes_on_host and _resident_code_bytes(rt) == 0,
          "host placement left codes in the params")
    return rt


def _card_baseline() -> int:
    """What the card holds before a runtime is built (after a collection),
    so a run's peak is read above it, whatever earlier phases left."""
    import gc
    import torch
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def _placement_run(rt, steps: int, path: str = "", baseline: int = 0) -> dict:
    """``steps`` of ``rt.train`` timed at every step, with the card's peak
    memory over the run above ``baseline`` (``_card_baseline`` before the
    runtime was built: its params, the codes included, count) and, with
    ``path``, the launch counts zeroed just before and read just after."""
    import numpy as np
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    if path:
        zero_counts()
    res, periods = _train_timed(rt, steps)
    torch.cuda.synchronize()
    out = dict(losses=res.losses, periods=periods,
               peak=torch.cuda.max_memory_allocated() - baseline,
               median_ms=float(np.median(periods[1:GNN_TIMED])),
               resident=_resident_code_bytes(rt), params=_snapshot(rt.params, "cpu"))
    if path:
        out["launches"] = read_counts(path)
    if hasattr(rt.data_iter, "stats"):
        st = rt.data_iter.stats()
        n = max(st["n_produced"], 1)
        out["producer"] = {k: round(st[k] / n, 1) for k in ("sample_us", "code_gather_us",
                                                              "put_us")}
        out["bytes_per_batch"] = st["transferred_code_bytes_per_batch"]
        out["uint32_bytes_per_batch"] = st["uint32_code_bytes_per_batch"]
    return out


def _same_run(a: dict, b: dict, label: str) -> None:
    """Two runs' losses and final params, bitwise (the device run's
    ``codes_buf`` aside)."""
    pa, pb = ({**r["params"], "embed": {"decoder": r["params"]["embed"]["decoder"]}}
              for r in (a, b))
    losses, params = a["losses"] == b["losses"], _same_tree(pa, pb)
    print(f"[codes_host] {label}: host against device placement, {len(a['losses'])} losses "
          f"bitwise {losses}, final params bitwise {params}", flush=True)
    check(losses and params, f"codes_host {label}: host placement differs from device "
                             f"placement")


def _serve_routes(rt, requests, path: str = "") -> dict:
    """``rt.serve()`` (cached), ``serve(cache_capacity=0)`` and the batching
    tier (the requests submitted at once and taken as one microbatch), with
    the medians of requests 3-8 and, with ``path``, the launches."""
    import numpy as np
    import torch
    from repro_torch.serving import BatchingSpec
    if path:
        zero_counts()
    cached, cached_ms = _serve_timed(rt.serve(), requests)
    uncached, uncached_ms = _serve_timed(rt.serve(cache_capacity=0), requests)
    with rt.serve(batching=BatchingSpec(max_batch=len(requests), max_delay_ms=50.0)) as tier:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batched = [f.result() for f in [tier.submit(r) for r in requests]]
        batched_ms = (time.perf_counter() - t0) * 1e3
    check(all(r.batch_requests == len(requests) for r in batched),
          "codes_host: the batching tier did not take the requests as one microbatch")
    out = dict(cached=cached, uncached=uncached, batched=batched,
               cached_ms=float(np.median(cached_ms[2:])),
               uncached_ms=float(np.median(uncached_ms[2:])), batched_ms=batched_ms)
    if path:
        out["launches"] = read_counts(path)
    return out


def _copies(graph, k: int):
    """``k`` disjoint copies of ``(adj, labels)`` as one graph: the degree
    distribution of the original at k times its nodes (the power-law
    generator's own 1,354,744-node graph takes minutes on the host)."""
    import numpy as np
    from repro_torch.graph.csr import CSRMatrix
    adj, labels = graph
    n, nnz = adj.shape[0], adj.nnz
    indptr = np.concatenate([adj.indptr[:1]] + [adj.indptr[1:] + c * nnz for c in range(k)])
    indices = np.concatenate([adj.indices + c * n for c in range(k)])
    return (CSRMatrix(np.tile(adj.data, k), indices.astype(np.int32), indptr.astype(np.int32),
                      (k * n, k * n)), np.tile(labels, k))


def phase_codes_host(graph) -> tuple:
    """``codes_placement="host"`` at gnn_train's full width against device
    placement from the same init and codes, in one run: 50 steps at prefetch
    2 and 20 at prefetch 0 (losses and params bitwise), ``evaluate("val")``
    and ``embed``, cached, uncached and batched serving, a killed and
    resumed host run against 20 straight steps, the int8 family for 20
    steps; the period, the producer's stages, the code bytes moved a batch
    and held on the card and the peak memory of each; then the same at a
    fixed frontier on the serve graph and on one of 8x its nodes.  Each
    placement's runs hold the card alone.  Returns the launches by path,
    every f32 and int8 row count the host path decoded, and the forward's
    largest error at those sizes."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.core.codes import to_uint32
    from repro_torch.graph.runtime import GraphRuntime
    from repro_torch.kernels.hash_decode import ops as hd_ops
    decoded, forward = {"float32": set(), "int8": set()}, hd_ops._forward

    def recording_forward(codes, cb, *args, **kw):
        decoded["int8" if cb.dtype == torch.int8 else "float32"].add(int(codes.shape[0]))
        return forward(codes, cb, *args, **kw)

    def seeded(spec, g):                   # the seeded init and codes, kept on the host
        rt = GraphRuntime.from_spec(spec, graph=g)
        out = _snapshot(rt.params, "cpu"), to_uint32(rt.codes)
        rt.close()
        del rt
        torch.cuda.empty_cache()
        return out

    hd_ops._forward = recording_forward
    spec = _gnn_spec()
    init, codes = seeded(spec, graph)
    rng = np.random.default_rng(20)
    requests = [rng.choice(N_NODES, REQUEST, replace=False) for _ in range(8)]
    eval_ids = rng.choice(N_NODES, REQUEST, replace=False).astype(np.int32)
    runs, served, launches = {}, {}, {}
    for placement in ("device", "host"):
        host = placement == "host"
        baseline = _card_baseline()
        rt = _placed(spec, graph, init, codes, placement)
        run = _placement_run(rt, HOST_STEPS, "codes_host" if host else "", baseline)
        if host:                               # evaluate, embed and serve: one path
            zero_counts()
        run.update(evaluate=rt.evaluate("val"), embed=rt.embed(eval_ids))
        rt.close()                             # stops the producer; serving reads the params
        served[placement] = _serve_routes(rt, requests)
        if host:
            torch.cuda.synchronize()
            launches["codes_host"] = run["launches"]
            launches["codes_host_serve"] = read_counts("codes_host_serve")
        runs[placement] = run
        del rt
        torch.cuda.empty_cache()
        print(f"[codes_host] {placement} placement, {HOST_STEPS} steps at prefetch 2: period "
              f"median {run['median_ms']:.3f} ms (steps 2-{GNN_TIMED}) "
              f"{[round(t, 3) for t in run['periods'][1:GNN_TIMED]]}; producer a batch (us) "
              f"{run['producer']}; code bytes moved a batch {run['bytes_per_batch']:.0f} (as "
              f"int64 words; {run['uint32_bytes_per_batch']:.0f} as uint32), held on the card "
              f"{run['resident']}; peak memory above the card's baseline {run['peak']} B; "
              f"evaluate('val') "
              f"{run['evaluate']}", flush=True)
    dev, host = runs["device"], runs["host"]
    _same_run(dev, host, f"{HOST_STEPS} steps at prefetch 2")
    check(dev["evaluate"] == host["evaluate"] and np.array_equal(dev["embed"], host["embed"]),
          "codes_host: evaluate or embed differs between the placements")
    check(launches["codes_host"]["hash_decode"] == HOST_STEPS
          and launches["codes_host"]["hash_decode_backward"] == HOST_STEPS,
          f"codes_host: expected one forward and one backward launch a step: {launches}")
    check(launches["codes_host_serve"]["hash_decode"] > 0
          and launches["codes_host_serve"]["hash_decode_backward"] == 0,
          f"codes_host: evaluate and serving launched {launches['codes_host_serve']}")
    check(host["bytes_per_batch"] > 0 and dev["bytes_per_batch"] == 0
          and dev["resident"] == 8 * codes.size and host["resident"] == 0,
          "codes_host: the code bytes moved or held are not the placements'")
    for route in ("cached", "uncached", "batched"):
        check(all(np.array_equal(a.embeddings, b.embeddings)
                  and np.array_equal(a.logits, b.logits) and a.rows_decoded == b.rows_decoded
                  for a, b in zip(served["device"][route], served["host"][route])),
              f"codes_host: {route} serving under host placement differs from device")
    print(f"[codes_host] evaluate('val') and embed of {REQUEST} nodes bitwise equal; peak "
          f"memory host - device {host['peak'] - dev['peak']} B (codes_buf "
          f"{dev['resident']} B); serving, requests 3-8 median ms: cached (rt.serve()) device "
          f"{served['device']['cached_ms']:.3f} / host {served['host']['cached_ms']:.3f}; "
          f"uncached {served['device']['uncached_ms']:.3f} / {served['host']['uncached_ms']:.3f}; "
          f"batched, {len(requests)} requests in one microbatch "
          f"{served['device']['batched_ms']:.3f} / {served['host']['batched_ms']:.3f}; host "
          f"responses bitwise the device's on all three routes; launches of evaluate, embed "
          f"and serving {launches['codes_host_serve']}", flush=True)

    # prefetch 0: the loop gathers the rows before each step
    runs0 = {}
    for placement in ("device", "host"):
        baseline = _card_baseline()
        rt = _placed(_gnn_spec(prefetch_depth=0), graph, init, codes, placement)
        runs0[placement] = _placement_run(rt, HOST_STEPS0, baseline=baseline)
        rt.close()
        del rt
    _same_run(runs0["device"], runs0["host"], f"{HOST_STEPS0} steps at prefetch 0")
    print(f"[codes_host] prefetch 0 period median (steps 2-{GNN_TIMED}): device "
          f"{runs0['device']['median_ms']:.3f} / host {runs0['host']['median_ms']:.3f} ms; "
          f"peak {runs0['device']['peak']} / {runs0['host']['peak']} B", flush=True)

    # killed at step 10 and resumed from the checkpoint alone
    shutil.rmtree(HOST_CKPT, ignore_errors=True)
    killed = _placed(_gnn_spec(ckpt_dir=str(HOST_CKPT), ckpt_every=10), graph, init, codes,
                     "host")
    head = killed.train(10).losses
    killed.close()
    del killed
    resumed = GraphRuntime.resume(str(HOST_CKPT), graph=graph)
    tail = resumed.train(HOST_STEPS0)
    resumed.close()
    same = head + tail.losses == runs0["host"]["losses"]
    same_params = _same_tree(_snapshot(resumed.params, "cpu"), runs0["host"]["params"])
    print(f"[codes_host] kill and resume: resumed from step {tail.resumed_from} with "
          f"codes_placement {resumed.spec.model.embedding.codes_placement!r}; losses 1-20 "
          f"bitwise {same}, final params bitwise {same_params} against 20 straight steps",
          flush=True)
    check(tail.resumed_from == 10 and resumed.codes_on_host and same and same_params,
          "codes_host: the resumed host run differs from the straight one")
    shutil.rmtree(HOST_CKPT, ignore_errors=True)
    del resumed

    # one family: int8 storage decodes through the int8 kernel
    int8_spec = _family_spec("families_int8")
    int8_init, _ = seeded(int8_spec, graph)
    int8 = {}
    for placement in ("device", "host"):
        baseline = _card_baseline()
        rt = _placed(int8_spec, graph, int8_init, codes, placement)
        int8[placement] = _placement_run(rt, HOST_STEPS0,
                                         "codes_host_int8" if placement == "host" else "",
                                         baseline)
        rt.close()
        del rt
    launches["codes_host_int8"] = int8["host"]["launches"]
    _same_run(int8["device"], int8["host"], f"int8 storage, {HOST_STEPS0} steps")
    print(f"[codes_host] int8 period median device {int8['device']['median_ms']:.3f} / host "
          f"{int8['host']['median_ms']:.3f} ms; host launches {int8['host']['launches']}",
          flush=True)

    # the sweep: a fixed frontier (serve's cap) on the serve graph and on
    # 8x its nodes, eight disjoint copies of it; random codes, since the
    # placement does not depend on what the codes say
    big = _copies(graph, SWEEP_NODES // N_NODES)
    sweep, words = {}, {}
    for n_nodes, g in ((N_NODES, graph), (SWEEP_NODES, big)):
        sspec = _gnn_spec(n_nodes=n_nodes, frontier_cap=SWEEP_CAP).with_updates(
            kind="random_full")
        s_init, s_codes = seeded(sspec, g)
        words[n_nodes] = s_codes.size
        for placement in ("device", "host"):
            baseline = _card_baseline()
            rt = _placed(sspec, g, s_init, s_codes, placement)
            sweep[(n_nodes, placement)] = _placement_run(rt, SWEEP_STEPS, baseline=baseline)
            rt.close()
            del rt
            torch.cuda.empty_cache()
        _same_run(sweep[(n_nodes, "device")], sweep[(n_nodes, "host")],
                  f"sweep at {n_nodes} nodes, frontier {SWEEP_CAP} rows")
    del big
    hd_ops._forward = forward
    for (n_nodes, placement), r in sweep.items():
        print(f"[codes_host] sweep {n_nodes} nodes, {placement}: code bytes held on the card "
              f"{r['resident']}, moved a batch {r['bytes_per_batch']:.0f}; period median "
              f"{r['median_ms']:.3f} ms; producer a batch (us) {r['producer']}; peak memory "
              f"above the card's baseline {r['peak']} B", flush=True)
    check(all(r["resident"] == (8 * words[n] if p == "device" else 0)
              for (n, p), r in sweep.items()),
          "codes_host: the sweep's code bytes on the card are not the placements'")
    sizes = {k: sorted(v) for k, v in decoded.items()}
    err = max(check_gnn_frontiers(sizes["float32"], "decode sizes of the codes_host path"),
              check_gnn_frontiers(sizes["int8"], "int8 decode sizes of the codes_host path",
                                  variant="int8"))
    summary = dict(period_ms={p: runs[p]["median_ms"] for p in runs},
                   period0_ms={p: runs0[p]["median_ms"] for p in runs0},
                   int8_period_ms={p: int8[p]["median_ms"] for p in int8},
                   producer_us={p: runs[p]["producer"] for p in runs},
                   bytes_per_batch=host["bytes_per_batch"],
                   uint32_bytes_per_batch=host["uint32_bytes_per_batch"],
                   resident={p: runs[p]["resident"] for p in runs},
                   peak={p: runs[p]["peak"] for p in runs},
                   serve_ms={p: {k: served[p][k] for k in ("cached_ms", "uncached_ms",
                                                           "batched_ms")} for p in served},
                   sweep={f"{n}/{p}": dict(resident=r["resident"], period_ms=r["median_ms"],
                                           code_gather_us=r["producer"]["code_gather_us"],
                                           peak=r["peak"])
                          for (n, p), r in sweep.items()})
    print(f"[codes_host] summary {json.dumps(summary)}", flush=True)
    return launches, sizes, err


# -- phase sharded: four ranks over torch.distributed ----------------------

SHARDS = 4
# the first run; then SHARD_MORE, a checkpoint, resume, SHARD_MORE more (cut from
# 20 and 10 for the script's time when the LM's serving across ranks came, PERF.md §4)
SHARD_STEPS = 4
SHARD_MORE = 2
SHARD_IMPLS = ("sharded:pallas", "owner:pallas", "auto")
SHARD_CKPT = ROOT / "build" / "sharded_ckpt"


def _digest(tree) -> str:
    """sha256 of every tensor of a tree's bytes, in path order."""
    import hashlib
    from repro_torch.nn.module import leaves_with_path
    h = hashlib.sha256()
    for path, t in sorted(leaves_with_path(tree), key=lambda kv: kv[0]):
        h.update("/".join(path).encode())
        h.update(t.detach().cpu().contiguous().view(-1).view(__import__("torch").uint8)
                 .numpy().tobytes())
    return h.hexdigest()


def _batch_digest(batch) -> int:
    """The first 8 bytes of a host batch's sha256, as an int64."""
    import hashlib
    import numpy as np
    fb = batch["frontier"]
    h = hashlib.sha256()
    for a in (fb.unique, fb.valid, *fb.index_maps, batch["labels"]):
        h.update(np.ascontiguousarray(a).tobytes())
    return int.from_bytes(h.digest()[:8], "little", signed=True)


def _sharded_rank(rank: int, payload: dict) -> dict:
    """One of the ranks of phase ``sharded``: per decode backend, the
    step-0 checks, a straight run (launches counted), a run through a
    checkpoint and ``resume``, and what the parent prints."""
    import numpy as np
    import torch
    from repro_torch.core.decoder import decode_stage
    from repro_torch.core.embedding import lookup_codes
    from repro_torch.device import disable_tf32
    from repro_torch.graph.engine import SageBatchSource, ShardedSageBatchSource
    from repro_torch.graph.runtime import GraphRuntime
    from repro_torch.kernels.hash_decode import ops as hd_ops
    from repro_torch.parallel import sharding
    disable_tf32()
    mesh = sharding.data_mesh(SHARDS)
    dev = mesh.device
    graph, init = payload["graph"], payload["init"]
    # the row counts the straight runs decode at (the training path's)
    decoded, sink, forward = set(), [set()], hd_ops._forward

    def recording_forward(codes, *args, **kw):
        sink[0].add(int(codes.shape[0]))
        return forward(codes, *args, **kw)
    hd_ops._forward = recording_forward

    def params():
        return {k: params_of(v) for k, v in init.items()}

    def params_of(v):
        return ({k: params_of(x) for k, x in v.items()} if isinstance(v, dict)
                else torch.from_numpy(v).to(dev, copy=True))

    out = {"transport": mesh.backend, "device": str(dev), "impls": {}}
    for impl in payload["impls"]:
        r = out["impls"][impl] = {}
        ckpt = str(SHARD_CKPT / impl.replace(":", "_"))
        if rank == 0:
            import shutil
            shutil.rmtree(ckpt, ignore_errors=True)
        mesh.barrier()
        spec = _gnn_spec(n_shards=SHARDS, prefetch_depth=2, ckpt_dir=ckpt,
                         ckpt_every=1000).with_updates(lookup_impl=impl)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        rt = GraphRuntime.from_spec(spec, graph=graph, params=params())
        backend = rt.train_step.model.backend
        src = rt.source
        r.update(backend=type(backend).__name__, duplication=src.duplication_measured,
                 owner_plan=src.owner_plan, cap=src.frontier_cap,
                 owner_caps=(src.owner_cap, src.owner_unique_cap))
        # step 0: the same global batch on every rank, and its decoded rows
        # bitwise the 1-shard frontier's
        probe = ShardedSageBatchSource(
            rt.sampler, rt.splits["train"], rt.labels, spec.batch_size // SHARDS,
            n_shards=SHARDS, seed=spec.data_seed, pad_to=spec.pad_to,
            frontier_cap=spec.frontier_cap, owner_plan=src.owner_plan)
        batch = probe.next_batch()
        digests = mesh.all_gather(torch.tensor([_batch_digest(batch)], device=dev))
        r["same_batch"] = len({int(d) for d in digests}) == 1
        one = SageBatchSource(rt.sampler, rt.splits["train"], rt.labels, spec.batch_size,
                              seed=spec.data_seed, pad_to=spec.pad_to).next_batch()["frontier"]
        ecfg = rt.cfg.embedding_config()
        dec = rt.params["embed"]["decoder"]
        with torch.no_grad():
            fb = rt.place(batch)["frontier"]
            with sharding.use_sharding(mesh):
                rows = decode_stage(dec, lookup_codes(rt.params["embed"], fb.unique, ecfg),
                                    ecfg.decoder_config(), backend, frontier=True,
                                    plan=fb.plan)
            ids1 = torch.from_numpy(one.unique.astype(np.int64)).to(dev)
            rows1 = decode_stage(dec, lookup_codes(rt.params["embed"], ids1, ecfg),
                                 ecfg.decoder_config(), backend.base)
        valid = torch.from_numpy(batch["frontier"].valid).to(dev)
        ids = torch.from_numpy(batch["frontier"].unique.astype(np.int64)).to(dev)[valid]
        pos = torch.searchsorted(ids1[:one.n_unique], ids)
        r["rows_bitwise"] = bool(torch.equal(rows[valid], rows1[pos]))
        r["rows_checked"] = int(valid.sum())
        del rows, rows1
        # 20 steps (the path's launches and exchanges; a checkpoint at 20),
        # evaluate, 10 (a checkpoint at 30); then 10 in memory against 10
        # from a resume at 30
        stats0 = dict(rt.mesh.stats)
        sink[0] = decoded
        zero_counts()
        res, periods = _train_timed(rt, SHARD_STEPS)
        torch.cuda.synchronize(dev)
        r["launches"] = read_counts(f"sharded {impl}")
        sink[0] = set()
        r["bytes_per_step"] = {k: (rt.mesh.stats[k] - stats0.get(k, 0)) / SHARD_STEPS
                               for k in rt.mesh.stats if not k.endswith("_calls")}
        r.update(period_ms=float(np.median(periods[1:])),
                 peak_bytes=torch.cuda.max_memory_allocated(dev) - base,
                 overflows=src.plan_overflows,
                 rows_per_rank=(src.owner_unique_cap if r["backend"] == "OwnerBackend"
                                and src.owner_plan else src.frontier_cap))
        t = time.perf_counter()
        r["eval"] = rt.evaluate("val")
        r["eval_s"] = time.perf_counter() - t
        losses = res.losses + rt.train(SHARD_STEPS + SHARD_MORE).losses
        resumed = GraphRuntime.resume(ckpt, graph=graph)
        rt.ckpt = None                  # the in-memory run writes no more
        r["losses"] = losses + rt.train(SHARD_MORE).losses
        r["resumed_losses"] = resumed.train(SHARD_STEPS + 2 * SHARD_MORE).losses
        r["resumed_bitwise"] = (r["resumed_losses"] == r["losses"][-SHARD_MORE:]
                                and _same_tree(_snapshot(resumed.params, "cpu"),
                                               _snapshot(rt.params, "cpu")))
        r.update(digest=_digest(rt.params), resumed_digest=_digest(resumed.params))
        rt.close()
        resumed.close()
        del rt, resumed
        # the same 20 steps at Adam's eps 1, where rounding differences do
        # not part the trajectories (ROADMAP §C)
        rt = GraphRuntime.from_spec(spec.with_updates(optimizer=_eps1(spec.optimizer),
                                                      ckpt_dir=None),
                                    graph=graph, params=params())
        r["losses_eps1"] = rt.train(SHARD_STEPS).losses
        rt.close()
        del rt
        # under owner: each planned step's owners decode the distinct ids
        # of the four blocks, exactly (rank 0 replays the run's stream)
        if rank == 0 and src.owner_plan:
            replay = ShardedSageBatchSource(
                graph_sampler(graph, spec), _train_nodes(spec), graph[1],
                spec.batch_size // SHARDS, n_shards=SHARDS, seed=spec.data_seed,
                pad_to=spec.pad_to, frontier_cap=spec.frontier_cap, owner_plan=True)
            exact = planned = 0
            for _ in range(SHARD_STEPS + 2 * SHARD_MORE):
                fb_h = replay.next_batch()["frontier"]
                if fb_h.plan is not None:
                    planned += 1
                    exact += int(fb_h.plan.n_owned.sum()) == np.unique(
                        fb_h.unique[fb_h.valid]).shape[0]
            r["owner_check"] = (planned, exact, replay.plan_overflows,
                                int(fb_h.plan.n_owned.sum()) if fb_h.plan is not None else 0)
        torch.cuda.empty_cache()
    hd_ops._forward = forward
    out["decoded_sizes"] = sorted(decoded)
    return out


def _eps1(opt):
    import dataclasses
    return dataclasses.replace(opt, eps=1.0)


def graph_sampler(graph, spec):
    from repro_torch.graph.sampler import NeighborSampler
    return NeighborSampler(graph[0], spec.model.fanouts, max_deg=spec.max_deg,
                           seed=spec.data_seed)


def _train_nodes(spec):
    from repro_torch.graph.generate import train_val_test_split
    return train_val_test_split(spec.split_seed, spec.model.n_nodes, spec.split_frac)[0]


def phase_sharded(graph) -> tuple:
    """gnn_train's GraphSAGE at full width across 4 ranks of
    ``torch.distributed`` on this card (gloo; NCCL one card a rank where
    there are 4 cards): ``lookup_impl`` ``sharded:pallas``, ``owner:pallas``
    and ``auto``, each 20 steps (launches counted), ``evaluate``, 10 steps
    and a checkpoint, then 10 in memory against 10 after ``resume``, and 20
    at Adam's eps 1; beside 1-shard runs of the same spec and init.
    Returns the launches by path, the row counts each backend decoded at,
    and the kernels' largest error at them."""
    import numpy as np
    import torch
    from repro_torch.graph.runtime import GraphRuntime
    from repro_torch.parallel.sharding import spawn
    t0 = time.perf_counter()
    rt1 = GraphRuntime.from_spec(_gnn_spec(prefetch_depth=2), graph=graph)
    init = _snapshot(rt1.params, "cpu")
    res1, periods1 = _train_timed(rt1, SHARD_STEPS)
    one = res1.losses
    rt1.close()
    spec1, dev1 = rt1.spec, rt1.device
    rt1 = GraphRuntime.from_spec(spec1.with_updates(optimizer=_eps1(spec1.optimizer)),
                                 graph=graph, params=_snapshot(init, dev1))
    one_eps1 = rt1.train(SHARD_STEPS).losses
    rt1.close()
    del rt1
    torch.cuda.empty_cache()
    to_np = lambda t: ({k: to_np(v) for k, v in t.items()} if isinstance(t, dict)
                       else t.numpy())
    payload = {"graph": graph, "init": to_np(init), "impls": SHARD_IMPLS}
    try:
        results = spawn(_sharded_rank, SHARDS, backend="gloo", args=(payload,), timeout_s=900)
    except RuntimeError as e:
        fail(f"phase sharded: {e}")
    secs = time.perf_counter() - t0
    r0 = results[0]
    print(f"[sharded] {SHARDS} ranks share {torch.cuda.get_device_name(0)} over "
          f"{r0['transport']}, CUDA tensors in its collectives (ranks on {sorted({r['device'] for r in results})}); "
          f"{secs:.1f} s for the phase", flush=True)
    print(f"[sharded] 1-shard run, same spec and init: period {np.median(periods1[1:]):.3f} ms, "
          f"losses {one[:3]} ... {one[-1]}", flush=True)
    launches, sizes = {}, {}
    for impl in SHARD_IMPLS:
        rs = [r["impls"][impl] for r in results]
        a = rs[0]
        d0 = a["losses"][0] - one[0]
        drift = max(abs(x - y) for x, y in zip(a["losses"][:SHARD_STEPS], one))
        drift1 = max(abs(x - y) for x, y in zip(a["losses_eps1"], one_eps1))
        print(f"[sharded] {impl}: backend {a['backend']} (duplication measured "
              f"{a['duplication']}, owner plan {a['owner_plan']}, caps {a['owner_caps']}); "
              f"frontier_cap {a['cap']}, rows decoded per rank {a['rows_per_rank']}; "
              f"step-0 loss {a['losses'][0]} vs 1-shard {one[0]} (diff {d0}); largest "
              f"diff over {SHARD_STEPS} free steps {drift} at Adam's eps 1e-8 (rounding "
              f"parts the trajectories there, ROADMAP §C), {drift1} at eps 1", flush=True)
        print(f"[sharded] {impl}: period {a['period_ms']:.3f} ms a step (4 ranks share one card "
              f"over gloo: not a multi-GPU time); exchanged a step per rank "
              f"{ {k: round(v) for k, v in a['bytes_per_step'].items()} } B; peak memory per "
              f"rank over its first {SHARD_STEPS} steps "
              f"{[round(r['peak_bytes'] / 2**20, 1) for r in rs]} MiB; evaluate('val') "
              f"{a['eval']} in {a['eval_s']:.1f} s", flush=True)
        check(all(r["same_batch"] for r in rs), f"{impl}: the ranks' step-0 batches differ")
        check(all(r["rows_bitwise"] for r in rs),
              f"{impl}: decoded rows differ from the 1-shard frontier's")
        check(d0 == 0.0 or abs(d0) <= 1e-5, f"{impl}: step-0 loss {d0} from the 1-shard run's")
        check(drift1 <= 1e-3, f"{impl}: {SHARD_STEPS} steps at Adam's eps 1 part by {drift1} "
                              f"from the 1-shard run")
        check(len({r["digest"] for r in rs}) == 1 and len({r["resumed_digest"] for r in rs}) == 1,
              f"{impl}: the ranks' params differ")
        check(all(r["resumed_bitwise"] for r in rs),
              f"{impl}: the {SHARD_MORE} steps after resume are not the straight run's bit "
              f"for bit: losses {a['resumed_losses']} against {a['losses'][-SHARD_MORE:]}")
        check(all(r["losses"] == a["losses"] for r in rs), f"{impl}: the ranks' losses differ")
        if "owner_check" in a:
            planned, exact, overflows, last = a["owner_check"]
            print(f"[sharded] {impl}: owner plans at {planned} of "
                  f"{SHARD_STEPS + 2 * SHARD_MORE} steps, sum of n_owned equal to the distinct "
                  f"ids at {exact}; plan overflows {overflows} (in the run "
                  f"{[r['overflows'] for r in rs]}); last step decodes {last} ids once each",
                  flush=True)
            check(exact == planned, f"{impl}: owners did not decode each distinct id once")
        print(f"[sharded] {impl}: rows bitwise the 1-shard frontier's at step 0 "
              f"({a['rows_checked']} valid rows); losses and params equal on all ranks; "
              f"{SHARD_MORE} steps from a resume at step {SHARD_STEPS + SHARD_MORE} bitwise the "
              f"straight run's", flush=True)
        path = {"sharded:pallas": "sharded", "owner:pallas": "owner"}.get(impl, "sharded_auto")
        launches[path] = {k: sum(r["launches"][k] for r in rs) if k != "hash_decode_backward_by_kernel"
                          else {kk: sum(r["launches"][k][kk] for r in rs)
                                for kk in a["launches"][k]} for k in a["launches"]}
        check(launches[path]["hash_decode"] > 0 and launches[path]["hash_decode_backward"] > 0,
              f"{impl}: the path launched no hash_decode kernel")
        sizes[path] = a["rows_per_rank"]
    decoded = sorted(set().union(*(r["decoded_sizes"] for r in results)))
    if torch.cuda.device_count() >= SHARDS:
        try:
            nccl = spawn(_sharded_rank, SHARDS, backend="nccl",
                         args=(dict(payload, impls=("owner:pallas",)),), timeout_s=900)
        except RuntimeError as e:
            fail(f"phase sharded over NCCL: {e}")
        b = nccl[0]["impls"]["owner:pallas"]
        print(f"[sharded] owner:pallas over {nccl[0]['transport']}, one card a rank: period "
              f"{b['period_ms']:.3f} ms; losses bitwise the gloo run's "
              f"{b['losses'] == results[0]['impls']['owner:pallas']['losses']}", flush=True)
        check(len({r["impls"]["owner:pallas"]["digest"] for r in nccl}) == 1,
              "NCCL ranks' params differ")
    else:
        print(f"[sharded] NCCL run skipped: {torch.cuda.device_count()} card(s), "
              f"it needs {SHARDS}", flush=True)
    check(set(decoded) == {sizes["sharded"], sizes["owner"]},
          f"phase sharded's runs decoded at {decoded}, not the block and owner sizes {sizes}")
    err = max(check_gnn_frontiers([sizes["sharded"]], "sharded block sizes"),
              check_gnn_frontiers([sizes["owner"]], "owner decode sizes"))
    return launches, {"sharded_sizes": [sizes["sharded"]], "owner_sizes": [sizes["owner"]]}, err


ELASTIC_BATCH = 192        # divides by 4, 3 and 2 (256 cannot go to 3 ranks)
ELASTIC_STEPS = 14         # benchmarks/elastic_failover.py's schedule
ELASTIC_KILL = (2, 10)     # rank 2 stops renewing its lease at step 10
ELASTIC_MORE = 6           # timed steps at 3 ranks after the schedule
ELASTIC_CKPT = ROOT / "build" / "elastic_ckpt"
SHARED_CARD = "ranks share one card over gloo: not a multi-GPU time"


def _elastic_spec(impl: str, n_shards: int = SHARDS, **overrides):
    return _gnn_spec(n_shards=n_shards, batch_size=ELASTIC_BATCH, prefetch_depth=2,
                     **overrides).with_updates(lookup_impl=impl)


def _elastic_rank(rank: int, payload: dict) -> dict:
    """One of the 4 ranks of phase ``elastic``: (a) the kill schedule and
    its never-failed reference, (b) a 4-rank checkpoint rescaled to 2 and
    (c) a 2-rank runtime grown to 4, each beside its native run; the
    refusals; what the parent prints."""
    import dataclasses
    import shutil
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.device import disable_tf32
    from repro_torch.elastic import (ElasticManager, ElasticSpec, FailurePlan,
                                     rescale_runtime)
    from repro_torch.graph.runtime import GraphRuntime
    from repro_torch.kernels.hash_decode import ops as hd_ops
    from repro_torch.parallel.sharding import group_mesh, rank_device
    from repro_torch.train.checkpoint import TopologyMismatch
    disable_tf32()
    graph, init = payload["graph"], payload["init"]
    dev = rank_device(dist.get_rank())
    decoded, forward = set(), hd_ops._forward

    def recording_forward(codes, *args, **kw):
        decoded.add(int(codes.shape[0]))
        return forward(codes, *args, **kw)
    hd_ops._forward = recording_forward

    def params(dev):
        to = lambda v: ({k: to(x) for k, x in v.items()} if isinstance(v, dict)
                        else torch.from_numpy(v).to(dev, copy=True))
        return to(init)

    out = {"launches": {}}
    # (a) the kill schedule: shard 2 dies at step 10, recovery from the peers
    spec_a = _elastic_spec("sharded:pallas", elastic=ElasticSpec(lease_steps=1,
                                                                 chunk_bytes=1 << 16))
    rt = GraphRuntime.from_spec(spec_a, graph=graph, params=params(dev))
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    mgr = ElasticManager(rt, plan=FailurePlan(kill=(ELASTIC_KILL,), corrupt_chunks=(1,)))
    stamps = []
    zero_counts()
    res = mgr.run(ELASTIC_STEPS, on_metrics=lambda s, m: stamps.append(time.perf_counter()))
    torch.cuda.synchronize(dev)
    out["launches"]["elastic"] = read_counts("elastic")
    gaps = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    out.update(history=res.history, losses=res.losses, steps=res.steps,
               alive=res.runtime is not None, device=str(dev),
               reports=[dataclasses.asdict(r) for r in res.reports],
               recovery_s=mgr.recovery_seconds,
               period_before_ms=float(np.median(gaps[1:ELASTIC_KILL[1] + 1])))
    if res.runtime is not None:
        more, periods = _train_timed(res.runtime, ELASTIC_MORE)
        out.update(more=more.losses, period_after_ms=float(np.median(periods)),
                   n_shards=res.runtime.spec.n_shards, ckpt_dir=res.runtime.spec.ckpt_dir,
                   digest=_digest(res.runtime.params))
        res.runtime.close()
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev) - base
    del rt, res, mgr
    # its reference: never failed, 12 steps, rescale(3), the same steps on
    ref = GraphRuntime.from_spec(spec_a, graph=graph, params=params(dev))
    head = ref.train(ELASTIC_KILL[1] + 2).losses
    rt3 = ref.rescale(3)
    ref.close()
    out["ref"] = None
    if rt3 is not None:
        tail = rt3.train(ELASTIC_STEPS - ELASTIC_KILL[1] - 2).losses
        out["ref"] = (head + tail, rt3.train(ELASTIC_MORE).losses, _digest(rt3.params))
        rt3.close()
    del ref, rt3
    torch.cuda.empty_cache()
    if payload.get("kill_only"):
        hd_ops._forward = forward
        return out
    # (b) a 4-rank owner run with pinned caps writes its step-0 checkpoint
    # (and goes on one step in memory); rescale_checkpoint takes it to 2
    ckpt = str(ELASTIC_CKPT)
    if rank == 0:
        shutil.rmtree(ckpt, ignore_errors=True)
    dist.barrier()
    spec_b = _elastic_spec("owner:pallas", owner_cap=payload["caps"][0],
                           owner_unique_cap=payload["caps"][1])
    rt = GraphRuntime.from_spec(dataclasses.replace(spec_b, ckpt_dir=ckpt, ckpt_every=1000),
                                graph=graph, params=params(dev))
    rt.train(0)
    rt.ckpt = None                  # the in-memory run writes no more
    out["owner4"] = rt.train(1).losses
    rt.close()
    zero_counts()
    rt2 = GraphRuntime.rescale_checkpoint(ckpt, 2, graph=graph)
    out["from_ckpt"] = None
    if rt2 is not None:
        out["from_ckpt"] = (rt2.train(1).losses, (rt2.spec.owner_cap, rt2.spec.owner_unique_cap),
                            rt2.spec.n_shards)
        rt2.close()
    torch.cuda.synchronize(dev)
    out["launches"]["elastic_ckpt"] = read_counts("elastic_ckpt")
    mesh2 = group_mesh([0, 1])
    out["native2"] = out["mismatch"] = None
    if mesh2 is not None:
        native = GraphRuntime.from_spec(
            _elastic_spec("owner:pallas", n_shards=2, owner_cap=out["from_ckpt"][1][0],
                          owner_unique_cap=out["from_ckpt"][1][1]),
            graph=graph, params=params(dev), group=mesh2.group)
        out["native2"] = native.train(1).losses
        native.close()
        bad = GraphRuntime.from_spec(dataclasses.replace(spec_b, n_shards=2, ckpt_dir=ckpt),
                                     graph=graph, params=params(dev), group=mesh2.group)
        try:
            bad.train(4)
        except TopologyMismatch as e:
            out["mismatch"] = str(e)
        finally:
            bad.close()
    # (c) a native 2-rank runtime grown to 4 at step 0, one step; the 2-rank
    # runtime itself then steps (23,296 rows a block)
    zero_counts()
    rt2 = None
    if mesh2 is not None:
        rt2 = GraphRuntime.from_spec(_elastic_spec("sharded:pallas", n_shards=2), graph=graph,
                                     params=params(dev), group=mesh2.group)
        grown = rt2.rescale(4)
    else:
        grown = rescale_runtime(None, SHARDS, graph=graph)
    out["grown"] = (grown.train(1).losses, grown.spec.n_shards, grown.mesh.size)
    torch.cuda.synchronize(dev)
    out["launches"]["elastic_grow"] = read_counts("elastic_grow")
    try:
        grown.rescale(5)
        out["five"] = None
    except ValueError as e:
        out["five"] = str(e)
    grown.close()
    if rt2 is not None:
        out["two"] = rt2.train(1).losses
        rt2.close()
    native = GraphRuntime.from_spec(_elastic_spec("sharded:pallas"), graph=graph,
                                    params=params(dev))
    out["native4"] = native.train(1).losses
    native.close()
    hd_ops._forward = forward
    out["decoded_sizes"] = sorted(decoded)
    return out


def phase_elastic(graph) -> tuple:
    """gnn_train's GraphSAGE at full width, ``n_shards=4`` and a global
    batch of 192, on 4 ranks sharing this card over gloo: a rank killed
    and the run continued on 3 from its peers, a 4-rank checkpoint rescaled
    to 2, a 2-rank run grown to 4, each bitwise its reference; (a) again
    over NCCL where there are 4 cards.  Returns the launches by path, the
    row counts decoded and the kernels' largest error at them."""
    import numpy as np
    import torch
    from repro_torch.core.backend import rederive_owner_caps
    from repro_torch.graph.engine import default_frontier_cap
    from repro_torch.graph.runtime import GraphRuntime
    from repro_torch.graph.sampler import default_owner_caps
    from repro_torch.parallel.sharding import spawn
    t0 = time.perf_counter()
    rt1 = GraphRuntime.from_spec(_gnn_spec(), graph=graph)
    to_np = lambda t: ({k: to_np(v) for k, v in t.items()} if isinstance(t, dict)
                       else t.cpu().numpy())
    init = to_np(rt1.params)
    rt1.close()
    del rt1
    torch.cuda.empty_cache()
    block4 = default_frontier_cap(ELASTIC_BATCH // SHARDS, (15, 15), 256, N_NODES)
    caps = default_owner_caps(block4, SHARDS)
    payload = {"graph": graph, "init": init, "caps": caps}
    try:
        results = spawn(_elastic_rank, SHARDS, backend="gloo", args=(payload,), timeout_s=900)
    except RuntimeError as e:
        fail(f"phase elastic: {e}")
    secs = time.perf_counter() - t0
    r0 = results[0]
    survivors = [r for r in results if r["alive"]]
    (rep,) = r0["reports"]
    print(f"[elastic] {SHARDS} ranks share {torch.cuda.get_device_name(0)} over gloo (ranks on "
          f"{sorted({r['device'] for r in results})}); global batch {ELASTIC_BATCH}; "
          f"{secs:.1f} s for the phase", flush=True)
    print(f"[elastic] (a) kill rank {ELASTIC_KILL[0]} at step {ELASTIC_KILL[1]}: history "
          f"{r0['history']}; report {rep}; rank 2 left with runtime None "
          f"{not results[2]['alive']} after {results[2]['steps']} steps", flush=True)
    print(f"[elastic] (a) payload {rep['payload_bytes']} B, wire {rep['bytes_transferred']} B, "
          f"{rep['chunks']} chunks of 65,536 B, {rep['retransmits']} retransmit; recovery wall "
          f"time (interrupt to the rescaled runtime's first step) "
          f"{[round(r['recovery_s'][0], 3) for r in survivors]} s on the survivors ({SHARED_CARD})",
          flush=True)
    print(f"[elastic] (a) period before the rescale (4 ranks, median of steps 2-"
          f"{ELASTIC_KILL[1] + 1}) {[round(r['period_before_ms'], 3) for r in results]} ms; after "
          f"(3 ranks, {ELASTIC_MORE} more steps) "
          f"{[round(r['period_after_ms'], 3) for r in survivors]} ms ({SHARED_CARD}); peak "
          f"memory a rank {[round(r['peak_bytes'] / 2**20, 1) for r in results]} MiB", flush=True)
    ref_losses, ref_more, ref_digest = r0["ref"]
    print(f"[elastic] (a) losses {r0['losses'][:2]} ... {r0['losses'][-2:]}; the reference's "
          f"{ref_losses[:2]} ... {ref_losses[-2:]}; bitwise on every survivor "
          f"{all(r['losses'] == ref_losses and r['more'] == ref_more for r in survivors)}",
          flush=True)
    check(r0["history"] == ["HEALTHY", "DEGRADED", "RESCALING", "HEALTHY"],
          f"elastic: history {r0['history']}")
    check(tuple(rep["failed_shards"]) == (2,) and rep["detected_at_step"] == 11
          and rep["steps_lost"] == 1 and (rep["n_before"], rep["n_after"]) == (4, 3)
          and rep["retransmits"] == 1 and rep["bytes_transferred"] > rep["payload_bytes"],
          f"elastic: report {rep}")
    check([r["alive"] for r in results] == [True, True, False, True],
          "elastic: only rank 2 should leave the run")
    check(all(r["reports"] == [rep] and r["history"] == r0["history"] for r in survivors),
          "elastic: the survivors' reports differ")
    check(all(r["losses"] == ref_losses and r["more"] == ref_more for r in survivors),
          f"elastic: the continued run is not its reference's bit for bit: "
          f"{r0['losses']} against {ref_losses}")
    check(results[2]["losses"] == ref_losses[:ELASTIC_KILL[1] + 2],
          "elastic: the killed rank's losses differ")
    check(all(r["digest"] == ref_digest and r["n_shards"] == 3 and r["ckpt_dir"] is None
              for r in survivors), "elastic: the survivors' params differ from the reference's")
    # (b)
    got, caps2, n2 = r0["from_ckpt"]
    want_caps = rederive_owner_caps(default_frontier_cap(ELASTIC_BATCH // 2, (15, 15), 256,
                                                         N_NODES), 2, explicit=caps)
    print(f"[elastic] (b) 4-rank owner:pallas checkpoint (caps {caps}) rescaled to {n2} ranks: "
          f"step loss {got} against a native 2-rank run's {r0['native2']}; caps {caps2} "
          f"(rederive_owner_caps: {want_caps}); the 4-rank run's own step {r0['owner4']}",
          flush=True)
    check(all(r["from_ckpt"] is None for r in results[2:]), "elastic: ranks 2-3 kept a runtime")
    check(all(r["from_ckpt"][0] == r["native2"] for r in results[:2]),
          "elastic: the checkpoint rescaled to 2 ranks is not a native run bit for bit")
    check(caps2 == want_caps == (14_560, 11_648), f"elastic: rescaled caps {caps2}")
    check(all("GraphRuntime.rescale" in (r["mismatch"] or "") for r in results[:2]),
          f"elastic: the 2-rank spec on the 4-rank checkpoint: {r0['mismatch']}")
    # (c)
    print(f"[elastic] (c) 2 ranks grown to 4 at step 0: step loss {r0['grown'][0]} against a "
          f"native 4-rank run's {r0['native4']}; the 2-rank runtime's own step {r0['two']}; "
          f"rescale(5): {r0['five']!r}", flush=True)
    check(all(r["grown"][0] == r["native4"] and r["grown"][1:] == (4, 4) for r in results),
          "elastic: the grown run is not a native 4-rank run bit for bit")
    check(abs(r0["two"][0] - r0["native4"][0]) <= 1e-5,
          f"elastic: the 2-rank step {r0['two']} against the 4-rank one {r0['native4']}")
    check(all("not divisible" in (r["five"] or "") for r in results),
          "elastic: rescale(5) of a batch of 192 did not raise")
    launches = {}
    for path in ("elastic", "elastic_ckpt", "elastic_grow"):
        rs = [r["launches"][path] for r in results]
        launches[path] = {k: sum(x[k] for x in rs) if k != "hash_decode_backward_by_kernel"
                          else {kk: sum(x[k][kk] for x in rs) for kk in rs[0][k]}
                          for k in rs[0]}
        check(launches[path]["hash_decode"] > 0 and launches[path]["hash_decode_backward"] > 0,
              f"{path}: the path launched no hash_decode kernel")
    print(f"[elastic] launches summed over the ranks: "
          f"{ {p: (v['hash_decode'], v['hash_decode_backward']) for p, v in launches.items()} }",
          flush=True)
    # the blocks at 4, 3 and 2 ranks and the owners' rows at 4 and 2 (a
    # batch whose owner plan overflows decodes its block instead)
    decoded = sorted(set().union(*(r["decoded_sizes"] for r in results)))
    block3 = default_frontier_cap(ELASTIC_BATCH // 3, (15, 15), 256, N_NODES)
    want_sizes = {block4, block3, default_frontier_cap(ELASTIC_BATCH // 2, (15, 15), 256,
                                                       N_NODES), caps[1], caps2[1]}
    print(f"[elastic] row counts decoded {decoded} (blocks {block4}, {block3} at 4 and 3 ranks; "
          f"owners' rows {caps[1]} at 4, {caps2[1]} at 2)", flush=True)
    check(set(decoded) <= want_sizes and {block4, block3} <= set(decoded),
          f"elastic decoded at {decoded}, not within {sorted(want_sizes)}")
    if torch.cuda.device_count() >= SHARDS:
        try:
            nccl = spawn(_elastic_rank, SHARDS, backend="nccl",
                         args=(dict(payload, kill_only=True),), timeout_s=900)
        except RuntimeError as e:
            fail(f"phase elastic over NCCL: {e}")
        alive = [r for r in nccl if r["alive"]]
        print(f"[elastic] (a) over NCCL, one card a rank: survivors on "
              f"{[r['device'] for r in alive]}; period before / after "
              f"{nccl[0]['period_before_ms']:.3f} / {nccl[0]['period_after_ms']:.3f} ms; recovery "
              f"{nccl[0]['recovery_s'][0]:.3f} s; losses bitwise the gloo run's "
              f"{nccl[0]['losses'] == r0['losses']}", flush=True)
        check(all(r["losses"] == nccl[0]["ref"][0] and r["digest"] == nccl[0]["ref"][2]
                  for r in alive), "elastic over NCCL: the continued run is not its reference's")
        check([r["device"] for r in alive] == ["cuda:0", "cuda:1", "cuda:3"],
              "elastic over NCCL: a survivor moved to another card")
    else:
        print(f"[elastic] NCCL run skipped: {torch.cuda.device_count()} card(s), it needs "
              f"{SHARDS}", flush=True)
    err = check_gnn_frontiers(decoded, "elastic decode sizes")
    return launches, {"elastic_sizes": decoded}, err


# ---------------------------------------------------------------------------
# slice 15: the moe, ssm and hybrid LM families
# ---------------------------------------------------------------------------

# training steps of granite, mamba2, musicgen and qwen2-vl, LM_BATCH x LM_SEQ
# tokens (cut from 5 for the script's time, PERF.md §4)
LM_FAMILY_STEPS = 3
# 8 prompts of 512 and 8 greedy tokens (cut from 64, then 32, for the script's
# time: granite's and zamba2's decode steps take 110-180 ms, all host-bound)
LM_FAMILY_SERVE = (8, 512, 8)
# f32 cached (single-step recurrence for the SSM layers) against uncached
# (the chunked scan) logits: ten times the dense qwen bound, for the
# recurrence's and the scan's other summation order over 64 layers and 512
# positions; a cache off by one position must miss it.  granite's
# routing is discontinuous: a router near-tie that the two paths break
# apart swaps an expert, so its rows are compared up to their first
# position whose routing differs (the count is printed).
LM_FAMILY_F32_BOUND = 1e-3
# granite's sorted-dispatch step against the dense-dispatch loss on one
# batch from one state: bf16 products summed in other orders (8 experts
# one at a time against 40 in one product) through 32 layers, averaged
# over 8,192 tokens.  On the H100 the two came 3.1e-4 apart (5e-2 was the
# bound before that run); the bound sits at 16 times that
MOE_SORTED_BOUND = 5e-3
CONTROL_STEPS = 4          # decode steps of each off-by-one control (cut from 8)
GRANITE, MAMBA2, ZAMBA2 = "granite-moe-3b-a800m", "mamba2-2.7b", "zamba2-7b"
# zamba2-7b trained at full width on one card: two groups of six Mamba2
# layers and a tail of one (the structure ``reduced`` keeps), the shared
# block at its 2 sites; 1,448,372,736 params by ``param_count()``
HYBRID_TRAIN_LAYERS, HYBRID_TRAIN_PARAMS = 13, 1_448_372_736
HYBRID_TRAIN_STEPS = 2     # cut from 3 for the script's time (PERF.md §4)


def _expected_train_launches(cfg, steps: int) -> dict:
    """A training path's launches from its config: a hash kind decodes
    once a step forward and once backward and encodes its vocabulary in one
    projection and one pack; every attention site (a layer, or a hybrid's
    shared-block call) runs flash twice a step under remat, all on the bf16
    tensor-core kernel."""
    from repro_torch.models.lm import _n_attn_sites
    hashed = cfg.embedding.kind.startswith("hash")
    attn = steps * (2 if cfg.remat else 1) * _n_attn_sites(cfg)
    return {"hash_decode": steps if hashed else 0,
            "hash_decode_backward": steps if hashed else 0,
            "lsh_encode_by_kernel": {"project": int(hashed), "pack": int(hashed), "fused": 0},
            "flash_attention_by_kernel": flash_want(bf16_wgmma=attn)}


def _train_lm_family(cfg, label: str, stream=None, moments: str = "bfloat16",
                     steps: int = LM_FAMILY_STEPS):
    """The launcher's chain from its parts (``encode_vocab``,
    ``init_train_state`` with ``moments`` Adam moments, ``make_train_step``,
    ``run_training``), as the JAX package's per-arch profile runs it, for
    ``steps`` steps on ``stream`` (a ``TokenStream`` by default);
    the launches counted around exactly this run, against
    ``_expected_train_launches``; the MFU line."""
    import numpy as np
    import torch
    from repro_torch.data import TokenStream, TokenStreamConfig
    from repro_torch.device import make_generator
    from repro_torch.launch.train import encode_vocab
    from repro_torch.nn.module import param_count
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import (LoopConfig, TrainHyper, init_train_state,
                                   make_train_step, run_training)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    zero_counts()
    generator = make_generator(0, "cuda")
    if stream is None:
        stream = TokenStream(TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=LM_SEQ,
                                               batch_size=LM_BATCH, seed=0))
    codes = encode_vocab(cfg, generator, batch=LM_BATCH, seq=LM_SEQ, cooc_batches=8, seed=0,
                         log=lambda line: print(f"[{label}] {line}", flush=True))
    state = init_train_state(generator, cfg, codes=codes, moments_dtype=getattr(torch, moments))
    hyper = TrainHyper(optimizer=AdamWConfig(lr=1e-3, weight_decay=0.01, clip_norm=1.0),
                       total_steps=steps)
    to_dev = lambda b: {k: torch.from_numpy(v).cuda() for k, v in b.items()}  # noqa: E731
    res = run_training(make_train_step(cfg, hyper), state, stream,
                       LoopConfig(total_steps=steps, log_every=1), to_device=to_dev)
    torch.cuda.synchronize()
    launches = _path_counts(label)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    n_params = param_count(res.state["params"], trainable_only=True)
    print(f"[{label}] {cfg.name} ({cfg.family}; {cfg.n_layers} layers; {n_params} trainable f32 "
          f"parameters, {moments} moments, moe_impl {cfg.moe_impl!r}, attn {cfg.attn_impl!r}, "
          f"loss_vocab_chunk {cfg.loss_vocab_chunk}, embedding {cfg.embedding.kind}) "
          f"{steps} steps of {LM_BATCH} x {LM_SEQ}: losses "
          f"{res.losses}; step ms {[round(t * 1e3, 3) for t in res.step_times]}; chain wall "
          f"{wall:.2f} s; peak max_memory_allocated {peak} B above the {base} B held before; "
          f"launches {launches}; {smi_query('name,power.limit')}", flush=True)
    check(all(np.isfinite(res.losses)), f"{label}: non-finite loss {res.losses}")
    expect = _expected_train_launches(cfg, steps)
    got = {k: launches[k] for k in expect}
    check(got == expect, f"{label}: launches {got}, expected {expect}")
    print_mfu(cfg, res.step_times, label)
    return res, stream, launches, peak


def _grad_bits_twice(params, batch, cfg, label: str) -> bool:
    """Two ``loss_and_grads`` of one batch from one state: the first
    gradient's leaves copied to the host, then the second's compared with
    them leaf by leaf, bit for bit (two gradients at once would not fit
    beside granite's masters and moments)."""
    import torch
    from repro_torch.nn.module import leaves_with_path
    from repro_torch.train.step import loss_and_grads
    loss1, grads = loss_and_grads(params, batch, cfg)
    first = {path: g.cpu() for path, g in leaves_with_path(grads)}
    del grads
    loss2, grads = loss_and_grads(params, batch, cfg)
    differ = [path for path, g in leaves_with_path(grads) if not torch.equal(g.cpu(), first[path])]
    del grads, first
    torch.cuda.empty_cache()
    same = not differ and float(loss1) == float(loss2)
    print(f"[{label}] two backward passes of one step: losses {float(loss1)} / {float(loss2)}; "
          f"gradients bitwise {same} ({len(differ)} leaves differ: {differ[:4]})", flush=True)
    check(same, f"{label}: two gradients of one step differ in {differ[:4]}")
    return same


@contextlib.contextmanager
def _routing_recorder():
    """Record the expert ids (sorted within each token's k) of every
    ``router_probs`` call while inside."""
    from repro_torch.nn import moe
    calls, plain = [], moe.router_probs

    def recorded(params, x, cfg):
        w, idx = plain(params, x, cfg)
        calls.append(idx.sort(dim=-1).values)
        return w, idx

    moe.router_probs = recorded
    try:
        yield calls
    finally:
        moe.router_probs = plain


def _lm_family_cached_check(eng, prompts, new: int) -> dict:
    """An f32 engine's generate against ``lm_forward`` without a cache over
    its final sequences, padded to a whole SSD chunk (causal, so the pad
    changes no earlier logit): max gap within ``LM_FAMILY_F32_BOUND``; a cache
    off by one position either way must miss it over the first
    ``CONTROL_STEPS`` steps.  For moe, each row is
    compared up to its first position whose routing differs between the two
    paths.  Tokens agree wherever the uncached top-2 margin exceeds twice
    the bound."""
    import numpy as np
    import torch
    from repro_torch.models.lm import lm_forward
    cfg, dev = eng.cfg, eng.device
    B, s0 = prompts.shape
    with _routing_recorder() as cached_routes:
        run = _recorded_generate(eng, prompts, new, keep=True)
    tokens = run["res"].tokens
    S = tokens.shape[1]
    pad = (-S) % cfg.ssm_chunk if cfg.family in ("ssm", "hybrid") else 0
    padded = np.concatenate([tokens, np.zeros((B, pad), tokens.dtype)], axis=1)
    with torch.inference_mode(), _routing_recorder() as full_routes:
        full, _ = lm_forward(eng.params, torch.as_tensor(padded, device=dev), cfg)
        ref = full[:, s0 - 1:S]
        del full
        first = torch.full((B,), S, device=dev)
        swapped = 0
        if cfg.family == "moe":
            L = cfg.n_layers
            differ = torch.zeros((B, S), dtype=torch.bool, device=dev)
            for layer in range(L):
                cached = torch.cat([cached_routes[layer].reshape(B, s0, -1)]
                                   + [cached_routes[L * (t + 1) + layer].reshape(B, 1, -1)
                                      for t in range(new)], dim=1)
                uncached = full_routes[layer].reshape(B, padded.shape[1], -1)[:, :S]
                differ |= (cached != uncached).any(-1)
            swapped = int(differ.sum())
            first = torch.where(differ.any(1), differ.int().argmax(1), first)
        pos = torch.arange(new + 1, device=dev) + s0 - 1
        valid = pos[None, :] < first[:, None]                      # (B, new + 1)
        per_step = (ref - run["logits"]).abs().amax(-1)
        gap = float(torch.where(valid, per_step, 0.0).max())
        # the controls over the first CONTROL_STEPS decode steps: an
        # off-by-one position shows from the first
        faulted = {shift: _faulted_gap(eng, tokens[:, :s0 + CONTROL_STEPS], s0, ref, shift)
                   for shift in (1, -1)}
        top2 = ref[..., :cfg.vocab_size].topk(2, dim=-1)
        margin = (top2.values[..., 0] - top2.values[..., 1])[:, :-1]
        agree = (top2.indices[:, :-1, 0].cpu().numpy() == tokens[:, s0:])
        sure = ((margin > 2 * LM_FAMILY_F32_BOUND) & valid[:, :-1]).cpu().numpy()
        scale = float(ref.abs().max())
    print(f"[{cfg.name}] f32 cached against uncached ({B} x {new + 1} steps, the uncached "
          f"forward over {padded.shape[1]} tokens): max abs diff {gap} over "
          f"{int(valid.sum())} compared steps (bound {LM_FAMILY_F32_BOUND}; largest |logit| "
          f"{scale}); routing swaps between the paths {swapped} (token, layer) pairs, rows "
          f"cut at positions {first.tolist()}; a cache off by +1 / -1 position ({CONTROL_STEPS} "
          f"steps): "
          f"{faulted[1]} / {faulted[-1]}; tokens where the uncached top-2 margin > "
          f"{2 * LM_FAMILY_F32_BOUND}: {int((agree & sure).sum())} of {int(sure.sum())} agree",
          flush=True)
    check(gap <= LM_FAMILY_F32_BOUND, f"{cfg.name}: cached and uncached f32 logits differ by {gap}")
    check(int(valid.sum()) >= (new + 1) * B // 2,
          f"{cfg.name}: routing swaps left {int(valid.sum())} steps to compare")
    for shift, fgap in faulted.items():
        check(fgap > LM_FAMILY_F32_BOUND, f"{cfg.name}: a cache off by {shift:+d} position stays "
                                       f"within the bound ({fgap})")
    check(bool(agree[sure].all()), f"{cfg.name}: tokens with a clear margin differ from uncached")
    return dict(f32_gap=gap, f32_offby1=faulted, routing_swaps=swapped)


def _dense_cached_check(eng, prompts, new: int) -> dict:
    """An f32 dense engine's cached logits against the uncached forward
    within ``SERVE_F32_BOUND``, where a cache off by one position must miss."""
    s0 = prompts.shape[1]
    return dict(f32_gap=_check_cached_against_uncached(
        eng, _recorded_generate(eng, prompts, new, keep=True), s0, SERVE_F32_BOUND,
        controls=True))


def _serve_lm_family(cfg, params, label: str, seed: int, decodes=None,
                     f32_check=_lm_family_cached_check) -> tuple:
    """``DecodeEngine`` on the kernel and on ``gather`` (bitwise; ``decodes``
    as ``_serve_pair``'s), an f32 engine checked by ``f32_check(eng,
    prompts, new)`` against the uncached forward (none if None), then the
    timed bf16 run: prefill, per-token, tokens/s, the cache's bytes (KV and
    SSM) and peak memory.  Audio prompts are (B, s0, n_codebooks)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core.backend import torch_dtype
    from repro_torch.models.lm import _n_attn_sites, _n_ssm_layers, ssm_config
    from repro_torch.serving import DecodeEngine
    B, s0, new = LM_FAMILY_SERVE
    card = smi_query("name,power.limit")
    streams = (cfg.n_codebooks,) if cfg.input_mode == "audio_tokens" else ()
    prompts = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, s0) + streams)
    eng, run, launches = _serve_pair(cfg, params, prompts, new, label, decodes=decodes)
    check(bool(run["logits"].isfinite().all()), f"{label}: non-finite logits")
    del run
    out = {}
    if f32_check is not None:
        f32 = DecodeEngine(dataclasses.replace(cfg, compute_dtype="float32"), params,
                           s_max=SERVE_S_MAX, decode_backend="auto")
        out = f32_check(f32, prompts, new)
        del f32
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    timed = _recorded_generate(eng, prompts, new, timed=True)
    peak = torch.cuda.max_memory_allocated() - base
    elem = torch_dtype(cfg.compute_dtype).itemsize
    expect = 2 * _n_attn_sites(cfg) * B * SERVE_S_MAX * cfg.n_kv_heads * cfg.head_dim * elem
    if _n_ssm_layers(cfg):
        s = ssm_config(cfg)
        expect += _n_ssm_layers(cfg) * B * (s.n_heads * s.d_state * s.headdim * 4
                                            + (s.conv_width - 1) * s.conv_channels * elem)
    check(timed["cache_bytes"] == expect, f"{label}: cache {timed['cache_bytes']} B, "
                                          f"expected {expect}")
    print(f"[{label}] {cfg.name} ({cfg.n_layers} layers) B={B}, prompt {s0}"
          f"{' x ' + str(streams[0]) + ' codebooks' if streams else ''}, {new} new tokens, "
          f"s_max {SERVE_S_MAX}, bf16: prefill {timed['prefill_ms']:.3f} ms; per-token decode "
          f"{timed['per_token_ms']:.3f} ms (median of steps 2-{new}); "
          f"{B / timed['per_token_ms'] * 1e3:.1f} tokens/s; generate wall "
          f"{timed['wall_ms']:.3f} ms; cache {timed['cache_bytes']} B (KV and SSM); params "
          f"{_nbytes(params)} B; peak max_memory_allocated over that generate {peak} B above "
          f"the {base} B held; {card}", flush=True)
    _serve_breakdown(eng, prompts)
    del eng
    torch.cuda.empty_cache()
    out.update({k: v for k, v in timed.items() if k not in ("step_ms", "res")}, peak=peak)
    return launches, out


def phase_moe() -> tuple:
    """granite-moe-3b-a800m at full width: 5 training steps on JAX's
    profile (dense dispatch, bf16 moments, flash attention), two gradients
    of one step bitwise, one step of the sorted dispatch from the same
    state against the dense loss, one dense step's breakdown, then the
    trained params served."""
    import dataclasses
    import torch
    from repro_torch.models.lm import lm_loss
    from repro_torch.train import TrainHyper, make_train_step
    t_phase = time.perf_counter()
    cfg = _serve_cfg(GRANITE, attn_impl="flash", moe_impl="dense")
    res, stream, train_launches, peak = _train_lm_family(cfg, "moe_train")
    state = res.state
    batch = {k: torch.from_numpy(v).cuda() for k, v in stream.next_batch().items()}
    _grad_bits_twice(state["params"], batch, cfg, "moe_train")
    with torch.no_grad():
        dense_loss = float(lm_loss(state["params"], batch, cfg))
    sorted_cfg = dataclasses.replace(cfg, moe_impl="ep")
    step = make_train_step(sorted_cfg, TrainHyper(total_steps=LM_FAMILY_STEPS + 1))
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    state, m = step(state, batch)
    sorted_loss = float(m["loss"])
    sorted_ms = (time.perf_counter() - t0) * 1e3
    sorted_launches = _path_counts("moe_sorted")
    print(f"[moe_train] one step of the sorted dispatch (moe_impl 'ep', one device) from the "
          f"trained state: loss {sorted_loss} against the dense dispatch's {dense_loss} on the "
          f"same batch (diff {abs(sorted_loss - dense_loss)}, bound {MOE_SORTED_BOUND}); step "
          f"{sorted_ms:.3f} ms (host clock, 32 read-backs of the group sizes); launches "
          f"{sorted_launches}", flush=True)
    check(abs(sorted_loss - dense_loss) <= MOE_SORTED_BOUND,
          f"sorted dispatch loss {sorted_loss} against dense {dense_loss}")
    check(sorted_launches["hash_decode"] == 1 and sorted_launches["hash_decode_backward"] == 1,
          f"moe_sorted launches {sorted_launches}")
    train_breakdown(make_train_step(cfg, TrainHyper(total_steps=LM_FAMILY_STEPS + 3)), state,
                    batch, cfg.name)
    params = state["params"]
    del state, res, batch
    torch.cuda.empty_cache()
    serve_launches, served = _serve_lm_family(_serve_cfg(GRANITE), params, "moe_serve", seed=9)
    del params
    torch.cuda.empty_cache()
    print(f"[moe] phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return ({"moe_train": train_launches, "moe_sorted": sorted_launches,
             "moe_serve": serve_launches},
            dict(train_peak=peak, sorted_loss=sorted_loss, dense_loss=dense_loss,
                 sorted_step_ms=sorted_ms, serve=served))


def _ssd_exp_before_mask_grad(L: int, H: int, seed: int = 0, device: str = "cuda") -> tuple:
    """The intra-chunk decay of one 128-step chunk at mamba2's 80 heads and
    its dt range, in the JAX package's order (exp over the whole block,
    then the causal mask) and in the port's (mask to -inf, then exp): the
    two forward values and whether each dt gradient is finite."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand((1, L, H), generator=gen, device=device)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3)).requires_grad_(True)
    A = -torch.arange(1, H + 1, dtype=torch.float32, device=device)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool, device=device))[..., None]
    out = {}
    for order in ("jax", "port"):
        cs = torch.cumsum(dt * A, dim=1)[0]
        dec = cs[:, None, :] - cs[None, :, :]
        M = (torch.where(causal, torch.exp(dec), 0.0) if order == "jax"
             else torch.exp(dec.masked_fill(~causal, -math.inf)))
        g, = torch.autograd.grad(M.sum(), dt)
        out[order] = (M.detach(), bool(g.isfinite().all()))
    return torch.equal(out["jax"][0], out["port"][0]), out["jax"][1], out["port"][1]


def phase_ssm() -> tuple:
    """mamba2-2.7b at full width: 5 training steps on JAX's profile (bf16
    moments, ``loss_vocab_chunk=6304``), one step's breakdown, then the
    trained params served."""
    import torch
    t_phase = time.perf_counter()
    same, jax_finite, port_finite = _ssd_exp_before_mask_grad(128, 80)
    print(f"[ssm_train] SSD intra-chunk decay at 80 heads, 128 steps, mamba2's dt range: the "
          f"same forward values {same}; dt gradient finite with the exp before the mask (the "
          f"JAX package's order) {jax_finite}, with the mask first (the port's) "
          f"{port_finite}", flush=True)
    check(same and port_finite and not jax_finite,
          "the SSD mask control did not show the overflow it guards against")
    cfg = _serve_cfg(MAMBA2, loss_vocab_chunk=6304)
    res, stream, train_launches, peak = _train_lm_family(cfg, "ssm_train")
    _train_breakdown_from(cfg, res.state, stream)
    params = res.state["params"]
    del res
    torch.cuda.empty_cache()
    serve_launches, served = _serve_lm_family(_serve_cfg(MAMBA2), params, "ssm_serve", seed=10)
    del params
    torch.cuda.empty_cache()
    print(f"[ssm] phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return ({"ssm_train": train_launches, "ssm_serve": serve_launches},
            dict(train_peak=peak, serve=served))


def phase_hybrid() -> tuple:
    """zamba2-7b at full width: ``HYBRID_TRAIN_LAYERS`` of its 81 layers
    trained ``HYBRID_TRAIN_STEPS`` steps on its JAX profile (bf16 moments,
    ``loss_vocab_chunk=4000``) through flash at its heads of 112 (at 81
    layers its masters and moments do not fit one card); then all 81
    served: ``init_lm``'s peak beside the masters' bytes, then the
    engines."""
    import torch
    from repro_torch.models.lm import _n_attn_sites, init_lm
    t_phase = time.perf_counter()
    train_cfg = _serve_cfg(ZAMBA2, attn_impl="flash", loss_vocab_chunk=4000,
                           n_layers=HYBRID_TRAIN_LAYERS)
    check(train_cfg.head_dim == 112 and _n_attn_sites(train_cfg) == 2
          and train_cfg.param_count() == HYBRID_TRAIN_PARAMS,
          f"hybrid_train: {train_cfg.n_layers} layers, heads of {train_cfg.head_dim}, "
          f"{_n_attn_sites(train_cfg)} shared-block sites, {train_cfg.param_count()} params")
    res, _, train_launches, train_peak = _train_lm_family(train_cfg, "hybrid_train",
                                                          steps=HYBRID_TRAIN_STEPS)
    del res
    cfg = _serve_cfg(ZAMBA2)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = init_lm(torch.Generator("cuda").manual_seed(2), cfg)
    init_peak = torch.cuda.max_memory_allocated() - base
    masters = _nbytes(params)
    print(f"[hybrid] {cfg.name} init_lm: peak max_memory_allocated {init_peak} B for "
          f"{masters} B of params ({init_peak / masters:.3f}x; each layer drawn into the "
          f"preallocated stack)", flush=True)
    check(init_peak < 1.1 * masters, f"init_lm peak {init_peak} B for {masters} B of params")
    serve_launches, served = _serve_lm_family(cfg, params, "hybrid_serve", seed=11)
    del params
    torch.cuda.empty_cache()
    print(f"[hybrid] phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return ({"hybrid_train": train_launches, "hybrid_serve": serve_launches},
            dict(train_peak=train_peak, init_peak=init_peak, masters=masters, serve=served))


def _reduced_reference(cases) -> float:
    """Each (arch, fields) of ``cases`` reduced, in f32 on the card (the
    kernels) and on the CPU (plain versions) from one init: 3 training
    steps' losses within 1e-4 (the LM's card-against-CPU bound), on
    ``_train_stream``'s batches, then served (``_served_on_card_and_cpu``)."""
    import dataclasses
    import torch
    from repro_torch.configs import reduced
    from repro_torch.models.lm import init_lm
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train import TrainHyper, make_train_step
    worst = 0.0
    for arch, fields in cases:
        cfg = reduced(_serve_cfg(arch, **fields))
        cfg = dataclasses.replace(cfg, embedding=dataclasses.replace(
            cfg.embedding, lookup_impl="pallas"))
        params = init_lm(torch.Generator().manual_seed(0), cfg)
        states = {dev: {"params": _snapshot(params, dev), "step": 0} for dev in ("cuda", "cpu")}
        for s in states.values():
            s["opt"] = adamw_init(s["params"])
        step = make_train_step(cfg, TrainHyper(warmup_steps=1, total_steps=3))
        stream = _train_stream(cfg, 128, 4, seed=3)
        losses = []
        for _ in range(3):
            b = stream.next_batch()
            losses.append([float(step(states[dev], {k: torch.from_numpy(v).to(dev)
                                                    for k, v in b.items()})[1]["loss"])
                           for dev in ("cuda", "cpu")])
        train_gap = max(abs(a - b) for a, b in losses)
        print(f"[reference] reduced {arch} {fields or ''}: card (kernels) and CPU (plain), 3 "
              f"steps' (card, CPU) losses {losses}, max diff {train_gap}", flush=True)
        check(train_gap <= 1e-4, f"reduced {arch}: card and CPU losses differ by {train_gap}")
        serve_gap = _served_on_card_and_cpu(cfg, params, f"{arch} {fields or ''}".strip())
        worst = max(worst, train_gap, serve_gap)
    return worst


def _lm_family_reference() -> tuple:
    """Reduced granite (both dispatches), mamba2 and zamba2 on card and CPU,
    zamba2's shared block through flash (the f32 kernel at its 2 sites a
    step); the gap and the launches, counted around the four."""
    zero_counts()
    gap = _reduced_reference(((GRANITE, {}), (GRANITE, {"moe_impl": "dense"}), (MAMBA2, {}),
                              (ZAMBA2, {"attn_impl": "flash"})))
    launches = _path_counts("families_reference")
    want = flash_want(f32_cuda_core=3 * 2)
    check(launches["flash_attention_by_kernel"] == want,
          f"families_reference launched flash {launches['flash_attention_by_kernel']}, "
          f"expected {want}")
    return gap, launches


def phase_lm_families() -> tuple:
    """Phases moe, ssm and hybrid, the families' reduced configs on card and
    CPU, and hash_decode bitwise at their paths' row counts."""
    t_phase = time.perf_counter()
    launches, out = {}, {}
    for phase in (phase_moe, phase_ssm, phase_hybrid):
        counts, info = phase()
        launches.update(counts)
        out[phase.__name__[len("phase_"):]] = info
    out["reference_gap"], launches["families_reference"] = _lm_family_reference()
    # training decodes LM_BATCH x LM_SEQ rows a step, serving B x prompt rows
    # in the prefill and B a decode step; the masters' f32 codebooks
    B, s0, _ = LM_FAMILY_SERVE
    sizes = [LM_BATCH * LM_SEQ, B * s0, B]
    out["max_abs_err"] = max(check_decode_case((rows, 16, 256, 512), variant, seed=60 + i)
                             for i, rows in enumerate(sizes)
                             for variant in ("float32", "bfloat16"))
    out["families_sizes"] = sizes
    print(f"[families] phases moe, ssm, hybrid and the reduced references: "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches, out


# ---------------------------------------------------------------------------
# slice 16: the audio and vlm LM families
# ---------------------------------------------------------------------------

MUSICGEN, QWEN2_VL = "musicgen-large", "qwen2-vl-7b"
# qwen2-vl-7b trains on 14 of its 28 layers: at 28 its f32 masters, f32
# gradients and bf16 moments come to ~85 GB, more than the card holds
VLM_TRAIN_LAYERS = 14
VL_GRID = 32               # a sequence's image: 32 x 32 patches of its 2,048 positions


def vl_positions(batch: int, seq: int, grid: int):
    """Test data, not a library function: (3, B, S) M-RoPE positions of a
    text / image / text sequence as Qwen2-VL lays them out.  Text positions
    are equal in all three streams; row b's ``grid`` x ``grid`` image span
    starts at text position ``st = grid * (b + 1)``, where the temporal
    stream holds ``st`` and height and width ``st`` + the patch's row and
    column; the text after it goes on from the largest position + 1."""
    import numpy as np
    pos = np.empty((3, batch, seq), np.int32)
    rows, cols = np.divmod(np.arange(grid * grid), grid)
    for b in range(batch):
        st = grid * (b + 1)
        end = st + grid * grid
        pos[:, b, :st] = np.arange(st)
        pos[:, b, st:end] = st
        pos[1, b, st:end] += rows
        pos[2, b, st:end] += cols
        pos[:, b, end:] = st + grid + np.arange(seq - end)
    return pos


class _AudioStream:
    """Random (B, S, nq) codebook tokens and their labels from a numpy seed:
    the JAX package has no audio token stream, and its tests build the batch
    so."""

    def __init__(self, cfg, seq: int, batch: int, seed: int):
        import numpy as np
        self.rng = np.random.default_rng(seed)
        self.shape = (batch, seq + 1, cfg.n_codebooks)
        self.vocab = cfg.vocab_size

    def next_batch(self):
        import numpy as np
        toks = self.rng.integers(0, self.vocab, self.shape).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class _VLStream:
    """A ``TokenStream``'s batches with ``vl_positions``' (3, B, S)
    M-RoPE positions."""

    def __init__(self, cfg, seq: int, batch: int, seed: int):
        from repro_torch.data import TokenStream, TokenStreamConfig
        self.tokens = TokenStream(TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                                    batch_size=batch, seed=seed))
        grid = VL_GRID        # the largest that fits every row's image
        while grid * batch + grid * grid > seq:
            grid -= 1
        self.positions = vl_positions(batch, seq, grid)

    def next_batch(self):
        return dict(self.tokens.next_batch(), positions=self.positions)


def _train_stream(cfg, seq: int, batch: int, seed: int):
    """The batches a config trains on: audio streams, M-RoPE positions, or
    the token stream."""
    if cfg.input_mode == "audio_tokens":
        return _AudioStream(cfg, seq, batch, seed)
    if cfg.input_mode == "tokens_mrope":
        return _VLStream(cfg, seq, batch, seed)
    from repro_torch.data import TokenStream, TokenStreamConfig
    return TokenStream(TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                         batch_size=batch, seed=seed))


def _train_breakdown_from(cfg, state, stream) -> None:
    """One more step of ``cfg`` from ``state``, under the stage timer and
    the profiler."""
    import torch
    from repro_torch.train import TrainHyper, make_train_step
    batch = {k: torch.from_numpy(v).cuda() for k, v in stream.next_batch().items()}
    train_breakdown(make_train_step(cfg, TrainHyper(total_steps=LM_FAMILY_STEPS + 3)), state,
                    batch, cfg.name)


def _musicgen_hash(batch) -> dict:
    """musicgen-large under ``hash_full``: codes from Algorithm 1 over the
    2,048-entry vocabulary, tiled x 4 by ``init_lm``; one
    ``loss_and_grads`` on the kernel (``pallas``) and one on ``gather``
    from the same init: the loss and the codebook gradient bitwise."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.device import make_generator
    from repro_torch.launch.train import encode_vocab
    from repro_torch.models.lm import init_lm
    from repro_torch.train.step import loss_and_grads
    cfgs = {impl: get_config(MUSICGEN, attn_impl="flash", embedding=dataclasses.replace(
        _hash_full(MUSICGEN), lookup_impl=impl)) for impl in ("pallas", "gather")}
    torch.cuda.empty_cache()
    zero_counts()
    generator = make_generator(0, "cuda")
    codes = encode_vocab(cfgs["pallas"], generator, batch=LM_BATCH, seq=LM_SEQ, cooc_batches=8,
                         seed=0, log=lambda line: print(f"[musicgen_hash] {line}", flush=True))
    params = init_lm(generator, cfgs["pallas"], codes=codes)
    buf, V, nq = params["embed"]["codes_buf"], cfgs["pallas"].vocab_padded, cfgs["pallas"].n_codebooks
    rows = buf.shape[0]
    tiled = rows == nq * V and all(torch.equal(buf[q * V:(q + 1) * V], buf[:V]) for q in range(nq))
    out = {}
    for impl, cfg in cfgs.items():
        t0 = time.perf_counter()
        loss, grads = loss_and_grads(params, batch, cfg)
        out[impl] = (float(loss), grads["embed"]["decoder"]["codebooks"].clone(),
                     time.perf_counter() - t0)
        del grads
        if impl == "pallas":
            torch.cuda.synchronize()
            launches = _path_counts("musicgen_hash")
    torch.cuda.empty_cache()
    (lp, gp, tp), (lg, gg, tg) = out["pallas"], out["gather"]
    same = lp == lg and torch.equal(gp, gg)
    print(f"[musicgen_hash] {MUSICGEN} under hash_full ({rows} code rows, the {V}-entry "
          f"vocabulary's tiled x {nq}: {tiled}): loss_and_grads on the kernel {lp} ({tp:.2f} s) "
          f"and on gather {lg} ({tg:.2f} s); codebook gradient {tuple(gp.shape)} {gp.dtype}, "
          f"norm {float(gp.float().norm())}; loss and codebook gradient bitwise {same} (max "
          f"diff {float((gp.float() - gg.float()).abs().max())}); launches {launches}; "
          f"{smi_query('name,power.limit')}", flush=True)
    check(tiled, f"musicgen_hash: {rows} code rows, tiled {tiled}")
    check(same, "musicgen_hash: the kernel's loss or codebook gradient differs from gather's")
    expect = _expected_train_launches(cfgs["pallas"], 1)
    got = {k: launches[k] for k in expect}
    check(got == expect, f"musicgen_hash: launches {got}, expected {expect}")
    del params, gp, gg
    torch.cuda.empty_cache()
    return launches


def phase_audio() -> tuple:
    """musicgen-large at full width: 5 training steps on its JAX profile
    (f32 moments, one microbatch, flash attention) over random 4-codebook
    tokens, two gradients of one batch bitwise, one step's breakdown; the
    ``hash_full`` ablation's kernel against gather; the trained (dense)
    params served."""
    import torch
    t_phase = time.perf_counter()
    cfg = _serve_cfg(MUSICGEN, attn_impl="flash")
    res, stream, train_launches, peak = _train_lm_family(
        cfg, "musicgen_train", stream=_AudioStream(cfg, LM_SEQ, LM_BATCH, seed=0),
        moments="float32")
    batch = {k: torch.from_numpy(v).cuda() for k, v in stream.next_batch().items()}
    _grad_bits_twice(res.state["params"], batch, cfg, "musicgen_train")
    _train_breakdown_from(cfg, res.state, stream)
    params = res.state["params"]
    del res
    torch.cuda.empty_cache()
    hash_launches = _musicgen_hash(batch)
    del batch
    serve_launches, served = _serve_lm_family(_serve_cfg(MUSICGEN), params, "musicgen_serve",
                                              seed=12, decodes=0, f32_check=_dense_cached_check)
    del params
    torch.cuda.empty_cache()
    print(f"[audio] phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return ({"musicgen_train": train_launches, "musicgen_hash": hash_launches,
             "musicgen_serve": serve_launches}, dict(train_peak=peak, serve=served))


def _mrope_control(params, cfg, batch) -> dict:
    """One batch's loss (no gradient) with three equal position streams,
    with standard RoPE on the same params and positions, and with the
    batch's distinct streams: the first two bitwise, the third not."""
    import dataclasses
    import torch
    from repro_torch.models.lm import lm_loss
    text = torch.arange(LM_SEQ, dtype=torch.int32, device="cuda")[None].expand(LM_BATCH, LM_SEQ)
    with torch.no_grad():
        equal = float(lm_loss(params, dict(batch, positions=text[None].expand(3, -1, -1)), cfg))
        standard = float(lm_loss(params, dict(batch, positions=text),
                                 dataclasses.replace(cfg, rope_variant="standard")))
        distinct = float(lm_loss(params, batch, cfg))
    print(f"[vlm_train] M-RoPE control on the trained params: three equal streams {equal}, "
          f"standard RoPE {standard} (bitwise {equal == standard}); the batch's distinct "
          f"streams ({VL_GRID} x {VL_GRID} image spans) {distinct} (diff "
          f"{abs(distinct - equal)})", flush=True)
    check(equal == standard, f"M-RoPE with equal streams {equal} != standard RoPE {standard}")
    check(distinct != equal, "the distinct M-RoPE streams gave the equal streams' loss")
    return dict(equal=equal, standard=standard, distinct=distinct)


def phase_vlm() -> tuple:
    """qwen2-vl-7b at full width: 14 of its 28 layers trained 5 steps on its
    JAX profile (bf16 moments, ``loss_vocab_chunk=19008``, flash, the
    vocabulary's Algorithm 1 through ``lsh_encode``) on batches with
    distinct M-RoPE streams, the equal-streams control and one step's
    breakdown; then all 28 layers served."""
    import torch
    from repro_torch.models.lm import init_lm
    t_phase = time.perf_counter()
    cfg = _serve_cfg(QWEN2_VL, attn_impl="flash", loss_vocab_chunk=19_008,
                     n_layers=VLM_TRAIN_LAYERS)
    res, stream, train_launches, peak = _train_lm_family(
        cfg, "vlm_train", stream=_VLStream(cfg, LM_SEQ, LM_BATCH, seed=0))
    batch = {k: torch.from_numpy(v).cuda() for k, v in stream.next_batch().items()}
    control = _mrope_control(res.state["params"], cfg, batch)
    _train_breakdown_from(cfg, res.state, stream)
    del res, batch
    torch.cuda.empty_cache()
    serve_cfg = _serve_cfg(QWEN2_VL)
    params = init_lm(torch.Generator("cuda").manual_seed(3), serve_cfg)
    serve_launches, served = _serve_lm_family(serve_cfg, params, "vlm_serve", seed=13,
                                              f32_check=None)
    del params
    torch.cuda.empty_cache()
    print(f"[vlm] phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return ({"vlm_train": train_launches, "vlm_serve": serve_launches},
            dict(train_peak=peak, control=control, serve=served))


def phase_audio_vlm() -> tuple:
    """Phases audio and vlm, their reduced configs on card and CPU, and
    hash_decode bitwise at the audio path's 32,768 rows (the vlm paths'
    8,192 / 4,096 / 8 are the families' sizes)."""
    t_phase = time.perf_counter()
    launches, out = {}, {}
    for phase in (phase_audio, phase_vlm):
        counts, info = phase()
        launches.update(counts)
        out[phase.__name__[len("phase_"):]] = info
    out["reference_gap"] = _reduced_reference(
        ((MUSICGEN, {}), (MUSICGEN, {"embedding": _hash_full(MUSICGEN)}), (QWEN2_VL, {})))
    rows = LM_BATCH * LM_SEQ * 4
    out["max_abs_err"] = max(check_decode_case((rows, 16, 256, 512), variant, seed=70 + i)
                             for i, variant in enumerate(("float32", "bfloat16")))
    out["audio_vlm_sizes"] = [rows]
    print(f"[audio_vlm] phases audio, vlm and the reduced references: "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches, out


# ---------------------------------------------------------------------------
# phase lm_ranks: the LM across 4 ranks of torch.distributed on the card
# ---------------------------------------------------------------------------

LM_RANKS = 4
LM_MESH = (2, 2)                   # (data, model)
LM_TP_STEPS, LM_TP_REPEAT = 3, 2   # lm_tp's run (cut from 5), then a second run of 2 steps
LM_DP_STEPS = 3
MOE_EP_STEPS = 2                   # cut from 3: the phase took 252.4 s at 3 (PERF.md §4)
PIPE_STAGES, PIPE_LAYERS, PIPE_MICRO = 4, 6, 8     # 6 of qwen's 24 blocks a stage
SSM_TP_STEPS = 2                   # mamba2 under TP over its SSD heads (ssm_tp)
SSM_TP_LAYERS = 32                 # ssm_tp's and serve_ssm_tp's mamba2, cut from 64 (PERF.md §4)
# the serving paths across ranks: (prompts, prompt length, greedy steps);
# f32 activations, so that 4 ranks against one read the order of the
# ranks' f32 sums, not bf16 roundings of partial sums
SERVE_TP = (4, 512, 8)             # qwen1.5-0.5b on (2, 2); 8 steps, cut from 16
SERVE_SSM_TP = (4, 256, 4)         # mamba2-2.7b on (2, 2)
SERVE_SPLIT_KV = (4, 512, 8)       # chatglm3-6b on (1, 4): its 2 KV heads do not divide 4
SPLIT_KV_LAYERS = 4                # chatglm3-6b cut to 4 of its 28 layers
CHATGLM = "chatglm3-6b"
# each serving step's logits, 4 ranks against the one-rank steps on the
# same params and tokens, f32: the families' f32 bound (the SSM recurrence
# against the chunked scan over 64 layers)
SERVE_RANKS_BOUND = 1e-3
DRY_PEAK_TOL = 0.2                 # the dry run's peak a rank against the card's, relative
LM_RANKS_REF = ROOT / "build" / "lm_ranks_ref"
# the 4-rank step-0 loss against the one-rank step's from the same init and
# batch (relative): bf16 products split over the model axis sum in another
# order.  On the H100 it came to 4.3e-6 under TP and 7.7e-8 under DP
# (PERF.md §6); the bound sits at about ten times the larger
LM_RANKS_LOSS_BOUND = 5e-5
# the gathered params after step 1 against the one-rank step's: JAX's own
# bound for its sharded step (tests/test_parallel.py).  At lr 1e-3 and
# warmup 100, step 0 moves a weight by about 1e-5, so this bound cannot see
# the gradient: the gradient check below does
LM_RANKS_RTOL, LM_RANKS_ATOL = 5e-3, 5e-4
# the step-0 gradient blocks of every rank against the one-rank step's
# gradient of the path's config, max |g - g_ref| / max |g_ref| over each
# leaf's block, and the clip's global norm (relative).  On the H100 they
# read 0.0217 / 0.0051 and 6.2e-4 / 8.9e-6 (lm_tp / lm_dp), and a data
# rank's gradient before the data axis's sum, which must fail the bound,
# 0.755 (PERF.md §6)
LM_RANKS_GRAD_BOUND, LM_RANKS_NORM_BOUND = 5e-2, 1e-2
PIPE_OUT_TOL, PIPE_GRAD_TOL = 2e-5, 1e-4
REDUCED_RANKS_BOUND = 1e-4
COMPRESS_CHECK = 1 << 16           # elements of each leaf checked against the plain version


def _rank_mesh(shape=LM_MESH):
    from repro_torch.launch.mesh import make_host_mesh
    return make_host_mesh(*shape)


def _bits_digest(t) -> int:
    """A leaf's bits as one integer (its 32-bit words summed as int64)."""
    import torch
    t = t.detach().contiguous()
    if t.element_size() == 2:
        t = t.view(torch.int16).to(torch.int64)
    elif t.dtype.is_floating_point:
        t = t.view(torch.int32).to(torch.int64)
    return int(t.sum())


def _replicated_digests(state, specs, mesh) -> bool:
    """Every leaf that is whole on some ranks (every param leaf whose spec
    leaves an axis out) holds the same bits on all of them: each rank's
    digests of all its leaves, all-gathered, compared among the ranks that
    should hold the same block."""
    import torch
    from repro_torch.nn.module import leaves_with_path
    from repro_torch.parallel.sharding import _axes_tuple
    rows, keys = [], []
    for path, t in leaves_with_path(state["params"]):
        spec = specs["params"]
        for k in path:
            spec = spec[k]
        rows.append(_bits_digest(t))
        keys.append({a for axes in spec for a in _axes_tuple(axes)})
    mine = torch.tensor(rows, dtype=torch.int64, device=mesh.device)
    every = [x.tolist() for x in mesh.all_gather(mine, mesh.axis_names, name="check")]
    coords = [mesh.spec.coords(r) for r in range(mesh.size)]
    for i, used in enumerate(keys):
        groups = {}
        for r, c in enumerate(coords):
            groups.setdefault(tuple(c[a] for a in sorted(used)), set()).add(every[r][i])
        if any(len(v) > 1 for v in groups.values()):
            return False
    return True


def _timed_steps(step, state, stream, steps, mesh, on_step=None):
    """``steps`` steps of the stream's global batches: losses, host-clock
    step times (each ending in a synchronise), the mesh's bytes a step, and
    ``max_memory_allocated`` before the first step and over each step
    (the peak is reset before each)."""
    import torch
    losses, times, per_step, peaks = [], [], [], []
    for i in range(steps):
        batch = stream.next_batch()
        before = dict(mesh.stats)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated())
        losses.append(loss)
        per_step.append({k: v - before.get(k, 0) for k, v in mesh.stats.items()
                         if not k.endswith("_calls")})
        if on_step is not None:
            on_step(i, state)
    return state, losses, times, per_step, peaks


def _blocks_against(state, ref_path, specs, mesh) -> dict:
    """This rank's param blocks against the same blocks of the one-rank
    step's params (``torch.load``ed, memory-mapped): the largest gap over
    JAX's allclose bound and the largest absolute gap."""
    import torch
    from repro_torch.nn.module import leaves_with_path
    from repro_torch.parallel import policy
    ref = torch.load(ref_path, mmap=True, weights_only=True)
    worst, gap = 0.0, 0.0
    coords = mesh.coords
    for path, t in leaves_with_path(state["params"]):
        if not t.is_floating_point():
            continue
        spec = specs["params"]
        for k in path:
            spec = spec[k]
        whole = ref["/".join(path)]
        want = whole[policy.block_slices(whole.shape, spec, mesh, coords)].to(t.device)
        d = (t - want).abs()
        gap = max(gap, float(d.max()))
        worst = max(worst, float((d / (LM_RANKS_ATOL + LM_RANKS_RTOL * want.abs())).max()))
    return {"over_bound": worst, "max_abs": gap}


def _grad_gap(got, want) -> float:
    """max |got - want| / max |want|."""
    d = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    return d / scale if scale else (0.0 if d == 0 else float("inf"))


def _grads_against(grads, ref_path, specs, mesh) -> tuple:
    """This rank's gradient blocks against the same blocks of the one-rank
    step's gradient (``torch.load``ed, memory-mapped): the worst leaf's
    ``_grad_gap`` and its name."""
    import torch
    from repro_torch.nn.module import leaves_with_path
    from repro_torch.parallel import policy
    ref = torch.load(ref_path, mmap=True, weights_only=True)
    worst = (0.0, "")
    for path, g in leaves_with_path(grads):
        spec = specs["params"]
        for k in path:
            spec = spec[k]
        whole = ref["/".join(path)]
        want = whole[policy.block_slices(whole.shape, spec, mesh, mesh.coords)].to(g.device)
        worst = max(worst, (_grad_gap(g, want), "/".join(path)))
    return worst


def _lm_rank_run(cfg, strategy, steps, mesh, moments, ref_path=None, grads_ref=None,
                 grads_at=None, ep_check=False, profile=False):
    """One rank's training run: encode, init the rank's blocks, ``steps``
    steps; launches counted around exactly this run.  ``grads_ref``: step
    0's gradient blocks and clip norm held against the one-rank step's.
    ``profile``: one more step, rank 0's under torch.profiler (its device
    busy share and kernels)."""
    import torch
    import repro_torch.train.step as step_mod
    from repro_torch.data import TokenStream, TokenStreamConfig
    from repro_torch.device import make_generator
    from repro_torch.launch.train import encode_vocab
    from repro_torch.nn.module import leaves_with_path
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel import policy
    from repro_torch.train import TrainHyper, init_train_state, make_train_step
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    zero_counts()
    t0 = time.perf_counter()
    gen = make_generator(0, "cuda")
    codes = encode_vocab(cfg, gen, batch=LM_BATCH, seq=LM_SEQ, cooc_batches=8, seed=0,
                         log=lambda line: None)
    out = {"same_codes": True, "replicated_equal": []}
    if codes is not None:
        dig = torch.tensor([_bits_digest(codes)], device=mesh.device)
        out["same_codes"] = len({int(x) for x in mesh.all_gather(dig, mesh.axis_names,
                                                                 name="check")}) == 1
    # the init's peak above what the rank held before it: at most its state
    # (its blocks and their moments) and one whole leaf drawn beside them
    torch.cuda.synchronize()
    before_init = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(gen, cfg, codes=codes, moments_dtype=getattr(torch, moments),
                             mesh=mesh, strategy=strategy)
    init_peak = torch.cuda.max_memory_allocated() - before_init
    held = sum(t.numel() * t.element_size() for tree in (state["params"], state["opt"]["mu"],
                                                          state["opt"]["nu"])
               for _, t in leaves_with_path(tree))
    leaf = max(t.numel() * t.element_size()
               for _, t in leaves_with_path(policy.abstract_params(cfg)))
    out["init_peak_bound"] = held + leaf
    hyper = TrainHyper(optimizer=AdamWConfig(lr=1e-3, weight_decay=0.01, clip_norm=1.0),
                       total_steps=steps)
    step = make_train_step(cfg, hyper, mesh=mesh, strategy=strategy)
    specs = policy.state_shardings(cfg, state, mesh, strategy)
    stream = TokenStream(TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=LM_SEQ,
                                           batch_size=LM_BATCH, seed=0))
    captured = {}
    hooked = grads_at is not None or grads_ref is not None
    if hooked:                         # read the gradients the optimizer gets
        update = step_mod.adamw_update

        def capture(params, grads, st, *a, **kw):
            if st["step"] == 0 and grads_ref is not None:
                out["grads_against"] = _grads_against(grads, grads_ref, specs, mesh)
                out["grad_norm"] = float(kw["grad_norm"](grads))
            if st["step"] == grads_at:
                captured.update({"/".join(p): g.detach().clone()
                                 for p, g in leaves_with_path(grads)})
            return update(params, grads, st, *a, **kw)
        step_mod.adamw_update = capture

    def on_step(i, st):
        out["replicated_equal"].append(_replicated_digests(st, specs, mesh))
        if i == 0 and ref_path is not None:
            out["against_one_rank"] = _blocks_against(st, ref_path, specs, mesh)
    try:
        state, losses, times, per_step, peaks = _timed_steps(step, state, stream, steps, mesh,
                                                             on_step)
    finally:
        if hooked:
            step_mod.adamw_update = update
    torch.cuda.synchronize()
    out["launches"] = _path_counts("lm_ranks")
    # the last step's peak above the run's start, less the gradient copies
    # a compress check holds from an earlier step: the step's own memory
    held = sum(g.numel() * g.element_size() for g in captured.values())
    out.update(losses=losses, times=times, bytes=per_step, wall=time.perf_counter() - t0,
               peak=max(max(peaks), before_init + init_peak) - base,
               step_peak=peaks[-1] - base - held,
               init_peak=init_peak,
               transport=mesh.backend, device=str(mesh.device))
    if profile:
        batch = stream.next_batch()
        if mesh.rank == 0:
            profile_call(f"rank 0 of {mesh.size}, one {cfg.name} step",
                         lambda: float(step(state, batch)[1]["loss"]))
        else:
            float(step(state, batch)[1]["loss"])
    if ep_check:
        out["ep"] = _ep_layers_check(state, cfg, strategy, mesh, stream)
    if captured:
        out["compress"] = _compress_check(captured, mesh)
    del state
    torch.cuda.empty_cache()
    return out


def _ep_layers_check(state, cfg, strategy, mesh, stream) -> dict:
    """One forward without gradients in which every MoE layer's EP output on
    this rank's tokens is held against ``moe_ffn_ep_reference`` on the same
    tokens with all experts (the model line's gathered), bitwise."""
    import torch
    import repro_torch.models.lm as lm_mod
    from repro_torch.nn import moe
    from repro_torch.parallel.sharding import use_sharding
    from repro_torch.parallel.tensor import use_plan
    from repro_torch.train.step import make_shard_plan
    plan = make_shard_plan(cfg, mesh, strategy, LM_BATCH)
    original = lm_mod.moe_ffn_ep
    seen = []

    def checked(params, x, mcfg, plan=None):
        y = original(params, x, mcfg, plan=plan)
        full = {k: (v if k == "router" else torch.cat(mesh.all_gather(v, "model", name="check")))
                for k, v in params.items()}
        ref = moe.moe_ffn_ep_reference(full, x, mcfg, ep=plan.tp_size, data_shards=1)
        seen.append((bool(torch.equal(y, ref)), float((y.float() - ref.float()).abs().max())))
        return y
    batch = stream.next_batch()
    from repro_torch.parallel import policy
    specs = policy.batch_shardings(batch, mesh, strategy)
    local = {n: policy.shard_leaf(torch.as_tensor(x), specs[n], mesh).to(mesh.device)
             for n, x in batch.items()}
    lm_mod.moe_ffn_ep = checked
    try:
        with torch.no_grad(), use_sharding(mesh, plan.rules), use_plan(plan):
            lm_mod.lm_loss(state["params"], local, cfg)
    finally:
        lm_mod.moe_ffn_ep = original
    return {"layers": len(seen), "bitwise": all(s for s, _ in seen),
            "max_abs": max(e for _, e in seen)}


def _compress_check(grads, mesh) -> dict:
    """``psum_compressed`` over the 4 ranks of every captured gradient
    leaf: the mean's bits equal on all ranks; the first ``COMPRESS_CHECK``
    elements of every leaf from every rank, all-gathered, through the
    one-process plain version on the card and on the CPU, bitwise the
    ranks' mean there and each other."""
    import torch
    from repro_torch.optim import compress
    axes = mesh.axis_names
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    before = dict(mesh.stats)
    means, digests, ok_plain, ok_cpu, n_el = {}, [], True, True, 0
    for key, g in grads.items():
        mean, _ = compress.psum_compressed(g, torch.zeros_like(g, dtype=torch.float32), mesh, axes)
        n_el += g.numel()
        digests.append(_bits_digest(mean))
        k = min(COMPRESS_CHECK, g.numel())
        heads = mesh.all_gather(g.reshape(-1)[:k].float().contiguous(), axes, name="check")
        zeros = [torch.zeros_like(h) for h in heads]
        plain, _ = compress.psum_compressed_reference(heads, zeros)
        cpu, _ = compress.psum_compressed_reference([h.cpu() for h in heads],
                                                    [z.cpu() for z in zeros])
        got = mean.reshape(-1)[:k].float()
        ok_plain &= bool(torch.equal(plain, got))
        ok_cpu &= bool(torch.equal(cpu, plain.cpu()))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    dig = torch.tensor(digests, dtype=torch.int64, device=mesh.device)
    every = mesh.all_gather(dig, axes, name="check")
    return {"leaves": len(grads), "elements": n_el, "same_on_ranks":
            all(torch.equal(e, every[0]) for e in every), "plain_bitwise": ok_plain,
            "cpu_bitwise": ok_cpu, "seconds": secs,
            "bytes": {k: v - before.get(k, 0) for k, v in mesh.stats.items()
                      if k.startswith("+".join(axes) + "/compress") and not k.endswith("_calls")}}


def _pipe_cfg():
    import dataclasses
    cfg = _lm_config()
    return dataclasses.replace(cfg, n_layers=PIPE_LAYERS, remat=False)


def _pipe_stage_fn(p, x):
    """One pipeline stage: 6 of qwen's blocks (flash attention, bf16)."""
    from repro_torch.models.lm import _rope, _unstack, attn_block
    from repro_torch.nn.rope import default_positions
    cfg = _pipe_cfg()
    B, S, _ = x.shape
    cos, sin = _rope(cfg, default_positions(B, S, cfg.rope_variant, x.device))
    for lp in _unstack(p, PIPE_LAYERS):
        x = attn_block(lp, x, cfg, cos, sin)[0]
    return x


def _pipe_inputs(device):
    """All 24 blocks' params drawn from seed 1 (stacked (4, 6, ...)) and 8
    microbatches of (1, 2048, 1024) bf16 from seed 2."""
    import torch
    from repro_torch.models.lm import _init_stacked, init_attn_block
    from repro_torch.nn.module import map_tree
    cfg = _pipe_cfg()
    gen = torch.Generator(device=device).manual_seed(1)
    blocks = _init_stacked(PIPE_STAGES * PIPE_LAYERS, lambda: init_attn_block(gen, cfg))
    blocks = map_tree(lambda _, t: t.view((PIPE_STAGES, PIPE_LAYERS) + tuple(t.shape[1:])), blocks)
    g2 = torch.Generator(device=device).manual_seed(2)
    xs = torch.randn(PIPE_MICRO, 1, LM_SEQ, cfg.d_model, generator=g2,
                     device=device).to(torch.bfloat16)
    return blocks, xs


def _pipeline_rank(line, ref_path) -> dict:
    """This rank's stage of ``gpipe`` on the (1, 4) mesh's model line:
    forward and backward timed, held against the sequential reference."""
    import torch
    from repro_torch.nn.module import leaves_with_path, map_tree
    from repro_torch.parallel.pipeline import gpipe
    stage = line.index("model")
    blocks, xs = _pipe_inputs(line.device)
    mine = map_tree(lambda _, t: t[stage].detach().clone().requires_grad_(True), blocks)
    del blocks
    torch.cuda.empty_cache()
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = gpipe(_pipe_stage_fn, mine, xs, line, axis="model")
    (y.float() ** 2).sum().backward()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _path_counts("pipeline")
    ref = torch.load(ref_path, mmap=True, weights_only=True)
    want = ref["out"].to(line.device).float()
    out_err = float((y.detach().float() - want).abs().max())
    out_ok = bool(((y.detach().float() - want).abs() <= PIPE_OUT_TOL * (1 + want.abs())).all())
    grad_err, grad_ok = 0.0, True
    for path, p in leaves_with_path(mine):
        w = ref["grads/" + "/".join(path)][stage].to(line.device)
        d = (p.grad - w).abs()
        grad_err = max(grad_err, float(d.max()))
        grad_ok &= bool((d <= PIPE_GRAD_TOL * (1 + w.abs())).all())
    return {"seconds": secs, "launches": launches, "out_err": out_err, "out_ok": out_ok,
            "grad_err": grad_err, "grad_ok": grad_ok,
            "bytes": {k: v for k, v in line.stats.items() if "shift" in k or "pipeline" in k},
            "peak": torch.cuda.max_memory_allocated()}


MOE_EP_LAYERS = 8                  # granite's 32 layers cut to 8 for the script's time


def _granite_ep():
    """granite-moe-3b-a800m at full width with expert-parallel dispatch and
    flash attention, cut to ``MOE_EP_LAYERS`` layers."""
    return _serve_cfg(GRANITE, attn_impl="flash", moe_impl="ep", n_layers=MOE_EP_LAYERS)


# the reduced configs held 4 ranks against one: (case, arch, dp_over_model).
# "granite ep" runs EP over the model axis with 16 experts at granite's own
# top-8 and capacity 4.0: a rank's window then holds every row routed to
# its experts, so nothing drops and one rank's moe_ffn is its reference
# (reduced granite's 8 experts padded to 16 sit all on model rank 0, where
# the capacity, at most the rank's rows times top-k, drops rows at any
# capacity factor: JAX's formula)
REDUCED_RANK_CASES = (("qwen", LM_ARCH, False), ("granite dp_over_model", GRANITE, True),
                      ("granite ep", GRANITE, False))


def _reduced_hyper():
    """AdamW at eps 1, lr 1 and no warmup: step 0 moves each weight by
    about its clipped gradient, so step 1's loss shows the gradient."""
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import TrainHyper
    return TrainHyper(optimizer=AdamWConfig(lr=1.0, weight_decay=0.01, clip_norm=1.0, eps=1.0),
                      warmup_steps=1, total_steps=2)


def _reduced_ranks(mesh, device) -> dict:
    """The ``REDUCED_RANK_CASES`` in f32, 2 steps on the 4 ranks of
    ``mesh`` on ``device`` (the card: kernels; the CPU: plain versions)."""
    import torch
    from repro_torch.parallel import policy
    from repro_torch.train import init_train_state, make_train_step
    out = {}
    m = mesh.on(device)
    for case, arch, dp in REDUCED_RANK_CASES:
        cfg = _reduced_ranks_cfg(case, arch)
        strategy = policy.Strategy(dp_over_model=dp)
        state = init_train_state(torch.Generator(device=device).manual_seed(0), cfg,
                                 mesh=m, strategy=strategy)
        step = make_train_step(cfg, _reduced_hyper(), mesh=m, strategy=strategy)
        stream = _train_stream(cfg, 128, 4, seed=3)
        out[case] = [float(step(state, stream.next_batch())[1]["loss"]) for _ in range(2)]
    return out


def _reduced_ranks_cfg(case: str, arch: str):
    """The reduced config in f32, decoded by the kernel."""
    import dataclasses
    from repro_torch.configs import reduced
    cfg = reduced(_serve_cfg(arch))
    if case == "granite ep":
        cfg = dataclasses.replace(cfg, n_experts=16, moe_top_k=8, moe_capacity_factor=4.0)
    return dataclasses.replace(cfg, embedding=dataclasses.replace(cfg.embedding,
                                                                  lookup_impl="pallas"))


def _lm_ranks_main(rank: int, payload: dict) -> dict:
    """One of the 4 ranks of phase ``lm_ranks``."""
    import dataclasses
    from repro_torch.device import disable_tf32
    from repro_torch.launch import profiles
    from repro_torch.parallel import policy
    disable_tf32()
    mesh = _rank_mesh()
    line = _rank_mesh((1, LM_RANKS))
    out = {}
    t0 = time.perf_counter()
    qwen = _lm_config()
    out["lm_tp"] = _lm_rank_run(qwen, policy.DEFAULT_STRATEGY, LM_TP_STEPS, mesh,
                                "float32", ref_path=payload["qwen_ref"],
                                grads_ref=payload["qwen_grads"], profile=True)
    again = _lm_rank_run(qwen, policy.DEFAULT_STRATEGY, LM_TP_REPEAT, mesh, "float32")
    out["lm_tp"]["repeat_losses"] = again["losses"]
    prof = profiles.OPTIMIZED_TRAIN[LM_ARCH]
    dp_cfg = dataclasses.replace(qwen, **prof["overrides"])
    out["lm_dp"] = _lm_rank_run(dp_cfg, prof["strategy"], LM_DP_STEPS, mesh,
                                prof["moments_dtype"], ref_path=payload["qwen_ref"],
                                grads_ref=payload["qwen_dp_grads"], grads_at=1)
    granite = _granite_ep()
    out["moe_ep"] = _lm_rank_run(granite, policy.DEFAULT_STRATEGY, MOE_EP_STEPS, mesh,
                                 "bfloat16", ep_check=True)
    out["ssm_tp"] = _lm_rank_run(_ssm_tp_cfg(), policy.DEFAULT_STRATEGY, SSM_TP_STEPS, mesh,
                                 "bfloat16", grads_ref=payload["ssm_grads"])
    for label, (cfg, shape) in _serve_paths().items():
        out[label] = _serve_rank_run(label, cfg, mesh if shape == LM_MESH else line,
                                     *_serve_dims(label))
    out["pipeline"] = _pipeline_rank(line, payload["pipe_ref"])
    out["reduced"] = {dev: _reduced_ranks(mesh, dev) for dev in ("cuda", "cpu")}
    out["seconds"] = time.perf_counter() - t0
    return out


def _one_rank_references() -> dict:
    """On the card alone, before the ranks start: qwen's one-rank step from
    the init and batch the ranks use (step-0 loss, params after step 1,
    saved for the ranks; the step-0 gradient and clip norm under
    ``lm_tp``'s config and under ``lm_dp``'s, whose chunked loss rounds
    otherwise, saved; and the control: the gradient a data rank holds
    before the data axis's sum, its half of the batch over the global token
    count, against the whole), granite's
    one-rank no-drop loss on the first batch, the pipeline's sequential
    reference (output and gradients), and the reduced configs' one-rank
    losses on the card and the CPU."""
    import torch
    import dataclasses
    from repro_torch.data import TokenStream, TokenStreamConfig
    from repro_torch.device import make_generator
    from repro_torch.launch import profiles
    from repro_torch.launch.train import encode_vocab
    from repro_torch.models.lm import init_lm, lm_loss
    from repro_torch.nn.module import leaves_with_path, map_tree
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, global_norm
    from repro_torch.parallel.pipeline import pipeline_reference
    from repro_torch.train import TrainHyper, init_train_state, make_train_step
    from repro_torch.train.step import loss_and_grads
    LM_RANKS_REF.mkdir(parents=True, exist_ok=True)
    out = {}
    for arch, cfg, moments in ((LM_ARCH, _lm_config(), "float32"),
                               (GRANITE, _granite_ep(), "bfloat16")):
        torch.cuda.empty_cache()
        gen = make_generator(0, "cuda")
        codes = encode_vocab(cfg, gen, batch=LM_BATCH, seq=LM_SEQ, cooc_batches=8, seed=0,
                             log=lambda line: None)
        state = init_train_state(gen, cfg, codes=codes, moments_dtype=getattr(torch, moments))
        stream = TokenStream(TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=LM_SEQ,
                                               batch_size=LM_BATCH, seed=0))
        batch = {k: torch.from_numpy(v).cuda() for k, v in stream.next_batch().items()}
        if arch == LM_ARCH:
            half = {k: v[:LM_BATCH // 2] for k, v in batch.items()}
            part = dict(leaves_with_path(loss_and_grads(state["params"], half, cfg)[1]))
            dp_cfg = dataclasses.replace(cfg, **profiles.OPTIMIZED_TRAIN[arch]["overrides"])
            for key, c in (("lm_tp", cfg), ("lm_dp", dp_cfg)):
                grads = dict(leaves_with_path(loss_and_grads(state["params"], batch, c)[1]))
                path = LM_RANKS_REF / f"{key}_grads0.pt"
                torch.save({"/".join(k): g.cpu() for k, g in grads.items()}, path)
                out[key] = {"loss": None, "grads": str(path),
                            "grad_norm": float(global_norm(list(grads.values()))),
                            "grad_control": max(_grad_gap(0.5 * part[k], g)
                                                for k, g in grads.items())}
            del part, grads
            hyper = TrainHyper(optimizer=AdamWConfig(lr=1e-3, weight_decay=0.01, clip_norm=1.0),
                               total_steps=LM_TP_STEPS)
            state, m = make_train_step(cfg, hyper)(state, batch)
            out[arch] = out["lm_tp"]["loss"] = out["lm_dp"]["loss"] = float(m["loss"])
            path = LM_RANKS_REF / "qwen_step1.pt"
            torch.save({"/".join(p): t.cpu() for p, t in leaves_with_path(state["params"])},
                       path)
            out["qwen_ref"] = str(path)
        else:
            with torch.no_grad():
                out[arch] = float(lm_loss(state["params"], batch, cfg))
        del state, codes
    out["ssm_tp"] = _ssm_tp_reference()
    torch.cuda.empty_cache()
    blocks, xs = _pipe_inputs("cuda")
    blocks = map_tree(lambda _, t: t.requires_grad_(True), blocks)
    y = pipeline_reference(_pipe_stage_fn, blocks, xs)
    (y.float() ** 2).sum().backward()
    ref = {"out": y.detach().cpu()}
    ref.update({"grads/" + "/".join(p): t.grad.cpu() for p, t in leaves_with_path(blocks)})
    path = LM_RANKS_REF / "pipeline.pt"
    torch.save(ref, path)
    out["pipe_ref"] = str(path)
    del blocks, xs, y, ref
    torch.cuda.empty_cache()
    out["reduced"] = {}
    for dev in ("cuda", "cpu"):
        for case, arch, _ in REDUCED_RANK_CASES:
            cfg = _reduced_ranks_cfg(case, arch)
            params = init_lm(torch.Generator(device=dev).manual_seed(0), cfg)
            st = {"params": params, "opt": adamw_init(params), "step": 0}
            step = make_train_step(cfg, _reduced_hyper())
            stream = _train_stream(cfg, 128, 4, seed=3)
            out["reduced"][(dev, case)] = [
                float(step(st, {k: torch.from_numpy(v).to(dev)
                                for k, v in stream.next_batch().items()})[1]["loss"])
                for _ in range(2)]
    return out


def _ssm_tp_cfg():
    """mamba2-2.7b on its JAX profile's chunk (``loss_vocab_chunk=6304``),
    decoded by the kernel: ``ssm_train``'s config, here under TP, cut to
    ``SSM_TP_LAYERS`` layers, in f32.  In bf16 (at all 64 layers) the
    step-0 gradient of one leaf, D_skip (each head's sum of dy * x over
    524,288 terms that cancel), sat 0.148 from the one-rank step's, over
    the 0.05 bound (PERF.md §6): the row-parallel partial sums round to
    bf16 before they are added, the one-rank product once, and the layers
    carry the difference.  In f32 the check reads the
    TP program, not bf16's roundings."""
    return _serve_cfg(MAMBA2, loss_vocab_chunk=6304, compute_dtype="float32",
                      n_layers=SSM_TP_LAYERS)


def _ssm_tp_reference() -> dict:
    """mamba2's one-rank step-0 loss and gradient from the init and batch
    the ranks use (the gradient saved in bf16 for the ranks to read their
    blocks: 5.4 GB against 10.8 in f32; its rounding is 2^-9 of an element,
    under a tenth of the 0.05 bound), the clip's norm, and the control: a
    data rank's gradient before the data axis's sum against the whole."""
    import torch
    from repro_torch.data import TokenStream, TokenStreamConfig
    from repro_torch.device import make_generator
    from repro_torch.launch.train import encode_vocab
    from repro_torch.nn.module import leaves_with_path
    from repro_torch.optim.adamw import global_norm
    from repro_torch.train import init_train_state
    from repro_torch.train.step import loss_and_grads
    cfg = _ssm_tp_cfg()
    torch.cuda.empty_cache()
    gen = make_generator(0, "cuda")
    codes = encode_vocab(cfg, gen, batch=LM_BATCH, seq=LM_SEQ, cooc_batches=8, seed=0,
                         log=lambda line: None)
    state = init_train_state(gen, cfg, codes=codes, moments_dtype=torch.bfloat16)
    stream = TokenStream(TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=LM_SEQ,
                                           batch_size=LM_BATCH, seed=0))
    batch = {k: torch.from_numpy(v).cuda() for k, v in stream.next_batch().items()}
    loss, grads = loss_and_grads(state["params"], batch, cfg)
    grads = dict(leaves_with_path(grads))
    norm = float(global_norm(list(grads.values())))
    path = LM_RANKS_REF / "ssm_tp_grads0.pt"
    torch.save({"/".join(k): g.to(torch.bfloat16).cpu() for k, g in grads.items()}, path)
    del grads
    half = {k: v[:LM_BATCH // 2] for k, v in batch.items()}
    part = dict(leaves_with_path(loss_and_grads(state["params"], half, cfg)[1]))
    saved = torch.load(path, mmap=True, weights_only=True)
    control = max(_grad_gap(0.5 * g, saved["/".join(k)].cuda()) for k, g in part.items())
    del state, part, codes
    torch.cuda.empty_cache()
    return {"loss": float(loss), "grads": str(path), "grad_norm": norm, "grad_control": control}


def _serve_paths() -> dict:
    """The serving paths across ranks: label -> (config, mesh shape)."""
    return {"serve_tp": (_serve_cfg(LM_ARCH, compute_dtype="float32"), LM_MESH),
            "serve_ssm_tp": (_serve_cfg(MAMBA2, compute_dtype="float32",
                                        n_layers=SSM_TP_LAYERS), LM_MESH),
            "serve_split_kv": (_serve_cfg(CHATGLM, compute_dtype="float32",
                                          n_layers=SPLIT_KV_LAYERS), (1, LM_RANKS))}


def _serve_dims(label: str):
    """(prompts, prompt length, greedy steps, cache slots) of a serving path."""
    b, plen, steps = {"serve_tp": SERVE_TP, "serve_ssm_tp": SERVE_SSM_TP,
                      "serve_split_kv": SERVE_SPLIT_KV}[label]
    return b, plen, steps, plen + steps


def _serve_prompts(cfg, b: int, plen: int):
    import numpy as np
    return np.random.default_rng(21).integers(0, cfg.vocab_size, (b, plen))


def _greedy(logits, cfg):
    """The next tokens (B, 1): the argmax over the real vocabulary."""
    return logits[:, :cfg.vocab_size].argmax(dim=-1, keepdim=True)


def _serve_rank_run(label: str, cfg, mesh, b: int, plen: int, steps: int, s_max: int) -> dict:
    """One rank's serving run: its blocks of the params drawn from seed 0
    (random codes, as ``examples/serve_lm.py``), the prefill of ``b``
    prompts of ``plen`` into a cache of ``s_max`` slots, then ``steps``
    greedy decode steps, every step's logits (global, the same on every
    rank) kept as numpy (a CPU tensor would travel back through a shared
    file the exiting rank takes with it); per step the host-clock time (synchronised), the bytes the
    rank received (``Mesh.stats``) and ``max_memory_allocated``; the
    launches counted around exactly this run."""
    import torch
    from repro_torch.device import make_generator
    from repro_torch.models.lm import init_lm
    from repro_torch.parallel import policy
    from repro_torch.train.step import _block_keeper, make_prefill_step, make_serve_step
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    zero_counts()
    t0 = time.perf_counter()
    params = init_lm(make_generator(0, "cuda"), cfg,
                     keep=_block_keeper(cfg, mesh, policy.DEFAULT_STRATEGY))
    prefill = make_prefill_step(cfg, s_max, mesh=mesh)
    serve = make_serve_step(cfg, mesh=mesh)
    tokens = torch.from_numpy(_serve_prompts(cfg, b, plen)).cuda()
    logits_all, times, per_step, peaks, fed = [], [], [], [], []
    cache = None
    for i in range(steps + 1):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = dict(mesh.stats)
        t1 = time.perf_counter()
        if i == 0:
            logits, cache = prefill(params, {"tokens": tokens})
        else:
            nxt = _greedy(logits, cfg)
            fed.append(nxt.cpu())
            logits, cache = serve(params, cache, {"tokens": nxt})
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        peaks.append(torch.cuda.max_memory_allocated() - base)
        per_step.append({k: v - before.get(k, 0) for k, v in mesh.stats.items()
                         if not k.endswith("_calls")})
        logits_all.append(logits.float().cpu().numpy())
    torch.cuda.synchronize()
    out = {"launches": _path_counts("lm_ranks"), "times": times, "bytes": per_step,
           "peaks": peaks, "wall": time.perf_counter() - t0, "cache_bytes": cache.nbytes,
           "kv_seq": cache.kv_seq,
           "digest": [_bits_digest(torch.from_numpy(x)) for x in logits_all],
           "tokens": torch.cat(fed, dim=1).numpy() if fed else None,
           "device": str(mesh.device)}
    if mesh.rank == 0:
        out["logits"] = logits_all
    del params, cache
    torch.cuda.empty_cache()
    return out


def _serve_one_rank(label: str, cfg, ranks_out: dict) -> dict:
    """On the card alone: the one-rank prefill and serve steps on the same
    params (drawn whole from seed 0) and the tokens the ranks fed; each
    step's logits against rank 0's."""
    import torch
    from repro_torch.device import make_generator
    from repro_torch.models.lm import init_lm
    from repro_torch.train.step import make_prefill_step, make_serve_step
    b, plen, steps, s_max = _serve_dims(label)
    torch.cuda.empty_cache()
    params = init_lm(make_generator(0, "cuda"), cfg)
    logits, cache = make_prefill_step(cfg, s_max)(
        params, {"tokens": torch.from_numpy(_serve_prompts(cfg, b, plen)).cuda()})
    serve = make_serve_step(cfg)
    want = [torch.from_numpy(x) for x in ranks_out["logits"]]
    fed = torch.from_numpy(ranks_out["tokens"]).cuda()
    gaps = [float((logits.float().cpu() - want[0]).abs().max())]
    for i in range(steps):
        logits, cache = serve(params, cache, {"tokens": fed[:, i:i + 1]})
        gaps.append(float((logits.float().cpu() - want[i + 1]).abs().max()))
    del params, cache
    torch.cuda.empty_cache()
    return gaps


# ---- the dry run of the 4-rank paths (launch/dryrun.py), on the host ----

def _dry_specs() -> dict:
    """Each 4-rank path's cells at its own mesh and shape: label -> list of
    (cell kind, config, mesh shape, strategy, batch, seq, cache slots,
    moments dtype)."""
    import dataclasses
    from repro_torch.launch import profiles
    from repro_torch.parallel import policy
    d = policy.DEFAULT_STRATEGY
    prof = profiles.OPTIMIZED_TRAIN[LM_ARCH]
    out = {"lm_tp": [("train", _lm_config(), LM_MESH, d, LM_BATCH, LM_SEQ, None, "float32")],
           "lm_dp": [("train", dataclasses.replace(_lm_config(), **prof["overrides"]), LM_MESH,
                      prof["strategy"], LM_BATCH, LM_SEQ, None, prof["moments_dtype"])],
           "moe_ep": [("train", _granite_ep(), LM_MESH, d, LM_BATCH, LM_SEQ, None, "bfloat16")],
           "ssm_tp": [("train", _ssm_tp_cfg(), LM_MESH, d, LM_BATCH, LM_SEQ, None, "bfloat16")]}
    for label, (cfg, shape) in _serve_paths().items():
        b, plen, _, s_max = _serve_dims(label)
        out[label] = [("prefill", cfg, shape, d, b, plen, s_max, "float32"),
                      ("decode", cfg, shape, d, b, s_max, s_max, "float32")]
    return out


def _dry_trace(label: str) -> dict:
    """One path's cells traced on the virtual rank 0 of its mesh (a worker
    process: one thread, no card): the bytes by axes and operation, the
    arguments' and the peak bytes, the counted FLOPs and the trace time."""
    import torch
    torch.set_num_threads(1)
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.parallel.sharding import MeshSpec
    if label == "production":
        t0 = time.perf_counter()
        rec = dryrun.run_cell(LM_ARCH, "train_4k", False)
        rec["wall_s"] = time.perf_counter() - t0
        return rec
    out = []
    for kind, cfg, shape, strategy, b, seq, s_max, moments in _dry_specs()[label]:
        mesh = MeshSpec(("data", "model"), shape)
        cell = dryrun.build_cell(cfg, ShapeSpec(label, kind, seq, b), mesh, 1, strategy, moments,
                                 s_max=s_max)
        tr = cell.trace()
        out.append({"kind": kind, "stats": tr["stats"], "argument": tr["argument_bytes"],
                    "peak": tr["peak_bytes"], "flops": tr["analysis"].flops,
                    "trace_s": tr["trace_s"], "ops": tr["ops"]})
    return {"cells": out}


def _dry_calibration() -> dict:
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.roofline import calibrate_counter
    from repro_torch.parallel.sharding import MeshSpec
    return {"16x16": calibrate_counter(make_production_mesh()),
            "2x2": calibrate_counter(MeshSpec(("data", "model"), LM_MESH))}


def _start_dry_run():
    """The dry-run traces in one worker process at the lowest priority
    beside the card's phases (they need no card, and the gloo ranks need
    the host's cores); ``_finish_dry_run`` collects them."""
    import multiprocessing as mp
    import os
    pool = mp.get_context("spawn").Pool(1, initializer=os.nice, initargs=(19,))
    labels = ["production"] + list(_dry_specs())
    return pool, labels, pool.map_async(_dry_trace, labels)


def _finish_dry_run(started, results) -> None:
    """The dry run's readings beside the live ranks': bytes by axes and
    operation equal, peak a rank within ``DRY_PEAK_TOL``, counted FLOPs
    beside ``model_flops``, the counter's calibration, the production
    cell's trace time."""
    from repro_torch.launch.roofline import model_flops
    from repro_torch.launch.shapes import ShapeSpec
    pool, labels, pending = started
    try:
        dry = dict(zip(labels, pending.get(timeout=900)))
    finally:
        pool.terminate()
        pool.join()
    calib = _dry_calibration()
    print(f"[dryrun] counter calibration (per-chip ratio): {calib['16x16']:.3f} at 16x16, "
          f"{calib['2x2']:.3f} at (2, 2)", flush=True)
    check(calib["16x16"] == 1.0 and calib["2x2"] == 1.0, f"counter calibration {calib}")
    prod = dry.pop("production")
    check(prod["status"] == "ok", f"dry run production cell: {prod.get('error')}")
    print(f"[dryrun] production cell {LM_ARCH} train_4k 16x16 (one rank of 256, fake tensors, "
          f"on the card machine's host): trace {prod['trace_s']} s (build {prod['build_s']} s, "
          f"wall {prod['wall_s']:.1f} s), {prod['ops']} ops, peak "
          f"{prod['memory']['peak_est_gib']:.3f} GiB a rank (arguments "
          f"{prod['memory']['argument_gib']:.3f}), counted FLOPs {prod['counted_flops']:.6e} "
          f"beside model_flops {prod['roofline']['model_flops_per_chip']:.6e}, collective "
          f"{prod['roofline']['coll_bytes_per_chip']:.6e} B", flush=True)
    for label, rec in dry.items():
        live = results[0][label]
        for cell in rec["cells"]:
            kind = cell["kind"]
            if kind == "train":
                want, peak = live["bytes"][-1], live["step_peak"]
                cfg, b, seq = next((c[1], c[4], c[5]) for c in _dry_specs()[label])
                mf = model_flops(cfg, ShapeSpec(label, "train", seq, b), LM_RANKS)
            elif kind == "prefill":
                want, peak = live["bytes"][0], live["peaks"][0]
                mf = None
            else:
                want, peak = live["bytes"][-1], max(live["peaks"][1:])
                mf = None
            got = {k: v for k, v in cell["stats"].items() if v}
            want = {k: v for k, v in want.items() if v}
            ratio = cell["peak"] / peak
            print(f"[dryrun] {label} {kind} (rank 0, {cell['ops']} ops traced in "
                  f"{cell['trace_s']:.1f} s): bytes by axes/operation {got}; the live rank 0's "
                  f"{want}: equal {got == want}; peak a rank {cell['peak']} B (arguments "
                  f"{cell['argument']} B) against max_memory_allocated {peak} B: ratio "
                  f"{ratio:.4f} (bound 1 +- {DRY_PEAK_TOL}); counted FLOPs {cell['flops']:.6e}"
                  + (f" beside model_flops {mf:.6e} a rank" if mf else ""), flush=True)
            check(got == want, f"dry run {label} {kind}: bytes {got} against the live {want}")
            if kind == "decode":
                check(all({k: v for k, v in st.items() if v} == want for st in live["bytes"][1:]),
                      f"{label}: the decode steps' bytes differ from step to step")
            check(abs(ratio - 1) <= DRY_PEAK_TOL,
                  f"dry run {label} {kind}: peak {cell['peak']} against the card's {peak}")


def _rank_launches(results, path: str) -> dict:
    first = results[0][path]["launches"]
    return {k: (sum(r[path]["launches"][k] for r in results) if not isinstance(v, dict)
                else {kk: sum(r[path]["launches"][k][kk] for r in results) for kk in v})
            for k, v in first.items()}


def _print_rank_path(label: str, cfg, results, one, steps: int) -> dict:
    """The path's lines: losses, period, bytes, peaks, MFU, checks."""
    import numpy as np
    from repro_torch.launch.roofline import model_flops
    from repro_torch.launch.shapes import ShapeSpec
    rs = [r[label] for r in results]
    a = rs[0]
    warm = sorted(a["times"][1:])
    period = warm[(len(warm) - 1) // 2]
    flops = model_flops(cfg, ShapeSpec("lm_step", "train", LM_SEQ, LM_BATCH), 1)
    mfu = flops / (period * BF16_FLOPS)
    by = {}
    for step_bytes in a["bytes"][1:]:
        for k, v in step_bytes.items():
            by[k] = by.get(k, 0) + v / max(1, len(a["bytes"]) - 1)
    print(f"[{label}] {cfg.name} on {LM_RANKS} ranks ({a['transport']}, {SHARED_CARD}) "
          f"mesh (data, model) = {LM_MESH}: {steps} steps of {LM_BATCH} x {LM_SEQ}: losses "
          f"{a['losses']}; step ms {[round(t * 1e3, 3) for t in a['times']]}; period (median "
          f"of steps 2-{steps}) {period * 1e3:.3f} ms; chain wall {a['wall']:.1f} s; "
          f"{smi_query('name,power.limit')}", flush=True)
    print(f"[{label}] bytes a rank receives a step (rank 0, mean of steps 2-{steps}), by axes/"
          f"operation: { {k: round(v) for k, v in sorted(by.items()) if v} }; total "
          f"{round(sum(by.values()))} B", flush=True)
    print(f"[{label}] peak max_memory_allocated per rank {[r['peak'] for r in rs]} B; the 4 "
          f"together {sum(r['peak'] for r in rs)} B; init's peak per rank "
          f"{[r['init_peak'] for r in rs]} B, at most the rank's state and one whole leaf "
          f"{[r['init_peak_bound'] for r in rs]} B", flush=True)
    check(all(r["init_peak"] <= r["init_peak_bound"] for r in rs),
          f"{label}: init held more than the rank's state and one leaf")
    print(f"[mfu] {label} ({cfg.name}, {cfg.n_layers} layers, 4 ranks on one card): model "
          f"FLOPs {flops:.6e} a step, period {period * 1e3:.3f} ms -> MFU {100 * mfu:.2f}% of "
          f"{BF16_FLOPS / 1e12:.0f} TFLOP/s bf16 on 1 chip; {smi_query('name,power.limit')}",
          flush=True)
    check(all(np.isfinite(a["losses"])), f"{label}: non-finite loss {a['losses']}")
    check(all(r["losses"] == a["losses"] for r in rs), f"{label}: the ranks' losses differ")
    check(all(all(r["replicated_equal"]) for r in rs),
          f"{label}: a replicated leaf differs across ranks")
    check(all(r["same_codes"] for r in rs), f"{label}: the ranks encoded other codes")
    if one is not None:
        one_loss = one["loss"]
        gap = abs(a["losses"][0] - one_loss) / abs(one_loss)
        print(f"[{label}] step-0 loss {a['losses'][0]} against the one-rank step's {one_loss}: "
              f"relative gap {gap} (bound {LM_RANKS_LOSS_BOUND})", flush=True)
        check(gap <= LM_RANKS_LOSS_BOUND, f"{label}: step-0 loss {gap} from the one-rank step's")
    if "against_one_rank" in a:
        worst = max(r["against_one_rank"]["over_bound"] for r in rs)
        gap = max(r["against_one_rank"]["max_abs"] for r in rs)
        print(f"[{label}] params after step 1 against the one-rank step's, every rank's blocks: "
              f"largest |diff| {gap}, largest |diff| / (atol + rtol |ref|) {worst} (JAX's rtol "
              f"{LM_RANKS_RTOL}, atol {LM_RANKS_ATOL}: must be <= 1)", flush=True)
        check(worst <= 1.0, f"{label}: params after step 1 off the one-rank step's by {worst}")
    if "grads_against" in a:
        gap, leaf = max(r["grads_against"] for r in rs)
        norm_gap = abs(a["grad_norm"] - one["grad_norm"]) / one["grad_norm"]
        print(f"[{label}] step-0 gradient against the one-rank step's, every rank's blocks: worst "
              f"leaf ({leaf}) max |diff| / max |ref| {gap} (bound {LM_RANKS_GRAD_BOUND}); "
              f"control, a data "
              f"rank's gradient before the data axis's sum: {one['grad_control']}; the clip's "
              f"norm {a['grad_norm']} against {one['grad_norm']}: relative gap {norm_gap} (bound "
              f"{LM_RANKS_NORM_BOUND})", flush=True)
        check(gap <= LM_RANKS_GRAD_BOUND, f"{label}: step-0 gradient off the one-rank's by {gap}")
        check(one["grad_control"] > LM_RANKS_GRAD_BOUND,
              f"{label}: the gradient bound passes a gradient without the data sum")
        check(norm_gap <= LM_RANKS_NORM_BOUND, f"{label}: clip norm off by {norm_gap}")
        check(all(r["grad_norm"] == a["grad_norm"] for r in rs), f"{label}: the ranks' norms differ")
    return {"period_ms": period * 1e3, "mfu": mfu, "bytes_per_step": by,
            "peak_per_rank": [r["peak"] for r in rs]}


def _print_serve_path(label: str, cfg, shape, results) -> dict:
    """A serving path's lines: the prefill and per-token times, bytes a
    rank by axes/operation, cache bytes and peak a rank; the checks: every
    rank the same logits bits, each step's logits against the one-rank
    steps on the card alone."""
    import numpy as np
    rs = [r[label] for r in results]
    a = rs[0]
    b, plen, steps, s_max = _serve_dims(label)
    per_token = float(np.median(a["times"][2:] if steps > 2 else a["times"][1:]))
    step_bytes = {k: v for k, v in a["bytes"][-1].items() if v}
    print(f"[{label}] {cfg.name} ({cfg.n_layers} layers, f32) on {LM_RANKS} ranks ({SHARED_CARD}) "
          f"mesh (data, model) = {shape}: prefill {b} x {plen} {a['times'][0] * 1e3:.3f} ms, "
          f"then {steps} greedy steps: per-token {per_token * 1e3:.3f} ms (median of steps "
          f"{'2' if steps > 2 else '1'}-{steps}; steps {[round(t * 1e3, 3) for t in a['times'][1:]]}); "
          f"cache {s_max} slots, {a['cache_bytes']} B a rank, KV slots split over "
          f"{a['kv_seq'] or 'no axis'}; chain wall {a['wall']:.1f} s; "
          f"{smi_query('name,power.limit')}", flush=True)
    print(f"[{label}] bytes rank 0 receives: prefill "
          f"{ {k: v for k, v in a['bytes'][0].items() if v} }, a decode step {step_bytes}; peak "
          f"max_memory_allocated per rank: prefill {[r['peaks'][0] for r in rs]} B, decode "
          f"{[max(r['peaks'][1:]) for r in rs]} B", flush=True)
    check(all(r["digest"] == a["digest"] for r in rs), f"{label}: the ranks' logits bits differ")
    gaps = _serve_one_rank(label, cfg, a)
    print(f"[{label}] each step's logits against the one-rank prefill and serve steps on the same "
          f"params and tokens (the card alone): max |diff| {[f'{g:.3e}' for g in gaps]} (bound "
          f"{SERVE_RANKS_BOUND})", flush=True)
    check(max(gaps) <= SERVE_RANKS_BOUND, f"{label}: logits {max(gaps)} from the one-rank steps")
    return {"prefill_ms": a["times"][0] * 1e3, "per_token_ms": per_token * 1e3,
            "bytes_prefill": a["bytes"][0], "bytes_per_step": step_bytes,
            "peak_per_rank": [max(r["peaks"]) for r in rs], "max_gap": max(gaps)}


def phase_lm_ranks() -> tuple:
    """The LM across 4 ranks of ``torch.distributed`` sharing the card over
    gloo (NCCL one card a rank where there are 4): paths lm_tp, lm_dp,
    moe_ep, ssm_tp, serve_tp, serve_ssm_tp, serve_split_kv, pipeline and
    compress, the reduced configs' 4 ranks against one on the card and the
    CPU, and the dry run of the 4-rank paths (traced on the host beside
    the card's work) against what their ranks read."""
    import dataclasses
    import torch
    from repro_torch.launch import profiles
    from repro_torch.parallel.sharding import spawn
    t_phase = time.perf_counter()
    dry_run = _start_dry_run()
    refs = _one_rank_references()
    t_ref = time.perf_counter() - t_phase
    print(f"[lm_ranks] one-rank references: qwen step-0 loss {refs[LM_ARCH]}, granite (moe_ffn, "
          f"no drop) {refs[GRANITE]}; {t_ref:.1f} s", flush=True)
    payload = {"qwen_ref": refs["qwen_ref"], "qwen_grads": refs["lm_tp"]["grads"],
               "qwen_dp_grads": refs["lm_dp"]["grads"], "pipe_ref": refs["pipe_ref"],
               "ssm_grads": refs["ssm_tp"]["grads"]}
    try:
        results = spawn(_lm_ranks_main, LM_RANKS, backend="gloo", args=(payload,),
                        timeout_s=600)
    except RuntimeError as e:
        fail(f"phase lm_ranks: {e}")
    print(f"[lm_ranks] {LM_RANKS} ranks on {sorted({r['lm_tp']['device'] for r in results})} "
          f"over {results[0]['lm_tp']['transport']}: {results[0]['seconds']:.1f} s in the "
          f"ranks", flush=True)
    qwen = _lm_config()
    info = {"lm_tp": _print_rank_path("lm_tp", qwen, results, refs["lm_tp"], LM_TP_STEPS)}
    a = results[0]["lm_tp"]
    print(f"[lm_tp] a second 4-rank run of {LM_TP_REPEAT} steps from the same init: losses "
          f"{a['repeat_losses']} against {a['losses'][:LM_TP_REPEAT]}", flush=True)
    check(a["repeat_losses"] == a["losses"][:LM_TP_REPEAT], "lm_tp: two runs' losses differ")
    dp_cfg = dataclasses.replace(qwen, **profiles.OPTIMIZED_TRAIN[LM_ARCH]["overrides"])
    info["lm_dp"] = _print_rank_path("lm_dp", dp_cfg, results, refs["lm_dp"], LM_DP_STEPS)
    granite = _granite_ep()
    info["moe_ep"] = _print_rank_path("moe_ep", granite, results, None, MOE_EP_STEPS)
    g0 = results[0]["moe_ep"]["losses"][0]
    print(f"[moe_ep] step-0 loss {g0} (EP, capacity {granite.moe_capacity_factor}: rows drop) "
          f"beside the one-rank moe_ffn (no drop) loss {refs[GRANITE]} (a readout, not a bound)",
          flush=True)
    for r in results:
        ep = r["moe_ep"]["ep"]
        print(f"[moe_ep] rank {results.index(r)}: {ep['layers']} MoE layers' EP output on its "
              f"tokens against moe_ffn_ep_reference (all experts, one process): bitwise "
              f"{ep['bitwise']}, max |diff| {ep['max_abs']}", flush=True)
        check(ep["bitwise"] and ep["layers"] == granite.n_layers,
              f"moe_ep: EP differs from moe_ffn_ep_reference ({ep})")
    info["ssm_tp"] = _print_rank_path("ssm_tp", _ssm_tp_cfg(), results, refs["ssm_tp"],
                                      SSM_TP_STEPS)
    for label, (cfg, shape) in _serve_paths().items():
        info[label] = _print_serve_path(label, cfg, shape, results)
    comp = [r["lm_dp"]["compress"] for r in results]
    c0 = comp[0]
    print(f"[compress] psum_compressed over {LM_RANKS} ranks of lm_dp's step-1 gradient "
          f"({c0['leaves']} leaves, {c0['elements']} elements a rank): the mean the same bits on "
          f"every rank {all(c['same_on_ranks'] for c in comp)}; the first {COMPRESS_CHECK} "
          f"elements of each leaf bitwise the one-process plain version on the card "
          f"{all(c['plain_bitwise'] for c in comp)}, and the card's plain version bitwise the "
          f"CPU's {all(c['cpu_bitwise'] for c in comp)}; {c0['seconds']:.2f} s; bytes a rank "
          f"{c0['bytes']}", flush=True)
    check(all(c["same_on_ranks"] and c["plain_bitwise"] and c["cpu_bitwise"] for c in comp),
          "compress: psum_compressed's bits differ")
    pipe = [r["pipeline"] for r in results]
    print(f"[pipeline] gpipe over {PIPE_STAGES} ranks (model axis), {PIPE_LAYERS} of qwen's "
          f"blocks a stage, {PIPE_MICRO} microbatches of (1, {LM_SEQ}, {qwen.d_model}) bf16: "
          f"forward + backward {[round(p['seconds'], 3) for p in pipe]} s; output max |diff| "
          f"{max(p['out_err'] for p in pipe)} (bound {PIPE_OUT_TOL}), gradients "
          f"{max(p['grad_err'] for p in pipe)} (bound {PIPE_GRAD_TOL}) against "
          f"pipeline_reference; bytes a rank {pipe[0]['bytes']}; peak per rank "
          f"{[p['peak'] for p in pipe]} B", flush=True)
    check(all(p["out_ok"] and p["grad_ok"] for p in pipe), "pipeline: gpipe off its reference")
    for dev in ("cuda", "cpu"):
        for case, _, _ in REDUCED_RANK_CASES:
            got = results[0]["reduced"][dev][case]
            want = refs["reduced"][(dev, case)]
            gap = max(abs(x - y) / abs(y) for x, y in zip(got, want))
            print(f"[reference] lm_ranks reduced {case} f32 on {dev}, AdamW eps 1, lr 1: 4 ranks "
                  f"{got} against 1 rank {want}, relative gap {gap} (bound "
                  f"{REDUCED_RANKS_BOUND})", flush=True)
            check(gap <= REDUCED_RANKS_BOUND, f"reduced {case} on {dev}: 4 ranks off by {gap}")
            check(all(r["reduced"][dev][case] == got for r in results),
                  f"reduced {case}: the ranks' losses differ")
    launches = {path: _rank_launches(results, path)
                for path in ("lm_tp", "lm_dp", "moe_ep", "ssm_tp", "pipeline", *_serve_paths())}
    for path, cfg, steps in (("lm_tp", qwen, LM_TP_STEPS), ("lm_dp", dp_cfg, LM_DP_STEPS),
                             ("moe_ep", granite, MOE_EP_STEPS),
                             ("ssm_tp", _ssm_tp_cfg(), SSM_TP_STEPS)):
        one = _expected_train_launches(cfg, steps)
        expect = {k: (v * LM_RANKS if not isinstance(v, dict)
                      else {kk: vv * LM_RANKS for kk, vv in v.items()}) for k, v in one.items()}
        got = {k: launches[path][k] for k in expect}
        print(f"[{path}] launches summed over the ranks {launches[path]}", flush=True)
        check(got == expect, f"{path}: launches {got}, expected {expect}")
    for label in _serve_paths():
        steps = _serve_dims(label)[2]
        got = launches[label]
        print(f"[{label}] launches summed over the ranks {got}", flush=True)
        check(got["hash_decode"] == LM_RANKS * (1 + steps) and got["hash_decode_backward"] == 0
              and got["flash_attention"] == 0 and got["lsh_encode"] == 0,
              f"{label}: launches {got}, expected {LM_RANKS * (1 + steps)} hash_decode only")
    _finish_dry_run(dry_run, results)
    ticks = PIPE_MICRO + PIPE_STAGES - 1
    check(launches["pipeline"]["flash_attention"] == LM_RANKS * ticks * PIPE_LAYERS,
          f"pipeline: flash_attention launched {launches['pipeline']['flash_attention']} times")
    if torch.cuda.device_count() >= LM_RANKS:
        try:
            nccl = spawn(_lm_nccl_main, LM_RANKS, backend="nccl", timeout_s=600)
        except RuntimeError as e:
            fail(f"phase lm_ranks over NCCL: {e}")
        print(f"[lm_tp] over NCCL, one card a rank: losses {nccl[0]['losses']} (gloo "
              f"{a['losses'][:LM_TP_REPEAT]}), step ms {nccl[0]['times']}", flush=True)
        check(nccl[0]["losses"] == a["losses"][:LM_TP_REPEAT], "NCCL losses differ from gloo's")
    else:
        print(f"[lm_ranks] NCCL run skipped: {torch.cuda.device_count()} card(s), it needs "
              f"{LM_RANKS}", flush=True)
    secs = time.perf_counter() - t_phase
    print(f"[lm_ranks] phase {secs:.1f} s (one-rank references {t_ref:.1f} s)", flush=True)
    info["seconds"] = secs
    info["max_abs_err"] = max(check_decode_case((rows, 16, 256, 512), "bfloat16", seed=80 + i)
                              for i, rows in enumerate((4096, 2048)))
    info["lm_ranks_sizes"] = [4096, 2048]
    return launches, info


def _lm_nccl_main(rank: int) -> dict:
    from repro_torch.device import disable_tf32
    from repro_torch.parallel import policy
    disable_tf32()
    r = _lm_rank_run(_lm_config(), policy.DEFAULT_STRATEGY, LM_TP_REPEAT, _rank_mesh(),
                     "float32")
    return {"losses": r["losses"], "times": [round(t * 1e3, 3) for t in r["times"]]}



def _hash_full(arch: str):
    """The arch's embedding spec under ``kind="hash_full"``."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch).embedding, kind="hash_full")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a CUDA card")
    if not (SRC / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from a checkout")
    from repro_torch.device import disable_tf32
    disable_tf32()
    t_start = time.perf_counter()

    def lap(what: str) -> None:
        print(f"[lap] {what} done at {time.perf_counter() - t_start:.1f} s", flush=True)
    name, count = phase_device()
    lap("phase_device")
    phase_build()
    lap("phase_build")
    from repro_torch.graph.engine import default_frontier_cap
    b_main = default_frontier_cap(REQUEST, (15, 15), 256, N_NODES)
    timing = phase_kernel_check(b_main)
    lap("phase_kernel_check")
    flash_err, flash_instances = phase_flash_check()
    lap("phase_flash_check")
    phase_backward_check()
    lap("phase_backward_check")
    serve_launches, cap, graph, (serve_rt, plain, requests, uncached) = phase_slice()
    lap("phase_slice")
    check(cap == b_main, f"served frontier cap {cap} != checked shape {b_main}")
    cached_launches, cached_bitwise, serve_sizes = phase_cached_serve(serve_rt, plain, requests,
                                                                      uncached)
    batched_launches, batched_sizes, batched_err = phase_batching(serve_rt)
    lap("phase_batching")
    serve_rt.close()
    del serve_rt, plain, uncached
    phase_small_reference()
    lap("phase_small_reference")
    gnn_launches, frontier_rows, frontier_sizes, gnn_codes, gnn_ref = phase_gnn_train(graph)
    lap("phase_gnn_train")
    gnn_cached_launches, planned_sizes = phase_gnn_cached(graph, gnn_ref)
    lap("phase_gnn_cached")
    full_launches, full_codes, gcn = phase_fullgraph(graph)
    lap("phase_fullgraph")
    time_spmm(gcn)
    lap("time_spmm")
    gcn.close()
    del gcn
    link_launches = phase_link(graph)
    lap("phase_link")
    merchant_launches, merchant_sizes = phase_merchant()
    lap("phase_merchant")
    phase_fullgraph_reference()
    lap("phase_fullgraph_reference")
    family_launches, family_sizes, family_err, family_times = phase_families(graph)
    lap("phase_families")
    phase_families_reference()
    lap("phase_families_reference")
    host_launches, host_sizes, host_err = phase_codes_host(graph)
    lap("phase_codes_host")
    shard_launches, shard_sizes, shard_err = phase_sharded(graph)
    lap("phase_sharded")
    elastic_launches, elastic_sizes, elastic_err = phase_elastic(graph)
    lap("phase_elastic")
    del graph, gnn_ref
    timing["max_abs_err"] = max(timing["max_abs_err"], batched_err,
                                check_gnn_frontiers(frontier_sizes),
                                check_gnn_frontiers(planned_sizes,
                                                    "decode sizes of the planned cached run"),
                                check_gnn_frontiers(merchant_sizes,
                                                    "decode sizes of the merchant path"),
                                family_err, host_err, shard_err, elastic_err)
    bwd_cases, bwd_err, bwd_err_by_mc = phase_hd_backward_check(frontier_rows, gnn_codes,
                                                                full_codes)
    lap("phase_hd_backward_check")
    lsh = phase_lsh_check()
    lap("phase_lsh_check")
    vocab_flips = phase_lsh_packed_check()
    lap("phase_lsh_packed_check")
    train_launches, _ = phase_train()
    lap("phase_train")
    lm_ref_launches = phase_lm_reference()
    lap("phase_lm_reference")
    serve_lm_launches, serve_lm = phase_serve_lm()
    lap("phase_serve_lm")
    timing["max_abs_err"] = max(timing["max_abs_err"], serve_lm.pop("max_abs_err"))
    family_lm_launches, family_lm = phase_lm_families()
    lap("phase_lm_families")
    timing["max_abs_err"] = max(timing["max_abs_err"], family_lm.pop("max_abs_err"))
    audio_vlm_launches, audio_vlm = phase_audio_vlm()
    lap("phase_audio_vlm")
    timing["max_abs_err"] = max(timing["max_abs_err"], audio_vlm.pop("max_abs_err"))
    lm_ranks_launches, lm_ranks = phase_lm_ranks()
    lap("phase_lm_ranks")
    timing["max_abs_err"] = max(timing["max_abs_err"], lm_ranks.pop("max_abs_err"))
    rec_launches = phase_reconstruct()
    lap("phase_reconstruct")
    phase_reconstruct_reference()
    lap("phase_reconstruct_reference")
    lm = time_lm_kernels()
    lap("time_lm_kernels")
    bwd_times = {"frontier": time_hd_backward(frontier_rows), "cap": time_hd_backward(61_696),
                 "lm": time_hd_backward(LM_BATCH * LM_SEQ, "bfloat16"),
                 "reconstruct": time_hd_backward(REC_BATCH, graph=True),
                 "full": time_hd_backward(N_NODES),
                 "c4096": time_hd_backward(61_696, c=4096)}
    variants = time_variants()
    lap("time_variants")
    lsh_times = time_lsh()
    lap("time_lsh")
    rec_shape, vocab_shape = (f"{n}x{d}x{w}" for n, d, w in LSH_PATH_SHAPES)
    paths = {"serve": serve_launches, "train": train_launches, "lm_reference": lm_ref_launches,
             "reconstruct": rec_launches, "gnn_train": gnn_launches,
             "serve_cached": cached_launches, "serve_batched": batched_launches,
             **gnn_cached_launches, **full_launches, "link": link_launches,
             "merchant": merchant_launches, **family_launches, **host_launches,
             **shard_launches, **elastic_launches, **serve_lm_launches,
             **family_lm_launches, **audio_vlm_launches, **lm_ranks_launches}
    hd_by_path, bwd_by_path, flash_by_path, lsh_by_path = (
        {path: counts[kernel] for path, counts in paths.items()}
        for kernel in ("hash_decode", "hash_decode_backward", "flash_attention", "lsh_encode"))
    lsh_by_kernel = {k: sum(counts["lsh_encode_by_kernel"][k] for counts in paths.values()
                            if "lsh_encode_by_kernel" in counts)
                     for k in train_launches["lsh_encode_by_kernel"]}
    flash_by_kernel = {k: sum(counts["flash_attention_by_kernel"][k]
                              for counts in paths.values()
                              if "flash_attention_by_kernel" in counts)
                       for k in train_launches["flash_attention_by_kernel"]}
    bwd_by_kernel = {k: sum(counts["hash_decode_backward_by_kernel"][k]
                            for counts in paths.values())
                     for k in serve_launches["hash_decode_backward_by_kernel"]}
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    flash_rows = {"f16_wgmma/64": "f16_wgmma", "bf16_wgmma/256": "bf16_wgmma_d256",
                  "f16_wgmma/256": "f16_wgmma_d256", "f32_cuda_core/256": "f32_cuda_core_d256",
                  "panels/320": "panels_d320"}
    flash_new = [dict(name=f"flash_attention {inst}", launches=0,
                      checked_launches=flash_instances[inst]["launches"],
                      max_abs_err=flash_instances[inst]["max_abs_err"],
                      **{k: lm["flash"]["variants"][row][k] for k in keys})
                 for inst, row in flash_rows.items()]
    hd_new = [dict(name=f"hash_decode float16 B={rows}", launches=0,
                   **{k: row[k] for k in ("max_abs_err", *keys)})
              for rows, row in timing.pop("float16").items()]
    bwd_new = [dict(name="hash_decode_backward (m, c) = (16, 4096) B=61696", launches=0,
                    max_abs_err=bwd_err_by_mc[16, 4096],
                    **{k: bwd_times["c4096"][k] for k in keys})]
    print(json.dumps({"kernels": [
        dict(name="hash_decode", route="cuda",
             source="src/repro_torch/kernels/hash_decode/csrc/hash_decode.cu",
             replaces="src/repro/kernels/hash_decode/kernel.py:67",
             launches=sum(hd_by_path.values()), launches_by_path=hd_by_path,
             bitwise=timing["max_abs_err"] == 0.0, **timing, train_shape=lm["hash_lm"],
             variants=variants, cached_serve_sizes=serve_sizes,
             batched_serve_sizes=batched_sizes, merchant_sizes=merchant_sizes,
             hashemb_sizes=family_sizes["hashemb"], int8_sizes=family_sizes["int8"],
             codes_host_sizes=host_sizes["float32"],
             codes_host_int8_sizes=host_sizes["int8"], **shard_sizes, **elastic_sizes,
             serve_lm_sizes=serve_lm.pop("serve_lm_sizes"),
             at_decode_step=serve_lm.pop("at_decode_step"), serve_lm=serve_lm,
             families_sizes=family_lm.pop("families_sizes"), families_lm=family_lm,
             audio_vlm_sizes=audio_vlm.pop("audio_vlm_sizes"), audio_vlm=audio_vlm,
             lm_ranks_sizes=lm_ranks.pop("lm_ranks_sizes"), lm_ranks=lm_ranks,
             int8_at_frontier=family_times["int8"],
             tt_decode_not_a_kernel=family_times["tt"],
             cached_serve_bitwise_to_uncached=cached_bitwise,
             instantiations_on_no_path=hd_new),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:85",
             launches=sum(flash_by_path.values()), launches_by_path=flash_by_path,
             launches_by_kernel=flash_by_kernel,
             max_abs_err=flash_err, **lm["flash"], instantiations_on_no_path=flash_new),
        dict(name="lsh_encode", route="cuda",
             source="src/repro_torch/kernels/lsh_encode/csrc/lsh_encode.cu",
             replaces="src/repro/kernels/lsh_encode/kernel.py:54",
             launches=sum(lsh_by_path.values()), launches_by_path=lsh_by_path,
             launches_by_kernel=lsh_by_kernel,
             bitwise=lsh["max_abs_err"] == 0, max_abs_err=lsh["max_abs_err"],
             gaussian_differing_bits=lsh["gaussian_differing_bits"],
             vocabulary_differing_bits=vocab_flips,
             library="torch.mm(A, V_all), the projection kernel's product",
             **lsh_times[rec_shape]["project"], kernels=lsh_times),
        dict(name="hash_decode_backward", route="cuda",
             source="src/repro_torch/kernels/hash_decode/csrc/hash_decode.cu",
             replaces="src/repro/kernels/hash_decode/ops.py:125 (_bwd, XLA; not a TPU kernel)",
             launches=sum(bwd_by_path.values()), launches_by_path=bwd_by_path,
             launches_by_kernel=bwd_by_kernel,
             bitwise=bwd_err == 0.0, bitwise_cases=bwd_cases, max_abs_err=bwd_err,
             **{k: v for k, v in bwd_times["frontier"].items() if k != "rows"},
             frontier_rows=frontier_rows, at_61696=bwd_times["cap"],
             at_lm_bf16=bwd_times["lm"], at_reconstruct_graph=bwd_times["reconstruct"],
             at_full_graph=bwd_times["full"], instantiations_on_no_path=bwd_new),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
