"""The port on a CUDA card: the hand-written ``hash_decode`` kernel against
its plain PyTorch version, its backward, the kernel backend inside the
serving path, the device-side LSH encode, the hand-written
``flash_attention`` kernels (bf16 on the tensor cores, f32 on the CUDA
cores) against their plain version, the LM train
step on the card against the CPU, the hand-written ``lsh_encode`` kernel
against its plain version, the reconstruction path on the card against
the CPU, and the GNN training slice: the ``hash_decode`` backward kernel
against its plain version, a GNN step on the card against the CPU, a
resumed run against a straight one, and ``PrefetchIterator`` on CUDA; and
the full-graph slice: both kernels at every node of the serve graph, the
device-resident sparse product, full-graph GCN / SGC / GIN steps against
the CPU and a resumed GCN run; and several ranks (``parallel``): four gloo
ranks sharing the card, and NCCL ranks one card each where there are
enough cards (``cuda_cards``); and elastic training: a rank killed and the
run continued on 3 ranks bitwise its reference, on gloo and over NCCL;
and LM serving: the engine on the kernel bitwise the engine on the gather
backend, the KV cache's writes on the card bitwise the CPU's, and the
chunked cross-entropy on the card within 1e-4 of the CPU's (f32 cuBLAS
and CPU matmuls sum in other orders); and the moe, ssm and hybrid LM
families: reduced configs on the card against the CPU, the moe gradient
the same bits twice, the SSM recurrence against the chunked scan, and each
family's kernel engine bitwise its gather engine.

Every test carries the ``gpu`` marker and skips without a card.  The file
imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_gpu.py

Tolerances: the kernel and the plain version do the same f32 adds in the
same order without FMA contraction, so they must agree bitwise.  The
decoder MLP and SAGE layers after the decode are the same cuBLAS calls on
the same bits, so embeddings through the kernel and the gather backend
must also agree (checked to 1e-6).  The ``hash_decode`` backward kernel
sums each codebook row's gradient in ascending row order, as its plain
version does on the CPU: bitwise, and two calls give the same bits; through
autograd it must match the gradient of the plain forward to 1e-5 of the
largest gradient (that gradient sums in another order).  A GNN step on the
card and on the CPU agree within 1e-4 on the loss (f32 cuBLAS and CPU
matmuls sum in other orders); a resumed run on the card equals the straight
one bit for bit.  ``flash_attention``
against its plain version, as ``assert_allclose(rtol=tol, atol=tol)``:
2e-5 in float32 (f32 FMAs against f32 cuBLAS products), 2e-2 in bfloat16 (the plain version takes the scores and
``w @ v`` in bf16 as ``mha_ref`` does; ``tests/test_kernels.py``'s
tolerances).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs.paper_gnn import paper_gnn_config
from repro_torch.core import backend as backend_mod
from repro_torch.core import codes as codes_lib
from repro_torch.core import embedding as emb_lib
from repro_torch.core import lsh
from repro_torch.device import disable_tf32
from repro_torch.graph.generate import powerlaw_graph
from repro_torch.graph.runtime import GraphRuntime, GraphSource, RuntimeSpec
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.hash_decode import ops
from repro_torch.kernels.hash_decode.ref import hash_decode_ref

pytestmark = pytest.mark.gpu

SHAPES = [(256, 16, 256, 512), (128, 128, 2, 512), (100, 8, 16, 96),
          (61_696, 16, 256, 512), (1, 3, 8, 5), (33, 4, 4, 130)]
VARIANTS = ["float32", "float32+w0", "bfloat16", "bfloat16+w0", "int8", "int8+w0"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100, see README)")
    disable_tf32()
    return torch.device("cuda")


def _operands(shape, variant, device, seed=3):
    B, m, c, d_c = shape
    rng = np.random.default_rng(seed)
    codes = torch.from_numpy(rng.integers(0, c, (B, m)).astype(np.int32))
    cb = torch.from_numpy(rng.standard_normal((m, c, d_c)).astype(np.float32))
    w0 = torch.from_numpy(rng.standard_normal(d_c).astype(np.float32))
    dtype, _, with_w0 = variant.partition("+")
    scales = None
    if dtype == "bfloat16":
        cb, w0 = cb.to(torch.bfloat16), w0.to(torch.bfloat16).float()
    elif dtype == "int8":
        cb, scales = ops.quantize_codebooks(cb)
    return [None if t is None else t.to(device)
            for t in (codes, cb, w0 if with_w0 else None, scales)]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_bitwise_plain_version(cuda, shape, variant):
    args = _operands(shape, variant, cuda)
    before = ops.hash_decode.launches
    got = ops.hash_decode(*args)
    torch.cuda.synchronize()
    assert ops.hash_decode.launches == before + 1
    assert torch.equal(got, hash_decode_ref(*args))


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("B", [1, 512, 61_696])
def test_staged_and_direct_variants_bitwise_across_48k_of_shared_memory(cuda, B, variant):
    """m = 16, c = 256: a slice of every codebook needs 128 KiB of shared
    memory (144 KiB with int8 scales), above the 48 KiB of static shared
    memory; d_c = 130 is a multiple of no slice width (8, 16, 32).  Both
    variants, and the launcher's choice, give the plain version's bits,
    and the same bits on a second call."""
    shape = (B, 16, 256, 130)
    args = _operands(shape, variant, cuda, seed=B)
    ref = hash_decode_ref(*args)
    for forced in ("staged", "direct"):
        first = ops._forward(*args, variant=forced)
        assert torch.equal(first, ref), forced
        assert torch.equal(ops._forward(*args, variant=forced), first), forced
    before = ops.hash_decode.launches
    assert torch.equal(ops.hash_decode(*args), ref)
    assert ops.hash_decode.launches == before + 1


def test_auto_backend_is_the_kernel_on_cuda(cuda):
    be = backend_mod.get_backend("auto", device=cuda)
    assert isinstance(be, backend_mod.KernelBackend)
    codes, cb, _, _ = _operands((500, 16, 256, 512), "float32", cuda)
    before = ops.hash_decode.launches
    out = be.decode(codes, cb)
    assert ops.hash_decode.launches == before + 1
    assert torch.equal(out, backend_mod.GatherBackend().decode(codes, cb))


def test_lsh_on_card_is_deterministic(cuda):
    adj, _ = powerlaw_graph(0, 3000, avg_degree=10, n_classes=8)

    def encode(device):
        g = torch.Generator(device=device).manual_seed(0)
        V = [torch.randn(3000, 32, generator=g, device=device) for _ in range(4)]
        return lsh.encode_lsh(adj, 256, 16, projections=[v.to(device) for v in V])

    a, b = encode(cuda), encode(cuda)
    assert torch.equal(a, b)
    g = torch.Generator(device=cuda).manual_seed(0)
    V = [torch.randn(3000, 32, generator=g, device=cuda).cpu() for _ in range(4)]
    cpu = lsh.encode_lsh(adj, 256, 16, projections=V)
    bits_a = np.unpackbits(codes_lib.to_uint32(a).view(np.uint8))
    bits_c = np.unpackbits(codes_lib.to_uint32(cpu).view(np.uint8))
    assert (bits_a == bits_c).mean() >= 0.999


def test_serving_through_kernel_matches_gather(cuda):
    cfg = paper_gnn_config("sage", n_nodes=2000, n_classes=8, fanout=5)
    cfg = dataclasses.replace(cfg, embedding=dataclasses.replace(
        cfg.embedding, lookup_impl="auto"))
    spec = RuntimeSpec(graph=GraphSource(n_nodes=2000, n_classes=8), model=cfg,
                       serve_batch=64)
    rt = GraphRuntime.from_spec(spec)
    assert rt.device.type == "cuda"
    kernel = rt.serve(cache_capacity=0)
    gather = rt.serve(cache_capacity=0, decode_backend="gather")
    ids = np.arange(0, 2000, 37)[:64]
    before = ops.hash_decode.launches
    rk = kernel.serve(ids)
    assert ops.hash_decode.launches == before + 1
    rg = gather.serve(ids)
    assert ops.hash_decode.launches == before + 1
    np.testing.assert_allclose(rk.embeddings, rg.embeddings, rtol=0, atol=1e-6)
    fb = kernel.frontier_for(ids).to(cuda)
    ecfg = rt.cfg.embedding_config()
    codes = emb_lib.lookup_codes(rt.params["embed"], fb.unique, ecfg)
    cb = rt.params["embed"]["decoder"]["codebooks"]
    assert torch.equal(kernel.model.backend.decode(codes, cb),
                       gather.model.backend.decode(codes, cb))


FLASH_CASES = [(2, 4, 4, 256, 64, True, "bfloat16"), (2, 4, 4, 256, 64, True, "float32"),
               (1, 8, 2, 300, 128, True, "bfloat16"), (1, 8, 2, 300, 128, True, "float32"),
               (1, 4, 4, 1000, 64, True, "bfloat16"), (2, 4, 1, 130, 32, False, "float32"),
               (1, 2, 2, 64, 32, True, "float32"), (3, 2, 2, 1, 64, True, "bfloat16"),
               # the bf16 kernel's tile edges (128-row query and key tiles):
               # S in {1, 127, 129, 1000}, every D, GQA K = 1 and 2, causal and full
               (1, 4, 1, 1, 32, True, "bfloat16"), (1, 8, 2, 1, 128, False, "bfloat16"),
               (2, 4, 2, 127, 64, True, "bfloat16"), (1, 4, 2, 127, 32, False, "bfloat16"),
               (2, 4, 1, 129, 64, True, "bfloat16"), (2, 4, 2, 129, 128, False, "bfloat16"),
               (2, 2, 2, 129, 32, True, "bfloat16"), (1, 4, 1, 1000, 128, True, "bfloat16"),
               (1, 4, 4, 1000, 64, False, "bfloat16"), (1, 4, 2, 1000, 32, True, "bfloat16")]
# Sq != Skv through the bf16 kernel: (Sq, Skv, causal); causal is the
# plain version's top-left mask (key position <= query position)
FLASH_RAGGED = [(129, 300, True), (300, 129, True), (1, 1000, False), (1000, 1, True),
                (127, 256, False)]


def _qkv(B, H, K, S, D, dtype, device, seed=0, Skv=None):
    rng = np.random.default_rng(seed)
    dt = backend_mod.torch_dtype(dtype)
    Skv = S if Skv is None else Skv
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device, dt)
            for shape in ((B, S, H, D), (B, Skv, K, D), (B, Skv, K, D))]


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_kernel_matches_plain_version(cuda, case):
    B, H, K, S, D, causal, dtype = case
    q, k, v = _qkv(B, H, K, S, D, dtype, cuda)
    before = fa_ops.flash_attention.launches
    got = fa_ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention.launches == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    ref = attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("case", FLASH_RAGGED, ids=lambda c: "-".join(map(str, c)))
def test_flash_bf16_kernel_query_and_key_lengths_differ(cuda, case):
    Sq, Skv, causal = case
    q, k, v = _qkv(2, 4, 2, Sq, 64, "bfloat16", cuda, seed=5, Skv=Skv)
    got = fa_ops.flash_attention(q, k, v, causal=causal)
    assert got.shape == q.shape
    ref = attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), ref.float(), rtol=2e-2, atol=2e-2)


def test_flash_launches_are_counted_by_kernel(cuda):
    """A bf16 call launches the tensor-core kernel, an f32 call the
    CUDA-core one; each moves only its own count."""
    counts = fa_ops.flash_attention.launches_by_kernel
    for dtype, name in (("bfloat16", "bf16_wgmma"), ("float32", "f32_cuda_core")):
        before = dict(counts)
        fa_ops.flash_attention(*_qkv(1, 4, 2, 200, 64, dtype, cuda))
        torch.cuda.synchronize()
        assert counts == {**before, name: before[name] + 1}


def test_flash_bf16_kernel_is_deterministic(cuda):
    """No atomics: two calls on the same inputs give the same bits."""
    q, k, v = _qkv(2, 8, 2, 1000, 64, "bfloat16", cuda, seed=6)
    assert torch.equal(fa_ops.flash_attention(q, k, v), fa_ops.flash_attention(q, k, v))


def test_flash_bf16_kernel_rejects_unaligned_operands(cuda):
    q, k, v = _qkv(1, 4, 2, 64, 64, "bfloat16", cuda)
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)[1:].view(q.shape)
    shifted.copy_(q)
    with pytest.raises(ValueError, match="aligned"):
        fa_ops.flash_attention(shifted, k, v)


def test_flash_kernel_gradients_are_the_plain_recompute(cuda):
    q, k, v = (t.requires_grad_(True) for t in _qkv(2, 4, 2, 200, 64, "float32", cuda))
    G = torch.randn(q.shape, generator=torch.Generator(cuda).manual_seed(1), device=cuda)
    (fa_ops.flash_attention(q, k, v) * G).sum().backward()
    mine = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    (attention_ref(q, k, v, causal=True) * G).sum().backward()
    for a, t in zip(mine, (q, k, v)):
        assert torch.equal(a, t.grad)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hash_decode_backward_is_deterministic_and_matches_plain(cuda, dtype):
    codes, cb, w0, _ = _operands((8192, 16, 256, 512), "float32+w0", cuda)
    cb = cb.to(backend_mod.torch_dtype(dtype))
    G = torch.randn(8192, 512, generator=torch.Generator(cuda).manual_seed(2), device=cuda)

    def grads(fn):
        c, w = cb.clone().requires_grad_(True), w0.clone().requires_grad_(True)
        (fn(codes, c, w) * G).sum().backward()
        return c.grad, w.grad

    a, b = grads(ops.hash_decode), grads(ops.hash_decode)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    ref = grads(hash_decode_ref)
    for mine, plain in zip(a, ref):
        assert mine.dtype == plain.dtype
        bound = 1e-5 * float(plain.float().abs().max())
        if dtype == "bfloat16" and mine is a[0]:
            bound = 8e-3 * float(plain.float().abs().max())     # one bf16 rounding
        assert float((mine.float() - plain.float()).abs().max()) <= bound


def test_lm_train_steps_on_card_match_cpu(cuda):
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import TokenStream, TokenStreamConfig
    from repro_torch.models.lm import init_lm
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train import TrainHyper, make_train_step
    cfg = reduced(get_config("qwen1.5-0.5b", attn_impl="flash"))
    cfg = dataclasses.replace(cfg, embedding=dataclasses.replace(
        cfg.embedding, lookup_impl="pallas"))
    params = init_lm(torch.Generator().manual_seed(0), cfg)
    states = {}
    for dev in ("cpu", cuda):
        p = _to(params, dev)
        states[str(dev)] = {"params": p, "opt": adamw_init(p), "step": 0}
    step = make_train_step(cfg, TrainHyper(warmup_steps=1, total_steps=3))
    stream = TokenStream(TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                           batch_size=2, seed=3))
    before = (ops.hash_decode.launches, fa_ops.flash_attention.launches)
    for _ in range(3):
        b = stream.next_batch()
        losses = []
        for dev, st in states.items():
            _, m = step(st, {k: torch.from_numpy(v).to(dev) for k, v in b.items()})
            losses.append(float(m["loss"]))
        assert abs(losses[0] - losses[1]) <= 1e-4, losses
    assert ops.hash_decode.launches > before[0]
    assert fa_ops.flash_attention.launches == before[1] + 3 * cfg.n_layers


def _to(tree, dev, copy=False):
    return {k: _to(v, dev, copy) if isinstance(v, dict) else v.to(dev, copy=copy)
            for k, v in tree.items()}


# ---------------- lsh_encode ----------------
# Integer-valued A and V in [-3, 3]: every f32 sum is exact, so the kernel
# and its plain version (a cuBLAS product) must give the same bits.  Gaussian
# inputs: a bit may differ only where |U_ref - t| <= 2 d 2**-24 sum|A V|
# (two f32 sums in different orders, each within d 2**-24 sum|A V| of the
# exact one, with t between them).

LSH_SHAPES = [(2048, 512, 32), (1024, 256, 16), (512, 128, 32), (1000, 300, 32),
              (333, 7, 5), (65, 33, 1), (1, 1, 32), (64, 32, 31), (3000, 1000, 17)]


def _lsh(n, d, w, kind, device, seed=0):
    from repro_torch.kernels.lsh_encode.ref import median0
    g = torch.Generator(device).manual_seed(seed)
    if kind == "integer":
        A = torch.randint(-3, 4, (n, d), generator=g, device=device).float()
        V = torch.randint(-3, 4, (d, w), generator=g, device=device).float()
    else:
        A = torch.randn(n, d, generator=g, device=device)
        V = torch.randn(d, w, generator=g, device=device)
    return A, V, median0(A @ V)


@pytest.mark.parametrize("shape", LSH_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_lsh_kernel_bitwise_at_integer_inputs(cuda, shape):
    from repro_torch.kernels.lsh_encode import ops as lsh_ops
    from repro_torch.kernels.lsh_encode.ref import lsh_encode_word_ref
    A, V, t = _lsh(*shape, "integer", cuda)
    before = lsh_ops.launches_by_kernel["fused"]
    got = lsh_ops.lsh_encode_word(A, V, t)
    torch.cuda.synchronize()
    assert lsh_ops.launches_by_kernel["fused"] == before + 1
    assert got.dtype == torch.int64 and int(got.max()) < 2 ** shape[2]
    assert torch.equal(got, lsh_encode_word_ref(A, V, t))


@pytest.mark.parametrize("shape", [(20000, 300, 32), (4096, 512, 32), (999, 77, 9)],
                         ids=lambda s: "x".join(map(str, s)))
def test_lsh_kernel_flips_only_within_rounding_at_gaussian_inputs(cuda, shape):
    from repro_torch.kernels.lsh_encode import ops as lsh_ops
    from repro_torch.kernels.lsh_encode.ref import lsh_encode_word_ref
    A, V, t = _lsh(*shape, "gaussian", cuda, seed=1)
    got, ref = lsh_ops.lsh_encode_word(A, V, t), lsh_encode_word_ref(A, V, t)
    shifts = torch.arange(shape[2], device=cuda)
    differ = (((got ^ ref)[:, None] >> shifts) & 1).bool()
    slack = 2 * shape[1] * 2.0 ** -24 * (A.abs() @ V.abs())
    assert not (differ & ((A @ V - t).abs() > slack)).any()
    assert float(differ.float().mean()) <= 1e-3


def _launched_since(before):
    from repro_torch.kernels.lsh_encode import ops as lsh_ops
    return {k: v - before[k] for k, v in lsh_ops.launches_by_kernel.items() if v != before[k]}


def test_lsh_encode_on_card_reads_A_once_per_encode(cuda):
    """Dense A: one pass over A for up to 128 bits through ``core.lsh`` and
    ``lsh_encode_packed`` -- the exact median one projection and one pack,
    zero thresholds and a sampled median one fused launch -- the same words
    from one generator state, and the CPU's plain version's words at
    integer inputs; CSR A: no launch."""
    from repro_torch.device import make_generator
    from repro_torch.kernels.lsh_encode import ops as lsh_ops
    A = torch.randint(-3, 4, (5000, 300), generator=torch.Generator(cuda).manual_seed(0),
                      device=cuda).float()
    proj = [torch.randint(-3, 4, (300, w), generator=torch.Generator().manual_seed(w)).float()
            for w in (32, 32, 16)]                          # c=16, m=20: 80 bits
    before = dict(lsh_ops.launches_by_kernel)
    on_card = lsh.encode_lsh(A, 16, 20, projections=[p.to(cuda) for p in proj])
    assert _launched_since(before) == {"project": 1, "pack": 1}
    assert torch.equal(on_card.cpu(), lsh.encode_lsh(A.cpu(), 16, 20, projections=proj))
    zero = lsh.encode_lsh(A, 16, 20, threshold="zero", projections=[p.to(cuda) for p in proj])
    assert _launched_since(before) == {"project": 1, "pack": 1, "fused": 1}
    assert torch.equal(zero.cpu(), lsh.encode_lsh(A.cpu(), 16, 20, threshold="zero",
                                                  projections=proj))
    before = dict(lsh_ops.launches_by_kernel)
    a = lsh_ops.lsh_encode_packed(A, 256, 16, generator=make_generator(3, cuda))
    b = lsh.encode_lsh(A, 256, 16, generator=make_generator(3, cuda))
    assert torch.equal(a, b) and _launched_since(before) == {"project": 2, "pack": 2}
    before = dict(lsh_ops.launches_by_kernel)
    sampled = lsh_ops.lsh_encode_packed(A, 256, 16, generator=make_generator(3, cuda),
                                        median_sample=1000)
    assert sampled.shape == a.shape and _launched_since(before) == {"fused": 1}
    adj, _ = powerlaw_graph(0, 500, avg_degree=6, n_classes=4)
    before = dict(lsh_ops.launches_by_kernel)
    lsh.encode_lsh(adj, 16, 8, generator=make_generator(0, cuda))
    assert _launched_since(before) == {}


@pytest.mark.parametrize("kind", ["integer", "gaussian"])
@pytest.mark.parametrize("n,d,w", [(1000, 300, 9), (4097, 77, 32), (333, 512, 80),
                                   (2049, 301, 128)], ids=lambda v: str(v))
def test_lsh_wide_entries_match_the_plain_version(cuda, n, d, w, kind):
    """``project``, ``pack`` and ``lsh_encode_words`` at W up to 128 with
    ragged n and d: bitwise at integer inputs; at Gaussian inputs U within
    each sum's rounding bound of cuBLAS's and the words flipping only
    within it -- with odd n each column's middle entry is its own median,
    so up to one bit a column flips on top of 0.1% of the rest; two calls
    give the same bits."""
    from repro_torch.kernels.lsh_encode import ops as lsh_ops
    from repro_torch.kernels.lsh_encode.ref import lsh_encode_words_ref
    A, V, t = _lsh(n, d, w, kind, cuda, seed=w)
    U, ref = lsh_ops.project(A, V), lsh_encode_words_ref(A, V, t)
    fused, packed = lsh_ops.lsh_encode_words(A, V, t), lsh_ops.pack(U, t)
    assert torch.equal(U, lsh_ops.project(A, V))
    assert torch.equal(fused, lsh_ops.lsh_encode_words(A, V, t))
    assert fused.shape == (n, -(-w // 32)) and fused.dtype == torch.int64
    if kind == "integer":
        assert torch.equal(U, A @ V) and torch.equal(fused, ref) and torch.equal(packed, ref)
        return
    slack = d * 2.0 ** -24 * (A.abs() @ V.abs())
    assert bool(((U - A @ V).abs() <= 2 * slack).all())
    shifts = torch.arange(32, device=cuda)
    for got in (fused, packed):
        differ = (((got ^ ref)[:, :, None] >> shifts) & 1).bool().reshape(n, -1)[:, :w]
        assert not (differ & ((A @ V - t).abs() > 2 * slack)).any()
        assert int(differ.sum()) <= (w if n % 2 else 0) + 1e-3 * n * w


def test_lsh_kernel_rejects_bad_operands_on_card(cuda):
    from repro_torch.kernels.lsh_encode import ops as lsh_ops
    A, V, t = _lsh(64, 40, 8, "gaussian", cuda)
    with pytest.raises(TypeError):
        lsh_ops.lsh_encode_word(A.half(), V, t)
    with pytest.raises(TypeError):
        lsh_ops.lsh_encode_word(A, V.double(), t)
    with pytest.raises(ValueError):
        lsh_ops.lsh_encode_word(A.t().contiguous().t(), V, t)      # not contiguous
    with pytest.raises(ValueError):
        lsh_ops.lsh_encode_word(A[:, ::2], V[::2].contiguous(), t)
    with pytest.raises(ValueError):
        lsh_ops.lsh_encode_word(A, V, t.cpu())                      # two devices


def test_small_reconstruct_path_on_card_matches_cpu(cuda):
    """The reconstruction path at the JAX benchmark's size: codes of
    integer-valued embeddings with integer projections bitwise, 5 decoder
    steps from one init with the same ids within 1e-4."""
    from repro_torch.core.embedding import init_embedding
    from repro_torch.graph.generate import clustered_embeddings
    from repro_torch.train.reconstruct import (reconstruction_config,
                                               train_decoder_on_reconstruction)
    n, dim = 2000, 64
    emb_np, _ = clustered_embeddings(0, n, dim)
    A = torch.from_numpy(np.round(8 * emb_np))
    g = torch.Generator().manual_seed(0)
    proj = [torch.round(2 * torch.randn(dim, 32, generator=g)) for _ in range(2)]
    on_card = lsh.encode_lsh(A.to(cuda), 16, 16, projections=[p.to(cuda) for p in proj])
    on_cpu = lsh.encode_lsh(A, 16, 16, projections=proj)
    assert torch.equal(on_card.cpu(), on_cpu)
    cfg = reconstruction_config(n, dim, 16, 16, 128, 128)
    init = init_embedding(torch.Generator().manual_seed(0), cfg, codes=on_cpu)
    gi = torch.Generator().manual_seed(1)
    ids = [torch.randint(0, n, (512,), generator=gi) for _ in range(5)]
    emb = torch.from_numpy(emb_np)
    before = ops.hash_decode.launches
    _, card = train_decoder_on_reconstruction(None, emb.to(cuda), None, cfg, 5,
                                              params=_to(init, cuda, copy=True), ids=ids)
    assert ops.hash_decode.launches >= before + 5
    _, cpu = train_decoder_on_reconstruction(None, emb, None, cfg, 5,
                                             params=_to(init, "cpu", copy=True), ids=ids)
    assert max(abs(a - b) for a, b in zip(card, cpu)) <= 1e-4, (card, cpu)


# ---- slice 6: GNN training ---------------------------------------------------

BWD_CASES = [(B, m, c, d_c) for B in (1, 512, 24_064, 61_696)
             for m, c in ((16, 256), (3, 16)) for d_c in (512, 130)]


def _bwd(shape, variant, device, seed=0):
    B, m, c, d_c = shape
    rng = np.random.default_rng(seed)
    codes = torch.from_numpy(rng.integers(0, c, (B, m)).astype(np.int32)).to(device)
    g = torch.from_numpy(rng.standard_normal((B, d_c)).astype(np.float32)).to(device)
    dtype, _, with_w0 = variant.partition("+")
    w0 = (torch.from_numpy(rng.standard_normal(d_c).astype(np.float32)).to(device)
          if with_w0 else None)
    return codes, g, w0, {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]


@pytest.mark.parametrize("variant", ["float32", "float32+w0", "bfloat16", "bfloat16+w0"])
@pytest.mark.parametrize("shape", BWD_CASES, ids=lambda s: "x".join(map(str, s)))
def test_backward_kernel_bitwise_plain_version(cuda, shape, variant):
    from repro_torch.kernels.hash_decode.ref import hash_decode_backward_ref
    codes, g, w0, dtype = _bwd(shape, variant, cuda)
    c = shape[2]
    before = ops.hash_decode_backward.launches
    a = ops.codebook_grad(codes, g, w0, c, dtype)
    b = ops.codebook_grad(codes, g, w0, c, dtype)
    torch.cuda.synchronize()
    assert ops.hash_decode_backward.launches == before + 2
    ref = hash_decode_backward_ref(codes.cpu(), g.cpu(), None if w0 is None else w0.cpu(),
                                   c, dtype)
    assert a.dtype == dtype and torch.equal(a.cpu(), ref) and torch.equal(a, b)


# skewed code sets (kind, B, m, c, d_c) of ``ref.code_set``: every row one
# code per codebook (codebook 0's out of range above, codebook 1's below,
# both clamped), Zipf codes, c = 16 at 61,696 rows (segments of about 3,900
# rows), and the sort's part sizes on either side of 32 parts of 512 rows
# (B <= 16,384: parts of 512 rows; 16,385: 17 parts of 1,024, the last of 1)
BWD_SKEWED = [("one_code", 24_064, 16, 256, 512), ("one_code", 61_696, 3, 16, 130),
              ("one_code", 512, 16, 256, 512), ("zipf", 24_064, 16, 256, 512),
              ("zipf", 61_696, 16, 256, 130), ("zipf", 16_384, 16, 256, 130),
              ("uniform", 61_696, 16, 16, 512), ("uniform", 16_385, 3, 16, 130)]


def _skewed_codes(kind, B, m, c, seed=0):
    from repro_torch.kernels.hash_decode.ref import code_set
    return torch.from_numpy(code_set(kind, B, m, c, np.random.default_rng(seed)))


@pytest.mark.parametrize("variant", ["float32", "float32+w0", "bfloat16", "bfloat16+w0"])
@pytest.mark.parametrize("case", BWD_SKEWED, ids=lambda s: "x".join(map(str, s)))
def test_backward_kernel_bitwise_on_skewed_codes(cuda, case, variant):
    from repro_torch.kernels.hash_decode.ref import hash_decode_backward_ref
    kind, B, m, c, d_c = case
    _, g, w0, dtype = _bwd((B, m, c, d_c), variant, cuda, seed=1)
    codes = _skewed_codes(kind, B, m, c).to(cuda)
    a = ops.codebook_grad(codes, g, w0, c, dtype)
    b = ops.codebook_grad(codes, g, w0, c, dtype)
    ref = hash_decode_backward_ref(codes.cpu(), g.cpu(), None if w0 is None else w0.cpu(),
                                   c, dtype)
    assert torch.equal(a.cpu(), ref) and torch.equal(a, b)


@pytest.mark.parametrize("case", BWD_SKEWED + [("clamped", 1, 3, 16, 0), ("clamped", 9_999, 16, 256, 0),
                                               ("clamped", 0, 4, 16, 0)],
                         ids=lambda s: "x".join(map(str, s)))
def test_sort_kernel_matches_code_order(cuda, case):
    from repro_torch.kernels.hash_decode.ref import code_order
    kind, B, m, c, _ = case
    codes = _skewed_codes(kind, B, m, c, seed=2 if kind == "clamped" else 0)
    offsets, rows = ops.code_order(codes.to(cuda), c)
    want_offsets, want_rows = code_order(codes, c)
    assert torch.equal(offsets.cpu(), want_offsets) and torch.equal(rows.cpu(), want_rows)


def test_backward_sizes_from_the_library(cuda):
    """The scratch holds the sort's offsets (m, c+1), rows (m, B) and 32
    parts' (m, c) counts.  A count block's (m, c) int32 histogram and a
    place block's (c*18 + 17) ints must fit a block's 227 KiB of shared
    memory: m*c above 58,112 or c above 3,227 is refused before any launch,
    whatever B."""
    assert ops.sort_sizes(24_064, 16, 256) == (16 * 257 + 16 * 24_064 + 32 * 16 * 256,
                                               32 * 16 * 256)
    ops.sort_sizes(1, 32, 1_816)                         # m*c = 58,112
    ops.sort_sizes(1, 1, 3_227)
    for m, c in ((32, 1_817), (1, 3_228), (256, 1024)):
        with pytest.raises(ValueError, match="shared memory"):
            ops.sort_sizes(8, m, c)
        codes = torch.zeros(8, m, dtype=torch.int32, device=cuda)
        with pytest.raises(ValueError, match="shared memory"):
            ops.codebook_grad(codes, torch.zeros(8, 4, device=cuda), None, c, torch.float32)


def _gnn_spec(n=3000, **kw):
    cfg = paper_gnn_config("sage", n_nodes=n, n_classes=8)
    cfg = dataclasses.replace(cfg, embedding=dataclasses.replace(cfg.embedding,
                                                                 lookup_impl="pallas"))
    return RuntimeSpec(graph=GraphSource(n_nodes=n, n_classes=8), model=cfg,
                       batch_size=64, **kw)


def test_gnn_train_steps_on_card_match_cpu(cuda):
    spec = _gnn_spec(prefetch_depth=0)
    card = GraphRuntime.from_spec(spec)
    cpu = GraphRuntime.from_spec(spec, graph=(card.adj, card.labels), device="cpu",
                                 params=_to(card.params, "cpu", copy=True))
    ops.hash_decode.launches = ops.hash_decode_backward.launches = 0
    ops.backward_kernel_launches(reset=True)
    a, b = card.train(3).losses, cpu.train(3).losses
    assert ops.hash_decode.launches == 3 and ops.hash_decode_backward.launches == 3
    assert ops.backward_kernel_launches() == {"count": 3, "place": 3, "sum": 3}
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    ev_card, ev_cpu = card.evaluate("val"), cpu.evaluate("val")
    assert ev_card["n"] == ev_cpu["n"] == len(card.splits["val"])
    assert abs(ev_card["loss"] - ev_cpu["loss"]) <= 1e-4


def test_gnn_resume_on_card_is_bitwise(cuda, tmp_path):
    init = GraphRuntime.from_spec(_gnn_spec(prefetch_depth=0))
    graph = (init.adj, init.labels)

    def run(d, steps):
        rt = GraphRuntime.from_spec(_gnn_spec(ckpt_dir=str(tmp_path / d), ckpt_every=2),
                                    graph=graph, params=_to(init.params, cuda, copy=True))
        res = rt.train(steps)
        rt.close()
        return rt, res

    straight, res_a = run("a", 6)
    _, res_b = run("b", 3)
    resumed = GraphRuntime.resume(str(tmp_path / "b"), graph=graph)
    res_c = resumed.train(6)
    resumed.close()
    assert res_c.resumed_from == 3 and res_b.losses + res_c.losses == res_a.losses
    from repro_torch.nn.module import leaves_with_path
    want, got = dict(leaves_with_path(straight.params)), dict(leaves_with_path(resumed.params))
    assert want.keys() == got.keys()
    assert all(torch.equal(want[k], got[k]) for k in want)


def test_prefetch_on_cuda_gives_the_sync_batches(cuda):
    from repro_torch.graph.engine import PrefetchIterator, SageBatchSource
    from repro_torch.graph.sampler import NeighborSampler
    adj, labels = powerlaw_graph(0, 3000, n_classes=8)

    def source():
        return SageBatchSource(NeighborSampler(adj, (15, 15)), np.arange(3000), labels,
                               256, seed=3)

    sync = source()
    expect = [sync.next_batch() for _ in range(6)]
    with PrefetchIterator(source(), depth=2, device=cuda) as pf:
        got = []
        for _ in range(6):
            b = pf.next_batch()
            # work on the consumer's stream, as a step would, before reading
            got.append({"labels": b["labels"].clone(),
                        "unique": b["frontier"].unique * 1,
                        "maps": [m + 0 for m in b["frontier"].index_maps]})
            del b
            torch.cuda.synchronize()
    for a, b in zip(expect, got):
        assert b["unique"].device.type == "cuda"
        np.testing.assert_array_equal(a["labels"], b["labels"].cpu().numpy())
        np.testing.assert_array_equal(a["frontier"].unique, b["unique"].cpu().numpy())
        for ma, mb in zip(a["frontier"].index_maps, b["maps"]):
            np.testing.assert_array_equal(ma, mb.cpu().numpy())


# ---------------- the hot-node cache on the card ----------------

CACHE_FIELDS = ("node_ids", "values", "version", "last_used", "version_counter", "clock",
                "hits", "misses")


def test_cache_lookup_on_card_is_the_cpu_lookup_at_the_serving_shape(cuda):
    """``lookup_missonly`` and ``lookup`` at the paper's served frontier
    (U = 61,696) against a full-graph cache (C = 169,343), three calls
    each, on the card and on the CPU from one state: outputs and every
    field bitwise (stable sorts, searches and scatters of distinct slots;
    the values are a fixed table's rows)."""
    from repro_torch.core.backend import CachedDecodeBackend, CacheState
    Ub, Cb, d = 61_696, 169_343, 64
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.standard_normal((Cb, d)).astype(np.float32))
    states = {dev: CacheState.create(Cb, d, device=dev) for dev in ("cpu", cuda)}
    cache = CachedDecodeBackend(staleness=1)
    for k in range(6):
        ids = rng.choice(Cb, Ub, replace=False).astype(np.int32)
        valid = np.arange(Ub) < Ub - 97
        n_dec = Ub if k % 3 == 0 else 4096 * (k + 1)
        outs = {}
        for dev, st in states.items():
            t = torch.from_numpy(ids).to(dev)
            v = torch.from_numpy(valid).to(dev)
            dec = (lambda i, dev=dev: table.to(dev)[i.long()])
            if k % 2:
                outs[dev], states[dev] = cache.lookup_missonly(st, t, dec, n_dec, valid=v)
            else:
                outs[dev], states[dev] = cache.lookup(st, t, dec, valid=v)
            if k == 3:
                states[dev] = CachedDecodeBackend.bump_version(states[dev])
        assert torch.equal(outs[cuda].cpu(), outs["cpu"]), f"call {k}"
        for f in CACHE_FIELDS:
            assert torch.equal(getattr(states[cuda], f).cpu(), getattr(states["cpu"], f)), f
    assert int(states["cpu"].hits) > 0


def test_in_place_cache_on_card_is_the_functional_one(cuda):
    """``lookup_missonly(..., buffers=)``, the serving engine's in-place
    update, against the functional call on the card at the served
    frontier (U = 61,696, C = 169,343): four planned calls, the last a
    repeat that decodes nothing; outputs and every field bitwise."""
    from repro_torch.core.backend import CachedDecodeBackend, CacheState
    Ub, Cb, d = 61_696, 169_343, 64
    rng = np.random.default_rng(1)
    table = torch.from_numpy(rng.standard_normal((Cb, d)).astype(np.float32)).to(cuda)
    cache = CachedDecodeBackend(staleness=0)
    functional = CacheState.create(Cb, d, device=cuda)
    buffers = CacheState.create(Cb + 1, d, device=cuda)
    in_place = buffers.head(Cb)
    requests = [rng.choice(Cb, Ub, replace=False).astype(np.int32) for _ in range(3)]
    for k, ids in enumerate(requests + requests[-1:]):
        valid = np.arange(Ub) < Ub - 97
        held = functional.node_ids.cpu().numpy()
        perm, n_miss = CachedDecodeBackend.plan_missonly(held[held >= 0], ids, valid)
        n_dec = CachedDecodeBackend.miss_bucket(n_miss, 256, Ub)
        t = torch.from_numpy(ids[perm]).to(cuda)
        v = torch.from_numpy(valid[perm]).to(cuda)
        a, functional = cache.lookup_missonly(functional, t, lambda i: table[i.long()],
                                              n_dec, valid=v)
        b, in_place = cache.lookup_missonly(in_place, t, lambda i: table[i.long()],
                                            n_dec, valid=v, buffers=buffers)
        assert (n_dec == 0) == (k == 3), (k, n_dec)
        assert torch.equal(a, b), f"call {k}"
        for f in CACHE_FIELDS:
            assert torch.equal(getattr(in_place, f), getattr(functional, f)), (k, f)
    assert in_place.values.data_ptr() == buffers.values.data_ptr()


def _cached(spec, **emb):
    return dataclasses.replace(spec, model=dataclasses.replace(
        spec.model, embedding=dataclasses.replace(spec.model.embedding, **emb)))


def test_cached_staleness0_training_on_card_is_the_uncached_run(cuda):
    """Staleness 0 through the kernel backend on the card: every row
    re-decodes every step, so the losses and params are the uncached run's
    bit for bit and nothing hits."""
    base = _gnn_spec(prefetch_depth=2)
    plain = GraphRuntime.from_spec(base)
    init = _to(plain.params, cuda, copy=True)
    a = plain.train(5).losses
    cached = GraphRuntime.from_spec(_cached(base, cache_capacity=4096), graph=(
        plain.adj, plain.labels), params=init)
    ops.hash_decode.launches = 0
    b = cached.train(5).losses
    assert ops.hash_decode.launches == 5 and a == b
    assert int(cached.state["cache"].hits) == 0
    from repro_torch.nn.module import leaves_with_path
    want, got = dict(leaves_with_path(plain.params)), dict(leaves_with_path(cached.params))
    assert all(torch.equal(want[k], got[k]) for k in want)


def test_planned_cached_resume_on_card_is_bitwise(cuda, tmp_path):
    """Staleness 4 with the miss planner: a run killed at 3 and resumed to 6
    equals 6 straight steps bit for bit (losses, params, the card's
    ``CacheState``), and the shadow equals the card's bookkeeping."""
    init = GraphRuntime.from_spec(_gnn_spec(prefetch_depth=0))
    graph = (init.adj, init.labels)
    spec = _cached(_gnn_spec(ckpt_every=3), cache_capacity=4096, cache_staleness=4,
                   cache_plan_misses=True)

    def run(d, steps):
        rt = GraphRuntime.from_spec(dataclasses.replace(spec, ckpt_dir=str(tmp_path / d)),
                                    graph=graph, params=_to(init.params, cuda, copy=True))
        res = rt.train(steps)
        rt.close()
        return rt, res

    straight, res_a = run("a", 6)
    _, res_b = run("b", 3)
    resumed = GraphRuntime.resume(str(tmp_path / "b"), graph=graph)
    res_c = resumed.train(6)
    resumed.close()
    assert res_c.resumed_from == 3 and res_b.losses + res_c.losses == res_a.losses
    assert int(straight.state["cache"].hits) > 0
    for f in CACHE_FIELDS:
        assert torch.equal(getattr(resumed.state["cache"], f),
                           getattr(straight.state["cache"], f)), f
    shadow = resumed.data_iter.state_dict()["miss_shadow"]
    book = resumed.state["cache"].bookkeeping()
    for f in ("node_ids", "version", "last_used"):
        np.testing.assert_array_equal(np.asarray(shadow[f]), book[f])
    from repro_torch.nn.module import leaves_with_path
    want, got = dict(leaves_with_path(straight.params)), dict(leaves_with_path(resumed.params))
    assert all(torch.equal(want[k], got[k]) for k in want)


def test_cached_serve_on_card_equals_uncached(cuda):
    """The default cached engine against ``cache_capacity=0`` on the card,
    over requests with repeats and one ``serve_many``: the decoded miss
    rows go through the same kernel, and the embeddings and logits agree
    within 1e-6 (the decoder MLP runs on the miss prefix, not the whole
    frontier, so cuBLAS may round a row differently; ``chip_smoke.py``
    prints the measured difference)."""
    rt = GraphRuntime.from_spec(_gnn_spec(prefetch_depth=0))
    cached, plain = rt.serve(), rt.serve(cache_capacity=0)
    assert cached.cached and cached.cache_capacity == min(4 * cached.frontier_cap, 3000)
    rng = np.random.default_rng(2)
    reqs = [rng.choice(3000, 256, replace=False) for _ in range(4)]
    ops.hash_decode.launches = 0
    got = [cached.serve(r) for r in reqs + reqs[:2]] + cached.serve_many(reqs[1:])
    assert ops.hash_decode.launches == sum(1 for g in got[:6] if g.rows_decoded) + (
        1 if got[-1].rows_decoded else 0)
    for r, g in zip(reqs + reqs[:2] + reqs[1:], got):
        p = plain.serve(r)
        np.testing.assert_allclose(g.embeddings, p.embeddings, rtol=0, atol=1e-6)
        np.testing.assert_allclose(g.logits, p.logits, rtol=0, atol=1e-6)
    assert got[4].rows_decoded == 0 and cached.stats()["hits"] > 0
    held = cached._cache_state.node_ids.cpu().numpy()      # the host's table of cached ids
    assert not cached._held_stale
    np.testing.assert_array_equal(np.flatnonzero(cached._held), np.sort(held[held >= 0]))


# ---------------- the full-graph slice ----------------
# A full-graph step decodes every node: the kernel and its backward at the
# serve graph's 169,343 rows (m=16, c=256, d_c=512, f32, no w0: the paper
# GCN's decode), bitwise to their plain versions.  The sparse product
# (``DeviceCSR``) is a gather and a segment sum without atomics: its forward
# is ``CSRMatrix.matmat``'s bits and two backward calls give the same bits.
# A full-graph step on the card and on the CPU agree within 1e-4 on the
# loss, as the GraphSAGE step does; a resumed GCN run equals the straight
# one bit for bit.

FULL_ROWS = 169_343


def test_kernels_bitwise_at_the_full_graph_rows(cuda):
    from repro_torch.kernels.hash_decode.ref import hash_decode_backward_ref
    shape = (FULL_ROWS, 16, 256, 512)
    args = _operands(shape, "float32", cuda, seed=19)
    assert torch.equal(ops.hash_decode(*args), hash_decode_ref(*args))
    codes, g, _, dtype = _bwd(shape, "float32", cuda, seed=19)
    a = ops.codebook_grad(codes, g, None, 256, dtype)
    assert torch.equal(a, ops.codebook_grad(codes, g, None, 256, dtype))
    assert torch.equal(a.cpu(), hash_decode_backward_ref(codes.cpu(), g.cpu(), None, 256, dtype))


@pytest.mark.parametrize("width", [64, 128])
def test_device_csr_product_on_card(cuda, width):
    adj, _ = powerlaw_graph(0, 20_000, avg_degree=14, n_classes=8)
    a = adj.with_self_loops().normalized("sym")
    dev = a.on(cuda)
    rng = np.random.default_rng(width)
    X = torch.from_numpy(rng.standard_normal((20_000, width)).astype(np.float32)).to(cuda)
    G = torch.from_numpy(rng.standard_normal((20_000, width)).astype(np.float32)).to(cuda)
    assert torch.equal(dev.matmat(X), a.matmat(X))

    def grad():
        x = X.clone().requires_grad_(True)
        return torch.autograd.grad(dev.matmat(x), x, G)[0]

    ga = grad()
    assert torch.equal(ga, grad())
    np.testing.assert_allclose(ga.cpu().numpy(), a.transpose().matmat(G.cpu()).numpy(),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("model", ["gcn", "sgc", "gin"])
def test_fullgraph_steps_on_card_match_cpu(cuda, model):
    spec = dataclasses.replace(_gnn_spec(), model=dataclasses.replace(_gnn_spec().model,
                                                                      model=model))
    card = GraphRuntime.from_spec(spec)
    cpu = GraphRuntime.from_spec(spec, graph=(card.adj, card.labels), device="cpu",
                                 params=_to(card.params, "cpu", copy=True))
    ops.hash_decode.launches = ops.hash_decode_backward.launches = 0
    a, b = card.train(3).losses, cpu.train(3).losses
    assert ops.hash_decode.launches == 3 and ops.hash_decode_backward.launches == 3
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    ev_card, ev_cpu = card.evaluate("val"), cpu.evaluate("val")
    assert ev_card["n"] == ev_cpu["n"] == len(card.splits["val"])
    assert abs(ev_card["loss"] - ev_cpu["loss"]) <= 1e-4
    with pytest.raises(NotImplementedError, match="full-graph"):
        card.serve()


def test_fullgraph_resume_on_card_is_bitwise(cuda, tmp_path):
    base = _gnn_spec()
    spec = dataclasses.replace(base, model=dataclasses.replace(base.model, model="gcn"))
    init = GraphRuntime.from_spec(spec)
    graph = (init.adj, init.labels)

    def run(d, steps):
        rt = GraphRuntime.from_spec(dataclasses.replace(spec, ckpt_dir=str(tmp_path / d),
                                                        ckpt_every=2),
                                    graph=graph, params=_to(init.params, cuda, copy=True))
        return rt, rt.train(steps)

    straight, res_a = run("a", 6)
    _, res_b = run("b", 3)
    resumed = GraphRuntime.resume(str(tmp_path / "b"), graph=graph)
    res_c = resumed.train(6)
    assert res_c.resumed_from == 3 and res_b.losses + res_c.losses == res_a.losses
    from repro_torch.nn.module import leaves_with_path
    want, got = dict(leaves_with_path(straight.params)), dict(leaves_with_path(resumed.params))
    assert want.keys() == got.keys()
    assert all(torch.equal(want[k], got[k]) for k in want)


# ---------------- the hashemb and tt families, int8 storage ----------------

@pytest.mark.parametrize("with_w0", [False, True], ids=["full", "light"])
@pytest.mark.parametrize("masters", ["float32", "bfloat16"])
def test_int8_kernel_backward_is_its_plain_version(cuda, masters, with_w0):
    """The int8 kernel path at a training frontier (24,064 rows, m=16,
    c=256, d_c=512): the forward and ``d_cb`` bitwise the CPU's plain
    versions, ``d_cb`` bitwise the unquantized kernel path's (it never
    reads codebook values), in the masters' dtype; ``d_w0`` sums the
    cotangent against the int8 decode, within 1e-5 of the CPU's largest
    entry (the reduction over rows sums in another order)."""
    rng = np.random.default_rng(5)
    B, m, c, d_c = 24_064, 16, 256, 512
    dtype = getattr(torch, masters)
    codes = torch.from_numpy(rng.integers(0, c, (B, m)).astype(np.int32))
    cb = torch.from_numpy(rng.standard_normal((m, c, d_c)).astype(np.float32)).to(dtype)
    w0 = torch.from_numpy(rng.standard_normal(d_c).astype(np.float32)) if with_w0 else None
    g = torch.from_numpy(rng.standard_normal((B, d_c)).astype(np.float32))

    def run(device, quantize):
        policy = backend_mod.MixedPrecisionPolicy(quantize=quantize)
        tcb = cb.clone().to(device).requires_grad_(True)
        tw0 = None if w0 is None else w0.clone().to(device).requires_grad_(True)
        out = backend_mod.get_backend("pallas", device=device, policy=policy).decode(
            codes.to(device), tcb, tw0)
        out.backward(g.to(device))
        return out.detach().cpu(), tcb.grad.cpu(), None if tw0 is None else tw0.grad.cpu()

    ops.hash_decode_backward.launches = 0
    out, d_cb, d_w0 = run(cuda, "int8")
    assert ops.hash_decode_backward.launches == 1
    ref_out, ref_cb, ref_w0 = run(torch.device("cpu"), "int8")
    assert d_cb.dtype == dtype
    assert torch.equal(out, ref_out) and torch.equal(d_cb, ref_cb)
    assert torch.equal(d_cb, run(cuda, "none")[1])
    if with_w0:
        np.testing.assert_allclose(d_w0.numpy(), ref_w0.numpy(), rtol=0,
                                   atol=1e-5 * float(ref_w0.abs().max()))


def test_hashemb_decode_on_card_is_the_cpus(cuda):
    """The hashemb decode stage at full width on 24,064 ids: the position
    hashes, the ``wpos`` fold and the kernel on the card give the CPU's
    plain version's bits (``hashemb:pallas`` there; ``auto``'s base on the
    card is the kernel)."""
    from repro_torch.core import decoder as dec_lib
    cfg = emb_lib.EmbeddingConfig(kind="random_full", n_entities=169_343, d_e=64,
                                  lookup_impl="hashemb", compute_dtype="float32")
    params = emb_lib.init_embedding(torch.Generator().manual_seed(0), cfg)
    params["decoder"]["wpos"] = torch.randn(16, 512, generator=torch.Generator().manual_seed(1))
    ids = torch.from_numpy(np.random.default_rng(2).choice(169_343, 24_064, replace=False))
    card = _to(params, cuda, copy=True)
    be = backend_mod.get_backend("hashemb", device=cuda, policy=cfg.decoder_config()
                                 .precision_policy())
    assert be.base.name == "pallas"
    got = dec_lib.decode_stage(card["decoder"], emb_lib.lookup_codes(card, ids.to(cuda), cfg),
                               cfg.decoder_config(), be)
    cpu_cfg = dataclasses.replace(cfg, lookup_impl="hashemb:pallas")
    want = dec_lib.decode_stage(params["decoder"], emb_lib.lookup_codes(params, ids, cpu_cfg),
                                cpu_cfg.decoder_config())
    assert torch.equal(got.cpu(), want)


def test_tt_decode_on_card_matches_cpu_and_its_gradient_is_deterministic(cuda):
    """TT at full width (c=256 -> 16 x 16, d_c=512 -> 16 x 32, r=8) on
    24,064 rows: within 1e-5 of the CPU's largest output (the f32 product
    sums m*r terms in cuBLAS' order); two gradients of one decode bitwise
    equal (the core rows' gather sums each row's cotangents in a fixed
    order; ``F.embedding``'s CUDA backward did not, at these repeats)."""
    rng = np.random.default_rng(3)
    g0 = torch.from_numpy(rng.standard_normal((16, 16, 16, 8)).astype(np.float32))
    g1 = torch.from_numpy(rng.standard_normal((16, 16, 8, 32)).astype(np.float32))
    codes = torch.from_numpy(rng.integers(0, 256, (24_064, 16)).astype(np.int32))
    g = torch.from_numpy(rng.standard_normal((24_064, 512)).astype(np.float32)).to(cuda)
    want = backend_mod.get_backend("tt", device=torch.device("cpu")).decode(codes, (g0, g1))
    cores = tuple(t.to(cuda).requires_grad_(True) for t in (g0, g1))
    be = backend_mod.get_backend("tt", device=cuda)
    ops.hash_decode.launches = 0
    out = be.decode(codes.to(cuda), cores)
    assert ops.hash_decode.launches == 0
    np.testing.assert_allclose(out.detach().cpu().numpy(), want.numpy(), rtol=0,
                               atol=1e-5 * float(want.abs().max()))
    a = torch.autograd.grad(out, cores, g, retain_graph=True)
    b = torch.autograd.grad(out, cores, g, retain_graph=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("family", [dict(lookup_impl="hashemb"),
                                    dict(lookup_impl="tt", tt_rank=8)], ids=["hashemb", "tt"])
def test_family_resume_on_card_is_bitwise(cuda, tmp_path, family):
    init = GraphRuntime.from_spec(_gnn_spec(prefetch_depth=0).with_updates(**family))
    graph = (init.adj, init.labels)

    def run(d, steps):
        spec = _gnn_spec(ckpt_dir=str(tmp_path / d), ckpt_every=2).with_updates(**family)
        rt = GraphRuntime.from_spec(spec, graph=graph, params=_to(init.params, cuda, copy=True))
        res = rt.train(steps)
        rt.close()
        return rt, res

    straight, res_a = run("a", 6)
    _, res_b = run("b", 3)
    resumed = GraphRuntime.resume(str(tmp_path / "b"), graph=graph)
    res_c = resumed.train(6)
    resumed.close()
    assert resumed.spec.model.embedding.lookup_impl == family["lookup_impl"]
    assert res_c.resumed_from == 3 and res_b.losses + res_c.losses == res_a.losses
    from repro_torch.nn.module import leaves_with_path
    want, got = dict(leaves_with_path(straight.params)), dict(leaves_with_path(resumed.params))
    assert want.keys() == got.keys()
    assert all(torch.equal(want[k], got[k]) for k in want)


# ---------------- the frontier gathers' backward at a hub ----------------

HUB_CASES = {  # (frontier rows U, width, level-2 map shape or edge count, hub repeats)
    "train_frontier": (24_064, 64, (2048, 15, 15), 150_000),
    "serve_many_8": (192_512, 64, (2048, 15, 15), 120_000),
    "link_edges": (169_343, 128, 200_000, 120_000),
}


@pytest.mark.parametrize("case", list(HUB_CASES))
def test_frontier_gathers_backward_is_deterministic_at_a_hub(cuda, case):
    """The SAGE forward's frontier gathers (``gnn._levels``) and
    ``link_scores``' row gathers are ``F.embedding``: three backward passes
    with one row repeated 120,000-150,000 times give the same bits (the
    latent item of ROADMAP §C; TT's core gathers parted at another shape)."""
    from repro_torch.graph.sampler import FrontierBatch
    from repro_torch.models import gnn
    U, d, shape, hub = HUB_CASES[case]
    rng = np.random.default_rng(11)
    table = torch.from_numpy(rng.standard_normal((U, d)).astype(np.float32)).to(cuda)

    def with_hub(shape):
        idx = rng.integers(0, U, shape).reshape(-1)
        idx[rng.choice(idx.size, min(hub, idx.size), replace=False)] = 7
        return torch.from_numpy(idx.reshape(shape)).to(cuda)

    if case == "link_edges":
        edges = torch.stack([with_hub(shape), torch.from_numpy(
            rng.integers(0, U, shape)).to(cuda)], 1)

        def loss(t):
            return gnn.link_scores(t, edges).square().sum()
    else:
        B, f1, f2 = shape
        maps = (with_hub((B,)), with_hub((B, f1)), with_hub((B, f1, f2)))
        fb = FrontierBatch(torch.arange(U, device=cuda), maps, U)
        params = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.1).to(cuda)
                  for k, s in (("w1", (2 * d, 128)), ("b1", (128,)), ("w2", (256, 128)),
                               ("b2", (128,)))}

        def loss(t):
            return gnn._levels(params, t, fb).square().sum()
    grads = []
    for _ in range(3):
        t = table.clone().requires_grad_(True)
        loss(t).backward()
        grads.append(t.grad)
    assert all(torch.equal(grads[0], g) for g in grads[1:])


# ---------------- codes kept on the host ----------------

def test_pinned_copy_keeps_high_bit_code_words(cuda):
    """The producer's pinned int64 buffer carries uint32 code words at or
    above 2**31 to the card as their bit patterns."""
    from repro_torch.graph.engine import PrefetchIterator
    from repro_torch.graph.sampler import FrontierBatch, attach_codes
    words = np.array([[0x80000001, 5], [0xFFFFFFFF, 0x7FFFFFFF], [0xDEADBEEF, 0]], np.uint32)
    fb = FrontierBatch(np.arange(3, dtype=np.int32), (np.arange(3, dtype=np.int32),), 3)

    class One:
        def next_batch(self):
            return {"frontier": fb}

    def gather(batch):
        return dict(batch, frontier=attach_codes(batch["frontier"], words))
    with PrefetchIterator(One(), depth=1, device=cuda, code_gather=gather) as pf:
        got = pf.next_batch()["frontier"].codes
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), torch.from_numpy(words.astype(np.int64)))
    st = pf.stats()                            # the producer has stopped
    assert st["transferred_code_bytes"] == st["n_produced"] * words.size * 8 > 0


@pytest.mark.parametrize("depth", [0, 2])
def test_host_codes_on_card_are_device_codes(cuda, depth):
    """Training (the producer's pinned copy at depth 2, the loop's gather at
    0), ``evaluate``, ``embed`` and cached, uncached and batched serving on
    the card: host placement gives the device placement's bits."""
    from repro_torch.serving.batcher import BatchingSpec
    dev = GraphRuntime.from_spec(_gnn_spec(prefetch_depth=depth))
    host = GraphRuntime.from_spec(_gnn_spec(prefetch_depth=depth).with_updates(
        codes_placement="host"), graph=(dev.adj, dev.labels))
    try:
        assert "codes_buf" not in host.params["embed"] and host.codes.dtype == np.uint32
        assert dev.train(4).losses == host.train(4).losses
        from repro_torch.nn.module import leaves_with_path
        want = dict(leaves_with_path(dev.params))
        want.pop(("embed", "codes_buf"))
        got = dict(leaves_with_path(host.params))
        assert want.keys() == got.keys() and all(torch.equal(want[k], got[k]) for k in want)
        assert dev.evaluate("val") == host.evaluate("val")
        ids = np.arange(0, 3000, 29, dtype=np.int32)
        np.testing.assert_array_equal(dev.embed(ids), host.embed(ids))
        reqs = [np.arange(i, 3000, 97, dtype=np.int32)[:30] for i in range(4)]
        for kw in ({}, {"cache_capacity": 0}):
            ed, eh = dev.serve(**kw), host.serve(**kw)
            for a, b in zip(ed.serve_many(reqs) + [ed.serve(r) for r in reqs],
                            eh.serve_many(reqs) + [eh.serve(r) for r in reqs]):
                np.testing.assert_array_equal(a.embeddings, b.embeddings)
                np.testing.assert_array_equal(a.logits, b.logits)
        with dev.serve(batching=BatchingSpec(max_batch=4)) as td, \
                host.serve(batching=BatchingSpec(max_batch=4)) as th:
            for r in reqs:
                np.testing.assert_array_equal(td.serve(r).embeddings, th.serve(r).embeddings)
    finally:
        dev.close()
        host.close()


def test_host_codes_resume_on_card_is_bitwise(cuda, tmp_path):
    """Host-placed: 3 steps, a checkpoint, ``GraphRuntime.resume`` and 3
    more equal 6 straight device-placed steps bit for bit."""
    dev = GraphRuntime.from_spec(_gnn_spec())
    want = dev.train(6).losses
    dev.close()
    spec = _gnn_spec(ckpt_dir=str(tmp_path), ckpt_every=3).with_updates(codes_placement="host")
    rt = GraphRuntime.from_spec(spec, graph=(dev.adj, dev.labels))
    head = rt.train(3).losses
    rt.close()
    back = GraphRuntime.resume(str(tmp_path), graph=(dev.adj, dev.labels))
    tail = back.train(6)
    back.close()
    assert back.codes_on_host and tail.resumed_from == 3 and head + tail.losses == want


# ---------------------------------------------------------------------------
# several ranks (parallel.sharding): gloo on one card, NCCL one card a rank
# ---------------------------------------------------------------------------

def cuda_cards(n: int) -> torch.device:
    """The ``cuda`` fixture for ``n`` cards: skips, never errors, on fewer."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        pytest.skip(f"needs {n} CUDA cards, have {have}")
    disable_tf32()
    return torch.device("cuda")


def _ranks_program(rank, n, case):
    """One rank: the collective backends' frontier decode of its block on
    its card against the gather oracle, then a few training steps per
    backend; returns what the parent compares across ranks."""
    from repro_torch.graph.sampler import OwnerPlan
    from repro_torch.parallel import sharding
    disable_tf32()
    mesh = sharding.data_mesh(n)
    dev = mesh.device
    cap, fb = case["cap"], case["frontier"]
    codes = torch.from_numpy(case["codes"]).to(dev)
    cb0 = torch.from_numpy(case["cb"]).to(dev)
    w00 = torch.from_numpy(case["w0"]).to(dev)
    vm = torch.from_numpy(fb.valid).to(dev)[:, None]
    plan = OwnerPlan(*(torch.from_numpy(a[rank:rank + 1].astype(np.int64)).to(dev)
                       for a in fb.plan.leaves()))
    oracle = backend_mod.get_backend("gather", device=dev)
    ref = oracle.decode(codes, cb0, w00)
    cb, w0 = cb0.clone().requires_grad_(), w00.clone().requires_grad_()
    gref = torch.autograd.grad(((oracle.decode(codes, cb, w0) * vm) ** 2).sum(), (cb, w0))
    out = {"transport": mesh.backend, "decode": {}, "runs": {}}
    with sharding.use_sharding(mesh):
        for name in ("sharded:pallas", "owner:pallas"):
            be = backend_mod.get_backend(name, device=dev)
            block = codes[rank * cap:(rank + 1) * cap]
            got = be.decode_frontier(block, cb0, w00, plan=plan)
            cb, w0 = cb0.clone().requires_grad_(), w00.clone().requires_grad_()
            g = torch.autograd.grad(((be.decode_frontier(block, cb, w0, plan=plan) * vm) ** 2)
                                    .sum(), (cb, w0))
            out["decode"][name] = (
                bool(torch.equal(got[vm[:, 0]], ref[vm[:, 0]])),
                max(float(((a - b).abs() / (1e-5 + 1e-4 * b.abs())).max()) for a, b in zip(g, gref)),
                [t.cpu().numpy() for t in g])
    for impl in ("sharded:pallas", "owner:pallas"):
        rt = GraphRuntime.from_spec(
            _gnn_spec(n_shards=n, prefetch_depth=2).with_updates(lookup_impl=impl))
        try:
            losses = rt.train(3).losses
            out["runs"][impl] = (losses, {k: v.cpu().numpy() for k, v in
                                          rt.params["embed"]["decoder"]["mlp"].items()},
                                 rt.params["embed"]["decoder"]["codebooks"].cpu().numpy())
        finally:
            rt.close()
    return out


def _ranks_case(n):
    from repro_torch.graph.engine import ShardedSageBatchSource
    from repro_torch.graph.sampler import NeighborSampler
    adj, labels = powerlaw_graph(0, 1200, avg_degree=8, n_classes=8, homophily=0.9)
    src = ShardedSageBatchSource(NeighborSampler(adj, (5, 5), max_deg=32, seed=0),
                                 np.arange(1200), labels, 64 // n, n_shards=n, seed=7,
                                 pad_to=64, owner_plan=True)
    fb = src.next_batch()["frontier"]
    assert fb.plan is not None
    rng = np.random.default_rng(0)
    return dict(frontier=fb, cap=src.frontier_cap,
                codes=rng.integers(0, 256, (1200, 16)).astype(np.int32)[fb.unique],
                cb=rng.standard_normal((16, 256, 512)).astype(np.float32),
                w0=rng.standard_normal(512).astype(np.float32))


def _check_ranks(results, one_shard):
    for name, (bitwise, rel, grads) in results[0]["decode"].items():
        assert bitwise, f"{name}: decoded rows differ from the gather oracle"
        assert rel <= 1.0, f"{name}: gradient beyond rtol 1e-4 / atol 1e-5 of the oracle's"
        for other in results[1:]:
            assert all(np.array_equal(a, b) for a, b in zip(grads, other["decode"][name][2]))
    for impl, (losses, mlp, cbs) in results[0]["runs"].items():
        assert losses[0] == one_shard[0], (impl, losses[0], one_shard[0])
        assert max(abs(a - b) for a, b in zip(losses, one_shard)) < 1e-3
        for other in results[1:]:
            o_losses, o_mlp, o_cbs = other["runs"][impl]
            assert o_losses == losses and np.array_equal(o_cbs, cbs)
            assert all(np.array_equal(mlp[k], o_mlp[k]) for k in mlp)


def _one_shard_losses():
    rt = GraphRuntime.from_spec(_gnn_spec(prefetch_depth=2))
    try:
        return rt.train(3).losses
    finally:
        rt.close()


def test_four_gloo_ranks_on_one_card(cuda):
    """Four ranks share the card over gloo (CUDA tensors in its
    collectives): decoded rows bitwise the oracle, gradients within rtol 1e-4 /
    atol 1e-5 of it (partials summed over the ranks), every rank's params
    equal, and the step-0 loss the 1-shard run's."""
    from repro_torch.parallel.sharding import spawn
    results = spawn(_ranks_program, 4, backend="gloo", args=(4, _ranks_case(4)))
    assert results[0]["transport"] == "gloo"
    _check_ranks(results, _one_shard_losses())


@pytest.mark.parametrize("n", [2, 4])
def test_nccl_ranks_one_card_each(n):
    """The same over NCCL, one card a rank (skips on fewer cards)."""
    cuda_cards(n)
    from repro_torch.parallel.sharding import spawn
    results = spawn(_ranks_program, n, backend="nccl", args=(n, _ranks_case(n)))
    assert results[0]["transport"] == "nccl"
    _check_ranks(results, _one_shard_losses())


# ---------------------------------------------------------------------------
# elastic training (repro_torch.elastic): kill a rank, recover from its peers
# ---------------------------------------------------------------------------

def _elastic_program(rank, impl):
    """One rank of the kill schedule (shard 2 dies at step 10, one chunk
    corrupted, lease 1), then its reference: a never-failed run to the
    interrupt, ``rescale(3)``, 2 more steps."""
    from repro_torch.elastic import ElasticManager, ElasticSpec, FailurePlan
    disable_tf32()
    spec = _gnn_spec(n_shards=4, prefetch_depth=2,
                     elastic=ElasticSpec(lease_steps=1, chunk_bytes=1 << 16)
                     ).with_updates(lookup_impl=impl, batch_size=48)
    res = ElasticManager(GraphRuntime.from_spec(spec),
                         plan=FailurePlan(kill=((2, 10),), corrupt_chunks=(1,))).run(14)
    out = {"history": res.history, "losses": res.losses, "alive": res.runtime is not None,
           "device": None, "reports": res.reports}
    if res.runtime is not None:
        out.update(device=str(res.runtime.device), n_shards=res.runtime.spec.n_shards,
                   params={k: v.cpu().numpy() for k, v in
                           res.runtime.params["embed"]["decoder"]["mlp"].items()},
                   codebooks=res.runtime.params["embed"]["decoder"]["codebooks"].cpu().numpy())
        res.runtime.close()
    ref = GraphRuntime.from_spec(spec)
    head = ref.train(12).losses
    rt3 = ref.rescale(3)
    ref.close()
    out["ref"] = None
    if rt3 is not None:
        out["ref"] = head + rt3.train(2).losses
        rt3.close()
    return out


def _check_elastic(results):
    from repro_torch.elastic import DEGRADED, HEALTHY, RESCALING
    survivors = [r for r in results if r["alive"]]
    assert [r["alive"] for r in results] == [True, True, False, True]
    ref = results[0]["ref"]
    for r in survivors:
        assert r["history"] == [HEALTHY, DEGRADED, RESCALING, HEALTHY]
        assert r["losses"] == ref and r["n_shards"] == 3
        assert np.array_equal(r["codebooks"], survivors[0]["codebooks"])
        assert all(np.array_equal(r["params"][k], survivors[0]["params"][k])
                   for k in r["params"])
        (rep,) = r["reports"]
        assert (rep.failed_shards, rep.detected_at_step, rep.retransmits) == ((2,), 11, 1)
    assert results[2]["losses"] == ref[:12]
    return survivors


@pytest.mark.parametrize("impl", ["sharded:pallas", "owner:pallas"])
def test_elastic_kill_on_four_gloo_ranks_of_one_card(cuda, impl):
    """Four ranks share the card over gloo: the run continued on 3 after
    the kill is bitwise its reference, and the survivors' params agree."""
    from repro_torch.parallel.sharding import spawn
    _check_elastic(spawn(_elastic_program, 4, backend="gloo", args=(impl,)))


def test_elastic_kill_over_nccl_keeps_each_rank_on_its_card():
    """The same over NCCL, one card a rank (skips below 4 cards): each
    survivor stays on its own card."""
    cuda_cards(4)
    from repro_torch.parallel.sharding import spawn
    results = spawn(_elastic_program, 4, backend="nccl", args=("sharded:pallas",))
    survivors = _check_elastic(results)
    assert [r["device"] for r in survivors] == ["cuda:0", "cuda:1", "cuda:3"]


# ---------------------------------------------------------------------------
# LM serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "chatglm3-6b"])
def test_lm_engine_on_kernel_is_the_gather_engine(cuda, arch):
    """Reduced configs: greedy tokens and every step's last logits through
    the ``hash_decode`` kernel (``auto``) bitwise the gather backend's."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.lm import init_lm
    from repro_torch.serving import DecodeEngine
    cfg = reduced(get_config(arch))
    params = init_lm(torch.Generator(cuda).manual_seed(0), cfg)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 16))
    before = ops.hash_decode.launches
    res = []
    for impl in ("auto", "gather"):
        eng, kept = DecodeEngine(cfg, params, s_max=64, decode_backend=impl), []

        def recorded(*args, step):                   # keep the prefill's and each step's logits
            out = step(*args)
            kept.append(out[0])
            return out

        eng._prefill = functools.partial(recorded, step=eng._prefill)
        eng._serve = functools.partial(recorded, step=eng._serve)
        res.append((eng.generate(prompts, 8).tokens, torch.stack(kept)))
    assert ops.hash_decode.launches == before + 9          # prefill + 8 steps, auto only
    np.testing.assert_array_equal(res[0][0], res[1][0])
    assert torch.equal(res[0][1], res[1][1])


@pytest.mark.parametrize("s_new", [1, 5, 32])
def test_kv_cache_update_on_card_is_the_cpus(cuda, s_new):
    from repro_torch.nn.kvcache import KVCache
    rng = np.random.default_rng(s_new)
    first = torch.from_numpy(rng.standard_normal((3, 7, 2, 16)).astype(np.float32))
    new = torch.from_numpy(rng.standard_normal((3, s_new, 2, 16)).astype(np.float32))
    out = {}
    for dev in ("cpu", cuda):
        c = KVCache.zeros(3, 32, 2, 16, torch.bfloat16, device=dev)
        if s_new != 32:
            c = c.update(first.to(dev), first.to(dev))
        c = c.update(new.to(dev), (2 * new).to(dev))
        out[str(dev)] = (c.pos, c.k.cpu(), c.v.cpu(), c.valid_mask().cpu())
    cpu, card = out["cpu"], out[str(cuda)]
    assert cpu[0] == card[0] and all(torch.equal(a, b) for a, b in zip(cpu[1:], card[1:]))


def test_chunked_loss_on_card_matches_cpu(cuda):
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.lm import init_lm
    from repro_torch.nn.module import value_and_grad
    from repro_torch.models import lm
    cfg = dataclasses.replace(reduced(get_config("yi-9b")), vocab_size=500,
                              loss_vocab_chunk=64)
    params = init_lm(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 500, (4, 65)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    got = {}
    for dev in ("cpu", cuda):
        got[str(dev)] = value_and_grad(lambda p: lm.lm_loss(p, _to(batch, dev), cfg),
                                       _to(params, dev))
    (l_cpu, g_cpu), (l_card, g_card) = got["cpu"], got[str(cuda)]
    assert abs(float(l_cpu) - float(l_card)) <= 1e-4
    assert float((g_cpu["head"] - g_card["head"].cpu()).abs().max()) <= 1e-4



# ---------------------------------------------------------------------------
# the moe, ssm and hybrid LM families
# ---------------------------------------------------------------------------

FAMILY_ARCHS = {"moe": "granite-moe-3b-a800m", "ssm": "mamba2-2.7b", "hybrid": "zamba2-7b"}


def _family_cfg(family, **fields):
    from repro_torch.configs import get_config, reduced
    return dataclasses.replace(reduced(get_config(FAMILY_ARCHS[family])), **fields)


@pytest.mark.parametrize("family", ["moe", "moe_dense", "ssm", "hybrid"])
def test_family_forward_and_step_on_card_match_cpu(cuda, family):
    """The reduced config's logits and one training step on the card (the
    kernels) against the CPU (plain versions) from one init: logits within
    1e-4, the loss within 1e-4, the params after the step within 1e-4 (f32
    cuBLAS and CPU matmuls sum in other orders).  Adam's eps is 1 (ROADMAP
    §C): at 1e-8 the first update is lr · g / |g| and an entry whose
    gradient is near zero moves by O(lr) on a rounding-level change."""
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.models import lm
    from repro_torch.nn.module import leaves_with_path
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train import TrainHyper, make_train_step
    fields = {"moe_impl": "dense"} if family == "moe_dense" else {}
    cfg = _family_cfg(family.split("_")[0], **fields)
    cfg = dataclasses.replace(cfg, embedding=dataclasses.replace(cfg.embedding,
                                                                 lookup_impl="pallas"))
    params = lm.init_lm(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 65)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    step = make_train_step(cfg, TrainHyper(optimizer=AdamWConfig(eps=1.0), warmup_steps=1,
                                           total_steps=3))
    out = {}
    for dev in ("cpu", cuda):
        p = _to(params, dev, copy=True)             # the step updates its params in place
        logits, _ = lm.lm_forward(p, batch["tokens"].to(dev), cfg)
        state, m = step({"params": p, "opt": adamw_init(p), "step": 0}, _to(batch, dev))
        out[str(dev)] = (logits.cpu(), float(m["loss"]),
                         [t.cpu() for _, t in leaves_with_path(state["params"])])
    (lc, loss_c, pc), (lg, loss_g, pg) = out["cpu"], out[str(cuda)]
    assert float((lc - lg).abs().max()) <= 1e-4
    assert abs(loss_c - loss_g) <= 1e-4
    assert max(float((a.float() - b.float()).abs().max()) for a, b in zip(pc, pg)) <= 1e-4


@pytest.mark.parametrize("impl", ["ep", "dense"])
def test_moe_backward_on_card_is_the_same_bits_twice(cuda, impl):
    """Two gradients of one reduced moe step on the card (8,192 tokens, so
    each expert group holds hundreds of rows): the same bits; the sorted
    dispatch's combine has no accumulating scatter."""
    from repro_torch.models import lm
    from repro_torch.nn.module import leaves_with_path, value_and_grad
    cfg = _family_cfg("moe", moe_impl=impl, compute_dtype="bfloat16")
    params = lm.init_lm(torch.Generator(cuda).manual_seed(1), cfg)
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (16, 513)))
    batch = _to({"tokens": toks[:, :-1], "labels": toks[:, 1:]}, cuda)
    runs = [value_and_grad(lambda p: lm.lm_loss(p, batch, cfg), params) for _ in range(2)]
    assert float(runs[0][0]) == float(runs[1][0])
    for (path, a), (_, b) in zip(leaves_with_path(runs[0][1]), leaves_with_path(runs[1][1])):
        assert torch.equal(a, b), path


def test_ssm_decode_on_card_equals_the_chunked_forward(cuda):
    """The mixer's single-step recurrence, 64 steps from a 64-step prefill
    into the cache, against one chunked pass over the 128 steps, on the card
    in f32 (1e-3, ``tests/test_nn.py``'s bound)."""
    from repro_torch.nn import ssm
    from repro_torch.nn.kvcache import SSMCache
    cfg = ssm.SSMConfig(d_model=256, d_state=64, headdim=32, chunk=32)
    p = ssm.init_ssm(torch.Generator(cuda).manual_seed(2), cfg)
    x = torch.randn((2, 128, 256), generator=torch.Generator(cuda).manual_seed(3), device=cuda)
    full, _ = ssm.ssm_forward(p, x, cfg)
    cache = SSMCache.zeros(2, cfg.n_heads, cfg.d_state, cfg.headdim, cfg.conv_width,
                           cfg.conv_channels, device=cuda)
    y, cache = ssm.ssm_forward(p, x[:, :64], cfg, cache=cache)
    ys = [y]
    for t in range(64, 128):
        y, cache = ssm.ssm_forward(p, x[:, t:t + 1], cfg, cache=cache)
        ys.append(y)
    assert float((torch.cat(ys, 1) - full).abs().max()) <= 1e-3


@pytest.mark.parametrize("family", list(FAMILY_ARCHS))
def test_family_engine_on_kernel_is_the_gather_engine(cuda, family):
    """Reduced configs in bf16: greedy tokens and every step's last logits
    through the ``hash_decode`` kernel (``auto``) bitwise the gather
    backend's, the SSM states and KV sites threaded through the steps."""
    from repro_torch.models.lm import init_lm
    from repro_torch.serving import DecodeEngine
    cfg = _family_cfg(family, compute_dtype="bfloat16")
    params = init_lm(torch.Generator(cuda).manual_seed(0), cfg)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 32))
    before = ops.hash_decode.launches
    res = []
    for impl in ("auto", "gather"):
        eng, kept = DecodeEngine(cfg, params, s_max=64, decode_backend=impl), []

        def recorded(*args, step):
            out = step(*args)
            kept.append(out[0])
            return out

        eng._prefill = functools.partial(recorded, step=eng._prefill)
        eng._serve = functools.partial(recorded, step=eng._serve)
        res.append((eng.generate(prompts, 8).tokens, torch.stack(kept)))
    assert ops.hash_decode.launches == before + 9
    np.testing.assert_array_equal(res[0][0], res[1][0])
    assert torch.equal(res[0][1], res[1][1])
