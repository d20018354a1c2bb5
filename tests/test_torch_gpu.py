"""The port on a CUDA card: the hand-written ``hash_decode`` kernel against
its plain PyTorch version, the kernel backend inside the serving path, and
the device-side LSH encode.

Every test carries the ``gpu`` marker and skips without a card.  The file
imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_gpu.py

Tolerances: the kernel and the plain version do the same f32 adds in the
same order without FMA contraction, so they must agree bitwise.  The
decoder MLP and SAGE layers after the decode are the same cuBLAS calls on
the same bits, so embeddings through the kernel and the gather backend
must also agree (checked to 1e-6).
"""

import dataclasses

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
