"""Port parity: the embedding-reconstruction path (paper §5.1, Fig. 1,
Tables 4-6) — ``repro_torch.core.memory``, ``graph.generate.
clustered_embeddings``, ``core.autoencoder``, ``train.reconstruct``,
``core.lsh.collision_experiment`` and the ``launch.reconstruct`` front
door — against ``repro.core.memory``, ``repro.graph.generate``,
``repro.core.autoencoder``, ``benchmarks/fig1_reconstruction.py`` and
``repro.core.lsh``.

JAX's draws (init, batch ids, Gumbel noise, projections) are made the JAX
way and handed to the port.  Tolerances: the memory arithmetic is the same
Python on both sides, so equal; the generators are numpy, so bitwise; hard
codes (argmax of logits) bitwise; forward passes within 1e-5 (f32 matmuls
in another order); five AdamW steps within 1e-5 on the loss and 1e-4 on
every parameter (Adam's first steps move a weight by about the learning
rate whatever its gradient's scale, so a rounding-level gradient
difference can move it by more than the forward error); collision counts
on integer-valued projections bitwise (exact sums).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import fig1_reconstruction as j_fig1
from repro.core import autoencoder as jae
from repro.core import codes as jcodes
from repro.core import lsh as jlsh
from repro.core import memory as jmem
from repro.core.decoder import DecoderConfig as JDecoderConfig
from repro.core.embedding import init_embedding as j_init_embedding
from repro.graph.generate import clustered_embeddings as j_clustered
from repro.graph.generate import powerlaw_graph as j_powerlaw
from repro_torch.core import autoencoder as tae
from repro_torch.core import codes as tcodes
from repro_torch.core import lsh as tlsh
from repro_torch.core import memory as tmem
from repro_torch.core.decoder import DecoderConfig
from repro_torch.graph.generate import clustered_embeddings as t_clustered
from repro_torch.graph.generate import powerlaw_graph as t_powerlaw
from repro_torch.interop import params_from_jax
from repro_torch.launch import reconstruct as t_launch
from repro_torch.nn.module import leaves_with_path
from repro_torch.train import reconstruct as t_rec

C, M, D_C, D_M, D_IN = 8, 4, 32, 32, 16


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_trees_close(mine, ref, atol):
    ref_leaves = dict(leaves_with_path(params_from_jax(_np(ref), device="cpu")))
    mine_leaves = dict(leaves_with_path(mine))
    assert mine_leaves.keys() == ref_leaves.keys()
    for path, r in ref_leaves.items():
        np.testing.assert_allclose(mine_leaves[path].numpy(), r.numpy(), rtol=0,
                                   atol=atol, err_msg="/".join(path))


# ---------------- core/memory.py ----------------

@pytest.mark.parametrize("table,d_e", [("PAPER_TABLE6_GLOVE", 300), ("PAPER_TABLE6_M2V", 128)])
def test_memory_reproduces_published_tables_4_and_6(table, d_e):
    pub = getattr(tmem, table)
    assert pub == getattr(jmem, table)
    t4 = tmem.PAPER_TABLE4_GLOVE if d_e == 300 else tmem.PAPER_TABLE4_M2V
    for n, ref in t4.items():
        assert abs(tmem.compression_ratio(n, d_e, 2, 128) - ref) < 0.011, n
    for (c, m), row in pub.items():
        for n, ref in row.items():
            assert abs(tmem.compression_ratio(n, d_e, c, m) - ref) < 0.011, (c, m, n)
    assert abs(tmem.compression_ratio(200_000, 300, 256, 16) - 18.11) < 0.01


def test_memory_reproduces_table2():
    t = tmem.PAPER_TABLE2
    light = tmem.memory_breakdown(t["n"], t["d_e"], 256, 16, 512, 512, 3, "light")
    full = tmem.memory_breakdown(t["n"], t["d_e"], 256, 16, 512, 512, 3, "full")
    assert abs(light.raw_table_bytes / tmem.MiB - t["raw_gpu_mib"]) < 0.01
    assert abs(light.binary_code_bytes / tmem.MiB - t["binary_code_mib"]) < 0.01
    assert abs(light.trainable_decoder_bytes / tmem.MiB - t["light_decoder_gpu_mib"]) < 0.01
    assert abs(light.frozen_decoder_bytes / tmem.MiB - t["light_codebooks_cpu_mib"]) < 0.01
    assert abs(full.trainable_decoder_bytes / tmem.MiB - t["full_decoder_gpu_mib"]) < 0.01
    gnn = t["gnn_mib"] * tmem.MiB
    ratio = (full.raw_table_bytes + gnn) / (full.trainable_decoder_bytes + gnn)
    assert abs(ratio - t["full_ratio_gpu"]) < 0.02


@pytest.mark.parametrize("convention", [True, False])
def test_memory_functions_equal_jax_over_a_grid(convention):
    for n in (1000, 5000, 200_000, 1_871_031):
        for d_e in (64, 128, 300):
            for c, m in ((2, 128), (4, 64), (16, 32), (256, 16)):
                for l in (1, 2, 3, 4):
                    for variant in ("light", "full"):
                        args = (n, d_e, c, m, 512, 256, l, variant, convention)
                        assert (tmem.memory_breakdown(*args).__dict__
                                == jmem.memory_breakdown(*args).__dict__), args
                        assert (tmem.decoder_param_counts(c, m, 512, 256, d_e, l, variant,
                                                          convention)
                                == jmem.decoder_param_counts(c, m, 512, 256, d_e, l,
                                                             variant, convention))
                assert (tmem.compression_ratio(n, d_e, c, m, paper_table_convention=convention)
                        == jmem.compression_ratio(n, d_e, c, m,
                                                  paper_table_convention=convention))
    with pytest.raises(ValueError):
        tmem.decoder_param_counts(16, 8, 64, 64, 32, 3, "medium")


# ---------------- graph/generate.py ----------------

@pytest.mark.parametrize("n,dim,k,noise", [(1000, 64, 8, 0.35), (777, 300, 5, 0.1)])
def test_clustered_embeddings_bitwise(n, dim, k, noise):
    te, tl = t_clustered(3, n, dim, k, noise)
    je, jl = j_clustered(3, n, dim, k, noise)
    np.testing.assert_array_equal(te, je)
    np.testing.assert_array_equal(tl, jl)
    assert te.dtype == np.float32 and tl.dtype == np.int32


# ---------------- core/autoencoder.py ----------------

def _ae_configs():
    jdec = JDecoderConfig(c=C, m=M, d_c=D_C, d_m=D_M, d_e=D_IN, compute_dtype="float32")
    tdec = DecoderConfig(c=C, m=M, d_c=D_C, d_m=D_M, d_e=D_IN, compute_dtype="float32")
    return (jae.AutoencoderConfig(d_in=D_IN, c=C, m=M, d_h=D_C, decoder=jdec),
            tae.AutoencoderConfig(d_in=D_IN, c=C, m=M, d_h=D_C, decoder=tdec))


@pytest.fixture(scope="module")
def ae():
    jcfg, tcfg = _ae_configs()
    emb, _ = j_clustered(0, 300, D_IN, 4, 0.35)
    params = jae.init_autoencoder(jax.random.PRNGKey(11), jcfg)
    return jcfg, tcfg, emb, params


def test_autoencoder_reconstruct_with_jax_params_and_noise(ae):
    jcfg, tcfg, emb, params = ae
    key = jax.random.PRNGKey(5)
    x = jnp.asarray(emb[:64])
    ref = np.asarray(jae.reconstruct(params, x, key, jcfg))
    noise = np.array(jax.random.gumbel(key, (64, M, C), jnp.float32))
    tp = params_from_jax(_np(params), device="cpu")
    assert set(tp["enc"]) == {"w1", "b1", "w2", "b2"} and "codebooks" in tp["decoder"]
    got = tae.reconstruct(tp, torch.from_numpy(emb[:64]), tcfg, noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        tae.encode_logits(tp, torch.from_numpy(emb[:64]), tcfg).numpy(),
        np.asarray(jae.encode_logits(params, x, jcfg)), rtol=0, atol=1e-5)
    # the port's own Gumbel draw: finite, seeded, standard Gumbel moments
    g = tae.gumbel(torch.Generator().manual_seed(0), (20000,))
    again = tae.gumbel(torch.Generator().manual_seed(0), (20000,))
    assert torch.isfinite(g).all(), "non-finite Gumbel noise"
    assert torch.equal(g, again), (
        f"two draws from one seed differ at {(g != again).nonzero().flatten()[:8].tolist()}")
    assert abs(float(g.mean()) - 0.5772) < 0.03, float(g.mean())
    assert abs(float(g.var()) - 1.6449) < 0.1, float(g.var())


def test_extract_codes_bitwise(ae):
    jcfg, tcfg, emb, params = ae
    ref = np.asarray(jae.extract_codes(params, jnp.asarray(emb), jcfg))
    got = tae.extract_codes(params_from_jax(_np(params), device="cpu"),
                            torch.from_numpy(emb), tcfg)
    np.testing.assert_array_equal(tcodes.to_uint32(got), ref)


def test_five_autoencoder_steps_match_jax(ae):
    jcfg, tcfg, emb, _ = ae
    key, steps, batch = jax.random.PRNGKey(9), 5, 64
    j_params, j_loss = jae.train_autoencoder(key, jnp.asarray(emb), jcfg, steps=steps,
                                             batch=batch)
    k_init, k_loop = jax.random.split(key)
    init = params_from_jax(_np(jae.init_autoencoder(k_init, jcfg)), device="cpu")
    ids, noise = [], []
    for i in range(steps):
        k_it = jax.random.fold_in(k_loop, i)
        ids.append(torch.from_numpy(np.array(jax.random.randint(
            jax.random.fold_in(k_it, 1), (batch,), 0, emb.shape[0]))))
        noise.append(torch.from_numpy(np.array(jax.random.gumbel(
            jax.random.fold_in(k_it, 2), (batch, M, C), jnp.float32))))
    t_params, t_loss = tae.train_autoencoder(None, torch.from_numpy(emb), tcfg, steps=steps,
                                             batch=batch, params=init, ids=ids, noise=noise)
    assert abs(t_loss - j_loss) <= 1e-5, (t_loss, j_loss)
    _assert_trees_close(t_params, j_params, atol=1e-4)


# ---------------- train/reconstruct.py ----------------

def test_five_decoder_reconstruction_steps_match_jax():
    """``_train_decoder_on_reconstruction`` of the Fig. 1 benchmark (c=m=16,
    d_c=d_m=128, 512 ids a step) on hashing codes, 5 steps, with JAX's
    init and ids injected."""
    n, dim, steps = 1000, 64, 5
    emb, _ = j_clustered(0, n, dim, 8, 0.35)
    key = jax.random.PRNGKey(0)
    codes = jlsh.encode_lsh(key, jnp.asarray(emb), j_fig1.C, j_fig1.M)
    j_params, j_cfg, j_loss = j_fig1._train_decoder_on_reconstruction(
        key, jnp.asarray(emb), codes, n_steps=steps)
    assert j_cfg.lookup_impl == "onehot"
    init = j_init_embedding(key, j_cfg, codes=codes)
    ids = [torch.from_numpy(np.array(jax.random.randint(
        jax.random.fold_in(jax.random.PRNGKey(1), i), (512,), 0, n))) for i in range(steps)]
    cfg = t_rec.reconstruction_config(n, dim, j_fig1.C, j_fig1.M, j_fig1.D_C, j_fig1.D_M)
    assert cfg.decoder_config().n_layers == j_cfg.n_layers == 3
    t_params, losses = t_rec.train_decoder_on_reconstruction(
        None, torch.from_numpy(emb), None, cfg, steps,
        params=params_from_jax(_np(init), device="cpu"), ids=ids)
    assert len(losses) == steps and losses[-1] < losses[0]
    assert abs(losses[-1] - j_loss) <= 1e-5, (losses[-1], j_loss)
    _assert_trees_close(t_params, j_params, atol=1e-4)


def test_kmeans_and_nmi_equal_the_benchmark_copies():
    from benchmarks.common import kmeans as j_kmeans, nmi as j_nmi
    emb, labels = j_clustered(0, 600, 32, 6, 0.5)
    a = t_rec.kmeans(emb, 6)
    np.testing.assert_array_equal(a, j_kmeans(emb, 6))
    assert t_rec.nmi(a, labels) == j_nmi(a, labels)
    assert t_rec.nmi(labels, labels) == pytest.approx(1.0)


def test_launcher_runs_every_scheme_on_cpu(capsys):
    out = t_launch.main(["--device", "cpu", "--n", "400", "--steps", "4"])
    assert set(out["schemes"]) == set(t_launch.SCHEMES)
    for name, r in out["schemes"].items():
        assert len(r["losses"]) == 4 and np.isfinite(r["losses"]).all(), name
        assert 0.0 <= r["nmi"] <= 1.0 + 1e-9, name
    assert out["compression_ratio"] == tmem.compression_ratio(400, 64, 16, 16, 128, 128)
    printed = capsys.readouterr().out
    assert "[reconstruct] hashing: mse=" in printed and "raw nmi=" in printed
    with pytest.raises(ValueError, match="unknown scheme"):
        t_launch.run(n=50, steps=1, schemes=["nope"], device="cpu")


# ---------------- core/lsh.py collision_experiment ----------------

@pytest.mark.parametrize("threshold", ["median", "zero"])
def test_collision_experiment_bitwise_on_integer_projections(threshold):
    n, c, m, trials = 500, 4, 6, 3
    ja = j_powerlaw(0, n, avg_degree=6, n_classes=4)[0]
    ta = t_powerlaw(0, n, avg_degree=6, n_classes=4)[0]
    key = jax.random.PRNGKey(4)
    per_trial, ref = [], []
    for trial in range(trials):
        sub = jax.random.fold_in(key, trial)
        Vs, k = [], sub
        for w in range(jcodes.n_words(c, m)):
            k, s = jax.random.split(k)
            Vs.append(np.round(2 * np.asarray(jax.random.normal(
                s, (n, min(32, jcodes.n_bits(c, m) - 32 * w))))).astype(np.float32))
        words = [jlsh._binarize_word(jlsh._project_csr(ja, jnp.asarray(V)), threshold)
                 for V in Vs]
        ref.append(jcodes.count_collisions(jnp.stack(words, axis=1)))
        per_trial.append([torch.from_numpy(V) for V in Vs])
    got = tlsh.collision_experiment(ta, c, m, threshold, projections=per_trial)
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert got.min() > 0                        # 12 bits for 500 nodes: collisions exist
    gens = lambda: [torch.Generator().manual_seed(100 + t) for t in range(trials)]
    a = tlsh.collision_experiment(ta, c, m, threshold, generators=gens())
    np.testing.assert_array_equal(a, tlsh.collision_experiment(ta, c, m, threshold,
                                                               generators=gens()))
    with pytest.raises(ValueError):
        tlsh.collision_experiment(ta, c, m, threshold)
