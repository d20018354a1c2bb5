"""The prefill and decode steps across ranks with TP over the SSM heads:
reduced mamba2-2.7b and zamba2-7b (the hybrid's shared attention block
too) on (data 2, model 2) under ``DEFAULT_STRATEGY``: each rank's SSM
state holds its half of the heads, its conv tail every channel (the
rank's new x-channel tail gathered over ``model`` each step).  Held, with
``tests/test_torch_serve_ranks.py``'s helpers and bounds, to JAX's steps
jitted under the policy's shardings on 4 host devices (a subprocess) and to
the port's one-rank steps: each step's logits within ``LOGIT_TOL``, the
gathered caches within ``CACHE_TOL`` of JAX's, every rank the same bits.
"""

import pytest

import test_torch_serve_ranks as base

CASES = {
    "mamba2": ("mamba2-2.7b", {}, (2, 2), base.BATCH),
    "zamba2": ("zamba2-7b", {}, (2, 2), base.BATCH),
}


@pytest.fixture(scope="module")
def jref(tmp_path_factory):
    return base.jax_steps(CASES, tmp_path_factory)


@pytest.fixture(scope="module")
def ranks(jref):
    return base.port_ranks(CASES, jref)


@pytest.mark.parametrize("case", list(CASES))
def test_serve_steps_across_ranks_against_jax(ranks, jref, case):
    base.check_against_jax(ranks, jref, case)


@pytest.mark.parametrize("case", list(CASES))
def test_serve_caches_across_ranks_against_jax(ranks, jref, case):
    base.check_caches(ranks, jref, case)


@pytest.mark.parametrize("case", list(CASES))
def test_serve_steps_across_ranks_against_one_rank(ranks, jref, case):
    base.check_against_one_rank(ranks, jref, CASES, case)


def test_ssm_state_split_and_conv_tail_gathered(ranks):
    """The SSM layers' cache across ranks: no KV slots split (zamba2's
    shared block's KV heads divide the model axis), the conv tail gathered
    and the norm's sum of squares added over ``model`` every step."""
    r = ranks[0]
    for case in CASES:
        assert r[case]["kv_seq"] == ()
        assert r[case]["stats"].get("model/conv_gather", 0) > 0
        assert r[case]["stats"].get("model/reduce", 0) > 0
