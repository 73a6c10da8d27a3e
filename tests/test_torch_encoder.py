"""The port's encoder side against the JAX package's, on the same weights
and inputs: `VAE.encode` (mu, log_var) on both content-encoder fronts, with
batch-norm on and off; the masked statistics ops (`masked_moments`,
training batch-norm with its running update, `masked_softmax`,
`attention_pool_bars`); the fused-front helpers (`embedding_stats`,
`fused_tables`, `gather_sum`). Tolerance rtol = atol = 2e-4."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyphemus_tpu.data.dataset import synthetic_batch
from polyphemus_tpu.models import VAE
from polyphemus_tpu.ops import fused_embed as jfe
from polyphemus_tpu.ops import masked as jmops
from polyphemus_tpu_torch.ops import fused_embed as fe
from polyphemus_tpu_torch.ops import masked as mops

from .torch_port_case import build, jax_tree, small_cfg, to_np

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("bn", [True, False], ids=["bn", "nobn"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "plain"])
def test_encode_matches_jax(fused, bn):
    cfg = dataclasses.replace(small_cfg(batch_norm=bn, n_layers=2),
                              fused_content_encoder=fused)
    variables, jmodel, model = build(cfg, seed=2)
    toks, mask = synthetic_batch(np.random.default_rng(3), 3, cfg.n_bars)
    mask[0, 1] = False  # an empty bar, fixed inside encode
    mu_j, lv_j = jmodel.apply(jax_tree(variables), jnp.asarray(toks),
                              jnp.asarray(mask), method=VAE.encode)
    with torch.no_grad():
        mu, lv = model.encode(torch.from_numpy(toks), torch.from_numpy(mask))
    np.testing.assert_allclose(to_np(mu), np.asarray(mu_j), **TOL)
    np.testing.assert_allclose(to_np(lv), np.asarray(lv_j), **TOL)


def _bn_case(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 5, 7, 6)).astype(np.float32) * 2 + 0.5
    mask = rng.random((3, 5, 7)) < 0.4
    scale = (1 + 0.1 * rng.standard_normal(6)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(6)).astype(np.float32)
    rm = (0.1 * rng.standard_normal(6)).astype(np.float32)
    rv = (1 + 0.1 * rng.random(6)).astype(np.float32)
    return x, mask, scale, bias, rm, rv


def test_masked_moments_match_jax():
    x, mask, *_ = _bn_case()
    want = jmops.masked_moments(jnp.asarray(x), jnp.asarray(mask), (0, 1, 2))
    got = mops.masked_moments(torch.from_numpy(x), torch.from_numpy(mask),
                              (0, 1, 2))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("training", [True, False], ids=["batch", "running"])
def test_batch_norm_masked_matches_jax(training):
    x, mask, scale, bias, rm, rv = _bn_case(1)
    y_j, m_j, v_j = jmops.batch_norm_masked(
        jnp.asarray(x), jnp.asarray(mask), jnp.asarray(scale),
        jnp.asarray(bias), jnp.asarray(rm), jnp.asarray(rv),
        use_running=not training)
    rm_t, rv_t = torch.from_numpy(rm.copy()), torch.from_numpy(rv.copy())
    y = mops.batch_norm_masked(torch.from_numpy(x), torch.from_numpy(scale),
                               torch.from_numpy(bias), rm_t, rv_t,
                               mask=torch.from_numpy(mask), training=training)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(rm_t.numpy(), np.asarray(m_j), **TOL)
    np.testing.assert_allclose(rv_t.numpy(), np.asarray(v_j), **TOL)


def test_attention_pool_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 4, 8, 5)).astype(np.float32)
    gates = rng.standard_normal((2, 3, 4, 8, 1)).astype(np.float32) * 3
    mask = rng.random((2, 3, 4, 8)) < 0.3
    mask[0, 0] = False  # an all-masked bar pools to zero
    want = jmops.attention_pool_bars(jnp.asarray(x), jnp.asarray(gates),
                                     jnp.asarray(mask))
    got = mops.attention_pool_bars(torch.from_numpy(x),
                                   torch.from_numpy(gates),
                                   torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    sm_j = jmops.masked_softmax(jnp.asarray(gates[..., 0]),
                                jnp.asarray(mask), axis=-1)
    sm = mops.masked_softmax(torch.from_numpy(gates[..., 0]),
                             torch.from_numpy(mask), dim=-1)
    np.testing.assert_allclose(sm.numpy(), np.asarray(sm_j), **TOL)


def test_fused_embed_helpers_match_jax():
    rng = np.random.default_rng(5)
    vocab, h, d, n_slots = 11, 6, 8, 15
    table = rng.standard_normal((vocab, h)).astype(np.float32)
    ebias = rng.standard_normal(h).astype(np.float32)
    ids = rng.integers(0, vocab, (2, 3, 4, n_slots))
    cmask = rng.random((2, 3, 4)) < 0.5
    want = jfe.embedding_stats(jnp.asarray(table), jnp.asarray(ebias),
                               jnp.asarray(ids), jnp.asarray(cmask))
    got = fe.embedding_stats(torch.from_numpy(table), torch.from_numpy(ebias),
                             torch.from_numpy(ids), torch.from_numpy(cmask))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    a = (1 + 0.1 * rng.standard_normal(h)).astype(np.float32)
    b = (0.1 * rng.standard_normal(h)).astype(np.float32)
    w = rng.standard_normal((n_slots, h, d)).astype(np.float32)
    t_j, c_j = jfe.fused_tables(*(jnp.asarray(v) for v in (table, ebias, a,
                                                           b, w)))
    t, c = fe.fused_tables(*(torch.from_numpy(v) for v in (table, ebias, a,
                                                           b, w)))
    np.testing.assert_allclose(t.numpy(), np.asarray(t_j), **TOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_j), **TOL)
    np.testing.assert_allclose(
        fe.gather_sum(t, c, torch.from_numpy(ids)).numpy(),
        np.asarray(jfe.gather_sum(t_j, c_j, jnp.asarray(ids))), **TOL)
