"""The port at 16 bars (the LMD16 configuration) against the JAX package,
at d = 32 with 2 GNN layers on the same weights and seeded inputs:
`VAE.decode` (structure and content logits at rtol = atol = 2e-4, the
threshold mask by the tie rule), `VAE.encode`, `VAE.decode_tokens` (ids by
the tie rule, its near-tie cap counted among the active cells of the mask),
one fp32 train step (`tests/test_torch_train_step.py::check_against_jax`:
losses, metrics, every grad, the updated params and batch-norm statistics),
and `load_train_config` on `examples/training_lmd16.json` as shipped. The
JAX side runs its Pallas kernels in interpret mode for decode and tokens."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyphemus_tpu import config as jconfig
from polyphemus_tpu.data.dataset import synthetic_batch
from polyphemus_tpu.models import VAE
from polyphemus_tpu_torch import config as pconfig

from .test_torch_train_step import check_against_jax, jax_reference_step, \
    run_case
from .torch_port_case import (assert_ids_match, assert_masks_match, build,
                              jax_tree, random_z, small_cfg, to_np)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_BARS = 16
TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def lmd16():
    """(config, numpy JAX variables, JAX VAE with the Pallas GCL, port VAE
    in eval mode), shared by the module's cases."""
    cfg = small_cfg(n_layers=2, n_bars=N_BARS)
    variables, _, model = build(cfg, seed=1)
    jmodel = VAE(dataclasses.replace(cfg, use_pallas_gcl=True, gcl_chain=2))
    return cfg, variables, jmodel, model


def test_decode_and_tokens_match_jax(lmd16):
    cfg, variables, jmodel, model = lmd16
    z = random_z(2, cfg.d, seed=4)
    s_j, c_j, m_j = jmodel.apply(jax_tree(variables), jnp.asarray(z),
                                 method=VAE.decode)
    with torch.no_grad():
        s_p, _, m_p = model.decode(torch.from_numpy(z), gcl_chain=2)
    assert s_p.shape == (2, N_BARS, 4, 32)
    np.testing.assert_allclose(to_np(s_p), np.asarray(s_j), **TOL)
    assert_masks_match(to_np(m_p), m_j, s_j)
    # content and ids on JAX's mask, so a threshold flip cannot spread
    mask = torch.from_numpy(np.array(m_j))
    with torch.no_grad():
        _, c_p, _ = model.decode(torch.from_numpy(z), mask, gcl_chain=2)
        _, ids_p, _ = model.decode_tokens(torch.from_numpy(z), mask)
    np.testing.assert_allclose(to_np(c_p), np.asarray(c_j), **TOL)
    _, ids_j, _ = jmodel.apply(jax_tree(variables), jnp.asarray(z),
                               jnp.asarray(m_j), method=VAE.decode_tokens)
    assert ids_p.dtype == torch.int32 and ids_p.shape == ids_j.shape
    assert_ids_match(to_np(ids_p), ids_j, to_np(c_p), mask=np.asarray(m_j))


def test_encode_matches_jax(lmd16):
    cfg, variables, _, model = lmd16
    toks, mask = synthetic_batch(np.random.default_rng(3), 2, N_BARS)
    mask[0, 5] = False  # an empty bar, fixed inside encode
    mu_j, lv_j = VAE(cfg).apply(jax_tree(variables), jnp.asarray(toks),
                                jnp.asarray(mask), method=VAE.encode)
    with torch.no_grad():
        mu, lv = model.encode(torch.from_numpy(toks), torch.from_numpy(mask))
    np.testing.assert_allclose(to_np(mu), np.asarray(mu_j), **TOL)
    np.testing.assert_allclose(to_np(lv), np.asarray(lv_j), **TOL)


def test_train_step_matches_jax():
    (cfg, variables, jmodel, toks, mask, rng, model, p_losses, p_accs,
     slack) = run_case(1, seed=2, n_bars=N_BARS)
    assert toks.shape[1] == N_BARS
    want = jax_reference_step(jmodel, cfg, variables, toks, mask, rng)
    check_against_jax(want, p_losses, p_accs, model, slack)


def test_lmd16_config_loads_as_shipped():
    path = os.path.join(ROOT, "examples", "training_lmd16.json")
    got = pconfig.load_train_config(path)
    want = jconfig.load_train_config(path)
    assert (got.model.n_bars, got.model.d, got.model.gnn_n_layers) == \
        (16, 512, 8)
    assert (got.batch_size, got.iters_to_accumulate, got.bf16) == \
        (64, 4, False)
    # every field the two packages share loads the same; the TPU tiling
    # keys (`gcl_bars_per_block`, `tail_bars_per_block`) are JAX's alone
    for name in ("model", "optimizer", "lr_scheduler", "beta_scheduler"):
        p, j = getattr(got, name), getattr(want, name)
        for f in dataclasses.fields(p):
            assert getattr(p, f.name) == getattr(j, f.name), (name, f.name)
    assert not hasattr(got.model, "gcl_bars_per_block")
    assert want.model.gcl_bars_per_block == 8
    for f in ("batch_size", "iters_to_accumulate", "bf16", "seed"):
        assert getattr(got, f) == getattr(want, f), f
