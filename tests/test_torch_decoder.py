"""The port's decoder against the JAX package's, on the same weights and z:
`VAE.decode` (structure and content logits, threshold mask) and
`VAE.decode_tokens` (argmax ids through the chord tail), for batch-norm on
and off and GCL chains of 1, 2 and 3 layers (3 layers, so chain 2 leaves a
remainder group). The JAX side runs its Pallas kernels in interpret mode.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyphemus_tpu.models import VAE

from .torch_port_case import (assert_ids_match, assert_masks_match, build,
                              jax_tree, random_z, small_cfg, to_np)

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("chain", [1, 2, 3])
@pytest.mark.parametrize("bn", [True, False], ids=["bn", "nobn"])
def test_decode_matches_jax(bn, chain):
    cfg = small_cfg(batch_norm=bn)
    variables, jmodel, model = build(cfg)
    jcfg = dataclasses.replace(cfg, use_pallas_gcl=True, gcl_chain=chain)
    z = random_z(3, cfg.d)
    s_j, c_j, m_j = VAE(jcfg).apply(jax_tree(variables), jnp.asarray(z),
                                    method=VAE.decode)
    with torch.no_grad():
        s_p, c_p, m_p = model.decode(torch.from_numpy(z), gcl_chain=chain)
    np.testing.assert_allclose(to_np(s_p), np.asarray(s_j), **TOL)
    assert_masks_match(to_np(m_p), m_j, s_j)
    # content on a shared mask, so a threshold flip cannot spread
    with torch.no_grad():
        _, c_p, _ = model.decode(torch.from_numpy(z),
                                 torch.from_numpy(np.array(m_j)),
                                 gcl_chain=chain)
    np.testing.assert_allclose(to_np(c_p), np.asarray(c_j), **TOL)


@pytest.mark.parametrize("bn", [True, False], ids=["bn", "nobn"])
def test_decode_tokens_matches_jax(bn):
    cfg = small_cfg(batch_norm=bn)
    variables, _, model = build(cfg, seed=1)
    jcfg = dataclasses.replace(cfg, use_pallas_gcl=True, gcl_chain=2)
    z = random_z(2, cfg.d, seed=5)
    s_j, ids_j, m_j = VAE(jcfg).apply(jax_tree(variables), jnp.asarray(z),
                                      method=VAE.decode_tokens)
    mask = torch.from_numpy(np.array(m_j))
    with torch.no_grad():
        _, ids_p, _ = model.decode_tokens(torch.from_numpy(z), mask)
        _, c_p, _ = model.decode(torch.from_numpy(z), mask)
    assert ids_p.dtype == torch.int32 and ids_p.shape == ids_j.shape
    assert_ids_match(to_np(ids_p), ids_j, to_np(c_p))


def test_sampled_tokens_are_valid_and_seeded():
    """Temperature > 0: plain sampling with a torch.Generator (the JAX
    noise differs, so only validity and seeding are checked)."""
    cfg = small_cfg()
    _, _, model = build(cfg)
    z = torch.from_numpy(random_z(2, cfg.d))

    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return model.decode_tokens(z, structure_temp=0.5,
                                       content_temp=1.0, generator=g)

    _, ids, mask = draw(0)
    assert mask.any(dim=(-1, -2)).all()
    assert int(ids[..., 0].max()) < 131 and int(ids[..., 1].max()) < 99
    torch.testing.assert_close(draw(0)[1], ids)
    assert not torch.equal(draw(1)[1], ids)
