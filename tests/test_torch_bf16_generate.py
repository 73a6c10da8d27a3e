"""bf16 generation: the port's `make_generator(bf16=True)` on the CPU
against the JAX package's `make_generator(bf16=True, pallas=True)` (the
chained eval GCL at chain 2 and the chord-tail kernel, in interpret mode),
on the same weights and z.

The two decode the same bf16 arithmetic: every op rounds to bf16 where
XLA's does (`Linear`/`Conv2d` round the product before the bias, the
threshold's sigmoid is 1 / (1 + exp(-x)) op by op), the GCL kernels round
where the Pallas bodies cast, and the chord tail sums bf16 products in fp32.
What still differs is the summation order of fp32 accumulations, which
moves a bf16 result by one ulp now and then:

  * structure logits: within one bf16 ulp (2^-7 relative, 2^-7 absolute
    below 1); held at twice that;
  * masks: in bf16, 1 + exp(-s) rounds to 2 for s >= -0.0117, so the 0.5
    threshold sits at s = -0.0117, not 0; a cell can flip where the two
    logits straddle it. Masks are held equal where |s| > S_TIE_BF16 = 0.03
    (the threshold's 0.0117 plus two ulps, 2 x 2^-7, of the logits' largest
    difference); the flipped share is reported and held under 1 %;
  * ids: one flipped cell changes its bar's graph, so ids are compared only
    in bars whose masks agree; there they are equal except where the
    fp32 top-2 logit gap of the chord tail (on the port's bf16 GCN output)
    is below LOGIT_TIE_BF16 = 1e-3: a bf16 ulp (2^-8 relative) of a GCN
    state element moves a logit by about 2e-4 at this width (through the
    slot projection, weights ~d^-1/2, and the unembed); such ties are held
    under 1 % of the active ids.

Observed at seeds 0-3 (d = 32, 3 layers): logits within 0.0059, 0-3 of
2048 cells flipped (under 0.15 %), every id equal in the bars that agree.
"""
import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyphemus_tpu.generate import make_generator as jax_make_generator
from polyphemus_tpu.models import VAE
from polyphemus_tpu_torch.generate import make_generator
from polyphemus_tpu_torch.ops.kernels import counts

from .test_torch_chord_tail import plain_logits
from .torch_port_case import build, jax_tree, random_z, small_cfg, top2_gap

S_TIE_BF16 = 0.03
LOGIT_TIE_BF16 = 1e-3
MAX_FLIP_SHARE = 1e-2
MAX_TIE_SHARE = 1e-2


def port_gaps(model, z, mask):
    """fp32 top-2 logit gaps (B, nb, T, S, 15, 2) of the chord tail on the
    port's bf16 GCN output for (z, mask)."""
    bf = copy.deepcopy(model).to(torch.bfloat16)
    seen = {}
    bf.decoder.c_decoder.graph_decoder.register_forward_hook(
        lambda mod, args, out: seen.update(x=out))
    with torch.no_grad():
        bf.decode_tokens(torch.from_numpy(z).bfloat16(),
                         torch.from_numpy(mask.copy()), gcl_chain=2)
    cd = bf.decoder.c_decoder
    params = [cd.chord_decoder.kernel, cd.chord_decoder.bias,
              cd.drums_pitch_emb.kernel, cd.drums_pitch_emb.bias,
              cd.non_drums_pitch_emb.kernel, cd.non_drums_pitch_emb.bias,
              cd.dur_emb.kernel, cd.dur_emb.bias]
    logits = plain_logits(seen["x"].double().numpy(),
                          *(p.detach().double().numpy() for p in params))
    return np.stack([top2_gap(logits[..., :131]),
                     top2_gap(logits[..., 131:])], axis=-1)


@pytest.mark.parametrize("seed", [0, 2])
def test_bf16_generation_matches_jax(seed):
    cfg = small_cfg(n_layers=3)
    variables, _, model = build(cfg, seed=seed)
    jmodel = VAE(dataclasses.replace(cfg, use_pallas_gcl=True, gcl_chain=2))
    z = random_z(8, cfg.d, seed=seed + 10)
    m_j, t_j = jax_make_generator(jmodel, jax_tree(variables), bf16=True,
                                  pallas=True)(jnp.asarray(z))
    _, _, s_j, _ = jax_make_generator(jmodel, jax_tree(variables), bf16=True,
                                      pallas=True, return_logits=True)(
        jnp.asarray(z))
    m_j, t_j = np.asarray(m_j), np.asarray(t_j)
    s_j = np.asarray(s_j.astype(jnp.float32))

    launches = dict(counts.launches)
    m_p, t_p = make_generator(model, bf16=True, device="cpu")(z)
    _, _, s_p, c_p = make_generator(model, bf16=True, device="cpu",
                                    return_logits=True)(z)
    assert counts.launches == launches
    assert s_p.dtype == torch.bfloat16 and c_p.dtype == torch.bfloat16
    assert t_p.dtype == torch.uint8
    assert next(model.parameters()).dtype == torch.float32  # left as it was
    m_p, t_p = m_p.numpy(), t_p.numpy()

    np.testing.assert_allclose(s_p.float().numpy(), s_j, rtol=2 ** -6,
                               atol=2 ** -6)
    clear = np.abs(s_j) > S_TIE_BF16
    np.testing.assert_array_equal(m_p[clear], m_j[clear])
    flips = m_p != m_j
    assert flips.mean() < MAX_FLIP_SHARE, flips.mean()

    same = ~flips.any(axis=(-1, -2))   # bars whose masks agree
    assert same.any()
    tie = port_gaps(model, z, m_j)[same] < LOGIT_TIE_BF16
    active = m_j[same]
    assert tie[active].mean() < MAX_TIE_SHARE, tie[active].mean()
    print(f'seed {seed}: {flips.sum()} of {flips.size} cells flipped, '
          f'{tie[active].mean():.4f} of active ids near-ties, '
          f'{(t_p[same] != t_j[same]).sum()} ids differ in agreeing bars')
    np.testing.assert_array_equal(t_p[same][~tie], t_j[same][~tie])


def test_bf16_generation_conditioned_and_sampled():
    """A given structure is kept; at a temperature > 0 the bf16 decode
    samples valid ids from seeded noise (JAX's noise differs)."""
    cfg = small_cfg(n_layers=3)
    _, _, model = build(cfg, seed=1)
    z = random_z(4, cfg.d, seed=7)
    mask = np.zeros((4, cfg.n_bars, 4, 32), bool)
    mask[..., 0, ::4] = True
    m, t = make_generator(model, conditioned=True, bf16=True,
                          device="cpu")(z, mask)
    np.testing.assert_array_equal(m.numpy(), mask)
    hot = make_generator(model, bf16=True, structure_temp=0.7,
                         content_temp=1.0, sample_seed=3, device="cpu")
    m1, t1 = hot(z)
    assert m1.any(dim=(-1, -2)).all()
    assert int(t1[..., 0].max()) < 131 and int(t1[..., 1].max()) < 99
    m2, t2 = make_generator(model, bf16=True, structure_temp=0.7,
                            content_temp=1.0, sample_seed=3,
                            device="cpu")(z)
    assert torch.equal(m1, m2) and torch.equal(t1, t2)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_make_generator_leaves_the_model_as_it_was(bf16, monkeypatch):
    """JAX's `make_generator` leaves `variables` untouched. A model in
    training mode keeps its mode, dtype and device and is decoded as its
    eval-mode self; a model already in eval mode on the device is used as
    it is (fp32: no copy)."""
    from types import SimpleNamespace

    from polyphemus_tpu_torch import generate as G

    cfg = small_cfg(n_layers=3)
    _, _, model = build(cfg, seed=1)   # in eval mode
    z = random_z(4, cfg.d, seed=5)
    want = make_generator(model, bf16=bf16, return_logits=True,
                          device="cpu")(z)
    model.train()
    got = make_generator(model, bf16=bf16, return_logits=True,
                         device="cpu")(z)
    assert all(m.training for m in model.modules())
    assert all(t.dtype == torch.float32 and t.device.type == "cpu"
               for t in list(model.parameters()) + list(model.buffers())
               if t.is_floating_point())
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)

    if not bf16:
        def no_copy(_):
            raise AssertionError("an eval model on the device was copied")

        monkeypatch.setattr(G, "copy", SimpleNamespace(deepcopy=no_copy))
        model.eval()
        again = make_generator(model, return_logits=True, device="cpu")(z)
        for a, b in zip(again, want):
            assert torch.equal(a, b)


def test_bf16_layers_round_as_jax():
    """In bf16 the JAX package rounds `x @ kernel` before `+ bias` (Dense
    and its im2col Conv3x3) and computes the sigmoid as 1 / (1 + exp(-x))
    op by op; the port's layers and threshold round at the same places, so
    they agree exactly (`F.linear` and `torch.sigmoid` round once and
    differ from JAX in many elements)."""
    import jax
    from flax import linen as fnn

    from polyphemus_tpu.models.layers import Conv3x3
    from polyphemus_tpu_torch.models.layers import Conv2d, Linear
    from polyphemus_tpu_torch.models.vae import _sigmoid

    rng = np.random.default_rng(0)
    bf = jnp.bfloat16
    x = jnp.asarray(rng.standard_normal((64, 96)), bf)
    lin = fnn.Dense(40)
    v = jax.tree_util.tree_map(lambda a: a.astype(bf),
                               lin.init(jax.random.key(0), x))
    v["params"]["bias"] = jnp.asarray(rng.standard_normal(40), bf)
    want = np.asarray(lin.apply(v, x).astype(jnp.float32))
    port = Linear(96, 40).to(torch.bfloat16)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(np.asarray(
            v["params"]["kernel"].astype(jnp.float32)).T))
        port.bias.copy_(torch.from_numpy(np.asarray(
            v["params"]["bias"].astype(jnp.float32))))
        xt = torch.from_numpy(np.asarray(x.astype(jnp.float32))).bfloat16()
        np.testing.assert_array_equal(port(xt).float().numpy(), want)
        assert (torch.nn.functional.linear(xt, port.weight, port.bias)
                .float().numpy() != want).any()

    img = jnp.asarray(rng.standard_normal((3, 4, 8, 5)), bf)  # NHWC
    conv = Conv3x3(6)
    cv = jax.tree_util.tree_map(lambda a: a.astype(bf),
                                conv.init(jax.random.key(1), img))
    cv["params"]["bias"] = jnp.asarray(rng.standard_normal(6), bf)
    want = np.asarray(conv.apply(cv, img).astype(jnp.float32))
    pconv = Conv2d(5, 6, 3, padding=1).to(torch.bfloat16)
    with torch.no_grad():
        k = np.asarray(cv["params"]["kernel"].astype(jnp.float32))
        pconv.weight.copy_(torch.from_numpy(k.transpose(3, 2, 0, 1).copy()))
        pconv.bias.copy_(torch.from_numpy(np.asarray(
            cv["params"]["bias"].astype(jnp.float32))))
        it = torch.from_numpy(np.asarray(img.astype(jnp.float32))
                              .transpose(0, 3, 1, 2).copy()).bfloat16()
        got = pconv(it).float().numpy().transpose(0, 2, 3, 1)
    # the two sum 45 products in different orders in fp32 before rounding
    mism = (got != want).mean()
    assert mism < 1e-2, mism
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -7)

    s = jnp.asarray(np.linspace(-0.05, 0.05, 2001), bf)
    st = torch.from_numpy(np.asarray(s.astype(jnp.float32))).bfloat16()
    want = np.asarray(jax.nn.sigmoid(s) >= 0.5)
    np.testing.assert_array_equal((_sigmoid(st) >= 0.5).numpy(), want)
    assert ((torch.sigmoid(st) >= 0.5).numpy() != want).any()
