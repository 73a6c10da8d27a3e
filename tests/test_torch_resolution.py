"""Bar grids other than 4 x 32 cells: the port at `resolution` 3, 4 and 12
(S = 12, 16 and 48 steps a bar) against the JAX package, on the CPU.

The JAX package's Pallas GCL and chord-tail kernels read the grid from x's
shape, so `make_generator(pallas=True)` (interpret mode) generates at any
resolution; the port's plain versions must give the same result, and its
CUDA wrappers must take these grids. Weights come from JAX's `model.init`
at each resolution (an RBG key: its initializers compile in half the time
of threefry's) through `from_jax_variables` (the reference-layout
converters fix 8 steps a quarter), latents from numpy at a seed.

  * fp32 generation: masks equal where |s_logit| > S_LOGIT_TIE, ids equal
    at active cells outside top-2 logit gaps < LOGIT_TIE, at most 1 % of
    the active ids near-ties (`test_generation_matches_jax`);
  * the encoder's mu within rtol = atol = 2e-4;
  * bf16 generation by `test_torch_bf16_generate`'s rules, at resolution
    12 only: JAX's bf16 Pallas decode takes ~12 s to trace and compile on
    the CPU at each resolution;
  * the wrappers' geometry checks on CPU tensors: S = 4r for r = 1..12
    passes `gcl.check_cuda_args` and `chord_tail._check_cuda_args`, for the
    training kernels (`gcl_fwd`, the backward, `gcl_fused`) too; the eval
    and chord routes take r = 13, 16, 24 and 48 as well (S = 52-192), the
    training forward refuses them; S % 4 != 0 and T != 4 raise; the fp32 fused
    backward, on no training path, refuses every S but 32.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyphemus_tpu.config import ModelConfig
from polyphemus_tpu.data.dataset import synthetic_batch
from polyphemus_tpu.generate import as_bf16
from polyphemus_tpu.generate import make_generator as jax_make_generator
from polyphemus_tpu.models import VAE
from polyphemus_tpu_torch.convert import from_jax_variables
from polyphemus_tpu_torch.generate import make_generator
from polyphemus_tpu_torch.models import VAE as PVAE
from polyphemus_tpu_torch.ops.kernels import chord_tail, counts, gcl, gcl_bwd

from .test_torch_bf16_generate import (LOGIT_TIE_BF16, MAX_FLIP_SHARE,
                                       MAX_TIE_SHARE, S_TIE_BF16, port_gaps)
from .torch_port_case import (assert_ids_match, assert_masks_match, jax_tree,
                              port_cfg, random_z, to_np)

RESOLUTIONS = [3, 4, 12]
BF16_RESOLUTIONS = [12]
TOL = dict(rtol=2e-4, atol=2e-4)


def case_cfg(resolution):
    return ModelConfig(d=32, gnn_n_layers=2, n_bars=2, resolution=resolution,
                       dropout=0.0, batch_norm=True)


@functools.lru_cache(maxsize=None)
def case(resolution):
    """(numpy JAX variables, the JAX VAE, the same with the Pallas GCL, the
    port's VAE in eval mode) at d = 32, 2 layers, 2 bars."""
    cfg = case_cfg(resolution)
    jmodel = VAE(cfg)
    toks, mask = synthetic_batch(np.random.default_rng(resolution), 1,
                                 cfg.n_bars, n_timesteps=cfg.n_timesteps)
    key = jax.random.key(resolution, impl="rbg")
    variables = jax.jit(lambda t, m: jmodel.init(
        {"params": key, "sample": jax.random.fold_in(key, 1)}, t, m,
        deterministic=True))(jnp.asarray(toks), jnp.asarray(mask))
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    model = PVAE(port_cfg(cfg))
    model.load_state_dict(from_jax_variables(variables))
    return (variables, jmodel,
            VAE(dataclasses.replace(cfg, use_pallas_gcl=True)), model.eval())


@pytest.mark.parametrize("resolution", RESOLUTIONS)
def test_generation_matches_jax(resolution):
    """One latent (2 bars). With `model.init`'s weights a run of cells of
    one track often has one GCN state, so a near-tie of its logits repeats
    in every cell of the run: at resolution 4 one tied logit row is 13
    ids, 0.35 % of the active ids. The cap is 1 % of them, not 0.1 %."""
    variables, _, jmodel, model = case(resolution)
    s = 4 * resolution
    z = random_z(1, 32, seed=resolution)
    m_j, t_j, s_j, c_j = (np.asarray(a) for a in jax_make_generator(
        jmodel, jax_tree(variables), pallas=True, return_logits=True)(
        jnp.asarray(z)))
    launches = dict(counts.launches)
    m_p, t_p = (to_np(a) for a in make_generator(model, device="cpu")(z))
    assert counts.launches == launches  # the CPU's plain versions
    assert m_p.shape == (1, 2, 4, s) and t_p.shape == (1, 2, 4, s, 15, 2)
    assert_masks_match(m_p, m_j, s_j)
    assert m_j.any()
    assert_ids_match(t_p, t_j, c_j, mask=m_j, max_tie_frac=1e-2)


@pytest.mark.parametrize("resolution", RESOLUTIONS)
def test_encoder_matches_jax(resolution):
    variables, jmodel, _, model = case(resolution)
    toks, mask = synthetic_batch(np.random.default_rng(resolution + 20), 3,
                                 2, n_timesteps=4 * resolution)
    mask[0, 1] = False  # an empty bar, fixed inside encode
    mu_j, lv_j = jax.jit(lambda v, t, m: jmodel.apply(
        v, t, m, method=VAE.encode))(jax_tree(variables), jnp.asarray(toks),
                                     jnp.asarray(mask))
    with torch.no_grad():
        mu, lv = model.encode(torch.from_numpy(toks), torch.from_numpy(mask))
    np.testing.assert_allclose(to_np(mu), np.asarray(mu_j), **TOL)
    np.testing.assert_allclose(to_np(lv), np.asarray(lv_j), **TOL)


def jax_bf16_decode(cfg, variables, z):
    """JAX's bf16 generation as `make_generator(bf16=True, pallas=True)`
    runs it (the Pallas GCL at chain 2 on bf16 variables, the fused token
    path) in one jit: (mask, ids, s_logits as fp32)."""
    model = VAE(dataclasses.replace(cfg, use_pallas_gcl=True, gcl_chain=2))
    s_j, t_j, m_j = jax.jit(lambda v, zz: model.apply(
        v, zz, None, method=VAE.decode_tokens))(
        as_bf16(jax_tree(variables)), jnp.asarray(z, jnp.bfloat16))
    return (np.asarray(m_j), np.asarray(t_j).astype(np.uint8),
            np.asarray(s_j.astype(jnp.float32)))


@pytest.mark.parametrize("resolution", BF16_RESOLUTIONS)
def test_bf16_generation_matches_jax(resolution):
    """bf16 generation against JAX's by `test_torch_bf16_generate`'s rules:
    structure logits within 2^-6, masks equal where |s| > S_TIE_BF16 with
    under 1 % flipped, and in the bars whose masks agree the ids equal
    outside top-2 gaps < LOGIT_TIE_BF16 of the chord tail on the port's
    bf16 GCN output (under 1 % of the active ids)."""
    variables, _, _, model = case(resolution)
    z = random_z(2, 32, seed=resolution + 10)
    m_j, t_j, s_j = jax_bf16_decode(case_cfg(resolution), variables, z)
    _, _, s_p, _ = make_generator(model, bf16=True, device="cpu",
                                  return_logits=True)(z)
    m_p, t_p = (to_np(a) for a in make_generator(model, bf16=True,
                                                 device="cpu")(z))
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
    print(f"resolution {resolution}: {flips.sum()} of {flips.size} cells "
          f"flipped, {tie[active].mean():.4f} of active ids near-ties, "
          f"{(t_p[same] != t_j[same]).sum()} ids differ in agreeing bars")
    np.testing.assert_array_equal(t_p[same][~tie], t_j[same][~tie])


def gcl_args(t, s, d=128, nbar=2):
    """`gcl.check_cuda_args`' x and want for bars of t x s cells (CPU)."""
    n = t * s
    x = torch.zeros(nbar, n, d)
    want = {"x": (x, (nbar, n, d), torch.float32),
            "aux": (torch.zeros(nbar, gcl.N_AUX, n, dtype=torch.int32),
                    (nbar, gcl.N_AUX, n), torch.int32),
            "gate_table": (torch.zeros(s, d), (s, d), torch.float32)}
    return x, want


def chord_args(t, s, d=128):
    x = torch.zeros(2, t, s, d)
    h = d // 2
    params = {"chord_kernel": torch.zeros(d, 15 * d),
              "chord_bias": torch.zeros(15 * d),
              "pk_drums": torch.zeros(h, 131), "pb_drums": torch.zeros(131),
              "pk_nd": torch.zeros(h, 131), "pb_nd": torch.zeros(131),
              "dk": torch.zeros(h, 99), "db": torch.zeros(99)}
    return x, params


@pytest.mark.parametrize("resolution", range(1, 13))
def test_the_eval_kernels_take_every_resolution_up_to_12(resolution):
    s = 4 * resolution
    x, want = gcl_args(4, s)
    gcl.check_cuda_args("gcl_eval", x, want, n_out=128, s=s,
                        grid=gcl.check_eval_grid)
    chord_tail._check_cuda_args(*chord_args(4, s))
    gcl.check_cuda_args("gcl_fwd", x, want, s=s)  # the training forward too


@pytest.mark.parametrize("t, s", [(4, 52), (4, 64), (4, 96), (4, 192)])
def test_the_eval_kernels_take_bars_above_48_steps(t, s):
    """Resolutions 13, 16, 24 and 48: the eval GCL (the long-bar kernels)
    and the chord tail take them; the training forward takes them in fp32
    and in bf16 (which refused them before bf16 training took long
    bars)."""
    x, want = gcl_args(t, s)
    gcl.check_cuda_args("gcl_eval", x, want, s=s, grid=gcl.check_eval_grid)
    chord_tail._check_cuda_args(*chord_args(t, s))
    gcl.check_cuda_args("gcl_fwd", x, want, s=s)
    xb = x.bfloat16()
    want = dict(want, x=(xb, x.shape, torch.bfloat16))
    gcl.check_cuda_args("gcl_fwd", xb, want, s=s)


@pytest.mark.parametrize("t, s", [(4, 2), (4, 30), (3, 16), (5, 32)])
def test_the_kernels_refuse_other_grids(t, s):
    x, want = gcl_args(t, s)
    with pytest.raises(ValueError, match="4 tracks|a multiple of 4"):
        gcl.check_cuda_args("gcl_eval", x, want, s=s,
                            grid=gcl.check_eval_grid)
    with pytest.raises(ValueError, match="4 x S cells with S a multiple of 4"):
        chord_tail._check_cuda_args(*chord_args(t, s))


TRAINING_KERNELS = ["gcl_fwd", "gcl_bwd_data", "gcl_bwd_weight",
                    "gcl_bwd_fused", "gcl_fused"]


@pytest.mark.parametrize("kernel", TRAINING_KERNELS)
@pytest.mark.parametrize("resolution", range(1, 13))
def test_training_kernels_take_every_resolution_up_to_12(kernel,
                                                         resolution):
    """The grids every training kernel takes on the card (the wrappers'
    `check_grid`, and the bf16 fused backward's form check), with the
    backward's gate table of S rows and a column shard of the output."""
    s = 4 * resolution
    gcl.check_grid(kernel, 4 * s, s)
    x, want = gcl_args(4, s, d=256)
    want["g"] = (torch.zeros(2, 4 * s, 128), (2, 4 * s, 128), torch.float32)
    gcl.check_cuda_args(kernel, x, want, n_out=128, s=s)
    gcl_bwd.check_fused_form(torch.bfloat16, s, 128, 256)


@pytest.mark.parametrize("kernel", TRAINING_KERNELS)
@pytest.mark.parametrize("t, s", [(4, 52), (4, 64), (4, 2), (4, 30),
                                  (3, 16)])
def test_training_kernels_refuse_other_grids(kernel, t, s):
    """3 tracks and S % 4 != 0 in every form; above 48 steps (S = 52, 64,
    which fp32 and bf16 take with the square weights,
    `test_fp32_training_kernels_take_52_and_64_steps`, and in the column
    form) the fused backward only."""
    dt = torch.bfloat16 if s > 48 else torch.float32
    if s > 48 and kernel != "gcl_bwd_fused":  # both forms train there
        gcl.check_grid(kernel, t * s, s, dt)
        x, want = gcl_args(4, s, d=256)
        want["g"] = (torch.zeros(2, 4 * s, 128), (2, 4 * s, 128),
                     torch.float32)
        gcl.check_cuda_args(kernel, x, want, n_out=128, s=s)
        return
    with pytest.raises(ValueError, match=f"{kernel} kernel takes bars of "
                                         f"(4 tracks|4 x S cells with S a "
                                         f"multiple of 4)"):
        gcl.check_grid(kernel, t * s, s, dt)


@pytest.mark.parametrize("kernel", [k for k in TRAINING_KERNELS
                                    if k != "gcl_bwd_fused"])
@pytest.mark.parametrize("s", [52, 64])
def test_fp32_training_kernels_take_52_and_64_steps(kernel, s):
    gcl.check_grid(kernel, 4 * s, s)
    x, want = gcl_args(4, s, d=256)
    gcl.check_cuda_args(kernel, x, want, s=s)


@pytest.mark.parametrize("resolution", [r for r in range(1, 13) if r != 8])
def test_fp32_fused_backward_refuses_other_grids(resolution):
    """`csrc/gcl_bwd_fused.cu` (on no training path) stays at 4 x 32 cells:
    its form check refuses every other resolution with a message that names
    it, and takes resolution 8 and the bf16 form at every grid."""
    s = 4 * resolution
    with pytest.raises(ValueError, match="fp32 fused backward .*gcl_bwd_fused"
                                         "\\.cu.*\\(resolution 8\\)"):
        gcl_bwd.check_fused_form(torch.float32, s, 256, 256)
    gcl_bwd.check_fused_form(torch.float32, 32, 256, 256)
    gcl_bwd.check_fused_form(torch.bfloat16, s, 256, 256)
