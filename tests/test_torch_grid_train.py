"""Training at bar grids other than 4 x 32 cells (`resolution` r != 8, S =
4 r steps a bar) against the JAX package, on the CPU.

The JAX package's training kernels take the steps a bar from x's shape, so
its Pallas GCL (interpret mode) trains at any resolution; the port's plain
training GCL, what a CPU tensor runs and what the card's grid kernels are
held to, must give the same result at every grid they take:

  * at S = 12, 16, 24 and 48 (d = 16, 4 bars from a numpy seed, an empty, a
    single-node and a full bar among them): the plain forward `gcl_fwd`
    against `gcl_apply_pallas` without its epilogue (rtol = atol = 2e-4),
    the plain split backward (`gcl_bwd_data`, `gcl_bwd_weight`) against
    `gcl_backward_pallas` (5e-4, as tests/test_torch_gcl_train.py at S =
    32), and the bf16 `gcl_fused` autograd function (the fused backward's
    plain version) against `jax.grad` of JAX's bf16 `gcl_fused`, each grad
    within 2e-2 x its max |JAX| (tests/test_torch_gcl_fused_bwd.py's rule);
  * one fp32 train step of a small model (d = 32, 2 layers, 2 bars) at r =
    4 and 12 against JAX's (`test_torch_train_step.jax_reference_step`):
    losses within 2e-4, grads, params and batch statistics within 5e-4,
    the metrics by the near-tie rule, as at r = 8.

On the CPU the kernels' launch counters stay 0."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyphemus_tpu.ops.kernels import gcl_pallas, gcl_pallas_bwd
from polyphemus_tpu_torch.ops.kernels import counts, gcl, gcl_bwd

from .test_torch_gcl_fused_bwd import assert_bf16_close
from .test_torch_gcl_train import BWD_TOL, FWD_TOL
from .test_torch_train_step import (check_against_jax, jax_reference_step,
                                    run_case)

T, D = 4, 16
STEPS = [12, 16, 24, 48]


def layer_case(s, seed, nbar=4, d=D, density=0.3):
    """mask (nbar, T, s) with a single-node bar off track 0, an empty bar
    (fixed to cell [0, 0]) and a full bar; x (masked), upstream g, gate
    table, relation and root weights and bias, fp32, from a numpy seed."""
    rng = np.random.default_rng(seed)
    mask = rng.random((nbar, T, s)) < density
    mask[0] = False
    mask[0, 2, s // 2 + 1] = True
    mask[1] = False
    mask[1, 0, 0] = True
    mask[2] = True
    x = (rng.standard_normal((nbar, T, s, d)).astype(np.float32)
         * mask[..., None])
    g = rng.standard_normal((nbar, T, s, d)).astype(np.float32)
    gate = (rng.standard_normal((s, d)) * 0.5).astype(np.float32)
    rel_w = (rng.standard_normal((6, d, d)) * d ** -0.5).astype(np.float32)
    root = (rng.standard_normal((d, d)) * d ** -0.5).astype(np.float32)
    bias = (rng.standard_normal(d) * 0.2).astype(np.float32)
    return mask, x, g, gate, rel_w, root, bias


def port_args(mask, x, *rest):
    nbar, t, s, d = x.shape
    aux = gcl.build_kernel_aux(torch.from_numpy(mask)).reshape(
        nbar, gcl.N_AUX, t * s)
    return aux, torch.from_numpy(x).reshape(nbar, t * s, d), [
        torch.from_numpy(a) for a in rest]


@pytest.mark.parametrize("s", STEPS)
def test_gcl_fwd_plain_matches_pallas_at_other_grids(s):
    mask, x, _, gate, rel_w, root, bias = layer_case(s, seed=s)
    wbig_j = gcl_pallas.pack_weights(jnp.asarray(rel_w), jnp.asarray(root),
                                     T, dtype=jnp.float32)
    want = gcl_pallas.gcl_apply_pallas(
        jnp.asarray(x), gcl_pallas.build_kernel_aux(jnp.asarray(mask)),
        jnp.asarray(gate), wbig_j, jnp.asarray(bias))
    aux, xf, (gate_t, rel_t, root_t, bias_t) = port_args(
        mask, x, gate, rel_w, root, bias)
    before = dict(counts.launches)
    got = gcl.gcl_fwd(xf, aux, gate_t, gcl.pack_weights(rel_t, root_t, T),
                      bias_t)
    assert counts.launches == before  # the CPU takes the plain path
    np.testing.assert_allclose(got.reshape(x.shape).numpy(),
                               np.asarray(want), **FWD_TOL)


@pytest.mark.parametrize("s", STEPS)
def test_gcl_bwd_plain_matches_pallas_backward_at_other_grids(s):
    mask, x, g, gate, rel_w, root, _ = layer_case(s, seed=s + 1)
    wbig_j = gcl_pallas.pack_weights(jnp.asarray(rel_w), jnp.asarray(root),
                                     T, dtype=jnp.float32)
    dx_j, dg_j, dw_j, db_j = gcl_pallas_bwd.gcl_backward_pallas(
        jnp.asarray(x), gcl_pallas.build_kernel_aux(jnp.asarray(mask)),
        jnp.asarray(gate), wbig_j, jnp.asarray(g))
    aux, xf, (gf, gate_t, rel_t, root_t) = port_args(mask, x, g, gate,
                                                     rel_w, root)
    gf = gf.reshape(xf.shape)
    before = dict(counts.launches)
    dx, dg, db = gcl_bwd.gcl_bwd_data(xf, gf, aux, gate_t,
                                      gcl.pack_weights(rel_t, root_t, T))
    dw = gcl_bwd.gcl_bwd_weight(xf, gf, aux, gate_t)
    assert counts.launches == before
    assert dg.shape == (s, D)
    for name, a, b in (("dx", dx.reshape(x.shape), dx_j), ("dgate", dg, dg_j),
                       ("dbias", db, db_j), ("dwbig", dw, dw_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **BWD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("s", STEPS)
def test_gcl_fused_bf16_matches_jax_grad_at_other_grids(s):
    """The bf16 training layer's grads: the port's `gcl_fused` (plain
    forward, fused backward's plain version) against `jax.grad` of JAX's
    bf16 `gcl_fused` (Pallas forward and fused backward, interpret
    mode)."""
    mask, x, g, gate, rel_w, root, bias = layer_case(s, seed=s + 2)
    bf = jnp.bfloat16
    mj = jnp.asarray(mask)
    aux_j = gcl_pallas.build_kernel_aux(mj)
    up = jnp.asarray(g)
    args = [jnp.asarray(a).astype(bf) for a in (x, gate, rel_w, root, bias)]

    def loss(*a):
        out = gcl_pallas.gcl_fused(*a, aux_j, mj)
        return jnp.sum(out.astype(jnp.float32) * up)

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*args)
    want = [np.asarray(v.astype(jnp.float32)) for v in want]
    nbar = mask.shape[0]
    aux = gcl.build_kernel_aux(torch.from_numpy(mask)).reshape(
        nbar, gcl.N_AUX, T * s)
    leaves = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16).requires_grad_() for a in args]
    xf = leaves[0].reshape(nbar, T * s, D)
    before = dict(counts.launches)
    out = gcl_bwd.gcl_fused(xf, *leaves[1:], aux, torch.from_numpy(mask))
    (out.float() * torch.from_numpy(g).reshape(out.shape)).sum().backward()
    assert counts.launches == before
    got = [v.grad for v in leaves]
    assert all(v.dtype == torch.bfloat16 for v in got)
    assert got[1].shape == (s, D)
    assert_bf16_close([v.float().numpy() for v in got], want,
                      ("x", "gate_table", "rel_weight", "root", "bias"))


@pytest.mark.parametrize("resolution", [4, 12])
def test_train_step_matches_jax_at_other_grids(resolution):
    """One fp32 step at accumulate 1 (weights from JAX's `model.init` at the
    grid); both resolutions in one process also hold `jax_reference_step`'s
    cache of grad functions to one per model."""
    (cfg, variables, jmodel, toks, mask, rng, model, p_losses, p_accs,
     slack) = run_case(1, seed=resolution, resolution=resolution)
    assert mask.shape[-1] == 4 * resolution
    want = jax_reference_step(jmodel, cfg, variables, toks, mask, rng)
    check_against_jax(want, p_losses, p_accs, model, slack)
