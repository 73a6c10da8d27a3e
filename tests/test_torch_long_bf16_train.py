"""bf16 training at bars of more than 48 steps (`resolution` 13 and up; 24,
the Lakh Pianoroll Dataset's grid, is S = 96) against the JAX package on
the CPU.

JAX trains under the bf16 policy through `gcl_fused`'s custom VJP, whose
backward is the split pair of Pallas kernels (`gcl_backward_pallas`:
`_bwd_data_kernel`, `_bwd_weight_kernel`) in both dtypes and at every grid
(`gcl_pallas.py:493-516`); its single-pass `gcl_backward_fused`
(`_bwd_fused_kernel`) computes the same outputs. Above 48 steps the port's
bf16 training layer takes the forward `gcl_fwd` and the fused backward
`gcl_bwd_fused` (on the card `csrc/gcl_eval_long_bf16_tc.cu`'s training
form and `csrc/gcl_bwd_fused_long_bf16_tc.cu`); the split pair
`gcl_bwd_data`, `gcl_bwd_weight` stays, JAX's route and the fused kernels'
yardstick on the card. Their plain versions, what a CPU tensor runs and
what the card's kernels are held to, must give JAX's bf16 results:

  * at S = 52, 64, 96 and 192 (d = 32, 3 bars from a numpy seed:
    `tests/test_torch_grid_train.py`'s `layer_case`, an empty, a
    single-node and a full bar): the bf16 plain `gcl_fwd` against bf16
    `gcl_apply_pallas` without its epilogue, and the bf16 plain split
    backward against bf16 `gcl_backward_pallas` and the bf16 plain fused
    backward `gcl_bwd_fused_plain` against bf16 `gcl_backward_fused`
    (interpret mode); every output within BF16_REL (2e-2) of its max |JAX|,
    the bound of `tests/test_torch_gcl_fused_bwd.py`;
  * one bf16 `GclFused` layer at S = 96 (the plain forward and fused
    backward): its grads (x, gate table, relation and root weights, bias)
    against `jax.grad` of JAX's bf16 `gcl_fused`, to the same bound;
  * one bf16 train step of a small model (d = 32, 2 layers, 2 bars, one
    microbatch of 32) at r = 13 and 24 against JAX's step under the policy,
    by the rules of `tests/test_torch_bf16_train.py` (`check_step`), the
    weights from JAX's `model.init` at the grid.

On the CPU the kernels' launch counters stay 0. (The card route of the bf16
layer: `tests/test_torch_long_train.py`.)"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyphemus_tpu.ops.kernels import gcl_pallas, gcl_pallas_bwd
from polyphemus_tpu_torch.ops.kernels import counts, gcl, gcl_bwd

from .test_torch_bf16_train import check_step, run_case
from .test_torch_gcl_fused_bwd import assert_bf16_close
from .test_torch_grid_train import layer_case

T, D, NBAR = 4, 32, 3
STEPS = [52, 64, 96, 192]       # resolutions 13, 16, 24, 48
BF = jnp.bfloat16


def bf16_case(s, seed):
    """`layer_case` at bars of 4 x s cells, its float inputs rounded to
    bf16 by JAX's cast: (mask, x, g, gate, rel_w, root, bias) as jax bf16
    arrays (mask bool) and the same values as torch bf16 tensors, x and g
    flat (nbar, 4 s, D)."""
    mask, *vals = layer_case(s, seed=seed, nbar=NBAR, d=D)
    jx = [jnp.asarray(v).astype(BF) for v in vals]
    tx = [torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        torch.bfloat16) for v in jx]
    tx[0] = tx[0].reshape(NBAR, T * s, D)
    tx[1] = tx[1].reshape(NBAR, T * s, D)
    return mask, jx, tx


def port_aux(mask):
    return gcl.build_kernel_aux(torch.from_numpy(mask)).reshape(
        mask.shape[0], gcl.N_AUX, -1)


def f32(v):
    return np.asarray(jnp.asarray(v).astype(jnp.float32)) \
        if not torch.is_tensor(v) else v.float().numpy()


@pytest.mark.parametrize("s", STEPS)
def test_bf16_gcl_fwd_plain_matches_pallas_above_48_steps(s):
    mask, (x, _, gate, rel_w, root, bias), t = bf16_case(s, seed=s + 30)
    want = gcl_pallas.gcl_apply_pallas(
        x, gcl_pallas.build_kernel_aux(jnp.asarray(mask)), gate,
        gcl_pallas.pack_weights(rel_w, root, T, dtype=BF), bias)
    before = dict(counts.launches)
    got = gcl.gcl_fwd(t[0], port_aux(mask), t[2],
                      gcl.pack_weights(t[3], t[4], T), t[5])
    assert counts.launches == before  # the CPU takes the plain path
    assert got.dtype == torch.bfloat16
    assert_bf16_close([f32(got).reshape(x.shape)], [f32(want)], ("out",))


@pytest.mark.parametrize("s", STEPS)
def test_bf16_split_plain_matches_pallas_backward_above_48_steps(s):
    mask, (x, g, gate, rel_w, root, _), t = bf16_case(s, seed=s + 31)
    dx_j, dg_j, dw_j, db_j = gcl_pallas_bwd.gcl_backward_pallas(
        x, gcl_pallas.build_kernel_aux(jnp.asarray(mask)), gate,
        gcl_pallas.pack_weights(rel_w, root, T, dtype=BF), g)
    aux = port_aux(mask)
    before = dict(counts.launches)
    dx, dg, db = gcl_bwd.gcl_bwd_data(t[0], t[1], aux, t[2],
                                      gcl.pack_weights(t[3], t[4], T))
    dw = gcl_bwd.gcl_bwd_weight(t[0], t[1], aux, t[2])
    assert counts.launches == before
    # JAX's dtypes: dx bf16, the sums fp32
    assert dx.dtype == torch.bfloat16 and dx_j.dtype == BF
    assert all(v.dtype == torch.float32 for v in (dg, db, dw))
    assert dg.shape == (s, D)
    assert_bf16_close(
        [f32(dx).reshape(x.shape), f32(dg), f32(db), f32(dw)],
        [f32(dx_j), f32(dg_j), f32(db_j), f32(dw_j)],
        ("dx", "dgate", "dbias", "dwbig"))


@pytest.mark.parametrize("s", STEPS)
def test_bf16_fused_plain_matches_pallas_fused_backward_above_48_steps(s):
    """The bf16 plain fused backward (what the card's long-bar fused kernels
    are held to) against JAX's single-pass `gcl_backward_fused` on the same
    bf16 inputs, output by output."""
    mask, (x, g, gate, rel_w, root, _), t = bf16_case(s, seed=s + 32)
    dx_j, dg_j, dw_j, db_j = gcl_pallas_bwd.gcl_backward_fused(
        x, gcl_pallas.build_kernel_aux(jnp.asarray(mask)), gate,
        gcl_pallas.pack_weights(rel_w, root, T, dtype=BF), g)
    before = dict(counts.launches)
    dx, dg, db, dw = gcl_bwd.gcl_bwd_fused(t[0], t[1], port_aux(mask), t[2],
                                           gcl.pack_weights(t[3], t[4], T))
    assert counts.launches == before
    assert dx.dtype == torch.bfloat16 and dx_j.dtype == BF
    assert all(v.dtype == torch.float32 for v in (dg, db, dw))
    assert dg.shape == (s, D) and dw.shape == (8 * D, D)
    assert_bf16_close(
        [f32(dx).reshape(x.shape), f32(dg), f32(db), f32(dw)],
        [f32(dx_j), f32(dg_j), f32(db_j), f32(dw_j)],
        ("dx", "dgate", "dbias", "dwbig"))


def test_bf16_gcl_fused_matches_jax_grad_at_96_steps():
    """The bf16 training layer's grads at S = 96: the port's `gcl_fused`
    (plain forward, plain fused backward) against `jax.grad` of JAX's bf16
    `gcl_fused` (Pallas forward and split backward, interpret mode)."""
    s = 96
    mask, (x, g, gate, rel_w, root, bias), t = bf16_case(s, seed=7)
    mj = jnp.asarray(mask)
    aux_j = gcl_pallas.build_kernel_aux(mj)
    up = f32(g)

    def loss(*a):
        out = gcl_pallas.gcl_fused(*a, aux_j, mj)
        return jnp.sum(out.astype(jnp.float32) * up)

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(x, gate, rel_w, root,
                                                   bias)
    leaves = [v.clone().requires_grad_() for v in (t[0], t[2], t[3], t[4],
                                                   t[5])]
    before = dict(counts.launches)
    out = gcl_bwd.gcl_fused(*leaves, port_aux(mask), torch.from_numpy(mask))
    (out.float() * torch.from_numpy(up).reshape(out.shape)).sum().backward()
    assert counts.launches == before
    got = [v.grad for v in leaves]
    assert all(v.dtype == torch.bfloat16 for v in got)
    assert got[1].shape == (s, D)
    assert_bf16_close([f32(got[0]).reshape(x.shape)]
                      + [f32(v) for v in got[1:]], [f32(v) for v in want],
                      ("x", "gate_table", "rel_weight", "root", "bias"))


@pytest.mark.parametrize("resolution", [13, 24])
def test_bf16_train_step_matches_jax_above_48_steps(resolution):
    """One bf16 step at accumulate 1 against JAX's under the policy, by
    `tests/test_torch_bf16_train.py`'s rules, seeded by the resolution as
    the fp32 steps at other grids are (`tests/test_torch_long_train.py`);
    no kernel launch on the CPU."""
    before = dict(counts.launches)
    want, bf16, fp32 = run_case(1, resolution=resolution, seed=resolution)
    assert counts.launches == before
    assert bf16[2].cfg.n_timesteps == 4 * resolution
    check_step(want, bf16, fp32)
