"""fp32 training at bars of more than 48 steps (`resolution` 13 and up; 24,
the Lakh Pianoroll Dataset's grid, is S = 96) against the JAX package on
the CPU, and the route the training layer takes on the card.

The JAX package's training kernels take the steps a bar from x's shape, so
its Pallas GCL (interpret mode) trains at any resolution; the port's plain
training GCL, what a CPU tensor runs and what the card's long-bar kernels
are held to, must give the same result there:

  * at S = 52, 64, 96 and 192 (d = 32, 3 bars from a numpy seed: an empty,
    a single-node and a full bar): the plain forward `gcl_fwd` against
    `gcl_apply_pallas` without its epilogue (rtol = atol = 2e-4), the plain
    split backward (`gcl_bwd_data`, `gcl_bwd_weight`) against
    `gcl_backward_pallas` (5e-4), as `tests/test_torch_grid_train.py` holds
    them at S <= 48;
  * one fp32 train step of a small model (d = 32, 2 layers, 2 bars,
    accumulate 1) at r = 13 and 24 against JAX's
    (`test_torch_train_step.jax_reference_step`): losses within 2e-4,
    grads, params and batch statistics within 5e-4, the metrics by the
    near-tie rule; both resolutions in one process also hold its cache of
    grad functions to one per model.

The route at S > 48, with a CUDA tensor's path taken on CPU tensors (the
`card_route` fixture of `tests/test_torch_long_bars.py`: `on_card` patched,
the C launchers recorded): an fp32 `GclFused` forward and backward with the
square weights launches `gcl_fwd_long`, `gcl_bwd_data_long` and
`gcl_bwd_weight_long` once each and counts them at S; a bf16 one
`gcl_fwd_long_bf16` and `gcl_bwd_fused_long_bf16` (the fused backward,
as bf16 training takes it at every grid; no split kernel), counted as
`gcl_fwd_bf16`, `gcl_bwd_fused`; the bf16 fused backward alone launches
its long form once with (nbar, S, d, n); in the column form (tensor
parallelism) the same kernels with the shard's output width, counted as
column-form launches too; at S = 12 and 48 it keeps the grid kernels. On the CPU the kernels' launch counters stay 0. (bf16 against
JAX above 48 steps: `tests/test_torch_long_bf16_train.py`.)"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyphemus_tpu.ops.kernels import gcl_pallas, gcl_pallas_bwd
from polyphemus_tpu_torch.ops.kernels import counts, gcl, gcl_bwd

from .test_torch_gcl_train import BWD_TOL, FWD_TOL
from .test_torch_grid_train import layer_case, port_args
from .test_torch_long_bars import card_route  # noqa: F401 (a fixture)
from .test_torch_train_step import (check_against_jax, jax_reference_step,
                                    run_case)

T, D, NBAR = 4, 32, 3
STEPS = [52, 64, 96, 192]       # resolutions 13, 16, 24, 48


@pytest.mark.parametrize("s", STEPS)
def test_gcl_fwd_plain_matches_pallas_above_48_steps(s):
    mask, x, _, gate, rel_w, root, bias = layer_case(s, seed=s, nbar=NBAR,
                                                     d=D)
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
def test_gcl_bwd_plain_matches_pallas_backward_above_48_steps(s):
    mask, x, g, gate, rel_w, root, _ = layer_case(s, seed=s + 1, nbar=NBAR,
                                                  d=D)
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


@pytest.mark.parametrize("resolution", [13, 24])
def test_train_step_matches_jax_above_48_steps(resolution):
    """One fp32 step at accumulate 1 (weights from JAX's `model.init` at the
    grid)."""
    (cfg, variables, jmodel, toks, mask, rng, model, p_losses, p_accs,
     slack) = run_case(1, seed=resolution, resolution=resolution)
    assert mask.shape[-1] == 4 * resolution
    want = jax_reference_step(jmodel, cfg, variables, toks, mask, rng)
    check_against_jax(want, p_losses, p_accs, model, slack)


def layer_args(s, d=128, n=None, dtype=torch.float32, nbar=2):
    """`GclFused`'s arguments over nbar bars of 4 x s cells (zeros but aux
    and mask), relation and root weights of n output columns of d (default
    d), x and the weights requiring grads."""
    rng = np.random.default_rng(s)
    mask = torch.from_numpy(rng.random((nbar, T, s)) < 0.3)
    n = d if n is None else n
    aux = gcl.build_kernel_aux(mask).reshape(nbar, gcl.N_AUX, T * s)
    x = torch.zeros(nbar, T * s, d, dtype=dtype, requires_grad=True)
    gates = torch.zeros(s, d, dtype=dtype, requires_grad=True)
    rel_w = torch.zeros(6, d, n, dtype=dtype, requires_grad=True)
    root = torch.zeros(d, n, dtype=dtype, requires_grad=True)
    bias = torch.zeros(n, dtype=dtype, requires_grad=True)
    return x, gates, rel_w, root, bias, aux, mask


@pytest.fixture
def layer_route(card_route, monkeypatch):  # noqa: F811 (the fixture)
    """`card_route` with the backward wrappers' `on_card` patched too."""
    monkeypatch.setattr(gcl_bwd, "on_card", lambda kernel, x: True)
    return card_route


def test_fp32_training_layer_launches_the_long_forms(layer_route):
    """Forward and backward of one fp32 layer at S = 96: one launch of each
    long-bar kernel, with the layer's pointers and sizes (nbar, S, d, n,
    stream), each counted at S = 96."""
    s, d, nbar = 96, 128, 2
    args = layer_args(s, d, nbar=nbar)
    x, gates, aux = args[0], args[1], args[5]
    before = dict(counts.launches)
    out = gcl_bwd.GclFused.apply(*args)
    assert out.shape == (nbar, T * s, d)
    out.backward(torch.ones_like(out))
    names = [c[0] for c in layer_route]
    assert names == ["gcl_fwd_long", "gcl_bwd_data_long",
                     "gcl_bwd_weight_long"]
    (_, fwd), (_, data), (_, weight) = layer_route
    # (x, aux, gates, wbig, bias, out, nbar, S, d, n, stream)
    assert fwd[:3] == (x.data_ptr(), aux.data_ptr(), gates.data_ptr())
    assert fwd[5] == out.data_ptr() and fwd[6:] == (nbar, s, d, d, 0)
    # (x, g, aux, gates, wbig, dx, part, out, up, nbar, S, d, n, stream)
    assert data[0] == x.data_ptr() and data[2:5] == (
        aux.data_ptr(), gates.data_ptr(), fwd[3])
    assert len({data[5], data[6], data[7], data[8]}) == 4
    assert data[9:] == (nbar, s, d, d, 0)
    # (x, g, aux, gates, dwbig, nbar, S, d, n, stream)
    assert weight[:4] == (x.data_ptr(), data[1], aux.data_ptr(),
                          gates.data_ptr())
    assert weight[5:] == (nbar, s, d, d, 0)
    assert counts.since(before) == {
        (k, s, 1): 1 for k in ("gcl_fwd", "gcl_bwd_data", "gcl_bwd_weight")}


@pytest.mark.parametrize("s", STEPS)
def test_bf16_training_layer_refuses_long_bars_before_any_launch(
        layer_route, s):
    """Once refused above 48 steps, a bf16 layer now trains there: forward
    and backward launch the long-bar bf16 training form and the long-bar
    bf16 fused backward once each, with the layer's pointers and sizes,
    each counted at S, and no split kernel."""
    d, nbar = 128, 2
    args = layer_args(s, d, dtype=torch.bfloat16, nbar=nbar)
    x, gates, aux = args[0], args[1], args[5]
    before = dict(counts.launches)
    out = gcl_bwd.GclFused.apply(*args)
    assert out.shape == (nbar, T * s, d) and out.dtype == torch.bfloat16
    out.backward(torch.ones_like(out))
    assert [c[0] for c in layer_route] == [
        "gcl_fwd_long_bf16", "gcl_bwd_fused_long_bf16"]
    (_, fwd), (_, fused) = layer_route
    assert fwd[:3] == (x.data_ptr(), aux.data_ptr(), gates.data_ptr())
    assert fwd[5] == out.data_ptr() and fwd[6:] == (nbar, s, d, d, 0)
    # (x, g, aux, gates, wbig, dx, part, dwbig, out, up, nbar, S, d, n,
    # stream)
    assert fused[0] == x.data_ptr() and fused[2:5] == (
        aux.data_ptr(), gates.data_ptr(), fwd[3])
    assert len({fused[5], fused[6], fused[7], fused[8], fused[9]}) == 5
    assert fused[10:] == (nbar, s, d, d, 0)
    assert counts.since(before) == {
        (k, s, 1): 1 for k in ("gcl_fwd_bf16", "gcl_bwd_fused")}
    assert all(v.grad is not None and v.grad.dtype == torch.bfloat16
               for v in args[:5])


@pytest.mark.parametrize("s", STEPS)
def test_bf16_fused_backward_refuses_long_bars_before_any_launch(
        layer_route, s):
    """Once refused above 48 steps, the bf16 fused backward (bf16
    training's route at every grid) launches its long-bar form once with
    its arguments' pointers and (nbar, S, d, n), counted at S, no column
    form; its scratch (the upstream planes, 4 x nbar x 4S x d floats, and
    the per-bar partials) apart from its outputs."""
    bf = torch.bfloat16
    x, gates, rel_w, root, _, aux, _ = layer_args(s, dtype=bf)
    x, gates = x.detach(), gates.detach()
    wbig = gcl.pack_weights(rel_w.detach(), root.detach(), T)
    before = dict(counts.launches), dict(gcl.col_launches)
    dx, dgate, dbias, dwbig = gcl_bwd.gcl_bwd_fused(x, x, aux, gates, wbig)
    assert [c[0] for c in layer_route] == ["gcl_bwd_fused_long_bf16"]
    a = layer_route[0][1]
    assert a[:5] == (x.data_ptr(), x.data_ptr(), aux.data_ptr(),
                     gates.data_ptr(), wbig.data_ptr())
    assert a[5] == dx.data_ptr() and a[7] == dwbig.data_ptr()
    assert a[8] == dgate.data_ptr() and a[10:] == (2, s, 128, 128, 0)
    assert dx.shape == x.shape and dx.dtype == bf
    assert dgate.shape == (s, 128) and dbias.shape == (128,)
    assert dwbig.shape == (8 * 128, 128)
    assert counts.since(before[0]) == {("gcl_bwd_fused", s, 1): 1}
    assert gcl.col_launches == before[1]


@pytest.mark.parametrize("s", STEPS)
def test_column_form_refuses_long_bars_before_any_launch(layer_route, s):
    """Once refused above 48 steps, the column form (n = 128 of d = 256)
    of an fp32 and a bf16 layer now trains there: forward and backward
    launch the long-bar kernels once each (fp32: the forward and the split
    pair; bf16: the forward and the fused backward) with the layer's
    pointers and (nbar, S, d, n), each counted at S and as a column-form
    launch; the output and the weights' grads are n wide, x's grad d
    wide."""
    d, n, nbar = 256, 128, 2
    for dt, bf in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        del layer_route[:]
        args = layer_args(s, d, n, dtype=dt, nbar=nbar)
        x, gates, aux = args[0], args[1], args[5]
        before = dict(counts.launches), dict(gcl.col_launches)
        out = gcl_bwd.GclFused.apply(*args)
        assert out.shape == (nbar, T * s, n) and out.dtype == dt
        out.backward(torch.ones_like(out))
        bwd = (["gcl_bwd_fused_long_bf16"] if bf else
               ["gcl_bwd_data_long", "gcl_bwd_weight_long"])
        assert [c[0] for c in layer_route] == [f"gcl_fwd_long{bf}"] + bwd
        (_, fwd), (_, data) = layer_route[:2]
        assert fwd[:3] == (x.data_ptr(), aux.data_ptr(), gates.data_ptr())
        assert fwd[5] == out.data_ptr() and fwd[6:] == (nbar, s, d, n, 0)
        assert data[0] == x.data_ptr() and data[2:5] == (
            aux.data_ptr(), gates.data_ptr(), fwd[3])
        assert data[-5:] == (nbar, s, d, n, 0)
        if not bf:
            weight = layer_route[2][1]
            assert weight[:4] == (x.data_ptr(), data[1], aux.data_ptr(),
                                  gates.data_ptr())
            assert weight[5:] == (nbar, s, d, n, 0)
        names = ([f"gcl_fwd{bf}", "gcl_bwd_fused"] if bf else
                 ["gcl_fwd", "gcl_bwd_data", "gcl_bwd_weight"])
        assert counts.since(before[0]) == {(k, s, 1): 1 for k in names}
        cols = (["gcl_fwd_bf16", "gcl_bwd_fused_bf16"] if bf else names)
        assert {k: v - before[1][k] for k, v in gcl.col_launches.items()
                if v != before[1][k]} == dict.fromkeys(cols, 1)
        assert x.grad.shape == (nbar, T * s, d)
        assert args[2].grad.shape == (6, d, n) and args[4].grad.shape == (n,)


@pytest.mark.parametrize("s", [12, 48])
def test_fp32_training_layer_keeps_its_grid_launches_up_to_48_steps(
        layer_route, s):
    before = dict(counts.launches)
    out = gcl_bwd.GclFused.apply(*layer_args(s))
    out.backward(torch.ones_like(out))
    assert [c[0] for c in layer_route] == [
        "gcl_fwd_grid", "gcl_bwd_data_grid", "gcl_bwd_weight_grid"]
    # the grid data backward takes no scratch: (.., out, nbar, S, d, n, 0)
    assert layer_route[1][1][8:] == (2, s, 128, 128, 0)
    assert counts.since(before) == {
        (k, s, 1): 1 for k in ("gcl_fwd", "gcl_bwd_data", "gcl_bwd_weight")}
