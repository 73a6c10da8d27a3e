"""Bars of more than 48 steps (`resolution` 13 and up; 24, the Lakh
Pianoroll Dataset's grid, is S = 96): the port against the JAX package on
the CPU, and the route its wrappers take on the card.

The JAX package's Pallas GCL and chord-tail kernels read the grid from x's
shape, so they take any S; the port's plain versions must give the same
result at S = 52, 64, 96 and 192 (d = 32, 3 bars, inputs from numpy at a
seed; JAX's kernels in interpret mode):

  * the plain `gcl_eval` at K = 1 and 2 against `gcl_apply_pallas` with
    its epilogue and `gcl_apply_pallas_chain`: fp32 at rtol = atol = 2e-4,
    bf16 within 2e-2 x max |JAX| (`tests/test_torch_gcl_fused_bwd.py`'s
    bound);
  * the plain chord tail against `chord_tail_tokens`: ids equal outside
    top-2 logit gaps < 1e-4, fp32 and bf16 (`tests/test_torch_chord_tail.py`'s
    rule);
  * `make_generator` at resolution 13 and 24 (d = 32, 2 layers, 2 bars)
    against JAX's `make_generator(pallas=True)` by
    `tests/test_torch_resolution.py`'s rules.

The wrappers' route at S > 48, with a CUDA tensor's path taken on CPU
tensors (`on_card` patched, the C launchers recorded instead of called):
`gcl_eval` launches `gcl_eval_long` (bf16: `gcl_eval_long_bf16`) once a
layer, ping-ponging so that the last layer writes the output, and counts
each launch at K = 1; S <= 48 keeps one launch of the grid kernel at K;
the eval column form (tensor parallelism) at S > 48 is one launch of the
long kernel with its output width n and first column c0. The training
kernels take S > 48 with the square weights and in the column form, in
fp32 and bf16 (their route and their plain versions against JAX:
`tests/test_torch_long_train.py`, `tests/test_torch_long_bf16_train.py`,
`tests/test_torch_long_tensor_parallel.py`); the fused backward refuses it
before launching, with a message that names the roadmap's item. (The eval
and chord routes' geometry checks at S = 52-192 are
`tests/test_torch_resolution.py::test_the_eval_kernels_take_bars_above_48_steps`.)
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyphemus_tpu.generate import make_generator as jax_make_generator
from polyphemus_tpu.ops.kernels import chord_tail as jchord
from polyphemus_tpu.ops.kernels import gcl_pallas
from polyphemus_tpu_torch.generate import make_generator
from polyphemus_tpu_torch.ops.kernels import (_build, chord_tail, counts,
                                              gcl, gcl_bwd)

from .test_torch_chord_tail import plain_logits
from .test_torch_gcl import jax_stack, port_stack, stack_case
from .test_torch_resolution import case
from .torch_port_case import (LOGIT_TIE, assert_ids_match,
                              assert_masks_match, jax_tree, random_z, to_np,
                              top2_gap)

STEPS = [52, 64, 96, 192]       # resolutions 13, 16, 24, 48
TOL = dict(rtol=2e-4, atol=2e-4)
BF16_REL = 2e-2
D, NBAR = 32, 3


@pytest.mark.parametrize("k_layers", [1, 2])
@pytest.mark.parametrize("s", STEPS)
def test_gcl_eval_plain_matches_pallas(s, k_layers):
    x, mask, gate, layers = stack_case(seed=s + k_layers, nbar=NBAR, s=s,
                                       d=D, n_layers=k_layers)
    launches = dict(counts.launches)
    got = port_stack(x, mask, gate, layers, k_layers)
    assert counts.launches == launches  # the CPU takes the plain path
    want = jax_stack(x, mask, gate, layers, k_layers)
    np.testing.assert_allclose(got, want, **TOL)


def bf16_values(a):
    """a rounded to bf16 by JAX's cast, as a torch bf16 tensor."""
    return torch.from_numpy(np.array(jnp.asarray(a).astype(
        jnp.bfloat16).astype(jnp.float32))).to(torch.bfloat16)


@pytest.mark.parametrize("k_layers", [1, 2])
@pytest.mark.parametrize("s", STEPS)
def test_bf16_gcl_eval_plain_matches_pallas(s, k_layers):
    x, mask, gate, layers = stack_case(seed=s + 10 * k_layers, nbar=NBAR,
                                       s=s, d=D, n_layers=k_layers)
    bf = jnp.bfloat16
    t = mask.shape[-2]
    aux_j = gcl_pallas.build_kernel_aux(jnp.asarray(mask))
    wbigs = jnp.stack([gcl_pallas.pack_weights(
        jnp.asarray(lay["rel_w"]).astype(bf), jnp.asarray(lay["root"]).astype(bf),
        t, dtype=bf) for lay in layers])
    vec = {key: jnp.stack([jnp.asarray(lay[key]).astype(bf)
                           for lay in layers]) for key in ("bias", "ea", "eb")}
    xj, gj = jnp.asarray(x).astype(bf), jnp.asarray(gate).astype(bf)
    if k_layers == 1:
        want = gcl_pallas.gcl_apply_pallas(
            xj, aux_j, gj, wbigs[0], vec["bias"][0],
            epilogue_affine=(vec["ea"][0], vec["eb"][0]))
    else:
        want = gcl_pallas.gcl_apply_pallas_chain(
            xj, aux_j, gj, wbigs,
            *(vec[key].reshape(k_layers, 1, D) for key in ("bias", "ea", "eb")))
    want = np.asarray(want.astype(jnp.float32)).reshape(NBAR, t * s, D)
    aux = gcl.build_kernel_aux(torch.from_numpy(mask)).reshape(
        NBAR, gcl.N_AUX, t * s)
    launches = dict(counts.launches)
    got = gcl.gcl_eval(bf16_values(x).reshape(NBAR, t * s, D), aux,
                       bf16_values(gate), bf16_values(np.asarray(wbigs.astype(
                           jnp.float32))),
                       *(bf16_values(np.asarray(vec[key].astype(jnp.float32)))
                         for key in ("bias", "ea", "eb")))
    assert counts.launches == launches
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= BF16_REL * np.abs(want).max(), err


def tail_case(seed, s, d=D):
    rng = np.random.default_rng(seed)
    h = d // 2
    mask = rng.random((2, 2, 4, s)) < 0.4
    x = rng.standard_normal((2, 2, 4, s, d)).astype(np.float32) \
        * mask[..., None]

    def w(*shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    params = [w(d, 15 * d, scale=d ** -0.5), w(15 * d, scale=0.1),
              w(h, 131, scale=h ** -0.5), w(131, scale=0.1),
              w(h, 131, scale=h ** -0.5), w(131, scale=0.1),
              w(h, 99, scale=h ** -0.5), w(99, scale=0.1)]
    return x, params, mask


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("s", STEPS)
def test_chord_tail_plain_matches_jax(s, bf16):
    """Ids equal except at cells whose top-2 logit gap is below 1e-4 (on
    the bf16 values in bf16: the sums are fp32 on both sides), which must
    be under 1e-3 of the active cells' ids."""
    x, params, mask = tail_case(s, s)
    dt = jnp.bfloat16 if bf16 else jnp.float32
    want = np.asarray(jchord.chord_tail_tokens(
        jnp.asarray(x, dt), *(jnp.asarray(p, dt) for p in params),
        n_slots=15))
    to = bf16_values if bf16 else torch.from_numpy
    launches = dict(counts.launches)
    got = chord_tail.chord_tail_tokens(to(x), *map(to, params), n_slots=15)
    assert counts.launches == launches
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    vals = [np.asarray(jnp.asarray(a, dt).astype(jnp.float32))
            for a in [x] + params]
    logits = plain_logits(*vals)
    tie = np.stack([top2_gap(logits[..., :131]),
                    top2_gap(logits[..., 131:])], axis=-1) < LOGIT_TIE
    assert tie[mask].mean() < 1e-3
    np.testing.assert_array_equal(got.numpy()[~tie], want[~tie])


@pytest.mark.parametrize("resolution", [13, 24])
def test_generation_matches_jax(resolution):
    """One latent (2 bars) through the port's `make_generator` on the CPU
    and JAX's with the Pallas kernels, by `tests/test_torch_resolution.py`'s
    rules (masks equal where |s_logit| is clear of the threshold, ids equal
    at active cells outside near-ties, at most 1 % near-ties)."""
    variables, _, jmodel, model = case(resolution)
    s = 4 * resolution
    z = random_z(1, 32, seed=resolution)
    m_j, t_j, s_j, c_j = (np.asarray(a) for a in jax_make_generator(
        jmodel, jax_tree(variables), pallas=True, return_logits=True)(
        jnp.asarray(z)))
    launches = dict(counts.launches)
    m_p, t_p = (to_np(a) for a in make_generator(model, device="cpu")(z))
    assert counts.launches == launches
    assert m_p.shape == (1, 2, 4, s) and t_p.shape == (1, 2, 4, s, 15, 2)
    assert_masks_match(m_p, m_j, s_j)
    assert m_j.any()
    assert_ids_match(t_p, t_j, c_j, mask=m_j, max_tie_frac=1e-2)


TRAINING_KERNELS = ["gcl_fwd", "gcl_bwd_data", "gcl_bwd_weight",
                    "gcl_bwd_fused", "gcl_fused"]


# the long-bar launcher of each training wrapper, and the position of its
# first size (nbar) among its arguments
LONG_LAUNCHERS = {"gcl_fwd": ("gcl_fwd_long", 6),
                  "gcl_bwd_data": ("gcl_bwd_data_long", 9),
                  "gcl_bwd_weight": ("gcl_bwd_weight_long", 5)}


def column_launches(kernel, s, dt, d=256, n=128, nbar=2):
    """Run training wrapper `kernel` (or the `gcl_fused` layer, forward and
    backward) in the column form, output width n of d, over nbar bars of 4
    x s cells of dtype dt (zeros but aux)."""
    rng = np.random.default_rng(s)
    mask = torch.from_numpy(rng.random((nbar, 4, s)) < 0.3)
    aux = gcl.build_kernel_aux(mask).reshape(nbar, gcl.N_AUX, 4 * s)
    x = torch.zeros(nbar, 4 * s, d, dtype=dt)
    gates = torch.zeros(s, d, dtype=dt)
    wc, gc = torch.zeros(8 * d, n, dtype=dt), x[..., :n].contiguous()
    if kernel == "gcl_fwd":
        gcl.gcl_fwd(x, aux, gates, wc, torch.zeros(n, dtype=dt))
    elif kernel == "gcl_bwd_data":
        gcl_bwd.gcl_bwd_data(x, gc, aux, gates, wc)
    elif kernel == "gcl_bwd_weight":
        gcl_bwd.gcl_bwd_weight(x, gc, aux, gates)
    elif kernel == "gcl_bwd_fused":
        gcl_bwd.gcl_bwd_fused(x, gc, aux, gates, wc)
    else:
        out = gcl_bwd.gcl_fused(
            x.requires_grad_(), gates, torch.zeros(6, d, n, dtype=dt),
            torch.zeros(d, n, dtype=dt), torch.zeros(n, dtype=dt), aux, mask)
        assert out.shape == (nbar, 4 * s, n)
        out.backward(torch.zeros_like(out))


@pytest.mark.parametrize("kernel", TRAINING_KERNELS)
@pytest.mark.parametrize("s", STEPS)
def test_training_kernels_refuse_long_bars(card_route, monkeypatch, kernel,
                                           s):
    """What training at S > 48 still refuses names the limit and the
    roadmap's item: the fused backward (bf16 training's route up to 48
    steps) in any dtype, its bf16 column form before any launch. The
    column form (tensor
    parallelism, n = 128 of d = 256) of the other kernels runs in either
    dtype: the card route launches each wrapper's long-bar kernel once
    (`gcl_fused`: the forward and the split backward) with (nbar, S, d, n),
    counted at S and as a column-form launch."""
    monkeypatch.setattr(gcl_bwd, "on_card", lambda kernel, x: True)
    if kernel == "gcl_bwd_fused":
        fused = f"up to 48 .*{gcl.FUSED_LONG} is not ported yet .*ROADMAP"
        for dt in (torch.bfloat16, torch.float32):
            with pytest.raises(ValueError, match=fused):
                gcl.check_grid(kernel, 4 * s, s, dt)
        # (the fp32 form takes the square weights only, at 4 x 32 cells)
        with pytest.raises(ValueError, match=fused):
            column_launches(kernel, s, torch.bfloat16)
        assert card_route == []
        return
    wrappers = list(LONG_LAUNCHERS) if kernel == "gcl_fused" else [kernel]
    for dt in (torch.float32, torch.bfloat16):
        gcl.check_grid(kernel, 4 * s, s, dt)
        bf = "_bf16" if dt == torch.bfloat16 else ""
        del card_route[:]
        before = dict(counts.launches), dict(gcl.col_launches)
        column_launches(kernel, s, dt)
        assert [c[0] for c in card_route] == [
            LONG_LAUNCHERS[k][0] + bf for k in wrappers]
        for k, (_, a) in zip(wrappers, card_route):
            i = LONG_LAUNCHERS[k][1]
            assert a[i:] == (2, s, 256, 128, 0)
        assert counts.since(before[0]) == {(k + bf, s, 1): 1
                                           for k in wrappers}
        assert {k: v - before[1][k] for k, v in gcl.col_launches.items()
                if v != before[1][k]} == {k + bf: 1 for k in wrappers}


@pytest.mark.parametrize("kernel", [k for k in TRAINING_KERNELS
                                    if k != "gcl_bwd_fused"])
@pytest.mark.parametrize("s", STEPS)
def test_fp32_training_kernels_take_long_bars(kernel, s):
    """The fp32 training kernels with the square weights take every S % 4
    == 0 above 48: the grid check, and the wrappers' argument check with
    the backward's gate table of S rows. The grid check passes fp64 too (no
    kernel takes it: an fp64 layer on the card runs the plain versions,
    chip_smoke's fp64 witness step)."""
    gcl.check_grid(kernel, 4 * s, s)
    gcl.check_grid(kernel, 4 * s, s, torch.float64)
    x = torch.zeros(2, 4 * s, 256)
    gcl.check_cuda_args(kernel, x, {
        "x": (x, (2, 4 * s, 256), torch.float32),
        "g": (x, (2, 4 * s, 256), torch.float32),
        "gate_table": (torch.zeros(s, 256), (s, 256), torch.float32)}, s=s)


@pytest.fixture
def card_route(monkeypatch):
    """The wrappers' card path on CPU tensors: `on_card` true, each C
    launcher recorded as (kernel, its arguments) instead of called; the
    launch counts (the column forms' too) restored after."""
    calls = []
    monkeypatch.setattr(gcl, "on_card", lambda kernel, x: True)
    monkeypatch.setattr(_build, "stream_handle", lambda device: 0)
    monkeypatch.setattr(_build, "launcher",
                        lambda name: lambda *a: calls.append((name, a)) or 0)
    saved = dict(counts.launches), dict(gcl.col_launches)
    yield calls
    counts.restore(saved[0])
    gcl.col_launches.update(saved[1])


def eval_args(s, k_layers, dtype=torch.float32, d=128, n=None):
    """`gcl_eval`'s arguments over 2 bars of 4 x s cells (zeros but aux),
    output width n of d (default d)."""
    rng = np.random.default_rng(s)
    mask = torch.from_numpy(rng.random((2, 4, s)) < 0.3)
    n = d if n is None else n
    x = torch.zeros(2, 4 * s, d, dtype=dtype)
    aux = gcl.build_kernel_aux(mask).reshape(2, gcl.N_AUX, 4 * s)
    return (x, aux, torch.zeros(s, d, dtype=dtype),
            torch.zeros(k_layers, 8 * d, n, dtype=dtype),
            *(torch.zeros(k_layers, n, dtype=dtype) for _ in range(3)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k_layers", [1, 2, 3])
def test_gcl_eval_launches_the_long_kernel_once_a_layer(card_route, dtype,
                                                        k_layers):
    s = 96
    args = eval_args(s, k_layers, dtype)
    before = dict(counts.launches)
    out = gcl.gcl_eval(*args)
    name = "gcl_eval" if dtype == torch.float32 else "gcl_eval_bf16"
    long_name = name.replace("gcl_eval", "gcl_eval_long")
    assert [c[0] for c in card_route] == [long_name] * k_layers
    x, wbigs = args[0], args[3]
    src = x.data_ptr()
    for i, (_, a) in enumerate(card_route):
        # (x, aux, gates, wbig, bias, ea, eb, out, nbar, S, d, n, c0,
        # stream)
        assert a[0] == src and a[3] == wbigs[i].data_ptr()
        assert a[1] == args[1].data_ptr() and a[2] == args[2].data_ptr()
        assert a[4:7] == tuple(v[i].data_ptr() for v in args[4:])
        assert a[7] not in (src, x.data_ptr())
        assert a[8:] == (2, s, 128, 128, 0, 0)
        src = a[7]
    assert src == out.data_ptr()
    assert counts.since(before) == {(name, s, 1): k_layers}


@pytest.mark.parametrize("s", [12, 48])
def test_gcl_eval_keeps_one_grid_launch_up_to_48_steps(card_route, s):
    before = dict(counts.launches)
    gcl.gcl_eval(*eval_args(s, 2))
    assert [c[0] for c in card_route] == ["gcl_eval_grid"]
    assert card_route[0][1][10:] == (s, 128, 128, 0, 2, 0)
    assert counts.since(before) == {("gcl_eval", s, 2): 1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gcl_eval_refuses_the_column_form_above_48_steps(card_route, dtype):
    """The eval step's column form at S > 48 (n = 128 of d = 256, first
    column 128) is one launch of the long-bar kernel with (nbar, S, d, n,
    c0), writing the (nbar, 4 S, n) output; counted at K = 1 and as a
    column-form launch."""
    args = eval_args(64, 1, dtype, d=256, n=128)
    before = dict(counts.launches), dict(gcl.col_launches)
    out = gcl.gcl_eval(*args, col0=128)
    name = "gcl_eval" if dtype == torch.float32 else "gcl_eval_bf16"
    assert [c[0] for c in card_route] == [
        name.replace("gcl_eval", "gcl_eval_long")]
    a = card_route[0][1]
    # (x, aux, gates, wbig, bias, ea, eb, out, nbar, S, d, n, c0, stream)
    assert a[:7] == (args[0].data_ptr(), args[1].data_ptr(),
                     args[2].data_ptr(), args[3][0].data_ptr(),
                     *(v[0].data_ptr() for v in args[4:]))
    assert a[7] == out.data_ptr() and a[8:] == (2, 64, 256, 128, 128, 0)
    assert out.shape == (2, 4 * 64, 128) and out.dtype == dtype
    assert counts.since(before[0]) == {(name, 64, 1): 1}
    assert gcl.col_launches[name] == before[1][name] + 1


def test_training_refuses_long_bars_before_any_launch(card_route,
                                                      monkeypatch):
    """At S = 64 bf16 training runs (the training layer launches the bf16
    training forward, then the split backward's bf16 forms, each once; the
    forward and the pair alone launch theirs), and so does the fp32 column
    form (n = 128 of d = 256: the layer's three long-bar kernels, then the
    forward alone), while the fused backward raises before any launch."""
    monkeypatch.setattr(gcl_bwd, "on_card", lambda kernel, x: True)
    s, d = 64, 256
    bf = torch.bfloat16
    x, aux, gates = eval_args(s, 1, d=d)[:3]
    mask = torch.zeros(2, 4, s, dtype=torch.bool)
    wb = torch.zeros(8 * d, d, dtype=bf)
    before = dict(counts.launches)
    out = gcl_bwd.GclFused.apply(x.to(bf), gates.to(bf),
                                 torch.zeros(6, d, d, dtype=bf,
                                             requires_grad=True),
                                 torch.zeros(d, d, dtype=bf),
                                 torch.zeros(d, dtype=bf), aux, mask)
    out.backward(torch.zeros_like(out))
    gcl.gcl_fwd(x.to(bf), aux, gates.to(bf), wb, torch.zeros(d, dtype=bf))
    gcl_bwd.gcl_bwd_data(x.to(bf), x.to(bf), aux, gates.to(bf), wb)
    gcl_bwd.gcl_bwd_weight(x.to(bf), x.to(bf), aux, gates.to(bf))
    assert [c[0] for c in card_route] == [
        "gcl_fwd_long_bf16", "gcl_bwd_data_long_bf16",
        "gcl_bwd_weight_long_bf16"] * 2
    assert counts.since(before) == {
        (k, s, 1): 2 for k in ("gcl_fwd_bf16", "gcl_bwd_data_bf16",
                               "gcl_bwd_weight_bf16")}
    counts.restore(before)
    del card_route[:]
    with pytest.raises(ValueError, match=gcl.FUSED_LONG):
        gcl_bwd.gcl_bwd_fused(x.to(bf), x.to(bf), aux, gates.to(bf), wb)
    assert card_route == [] and counts.launches == before
    out = gcl_bwd.GclFused.apply(x, gates,
                                 torch.zeros(6, d, 128, requires_grad=True),
                                 torch.zeros(d, 128), torch.zeros(128), aux,
                                 mask)
    out.backward(torch.zeros_like(out))
    gcl.gcl_fwd(x, aux, gates, torch.zeros(8 * d, 128), torch.zeros(128))
    assert [c[0] for c in card_route] == [
        "gcl_fwd_long", "gcl_bwd_data_long", "gcl_bwd_weight_long",
        "gcl_fwd_long"]
    assert [c[1][-5:-1] for c in card_route] == [(2, s, d, 128)] * 4
    assert counts.since(before) == {("gcl_fwd", s, 1): 2,
                                    ("gcl_bwd_data", s, 1): 1,
                                    ("gcl_bwd_weight", s, 1): 1}
