"""The port's fused single-pass GCL backward (`gcl_bwd_fused`, what a CPU
tensor runs: its plain version) and the bf16 training forward, against the
JAX package's, on inputs from a numpy seed (T = 4, S = 32, D = 16, 2 x 2
bars, as tests/test_pallas_grad.py):

  * fp32: against `gcl_backward_fused` in interpret mode (rtol = atol =
    5e-4, the bound of the split backward's tests) and against the port's
    own plain split (5e-5, JAX's bound between its fused and split forms);
  * bf16: against `gcl_backward_fused` in interpret mode on the same bf16
    inputs, each output within 2e-2 x its max |JAX| (bf16 keeps 8 bits and
    the sums run in another order); the `gcl_fused` autograd function
    against `jax.grad` of JAX's `gcl_fused`, and the plain `gcl_fwd` against
    `gcl_apply_pallas`, both in bf16 with the same bound.

The bf16 kernel's dW product (`csrc/gcl_bwd_fused_bf16_tc.cu`, its dW
kernel) multiplies bf16 operands on the tensor cores with fp32 sums, bar by
bar: every operand (the rebuilt messages, x * m and the raw upstream g)
holds a bf16 value exactly, and that contraction gives the plain dW within
fp32 reordering (rtol = 1e-5, atol = 1e-5 x max |plain|).

On the CPU the kernels' launch counters stay 0."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyphemus_tpu.ops.kernels import gcl_pallas, gcl_pallas_bwd
from polyphemus_tpu_torch.ops.kernels import counts, gcl, gcl_bwd

T, S, D = 4, 32, 16
BF16_REL = 2e-2  # max abs err / max |JAX| for every bf16 output


def case(seed):
    rng = np.random.default_rng(seed)
    mask = rng.random((2, 2, T, S)) < 0.2
    mask[..., 0, 0] = True
    x = (rng.standard_normal((2, 2, T, S, D)).astype(np.float32)
         * mask[..., None])
    g = rng.standard_normal(x.shape).astype(np.float32)
    gate = rng.standard_normal((S, D)).astype(np.float32)
    rel_w = (rng.standard_normal((6, D, D)) * 0.2).astype(np.float32)
    root = (rng.standard_normal((D, D)) * 0.2).astype(np.float32)
    bias = (rng.standard_normal((D,)) * 0.2).astype(np.float32)
    return mask, x, g, gate, rel_w, root, bias


def jax_fused(mask, x, g, gate, rel_w, root, dt):
    """(dx, dgate, dbias, dwbig) of `gcl_backward_fused` in dtype dt, as
    flat numpy fp32 in the port's order and layout."""
    c = [jnp.asarray(a).astype(dt) for a in (x, g, gate, rel_w, root)]
    wbig = gcl_pallas.pack_weights(c[3], c[4], T, dtype=dt)
    dx, dg, dw, db = gcl_pallas_bwd.gcl_backward_fused(
        c[0], gcl_pallas.build_kernel_aux(jnp.asarray(mask)), c[2], wbig,
        c[1])
    return [np.asarray(jnp.asarray(v, jnp.float32)) for v in
            (dx.reshape(-1, T * S, D), dg, db, dw)]


def port_inputs(mask, x, g, gate, rel_w, root, dt):
    nbar = mask.shape[0] * mask.shape[1]
    aux = gcl.build_kernel_aux(torch.from_numpy(mask)).reshape(
        nbar, gcl.N_AUX, T * S)
    # rounded to dt through JAX's cast, so both sides see the same values
    def t(a):
        return torch.from_numpy(np.array(jnp.asarray(a).astype(dt).astype(
            jnp.float32))).to(torch.bfloat16 if dt == jnp.bfloat16
                              else torch.float32)

    xf, gf = t(x).reshape(nbar, T * S, D), t(g).reshape(nbar, T * S, D)
    wbig = gcl.pack_weights(t(rel_w), t(root), T)
    return xf, gf, aux, t(gate), wbig


def port_fused(*args):
    before = dict(counts.launches)
    out = gcl_bwd.gcl_bwd_fused(*args)
    assert counts.launches == before  # the CPU takes the plain path
    assert out[0].dtype == args[0].dtype
    assert all(v.dtype == torch.float32 for v in out[1:])
    return [v.float().numpy() for v in out]


def assert_bf16_close(got, want, names):
    for name, a, b in zip(names, got, want):
        scale = float(np.abs(b).max())
        err = float(np.abs(a - b).max())
        assert err <= BF16_REL * scale, (name, err, scale)


NAMES = ("dx", "dgate", "dbias", "dwbig")


@pytest.mark.parametrize("seed", [0, 3])
def test_fused_plain_matches_jax_fused_fp32(seed):
    mask, x, g, gate, rel_w, root, _ = case(seed)
    want = jax_fused(mask, x, g, gate, rel_w, root, jnp.float32)
    got = port_fused(*port_inputs(mask, x, g, gate, rel_w, root,
                                  jnp.float32))
    for name, a, b in zip(NAMES, got, want):
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=5e-4, err_msg=name)


@pytest.mark.parametrize("seed", [0, 3])
def test_fused_plain_matches_split_plain_fp32(seed):
    mask, x, g, gate, rel_w, root, _ = case(seed)
    xf, gf, aux, gt, wbig = port_inputs(mask, x, g, gate, rel_w, root,
                                        jnp.float32)
    fused = gcl_bwd.gcl_bwd_fused_plain(xf, gf, aux, gt, wbig)
    dx, dg, db = gcl_bwd.gcl_bwd_data_plain(xf, gf, aux, gt, wbig)
    dw = gcl_bwd.gcl_bwd_weight_plain(xf, gf, aux, gt)
    for name, a, b in zip(NAMES, fused, (dx, dg, db, dw)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-5,
                                   atol=5e-5, err_msg=name)


@pytest.mark.parametrize("seed,empty_bar", [
    pytest.param(0, False, id="0"), pytest.param(3, False, id="3"),
    pytest.param(0, True, id="0-empty_bar")])
def test_fused_plain_matches_jax_fused_bf16(seed, empty_bar):
    """With `empty_bar`, flat bar 1 has no active cell while its x and g are
    not 0: its dx rows are exactly 0 on both sides."""
    mask, x, g, gate, rel_w, root, _ = case(seed)
    if empty_bar:
        mask[0, 1] = False
        x[0, 1] = np.random.default_rng(seed + 100).standard_normal(
            x[0, 1].shape).astype(np.float32)
        assert (x[0, 1] != 0).any() and (g[0, 1] != 0).any()
    want = jax_fused(mask, x, g, gate, rel_w, root, jnp.bfloat16)
    got = port_fused(*port_inputs(mask, x, g, gate, rel_w, root,
                                  jnp.bfloat16))
    assert_bf16_close(got, want, NAMES)
    if empty_bar:
        assert (got[0][1] == 0).all() and (want[0][1] == 0).all()


def test_gcl_fused_autograd_matches_jax_grad_bf16():
    mask, x, g, gate, rel_w, root, bias = case(5)
    bf = jnp.bfloat16
    mj = jnp.asarray(mask)
    aux_j = gcl_pallas.build_kernel_aux(mj)
    up = jnp.asarray(g.reshape(x.shape))
    args = [jnp.asarray(a).astype(bf) for a in (x, gate, rel_w, root, bias)]

    def loss(*a):
        out = gcl_pallas.gcl_fused(*a, aux_j, mj)
        return jnp.sum(out.astype(jnp.float32) * up)

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*args)
    want = [np.asarray(v.astype(jnp.float32)) for v in want]
    nbar = 4
    aux = gcl.build_kernel_aux(torch.from_numpy(mask)).reshape(
        nbar, gcl.N_AUX, T * S)
    leaves = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16).requires_grad_() for a in args]
    xf = leaves[0].reshape(nbar, T * S, D)
    out = gcl_bwd.gcl_fused(xf, *leaves[1:], aux, torch.from_numpy(mask))
    assert out.dtype == torch.bfloat16
    (out.float() * torch.from_numpy(g).reshape(out.shape)).sum().backward()
    got = [v.grad for v in leaves]
    assert all(v.dtype == torch.bfloat16 for v in got)
    assert_bf16_close([v.float().numpy() for v in got], want,
                      ("x", "gate_table", "rel_weight", "root", "bias"))


def test_gcl_fwd_plain_matches_pallas_bf16():
    mask, x, _, gate, rel_w, root, bias = case(6)
    bf = jnp.bfloat16
    c = [jnp.asarray(a).astype(bf) for a in (x, gate, rel_w, root, bias)]
    want = gcl_pallas.gcl_apply_pallas(
        c[0], gcl_pallas.build_kernel_aux(jnp.asarray(mask)), c[1],
        gcl_pallas.pack_weights(c[2], c[3], T, dtype=bf), c[4])
    want = np.asarray(want.astype(jnp.float32)).reshape(-1, T * S, D)
    xf, _, aux, gt, wbig = port_inputs(mask, x, x, gate, rel_w, root, bf)
    b = torch.from_numpy(np.array(c[4].astype(jnp.float32))).to(
        torch.bfloat16)
    before = dict(counts.launches)
    got = gcl.gcl_fwd(xf, aux, gt, wbig, b)
    assert counts.launches == before
    assert got.dtype == torch.bfloat16
    assert_bf16_close([got.float().numpy()], [want], ("out",))


@pytest.mark.parametrize("k_layers", [1, 2])
def test_gcl_eval_plain_matches_pallas_bf16(k_layers):
    mask, x, _, gate, rel_w, root, bias = case(7)
    rng = np.random.default_rng(8)
    ea = (1.0 + 0.2 * rng.standard_normal((k_layers, D))).astype(np.float32)
    eb = (0.2 * rng.standard_normal((k_layers, D))).astype(np.float32)
    scale = (1.0 + 0.5 * np.arange(k_layers)).astype(np.float32)
    bf = jnp.bfloat16
    c = [jnp.asarray(a).astype(bf) for a in (x, gate, bias, ea, eb)]
    aux_j = gcl_pallas.build_kernel_aux(jnp.asarray(mask))
    wbigs = jnp.stack([gcl_pallas.pack_weights(
        jnp.asarray(rel_w * s).astype(bf), jnp.asarray(root * s).astype(bf),
        T, dtype=bf) for s in scale])
    if k_layers == 1:
        want = gcl_pallas.gcl_apply_pallas(
            c[0], aux_j, c[1], wbigs[0], c[2],
            epilogue_affine=(c[3][0], c[4][0]))
    else:
        want = gcl_pallas.gcl_apply_pallas_chain(
            c[0], aux_j, c[1], wbigs,
            jnp.stack([c[2].reshape(1, D)] * k_layers),
            c[3].reshape(k_layers, 1, D), c[4].reshape(k_layers, 1, D))
    want = np.asarray(want.astype(jnp.float32)).reshape(-1, T * S, D)

    def t(a):
        return torch.from_numpy(np.array(jnp.asarray(a).astype(
            jnp.float32))).to(torch.bfloat16)

    xf, _, aux, gt, _ = port_inputs(mask, x, x, gate, rel_w, root, bf)
    before = dict(counts.launches)
    got = gcl.gcl_eval(xf, aux, gt, t(wbigs), torch.stack(
        [t(c[2])] * k_layers), t(c[3]), t(c[4]))
    assert counts.launches == before
    assert got.dtype == torch.bfloat16
    assert_bf16_close([got.float().numpy()], [want], ("out",))


def bf16_dw_operands(seed, empty_bar=False):
    """The dW kernel's operands on case(seed) in bf16: A tiles (h_track,
    h_self, h_onset, h_next, x * m) and B (the raw upstream g), each
    (nbar, n, D) fp32, and the plain version's dW."""
    mask, x, g, gate, rel_w, root, _ = case(seed)
    if empty_bar:
        mask[0, 1] = False
    xf, gf, aux, gt, wbig = port_inputs(mask, x, g, gate, rel_w, root,
                                        jnp.bfloat16)
    st = gcl.bar_statics(aux, gt, torch.bfloat16)
    m = st.m.float()
    h = gcl_bwd.fused_messages(xf, st, gt, S)
    a_tiles = [*h, xf.float() * m]
    dw = gcl_bwd.gcl_bwd_fused_plain(xf, gf, aux, gt, wbig)[3]
    return a_tiles, gf.float(), m, dw


@pytest.mark.parametrize("seed,empty_bar", [
    pytest.param(0, False, id="0"), pytest.param(3, False, id="3"),
    pytest.param(0, True, id="0-empty_bar")])
def test_dw_operands_are_bf16_values(seed, empty_bar):
    """Every value the bf16 dW product multiplies is a bf16 value, so the
    tensor cores' bf16 products are the plain version's products exactly;
    the messages are 0 on every inactive cell (m is folded into the A
    tiles, and g goes in raw)."""
    a_tiles, g, m, _ = bf16_dw_operands(seed, empty_bar)
    for name, v in zip(("h_track", "h_self", "h_onset", "h_next", "x*m",
                        "g", "g*m"), (*a_tiles, g, g * m)):
        assert torch.equal(v.to(torch.bfloat16).float(), v), name
    for name, v in zip(("h_track", "h_self", "h_onset", "h_next"),
                       a_tiles[:4]):
        assert (v[m.expand_as(v) == 0] == 0).all(), name


@pytest.mark.parametrize("seed,empty_bar", [
    pytest.param(0, False, id="0"), pytest.param(3, False, id="3"),
    pytest.param(0, True, id="0-empty_bar")])
def test_per_bar_bf16_contraction_matches_plain_dw(seed, empty_bar):
    """dW as the dW kernel sums it: per bar, A_blk^T @ g on bf16 operands
    with fp32 sums (track blocks over their own 32 rows), added bar after
    bar into fp32 sums, equals the plain dW within fp32 reordering."""
    a_tiles, g, _, want = bf16_dw_operands(seed, empty_bar)
    nbar = g.shape[0]
    acc = torch.zeros(8 * D, D, dtype=torch.float32)
    for bar in range(nbar):
        blocks = [a_tiles[0][bar, t * S:(t + 1) * S].t()
                  @ g[bar, t * S:(t + 1) * S] for t in range(T)]
        blocks += [a[bar].t() @ g[bar] for a in a_tiles[1:]]
        acc += torch.cat(blocks, dim=0)
    np.testing.assert_allclose(acc.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())
