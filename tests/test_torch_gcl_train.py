"""The port's training GCL against the JAX package's: the plain forward
(`gcl_fwd_plain`, what a CPU tensor runs) against `gcl_apply_pallas`
without its epilogue (rtol = atol = 2e-4), and the plain backward
(`gcl_bwd_data_plain`, `gcl_bwd_weight_plain`) against the Pallas backward
`gcl_backward_pallas` (rtol = atol = 5e-4, as tests/test_pallas_grad.py),
both in interpret mode at D = 16; the plain backward against
`torch.autograd` through the plain forward; the `gcl_fused` autograd
function against the lattice GCL's autograd. On the CPU the kernels'
launch counters stay 0."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyphemus_tpu.ops.kernels import gcl_pallas, gcl_pallas_bwd
from polyphemus_tpu_torch.ops import lattice
from polyphemus_tpu_torch.ops.kernels import gcl, gcl_bwd

FWD_TOL = dict(rtol=2e-4, atol=2e-4)
BWD_TOL = dict(rtol=5e-4, atol=5e-4)
T, S = 4, 32


def layer_case(seed=0, nbar=5, d=16, density=0.3):
    rng = np.random.default_rng(seed)
    mask = rng.random((nbar, T, S)) < density
    mask[0] = False
    mask[0, 2, 17] = True                # single-node bar off track 0
    mask[1] = False
    mask[1, 0, 0] = True                 # fixed empty bar
    mask[2] = True                       # full bar
    x = (rng.standard_normal((nbar, T, S, d)).astype(np.float32)
         * mask[..., None])
    g = rng.standard_normal((nbar, T, S, d)).astype(np.float32)
    gate = (rng.standard_normal((S, d)) * 0.5).astype(np.float32)
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


# density 0.0 leaves bars 3 and 4 without an active cell
@pytest.mark.parametrize("density", [0.0, 0.05, 0.3, 0.9])
def test_gcl_fwd_plain_matches_pallas_without_epilogue(density):
    mask, x, _, gate, rel_w, root, bias = layer_case(seed=1, d=32,
                                                     density=density)
    aux_j = gcl_pallas.build_kernel_aux(jnp.asarray(mask))
    wbig_j = gcl_pallas.pack_weights(jnp.asarray(rel_w), jnp.asarray(root),
                                     T, dtype=jnp.float32)
    want = gcl_pallas.gcl_apply_pallas(jnp.asarray(x), aux_j,
                                       jnp.asarray(gate), wbig_j,
                                       jnp.asarray(bias))
    aux, xf, (gate_t, rel_t, root_t, bias_t) = port_args(
        mask, x, gate, rel_w, root, bias)
    launches = gcl.fwd_launches
    got = gcl.gcl_fwd(xf, aux, gate_t, gcl.pack_weights(rel_t, root_t, T),
                      bias_t)
    assert gcl.fwd_launches == launches  # the CPU takes the plain path
    np.testing.assert_allclose(got.reshape(x.shape).numpy(),
                               np.asarray(want), **FWD_TOL)
    empty = torch.from_numpy(~mask.any(axis=(1, 2)))
    assert (got.reshape(x.shape)[empty] == 0).all()  # no active cell: zeros


@pytest.mark.parametrize("seed", [0, 1])
def test_gcl_bwd_plain_matches_pallas_backward(seed):
    mask, x, g, gate, rel_w, root, _ = layer_case(seed=seed)
    wbig_j = gcl_pallas.pack_weights(jnp.asarray(rel_w), jnp.asarray(root),
                                     T, dtype=jnp.float32)
    dx_j, dg_j, dw_j, db_j = gcl_pallas_bwd.gcl_backward_pallas(
        jnp.asarray(x), gcl_pallas.build_kernel_aux(jnp.asarray(mask)),
        jnp.asarray(gate), wbig_j, jnp.asarray(g))
    aux, xf, (gf, gate_t, rel_t, root_t) = port_args(mask, x, g, gate,
                                                     rel_w, root)
    gf = gf.reshape(xf.shape)
    before = (gcl_bwd.data_launches, gcl_bwd.weight_launches)
    dx, dg, db = gcl_bwd.gcl_bwd_data(xf, gf, aux, gate_t,
                                      gcl.pack_weights(rel_t, root_t, T))
    dw = gcl_bwd.gcl_bwd_weight(xf, gf, aux, gate_t)
    assert (gcl_bwd.data_launches, gcl_bwd.weight_launches) == before
    np.testing.assert_allclose(dx.reshape(x.shape).numpy(), np.asarray(dx_j),
                               **BWD_TOL)
    np.testing.assert_allclose(dg.numpy(), np.asarray(dg_j), **BWD_TOL)
    np.testing.assert_allclose(db.numpy(), np.asarray(db_j), **BWD_TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_j), **BWD_TOL)


def test_gcl_bwd_plain_equals_autograd_of_the_plain_forward():
    """In float64 the hand-written backward and autograd agree to rounding."""
    mask, x, g, gate, rel_w, root, bias = layer_case(seed=4, d=8)
    aux, xf, rest = port_args(mask, x, g, gate, rel_w, root, bias)
    xf = xf.double()
    gf, gate_t, rel_t, root_t, bias_t = (a.double() for a in rest)
    gf = gf.reshape(xf.shape)
    leaves = [a.clone().requires_grad_() for a in (xf, gate_t, rel_t,
                                                   root_t, bias_t)]
    wbig = gcl.pack_weights(leaves[2], leaves[3], T)
    out = gcl.gcl_fwd_plain(leaves[0], aux, leaves[1], wbig, leaves[4])
    (out * gf).sum().backward()
    dx, dg, db = gcl_bwd.gcl_bwd_data_plain(xf, gf, aux, gate_t,
                                            gcl.pack_weights(rel_t, root_t, T))
    dw = gcl_bwd.gcl_bwd_weight_plain(xf, gf, aux, gate_t)
    torch.testing.assert_close(dx, leaves[0].grad, rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(dg, leaves[1].grad, rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(db, leaves[4].grad, rtol=1e-10, atol=1e-10)
    # dwbig against autograd on the packed weight itself
    wb = gcl.pack_weights(rel_t, root_t, T).requires_grad_()
    (gcl.gcl_fwd_plain(xf, aux, gate_t, wb, bias_t) * gf).sum().backward()
    torch.testing.assert_close(dw, wb.grad, rtol=1e-10, atol=1e-10)


def test_gcl_fused_grads_match_the_lattice_autograd():
    """The autograd function's grads for every input equal autograd
    through the plain lattice GCL (`lattice.gcl_apply`)."""
    mask, x, g, gate, rel_w, root, bias = layer_case(seed=2)
    m = torch.from_numpy(mask)
    aux, xf, rest = port_args(mask, x, g, gate, rel_w, root, bias)
    gf = rest[0].reshape(xf.shape)

    def grads(fn):
        leaves = [a.clone().requires_grad_() for a in [xf] + rest[1:]]
        (fn(*leaves) * gf).sum().backward()
        return [a.grad for a in leaves]

    nbr = lattice.build_neighbors(m)
    want = grads(lambda x_, gt, w, r, b: lattice.gcl_apply(
        x_.reshape(x.shape), m, nbr, gt, w, r, b).reshape(xf.shape))
    got = grads(lambda x_, gt, w, r, b: gcl_bwd.gcl_fused(
        x_, gt, w, r, b, aux, m))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **BWD_TOL)
