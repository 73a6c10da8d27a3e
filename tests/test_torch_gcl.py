"""The port's GCL against the JAX package's: the plain `gcl_eval` (what a CPU
tensor runs) against `gcl_apply_pallas` with its epilogue (K = 1) and
`gcl_apply_pallas_chain` (K = 2, 3, and a 3-layer stack in groups of 2),
in interpret mode; the eval `lattice.gcl_apply` against its JAX
counterpart; `pack_weights`. Tolerance rtol = atol = 2e-4. On the CPU the
kernel's launch counter stays 0."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyphemus_tpu.ops import lattice as jlat
from polyphemus_tpu.ops.kernels import gcl_pallas
from polyphemus_tpu_torch.ops import lattice
from polyphemus_tpu_torch.ops.kernels import gcl

TOL = dict(rtol=2e-4, atol=2e-4)


def stack_case(seed=0, nbar=6, t=4, s=32, d=64, n_layers=3, density=0.3):
    rng = np.random.default_rng(seed)
    mask = rng.random((nbar, t, s)) < density
    mask[0] = False
    mask[0, 1, 5] = True                 # single-node bar
    mask[1] = False
    mask[1, 0, 0] = True                 # fixed empty bar
    x = (rng.standard_normal((nbar, t, s, d)).astype(np.float32)
         * mask[..., None])
    gate = rng.standard_normal((s, d)).astype(np.float32) * 0.3
    layers = []
    for _ in range(n_layers):
        layers.append(dict(
            rel_w=(rng.standard_normal((6, d, d)) * d ** -0.5).astype(np.float32),
            root=(rng.standard_normal((d, d)) * d ** -0.5).astype(np.float32),
            bias=(rng.standard_normal(d) * 0.1).astype(np.float32),
            ea=(1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32),
            eb=(0.1 * rng.standard_normal(d)).astype(np.float32)))
    return x, mask, gate, layers


def jax_stack(x, mask, gate, layers, chain):
    """The JAX generation path: Pallas kernels, groups of `chain` layers."""
    aux = gcl_pallas.build_kernel_aux(jnp.asarray(mask))
    x = jnp.asarray(x)
    t, d = mask.shape[-2], x.shape[-1]
    packed = [(gcl_pallas.pack_weights(jnp.asarray(l["rel_w"]),
                                       jnp.asarray(l["root"]), t,
                                       dtype=jnp.float32),
               jnp.asarray(l["bias"]), jnp.asarray(l["ea"]),
               jnp.asarray(l["eb"])) for l in layers]
    for lo in range(0, len(packed), chain):
        grp = packed[lo:lo + chain]
        if chain == 1:
            wbig, bias, ea, eb = grp[0]
            x = gcl_pallas.gcl_apply_pallas(x, aux, jnp.asarray(gate), wbig,
                                            bias, epilogue_affine=(ea, eb))
        else:
            x = gcl_pallas.gcl_apply_pallas_chain(
                x, aux, jnp.asarray(gate),
                *(jnp.stack([g[j].reshape(g[j].shape if j == 0 else (1, d))
                             for g in grp]) for j in range(4)))
    return np.asarray(x)


def port_stack(x, mask, gate, layers, chain):
    nbar, t, s, d = x.shape
    aux = gcl.build_kernel_aux(torch.from_numpy(mask)).reshape(
        nbar, gcl.N_AUX, t * s)
    per = [(gcl.pack_weights(torch.from_numpy(l["rel_w"]),
                             torch.from_numpy(l["root"]), t),
            torch.from_numpy(l["bias"]), torch.from_numpy(l["ea"]),
            torch.from_numpy(l["eb"])) for l in layers]
    xf = torch.from_numpy(x).reshape(nbar, t * s, d)
    for lo in range(0, len(per), chain):
        grp = per[lo:lo + chain]
        xf = gcl.gcl_eval(xf, aux, torch.from_numpy(gate),
                          *(torch.stack([g[j] for g in grp]) for j in range(4)))
    return xf.reshape(nbar, t, s, d).numpy()


@pytest.mark.parametrize("n_layers,chain", [(1, 1), (2, 1), (2, 2), (3, 3),
                                            (3, 2)])
def test_gcl_eval_matches_pallas(n_layers, chain):
    x, mask, gate, layers = stack_case(seed=n_layers * 10 + chain,
                                       n_layers=n_layers)
    launches = gcl.launches
    got = port_stack(x, mask, gate, layers, chain)
    assert gcl.launches == launches  # the CPU takes the plain path
    want = jax_stack(x, mask, gate, layers, chain)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("density", [0.05, 0.3, 0.9])
def test_lattice_gcl_apply_matches_jax(density):
    x, mask, gate, layers = stack_case(seed=7, n_layers=1, density=density)
    l = layers[0]
    want = jlat.gcl_apply(jnp.asarray(x), jnp.asarray(mask),
                          jlat.build_neighbors(jnp.asarray(mask)),
                          jnp.asarray(gate), jnp.asarray(l["rel_w"]),
                          jnp.asarray(l["root"]), jnp.asarray(l["bias"]))
    m = torch.from_numpy(mask)
    got = lattice.gcl_apply(torch.from_numpy(x), m, lattice.build_neighbors(m),
                            torch.from_numpy(gate),
                            torch.from_numpy(l["rel_w"]),
                            torch.from_numpy(l["root"]),
                            torch.from_numpy(l["bias"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gcl_eval_equals_the_residual_lattice_stack():
    """The kernel's function, written through `lattice.gcl_apply`:
    relu((gcl(x) * A + B) * m) + x per layer."""
    x, mask, gate, layers = stack_case(seed=3, n_layers=2)
    got = port_stack(x, mask, gate, layers, 2)
    m = torch.from_numpy(mask)
    nbr = lattice.build_neighbors(m)
    ref = torch.from_numpy(x)
    for l in layers:
        y = lattice.gcl_apply(ref, m, nbr, torch.from_numpy(gate),
                              torch.from_numpy(l["rel_w"]),
                              torch.from_numpy(l["root"]),
                              torch.from_numpy(l["bias"]))
        y = (y * torch.from_numpy(l["ea"]) + torch.from_numpy(l["eb"])) \
            * m[..., None]
        ref = ref + torch.relu(y)
    np.testing.assert_allclose(got, ref.numpy(), **TOL)


def test_pack_weights_matches_jax():
    rng = np.random.default_rng(0)
    rel_w = rng.standard_normal((6, 8, 8)).astype(np.float32)
    root = rng.standard_normal((8, 8)).astype(np.float32)
    want = gcl_pallas.pack_weights(jnp.asarray(rel_w), jnp.asarray(root), 4,
                                   dtype=jnp.float32)
    got = gcl.pack_weights(torch.from_numpy(rel_w), torch.from_numpy(root), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
