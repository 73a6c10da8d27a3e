"""Lattice ops of the port against the JAX package, exactly:
`ensure_nonempty_bars`, every field of `build_neighbors`, and the 14 aux
channels of `build_kernel_aux`, at mask densities 0.05 / 0.3 / 0.9 with
empty and single-node bars mixed in."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyphemus_tpu.ops import lattice as jlat
from polyphemus_tpu.ops.kernels import gcl_pallas
from polyphemus_tpu_torch.ops import lattice
from polyphemus_tpu_torch.ops.kernels import gcl


def lattice_masks(density, seed=0, b=3, nb=4, t=4, s=32):
    rng = np.random.default_rng(seed)
    mask = rng.random((b, nb, t, s)) < density
    mask[0, 0] = False                   # empty bar
    mask[0, 1] = False
    mask[0, 1, 2, 17] = True             # single node off track 0
    mask[1, 2] = False
    mask[1, 2, 0, 0] = True              # single node at the fixed cell
    return mask


@pytest.mark.parametrize("density", [0.05, 0.3, 0.9])
def test_ensure_nonempty_bars(density):
    mask = lattice_masks(density)
    want = np.asarray(jlat.ensure_nonempty_bars(jnp.asarray(mask)))
    got = lattice.ensure_nonempty_bars(torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 0, 0, 0] and got[0, 0].sum() == 1


@pytest.mark.parametrize("density", [0.05, 0.3, 0.9])
def test_build_neighbors_every_field(density):
    mask = np.array(jlat.ensure_nonempty_bars(
        jnp.asarray(lattice_masks(density, seed=1))))
    want = jlat.build_neighbors(jnp.asarray(mask))
    got = lattice.build_neighbors(torch.from_numpy(mask))
    assert got._fields == want._fields
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert got.single_node.any()


@pytest.mark.parametrize("density", [0.05, 0.3, 0.9])
def test_build_kernel_aux_channels(density):
    mask = np.array(jlat.ensure_nonempty_bars(
        jnp.asarray(lattice_masks(density, seed=2))))
    want = np.asarray(gcl_pallas.build_kernel_aux(jnp.asarray(mask)))
    got = gcl.build_kernel_aux(torch.from_numpy(mask))
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert gcl.N_AUX == gcl_pallas.N_AUX
    np.testing.assert_array_equal(got.numpy(), want)
