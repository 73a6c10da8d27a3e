"""The port's chord tail (its plain version, which a CPU tensor runs) against
the JAX package's `chord_tail_tokens` in interpret mode: ids equal except
at cells whose top-2 logit gap is below 1e-4, and those must be few."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyphemus_tpu.ops.kernels import chord_tail as jchord
from polyphemus_tpu_torch.ops.kernels import chord_tail

from .torch_port_case import LOGIT_TIE, top2_gap


def tail_case(seed, b=2, nb=2, d=32):
    rng = np.random.default_rng(seed)
    h = d // 2
    mask = rng.random((b, nb, 4, 32)) < 0.4
    x = rng.standard_normal((b, nb, 4, 32, d)).astype(np.float32) \
        * mask[..., None]

    def w(*shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    params = [w(d, 15 * d, scale=d ** -0.5), w(15 * d, scale=0.1),
              w(h, 131, scale=h ** -0.5), w(131, scale=0.1),
              w(h, 131, scale=h ** -0.5), w(131, scale=0.1),
              w(h, 99, scale=h ** -0.5), w(99, scale=0.1)]
    return x, params, mask


def plain_logits(x, ck, cb, pkd, pbd, pkn, pbn, dk, db):
    """(..., T, S, 15, 230) float64 logits, for the near-tie rule."""
    d = x.shape[-1]
    h = d // 2
    y = (x.astype(np.float64) @ ck + cb).reshape(x.shape[:-1] + (15, d))
    pitch = np.concatenate([y[..., :1, :, :, :h] @ pkd + pbd,
                            y[..., 1:, :, :, :h] @ pkn + pbn], axis=-4)
    return np.concatenate([pitch, y[..., h:] @ dk + db], axis=-1)


@pytest.mark.parametrize("seed", [0, 1])
def test_chord_tail_matches_jax(seed):
    x, params, mask = tail_case(seed)
    want = np.asarray(jchord.chord_tail_tokens(
        jnp.asarray(x), *map(jnp.asarray, params), n_slots=15))
    launches = chord_tail.launches
    got = chord_tail.chord_tail_tokens(
        torch.from_numpy(x), *map(torch.from_numpy, params), n_slots=15)
    assert chord_tail.launches == launches  # the CPU takes the plain path
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    logits = plain_logits(x, *params)
    tie = np.stack([top2_gap(logits[..., :131]),
                    top2_gap(logits[..., 131:])], axis=-1) < LOGIT_TIE
    # every empty cell has the same (bias-only) logits: count active ones
    assert tie[mask].mean() < 1e-3
    np.testing.assert_array_equal(got.numpy()[~tie], want[~tie])


def test_chord_tail_takes_the_first_of_equal_maxima():
    """Exact ties (empty cells, equal biases) resolve to the lowest id, as
    `jnp.argmax` and `torch.argmax` do."""
    x, params, _ = tail_case(3)
    x[:] = 0.0
    params[1][:] = 0.0                   # slot hiddens are all zero
    for i in (3, 5, 7):
        params[i][:] = 0.5               # so every logit equals 0.5
    got = chord_tail.chord_tail_tokens(
        torch.from_numpy(x), *map(torch.from_numpy, params), n_slots=15)
    assert int(got.abs().sum()) == 0
