"""The port's chord tail (its plain version, which a CPU tensor runs) against
the JAX package's `chord_tail_tokens` in interpret mode: ids equal except
at cells whose top-2 logit gap is below 1e-4, and those must be few."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyphemus_tpu.ops.kernels import chord_tail as jchord
from polyphemus_tpu_torch.ops.kernels import chord_tail, counts

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
    launches = dict(counts.launches)
    got = chord_tail.chord_tail_tokens(
        torch.from_numpy(x), *map(torch.from_numpy, params), n_slots=15)
    assert counts.launches == launches  # the CPU takes the plain path
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


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_chord_tail_matches_jax(seed):
    """bf16 x and weights: the plain version upcasts them (the fp32 sums of
    bf16 products that the Pallas body and the kernel take; slot hiddens and
    logits stay fp32), so the tie rule is fp32's, on the bf16 values."""
    x, params, mask = tail_case(seed)
    bf = jnp.bfloat16
    want = np.asarray(jchord.chord_tail_tokens(
        jnp.asarray(x, bf), *(jnp.asarray(p, bf) for p in params),
        n_slots=15))
    launches = dict(counts.launches)
    got = chord_tail.chord_tail_tokens(
        torch.from_numpy(x).bfloat16(),
        *(torch.from_numpy(p).bfloat16() for p in params), n_slots=15)
    assert counts.launches == launches
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    as_bf16 = [np.asarray(jnp.asarray(a, bf).astype(jnp.float32))
               for a in [x] + params]
    logits = plain_logits(*as_bf16)
    tie = np.stack([top2_gap(logits[..., :131]),
                    top2_gap(logits[..., 131:])], axis=-1) < LOGIT_TIE
    assert tie[mask].mean() < 1e-3
    np.testing.assert_array_equal(got.numpy()[~tie], want[~tie])


def test_bf16_plain_is_not_the_rounded_scan():
    """The bf16 form keeps the slot hiddens in fp32: rounding them to bf16
    (the XLA scan's arithmetic) gives other ids somewhere."""
    x, params, _ = tail_case(4, b=4)
    xt, pt = torch.from_numpy(x).bfloat16(), [torch.from_numpy(p).bfloat16()
                                              for p in params]
    got = chord_tail.chord_tail_plain(xt, *pt, n_slots=15)
    d = x.shape[-1]
    rounded = []
    for s in range(15):
        sh = xt @ pt[0][:, s * d:(s + 1) * d] + pt[1][s * d:(s + 1) * d]
        pitch = torch.cat([sh[..., :1, :, :d // 2] @ pt[2] + pt[3],
                           sh[..., 1:, :, :d // 2] @ pt[4] + pt[5]], dim=-3)
        dur = sh[..., d // 2:] @ pt[6] + pt[7]
        rounded.append(torch.stack([pitch.argmax(-1), dur.argmax(-1)], -1))
    assert not torch.equal(got, torch.stack(rounded, -2).to(torch.int32))


@pytest.mark.parametrize("d", [32, 512, 640])
def test_packed_unembeds_give_the_plain_ids(d):
    """`pack` in fp32 pads each half of each slot's columns to the fp32
    kernel's tile width H and lays the unembeds side by side, each
    zero-padded to 144 columns and to H rows: a padded column of h is 0,
    and the logits from the packed operands, argmax below the vocabulary
    edge, give the plain ids."""
    x, params, _ = tail_case(5, b=1, d=d)
    t = [torch.from_numpy(p) for p in params]
    packed = chord_tail.pack(torch.float32, *t)
    h, hp, w = d // 2, chord_tail.half_width(d), chord_tail.UNEMBED_WIDTH
    ck, cb, u, ub = (a.double() for a in packed)
    assert hp >= h and ck.shape == (d, 15 * 2 * hp) and u.shape == (hp, 3 * w)
    assert (packed[0] is t[0]) == (hp == h)
    slots = ck.reshape(d, 15, 2, hp)
    assert torch.equal(slots[..., :h], t[0].double().reshape(d, 15, 2, h))
    assert not slots[..., h:].any() and not cb.reshape(15, 2, hp)[..., h:].any()
    for i, (k, b) in enumerate(((t[2], t[3]), (t[4], t[5]), (t[6], t[7]))):
        assert torch.equal(u[:h, i * w:i * w + k.shape[1]], k.double())
        assert torch.equal(ub[i * w:i * w + b.shape[0]], b.double())
        assert not u[:, i * w + k.shape[1]:(i + 1) * w].any()
        assert not ub[i * w + b.shape[0]:(i + 1) * w].any()
    assert not u[h:].any()
    xt = torch.from_numpy(x).double()
    vp, vd = params[2].shape[1], params[6].shape[1]
    ids = []
    for s in range(15):
        sh = xt @ ck[:, s * 2 * hp:(s + 1) * 2 * hp] \
            + cb[s * 2 * hp:(s + 1) * 2 * hp]
        assert not sh[..., h:hp].any() and not sh[..., hp + h:].any()
        logits = sh[..., :hp] @ u[:, :2 * w] + ub[:2 * w]
        pitch = torch.cat([logits[..., :1, :, :vp],
                           logits[..., 1:, :, w:w + vp]], dim=-3)
        dur = sh[..., hp:] @ u[:, 2 * w:] + ub[2 * w:]
        ids.append(torch.stack([pitch.argmax(-1), dur[..., :vd].argmax(-1)],
                               -1))
    want = chord_tail.chord_tail_plain(xt, *(a.double() for a in t),
                                       n_slots=15)
    assert torch.equal(torch.stack(ids, -2).to(torch.int32), want)


def test_fp32_operands_are_packed_once_for_as_long_as_the_weights_last():
    """The fp32 wrapper packs the weights once: again only for other
    tensors or after an in-place change, and the cache keeps no weight
    alive."""
    import gc
    import weakref

    _, params, _ = tail_case(6, d=640)
    t = [torch.from_numpy(p) for p in params]
    first = chord_tail._operands(torch.float32, t)
    again = chord_tail._operands(torch.float32, t)
    assert all(a is b for a, b in zip(first, again))
    t[2][0, 0] += 1.0  # in place: the drum unembed's version moves on
    changed = chord_tail._operands(torch.float32, t)
    assert changed[2] is not first[2]
    assert changed[2][0, 0] == t[2][0, 0]
    copies = [a.clone() for a in t]
    assert chord_tail._operands(torch.float32, copies)[0] is not changed[0]
    # at d = 128 the weight is its own operand: the cache holds no reference
    _, params, _ = tail_case(7, d=128)
    t = [torch.from_numpy(p) for p in params]
    assert chord_tail._operands(torch.float32, t)[0] is t[0]
    ref = weakref.ref(t[0])
    del t
    gc.collect()
    assert ref() is None


def split3(h):
    """h (fp32) as three bf16 parts, each the bf16 rounding of what the
    parts before it leave, as `csrc/chord_tail_bf16_tc.cu` splits the slot
    hiddens for its unembed products."""
    parts = []
    for _ in range(3):
        p = h.bfloat16().float()
        parts.append(p)
        h = h - p
    return parts


@pytest.mark.parametrize("d", [32, 256, 640])
def test_bf16_packed_operands_give_the_plain_ids(d):
    """`pack` in bf16 pads as in fp32, with ck and the unembeds in
    bf16 and the biases in fp32. The slot hiddens in fp32, split into three
    bf16 parts that sum to them exactly, against the packed unembeds (the
    bf16 kernel's products) give the plain ids."""
    x, params, mask = tail_case(8, b=1, d=d)
    t = [torch.from_numpy(p).bfloat16() for p in params]
    ck, cb, u, ub = chord_tail.pack(torch.bfloat16, *t)
    h, hp, w = d // 2, chord_tail.half_width(d), chord_tail.UNEMBED_WIDTH
    assert (ck is t[0]) == (hp == h)
    assert ck.dtype == u.dtype == torch.bfloat16
    assert cb.dtype == ub.dtype == torch.float32
    assert ck.shape == (d, 15 * 2 * hp) and u.shape == (hp, 3 * w)
    slots = ck.reshape(d, 15, 2, hp)
    assert torch.equal(slots[..., :h], t[0].reshape(d, 15, 2, h))
    assert not slots[..., h:].any() and not cb.reshape(15, 2, hp)[..., h:].any()
    for i, (k, b) in enumerate(((t[2], t[3]), (t[4], t[5]), (t[6], t[7]))):
        assert torch.equal(u[:h, i * w:i * w + k.shape[1]], k)
        assert torch.equal(ub[i * w:i * w + b.shape[0]], b.float())
        assert not u[:, i * w + k.shape[1]:(i + 1) * w].any()
        assert not ub[i * w + b.shape[0]:(i + 1) * w].any()
    assert not u[h:].any()
    xt = torch.from_numpy(x).bfloat16()
    vp, vd = params[2].shape[1], params[6].shape[1]
    ud, ubd = u.double(), ub.double()
    ids, logits = [], []
    for s in range(15):
        cols = slice(s * 2 * hp, (s + 1) * 2 * hp)
        sh = (xt.double() @ ck[:, cols].double()).float() + cb[cols]
        parts = split3(sh)
        assert torch.equal(sum(p.double() for p in parts), sh.double())
        ph = sum(p[..., :hp].double() @ ud[:, :2 * w] for p in parts) \
            + ubd[:2 * w]
        dh = sum(p[..., hp:].double() @ ud[:, 2 * w:] for p in parts) \
            + ubd[2 * w:]
        pitch = torch.cat([ph[..., :1, :, :vp], ph[..., 1:, :, w:w + vp]],
                          dim=-3)
        dur = dh[..., :vd]
        ids.append(torch.stack([pitch.argmax(-1), dur.argmax(-1)], -1))
        logits.append(torch.cat([pitch, dur], -1))
    got = torch.stack(ids, -2).to(torch.int32)
    want = chord_tail.chord_tail_plain(xt, *t, n_slots=15)
    lg = torch.stack(logits, -2).numpy()
    tie = np.stack([top2_gap(lg[..., :vp]), top2_gap(lg[..., vp:])],
                   axis=-1) < LOGIT_TIE
    assert tie[mask].mean() < 1e-3
    np.testing.assert_array_equal(got.numpy()[~tie], want.numpy()[~tie])


def test_fp32_and_bf16_operands_are_cached_apart():
    """The fp32 and the bf16 wrapper each keep their own packing: packing
    the bf16 weights leaves the fp32 packing in place, and the other way
    round."""
    _, params, _ = tail_case(9, d=64)
    t32 = [torch.from_numpy(p) for p in params]
    t16 = [a.bfloat16() for a in t32]
    p32 = chord_tail._operands(torch.float32, t32)
    p16 = chord_tail._operands(torch.bfloat16, t16)
    assert p16[2].dtype == torch.bfloat16 and p32[2].dtype == torch.float32
    assert all(a is b for a, b in zip(chord_tail._operands(torch.float32, t32), p32))
    assert all(a is b for a, b in zip(chord_tail._operands(torch.bfloat16, t16), p16))
