"""Message dropout of the port's lattice GCL against the JAX package's.

`lattice.gcl_apply` in each mode ("edge": per-edge masks; "aggregate": one
mask over the stacked aggregates) at p = 0.1 and 0.5, 2 and 16 bars: the
keep masks are replayed from the JAX package's own draws (its order:
`jax.random.split(rng, 5)` into p, n, onset, next, self for "edge"; one
stacked draw for "aggregate") and passed as `keep`; outputs within
rtol = atol = 2e-5 of JAX's `lattice.gcl_apply` with that rng, and the
autograd grads of x, rel_weight, root, bias and gate_table within 1e-4 of
`jax.grad`'s (relative, and 1e-4 of each grad's max |jax| absolute). Also:
p = 0 gives the output without dropout exactly; an unknown mode raises;
generator masks keep a share within 4 sigma of 1 - p and one seed gives one
draw; a `GCN` in training with message dropout runs the lattice GCL and no
`gcl_fused`, and in eval `gcl_eval`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyphemus_tpu.ops import lattice as jlat
from polyphemus_tpu_torch.models import gnn
from polyphemus_tpu_torch.ops import lattice
from polyphemus_tpu_torch.ops.kernels import gcl as gcl_k
from polyphemus_tpu_torch.ops.kernels import gcl_bwd

D = 16
OUT_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_REL = 1e-4
GRAD_NAMES = ("x", "rel_weight", "root", "bias", "gate_table")


def dropout_case(n_bars, seed, b=2):
    """Seeded masks (realistic densities, a single-node bar off track 0, an
    empty bar fixed to cell [0, 0]), masked x, GCL weights and a
    cotangent."""
    rng = np.random.default_rng(seed)
    dens = rng.choice([0.05, 0.3, 0.5, 0.9], size=(b, n_bars, 1, 1))
    mask = rng.random((b, n_bars, 4, 32)) < dens
    mask[0, 0] = False
    mask[0, 0, 2, 17] = True
    mask[-1, -1] = False
    mask = np.array(jlat.ensure_nonempty_bars(jnp.asarray(mask)))
    f = np.float32
    x = rng.standard_normal(mask.shape + (D,)).astype(f) * mask[..., None]
    params = dict(
        rel_weight=(rng.standard_normal((6, D, D)) / np.sqrt(D)).astype(f),
        root=(rng.standard_normal((D, D)) / np.sqrt(D)).astype(f),
        bias=(0.1 * rng.standard_normal(D)).astype(f),
        gate_table=(0.5 * rng.standard_normal((32, D))).astype(f))
    cot = rng.standard_normal(mask.shape + (D,)).astype(f)
    return mask, x, params, cot


def jax_keep(rng, p, mode, x_shape):
    """The keep masks JAX's `gcl_apply` draws from `rng`, in its order."""
    keep = 1.0 - p
    if mode == "aggregate":
        return np.asarray(jax.random.bernoulli(rng, keep, (4,) + x_shape))
    t = x_shape[-3]
    pair = x_shape[:-3] + (t,) + x_shape[-3:]
    shapes = (x_shape, x_shape, pair, pair, x_shape)
    return [np.asarray(jax.random.bernoulli(k, keep, sh))
            for k, sh in zip(jax.random.split(rng, 5), shapes)]


def jax_out_and_grads(mask, x, params, cot, p, mode, rng):
    jm = jnp.asarray(mask)
    nbr = jlat.build_neighbors(jm)

    def f(x, rel_weight, root, bias, gate_table):
        out = jlat.gcl_apply(x, jm, nbr, gate_table, rel_weight, root, bias,
                             message_dropout=p, dropout_rng=rng,
                             message_dropout_mode=mode)
        return jnp.sum(out * cot), out

    args = [jnp.asarray(x)] + [jnp.asarray(params[k]) for k in GRAD_NAMES[1:]]
    grads, out = jax.grad(f, argnums=tuple(range(5)), has_aux=True)(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def port_out_and_grads(mask, x, params, cot, p, mode, keep):
    tm = torch.from_numpy(mask)
    nbr = lattice.build_neighbors(tm)
    args = [torch.tensor(x, requires_grad=True)] + [
        torch.tensor(params[k], requires_grad=True) for k in GRAD_NAMES[1:]]
    xt, rw, root, bias, gt = args
    keep = (torch.tensor(keep) if mode == "aggregate"
            else [torch.tensor(k) for k in keep])
    out = lattice.gcl_apply(xt, tm, nbr, gt, rw, root, bias,
                            message_dropout=p, message_dropout_mode=mode,
                            keep=keep)
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach().numpy(), [a.grad.numpy() for a in args]


@pytest.mark.parametrize("n_bars", [2, 16])
@pytest.mark.parametrize("p", [0.1, 0.5])
@pytest.mark.parametrize("mode", ["edge", "aggregate"])
def test_dropout_gcl_matches_jax_on_its_draws(mode, p, n_bars):
    mask, x, params, cot = dropout_case(n_bars, seed=n_bars + int(10 * p))
    rng = jax.random.key(n_bars * 7 + int(100 * p))
    want, want_g = jax_out_and_grads(mask, x, params, cot, p, mode, rng)
    keep = jax_keep(rng, p, mode, x.shape)
    got, got_g = port_out_and_grads(mask, x, params, cot, p, mode, keep)
    np.testing.assert_allclose(got, want, **OUT_TOL)
    # the masks dropped something, and not everything
    share = np.mean([k.mean() for k in
                     ([keep] if mode == "aggregate" else keep)])
    assert 0 < share < 1
    for name, g, w in zip(GRAD_NAMES, got_g, want_g):
        np.testing.assert_allclose(g, w, rtol=GRAD_REL,
                                   atol=GRAD_REL * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("mode", ["edge", "aggregate"])
def test_zero_dropout_is_the_plain_gcl_exactly(mode):
    mask, x, params, _ = dropout_case(2, seed=3)
    tm = torch.from_numpy(mask)
    nbr = lattice.build_neighbors(tm)
    args = [torch.from_numpy(x), tm, nbr] + [
        torch.from_numpy(params[k]) for k in
        ("gate_table", "rel_weight", "root", "bias")]
    gen = torch.Generator().manual_seed(0)
    plain = lattice.gcl_apply(*args)
    got = lattice.gcl_apply(*args, message_dropout=0.0, generator=gen,
                            message_dropout_mode=mode)
    assert torch.equal(got, plain)
    # and the eval form equals JAX's without dropout
    jm = jnp.asarray(mask)
    want = jlat.gcl_apply(jnp.asarray(x), jm, jlat.build_neighbors(jm),
                          *(jnp.asarray(params[k]) for k in
                            ("gate_table", "rel_weight", "root", "bias")))
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), **OUT_TOL)


def test_unknown_mode_raises():
    mask, x, params, _ = dropout_case(2, seed=4)
    tm = torch.from_numpy(mask)
    with pytest.raises(ValueError, match="message_dropout_mode"):
        lattice.gcl_apply(torch.from_numpy(x), tm, lattice.build_neighbors(tm),
                          *(torch.from_numpy(params[k]) for k in
                            ("gate_table", "rel_weight", "root", "bias")),
                          message_dropout=0.1, message_dropout_mode="node")


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_generator_masks_keep_their_share_and_repeat(p):
    shape = (64, 4, 32, D)
    n = int(np.prod(shape))
    km = lattice.keep_mask(shape, 1.0 - p, torch.Generator().manual_seed(1),
                           "cpu")
    sigma = np.sqrt(p * (1 - p) / n)
    assert abs(km.float().mean().item() - (1 - p)) < 4 * sigma
    mask, x, params, _ = dropout_case(2, seed=5)
    tm = torch.from_numpy(mask)
    nbr = lattice.build_neighbors(tm)
    args = [torch.from_numpy(x), tm, nbr] + [
        torch.from_numpy(params[k]) for k in
        ("gate_table", "rel_weight", "root", "bias")]
    for mode in ("edge", "aggregate"):
        outs = [lattice.gcl_apply(
            *args, message_dropout=p, message_dropout_mode=mode,
            generator=torch.Generator().manual_seed(seed))
            for seed in (7, 7, 8)]
        assert torch.equal(outs[0], outs[1]), mode
        assert not torch.equal(outs[0], outs[2]), mode


@pytest.mark.parametrize("mode", ["edge", "aggregate"])
def test_gcn_routes_dropout_training_through_the_lattice(mode, monkeypatch):
    """Training with message dropout calls the lattice GCL once per layer
    and never `gcl_fused`; eval calls `gcl_eval` whatever the dropout; the
    training output is finite and has grads."""
    calls = {"gcl_apply": 0, "gcl_fused": 0, "gcl_eval": 0}

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(gnn.lattice, "gcl_apply",
                        spy("gcl_apply", lattice.gcl_apply))
    monkeypatch.setattr(gnn.gcl_bwd, "gcl_fused",
                        spy("gcl_fused", gcl_bwd.gcl_fused))
    monkeypatch.setattr(gnn.gcl_k, "gcl_eval", spy("gcl_eval", gcl_k.gcl_eval))
    torch.manual_seed(0)
    net = gnn.GCN(D, 3, num_dists=32, batch_norm=True, message_dropout=0.1,
                  message_dropout_mode=mode)
    net.drop.generator = torch.Generator().manual_seed(2)
    mask, x, _, _ = dropout_case(2, seed=6)
    x = torch.tensor(x, requires_grad=True)
    out = net.train()(x, torch.from_numpy(mask))
    out.square().sum().backward()
    assert calls == {"gcl_apply": 3, "gcl_fused": 0, "gcl_eval": 0}
    assert torch.isfinite(out).all() and torch.isfinite(x.grad).all()
    with torch.no_grad():
        net.eval()(x.detach(), torch.from_numpy(mask))
    assert calls == {"gcl_apply": 3, "gcl_fused": 0, "gcl_eval": 3}
    calls.update(dict.fromkeys(calls, 0))
    net.message_dropout = 0.0
    net.train()(x.detach(), torch.from_numpy(mask))
    assert calls == {"gcl_apply": 0, "gcl_fused": 3, "gcl_eval": 0}
