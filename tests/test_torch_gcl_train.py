"""The port's training GCL against the JAX package's: the plain forward
(`gcl_fwd_plain`, what a CPU tensor runs) against `gcl_apply_pallas`
without its epilogue (rtol = atol = 2e-4), and the plain backward
(`gcl_bwd_data_plain`, `gcl_bwd_weight_plain`) against the Pallas backward
`gcl_backward_pallas` (rtol = atol = 5e-4, as tests/test_pallas_grad.py),
both in interpret mode at D = 16; the plain backward against
`torch.autograd` through the plain forward; the `gcl_fused` autograd
function against the lattice GCL's autograd; numpy emulations of one CTA
of the weight kernel (`csrc/gcl_bwd_weight.cu`) and of the data kernel
(`csrc/gcl_bwd_data.cu`) against both backwards at D = 128. On the CPU the
kernels' launch counters stay 0."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyphemus_tpu.ops.kernels import gcl_pallas, gcl_pallas_bwd
from polyphemus_tpu_torch.ops import lattice
from polyphemus_tpu_torch.ops.kernels import counts, gcl, gcl_bwd

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
    launches = dict(counts.launches)
    got = gcl.gcl_fwd(xf, aux, gate_t, gcl.pack_weights(rel_t, root_t, T),
                      bias_t)
    assert counts.launches == launches  # the CPU takes the plain path
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
    before = dict(counts.launches)
    dx, dg, db = gcl_bwd.gcl_bwd_data(xf, gf, aux, gate_t,
                                      gcl.pack_weights(rel_t, root_t, T))
    dw = gcl_bwd.gcl_bwd_weight(xf, gf, aux, gate_t)
    assert counts.launches == before
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


# The tiling of `csrc/gcl_bwd_weight.cu`: a CTA owns rows [c0, c0 + CT) of
# all 8 blocks x columns [j0, j0 + JT) and walks every bar in order. Warps
# 0-3 contract the rows of tracks 0 and 1, warps 4-7 those of tracks 2 and
# 3; a thread holds features 2 cg, 2 cg + 1 and columns 4 jg..4 jg + 3, 32 +
# 4 jg..32 + 4 jg + 3 of the 4 full blocks and of its half's 2 track blocks.
CT, JT = 32, 64
TID = np.arange(256)
HALF = TID // 128
CG = (TID // 32 % 4) * 4 + TID % 32 // 8
JG = TID % 8
FEATS = np.stack([2 * CG, 2 * CG + 1], axis=1)                     # (256, 2)
COLS = np.concatenate([4 * JG[:, None] + np.arange(4),
                       JT // 2 + 4 * JG[:, None] + np.arange(4)], axis=1)


def cell_statics(a):
    """One bar's aux (N_AUX, n) decoded as `gcl_common.cuh::cell_statics`."""
    f32 = np.float32
    n = a.shape[1]
    m = (a[gcl.MASK_CH] > 0).astype(f32)
    okp, okn, okpn = a[gcl.OK_P] > 0, a[gcl.OK_N] > 0, a[gcl.OK_PN] > 0
    cnt = okp.astype(np.int64) + okn
    con, cnx = a[gcl.CNT_ON], a[gcl.CNT_NX]

    def recip(c, valid):
        r = f32(1) / np.maximum(c, 1).astype(f32) * m
        return np.where(valid, r, f32(0)).astype(f32)

    return dict(
        ps=np.clip(a[gcl.PREV_SRC], 0, n - 1),
        ns=np.clip(a[gcl.NEXT_SRC], 0, n - 1),
        pn=np.clip(a[gcl.PN_SRC], 0, n - 1),
        dp=np.clip(a[gcl.DIST_P], 0, S - 1),
        dn=np.clip(a[gcl.DIST_N], 0, S - 1),
        dpn=np.clip(a[gcl.DIST_PN], 0, S - 1),
        okp=okp.astype(f32), okn=okn.astype(f32),
        okpn=(okpn & (a[gcl.MSRC] > 0)).astype(f32),
        rtr=recip(cnt, cnt > 0), ron=recip(con, con > 0),
        rnx=recip(cnx, okpn & (cnx > 0)), m=m,
        single=a[gcl.SINGLE].astype(f32))


def cta_a_tiles(xb, a, gates):
    """The A tiles one CTA rebuilds for one bar from x (n, CT) and the gate
    table (S, CT) of its features, with the kernel's fp32 operations:
    h_track, h_self, h_onset, h_next and x * m, each (n, CT)."""
    st = cell_statics(a)

    def col(v):
        return v[:, None]

    def msg(src, dist, ok):
        return np.maximum(xb[src] * gates[dist], 0) * col(ok)

    def others(v):
        v4 = v.reshape(T, S, -1)
        return ((((v4[0] + v4[1]) + v4[2]) + v4[3])[None] - v4).reshape(
            v.shape)

    y = np.maximum(xb * gates[0], 0) * col(st["m"])
    z = msg(st["pn"], st["dpn"], st["okpn"])
    h_track = (msg(st["ps"], st["dp"], st["okp"])
               + msg(st["ns"], st["dn"], st["okn"])) * col(st["rtr"])
    return [h_track, y * col(st["single"]), others(y) * col(st["ron"]),
            others(z) * col(st["rnx"]), xb * col(st["m"])]


def emulate_cta(x, g, aux, gates, c0, j0):
    """Rows [c0, c0 + CT) x columns [j0, j0 + JT) of the 8 blocks of dWbig,
    (8, CT, JT), as one CTA of the weight kernel sums them: per bar, every
    thread's FFMAs over the rows of its half (raw g: m is in the A tiles),
    then half 1's full-block sums added to half 0's, each output written
    by exactly one thread."""
    nbar = x.shape[0]
    tr = np.zeros((256, 2, 2, 8), np.float32)
    full = np.zeros((256, 4, 2, 8), np.float32)
    for bar in range(nbar):
        tiles = cta_a_tiles(x[bar][:, c0:c0 + CT], aux[bar],
                            gates[:, c0:c0 + CT])
        gb = g[bar][:, j0:j0 + JT]
        for tb in range(2):
            for kk in range(S):
                k = ((2 * HALF + tb) * S + kk)[:, None]
                b = gb[k, COLS][:, None, :]
                av = [t_[k, FEATS][:, :, None] for t_ in tiles]
                tr[:, tb] += av[0] * b
                for i in range(4):
                    full[:, i] += av[1 + i] * b
    out = np.zeros((8, CT, JT), np.float32)
    written = np.zeros(out.shape, np.int64)

    def put(blk, t, v):
        ix = (blk, FEATS[t][:, None], COLS[t][None, :])
        out[ix] = v
        written[ix] += 1

    for t in TID:
        if HALF[t] == 0:
            for i in range(4):
                put(T + i, t, full[t, i] + full[t + 128, i])
        for tb in range(2):
            put(2 * HALF[t] + tb, t, tr[t, tb])
    assert (written == 1).all()
    return out


@functools.lru_cache(maxsize=1)
def weight_case(d=128):
    """A 5-bar layer at width d (single-node, fixed and full bars): the
    port's arguments as numpy, the plain dWbig and JAX's Pallas dWbig."""
    mask, x, g, gate, rel_w, root, _ = layer_case(seed=6, d=d)
    wbig_j = gcl_pallas.pack_weights(jnp.asarray(rel_w), jnp.asarray(root),
                                     T, dtype=jnp.float32)
    _, _, dw_j, _ = gcl_pallas_bwd.gcl_backward_pallas(
        jnp.asarray(x), gcl_pallas.build_kernel_aux(jnp.asarray(mask)),
        jnp.asarray(gate), wbig_j, jnp.asarray(g))
    aux, xf, (gf, gate_t) = port_args(mask, x, g, gate)
    gf = gf.reshape(xf.shape)
    dw = gcl_bwd.gcl_bwd_weight_plain(xf, gf, aux, gate_t)
    return (xf.numpy(), gf.numpy(), aux.numpy(), gate, dw.numpy(),
            np.asarray(dw_j))


# the first tile, one inside (c0 != 0, j0 != 0), the last
@pytest.mark.parametrize("c0,j0", [(0, 0), (32, 64), (96, 64)])
def test_weight_kernel_cta_emulation_matches_both_backwards(c0, j0):
    x, g, aux, gate, dw_plain, dw_jax = weight_case()
    d = x.shape[-1]
    got = emulate_cta(x, g, aux, gate, c0, j0)

    def tile(dw):
        return dw.reshape(8, d, d)[:, c0:c0 + CT, j0:j0 + JT]

    assert np.abs(tile(dw_plain)).max() > 0
    np.testing.assert_allclose(got, tile(dw_plain), rtol=5e-5, atol=5e-5)
    np.testing.assert_allclose(got, tile(dw_jax), **BWD_TOL)


# The tiling of `csrc/gcl_bwd_data.cu`: a CTA owns columns [c0, c0 + BC)
# and walks the bars chunk, chunk + nchunks, ...; each bar's product runs
# in stages of BK features that start after the tile's own, the tiles of
# sums are stored times m and their upstream factors, and the scatters
# run as gathers over the inverted relations: the thread of (cell j,
# column q), j = warp + 8 k, sums dx[j] and adds its dgate shares into its
# warp's tile; the 8 warps' tiles are added in order after each bar.
BC, BK, NWARP = 32, 32, 8
DATA_NCHUNKS = 2


def inverted_relations(a):
    """One bar's statics and its three relations inverted as the kernel's
    decode writes them: src[r] = {j: (i, dist)} for the cell i that reads
    cell j through relation r (previous and next active cell of the track,
    the track's cell at the previous active column) with a share that is
    not 0; each j is read so by one cell at most."""
    st = cell_statics(a)
    m = st["m"] > 0
    col_active = a[gcl.CNT_ON] + m > 0
    src = [{}, {}, {}]
    for r, ok, to, dist in ((0, m & (st["okp"] > 0), st["ps"], st["dp"]),
                            (1, m & (st["okn"] > 0), st["ns"], st["dn"]),
                            (2, (st["okpn"] > 0) & col_active, st["pn"],
                             st["dpn"])):
        for i in np.flatnonzero(ok):
            assert to[i] not in src[r], (r, i, to[i])
            src[r][to[i]] = (i, dist[i])
    return st, src


def emulate_data_cta(x, g, aux, gates, wbig, c0, bars):
    """dx[bars][:, tile] and the CTA's dgate (S, BC) and dbias (BC)
    partials, as one CTA of the data kernel computes them for the column
    tile at c0 over `bars`."""
    n, d = x.shape[1:]
    nstage = d // BK
    tile = slice(c0, c0 + BC)
    w_tile = wbig.reshape(8, d, d)[:, tile]       # (8, BC, d)
    dgs = np.zeros((S, BC), np.float32)
    db = np.zeros((NWARP, BC), np.float32)
    dx = np.zeros((len(bars), n, BC), np.float32)

    def colsum(v, c):
        return ((v[c] + v[S + c]) + v[2 * S + c]) + v[3 * S + c]

    for b, bar in enumerate(bars):
        st, src = inverted_relations(aux[bar])
        acc = np.zeros((5, n, BC), np.float32)
        for k in range(nstage):
            f = slice((c0 // BK + 1 + k) % nstage * BK, None)
            f = slice(f.start, f.start + BK)
            gs = g[bar][:, f]
            for t in range(T):
                rows_t = slice(t * S, (t + 1) * S)
                acc[0][rows_t] += gs[rows_t] @ w_tile[t][:, f].T
            for seg in range(1, 5):
                acc[seg] += gs @ w_tile[T - 1 + seg][:, f].T
        assert f.start == c0                       # the last stage: dbias
        m = st["m"][:, None]
        db += (g[bar][:, tile] * m).reshape(NWARP, n // NWARP, BC).sum(1)
        up = [acc[0] * m * st["rtr"][:, None], acc[1] * m * st["single"][:, None],
              acc[2] * m * st["ron"][:, None], acc[3] * m * st["rnx"][:, None],
              acc[4] * m]
        xs, gt = x[bar][:, tile], gates[:, tile]
        dgw = np.zeros((NWARP, S, BC), np.float32)
        for w in range(NWARP):
            for j in range(w, n, NWARP):
                xv, v = xs[j], up[4][j].copy()
                for r in range(3):
                    if j not in src[r]:
                        continue
                    i, dist = src[r][j]
                    on = xv * gt[dist] > 0
                    u = up[0][i] if r < 2 else (colsum(up[3], i % S)
                                                - up[3][i])
                    v += np.where(on, u * gt[dist], 0)
                    dgw[w, dist] += np.where(on, u * xv, 0)
                if st["m"][j] > 0:
                    on = xv * gt[0] > 0
                    dy0 = colsum(up[2], j % S) - up[2][j] + up[1][j]
                    v += np.where(on, dy0 * gt[0], 0)
                    dgw[w, 0] += np.where(on, dy0 * xv, 0)
                dx[b, j] = v
        for w in range(NWARP):
            dgs += dgw[w]
    return dx, dgs, db.sum(0)


@functools.lru_cache(maxsize=None)
def data_case(chunk, d=128):
    """A 6-bar layer at width d (single-node, fixed and full bars, and bar
    4 without an active cell but with x and g not 0), cut to the bars of
    one chunk of DATA_NCHUNKS: the port's arguments as numpy, the plain
    (dx, dgate, dbias) and JAX's Pallas ones over those bars."""
    mask, x, g, gate, rel_w, root, _ = layer_case(seed=8, nbar=6, d=d)
    mask[4] = False
    x[4] = np.random.default_rng(9).standard_normal(x[4].shape)
    bars = list(range(chunk, 6, DATA_NCHUNKS))
    mask, x, g = mask[bars], x[bars], g[bars]
    wbig_j = gcl_pallas.pack_weights(jnp.asarray(rel_w), jnp.asarray(root),
                                     T, dtype=jnp.float32)
    dx_j, dg_j, _, db_j = gcl_pallas_bwd.gcl_backward_pallas(
        jnp.asarray(x), gcl_pallas.build_kernel_aux(jnp.asarray(mask)),
        jnp.asarray(gate), wbig_j, jnp.asarray(g))
    aux, xf, (gf, gate_t, rel_t, root_t) = port_args(mask, x, g, gate,
                                                     rel_w, root)
    gf = gf.reshape(xf.shape)
    wbig = gcl.pack_weights(rel_t, root_t, T)
    plain = gcl_bwd.gcl_bwd_data_plain(xf, gf, aux, gate_t, wbig)
    jax_out = (np.asarray(dx_j).reshape(xf.shape), np.asarray(dg_j),
               np.asarray(db_j))
    return ((xf.numpy(), gf.numpy(), aux.numpy(), gate, wbig.numpy()),
            tuple(v.numpy() for v in plain), jax_out)


# the first tile (with the empty bar), one inside, the last (empty bar)
@pytest.mark.parametrize("c0,chunk", [(0, 0), (32, 1), (96, 0)])
def test_data_kernel_cta_emulation_matches_both_backwards(c0, chunk):
    args, plain, jax_out = data_case(chunk)
    x = args[0]
    got = emulate_data_cta(*args, c0, list(range(x.shape[0])))
    if chunk == 0:                       # bar 4 of the layer, no active cell
        assert (x[2] != 0).any() and (got[0][2] == 0).all()
    tile = slice(c0, c0 + BC)
    for want in (plain, jax_out):
        np.testing.assert_allclose(got[0], want[0][..., tile], **BWD_TOL)
        np.testing.assert_allclose(got[1], want[1][:, tile], **BWD_TOL)
        np.testing.assert_allclose(got[2], want[2][tile], **BWD_TOL)
