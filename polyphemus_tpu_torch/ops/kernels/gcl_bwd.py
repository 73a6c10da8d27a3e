"""Lattice graph-conv layer backward, and the training autograd function.

Counterpart of `polyphemus_tpu/ops/kernels/gcl_pallas_bwd.py`
(`gcl_backward_pallas`: kernel A `_bwd_data_kernel`, kernel B
`_bwd_weight_kernel`; `gcl_backward_fused`: `_bwd_fused_kernel`) and of the
custom VJP `gcl_fused` of `gcl_pallas.py`. On a CUDA tensor over bars of 4
x 32 cells (resolution 8) `gcl_bwd_data` launches `csrc/gcl_bwd_data.cu`,
`gcl_bwd_weight` `csrc/gcl_bwd_weight.cu` and `gcl_bwd_fused`
`csrc/gcl_bwd_fused.cu` in fp32 and `csrc/gcl_bwd_fused_bf16_tc.cu` (two
kernels on the tensor cores: dx, dgate and dbias over the dH product, and
dWbig) in bf16. Bars of 4 x S cells at another S up to 48 (resolutions
1-12) go to `csrc/gcl_bwd_data_grid.cu`, `csrc/gcl_bwd_weight_grid.cu` and
`csrc/gcl_bwd_fused_grid_bf16_tc.cu`, and above it (resolutions 13 and
up) the data and weight pair, fp32 or bf16, square or in the column form,
to `csrc/gcl_bwd_data_long.cu` and `csrc/gcl_bwd_weight_long.cu`
(templates on the element type); the bf16 fused backward refuses that grid
(`gcl.check_grid`), and the fp32 one, on no training path, takes 4 x 32
only. The pair takes bf16 above 48 steps only: no path runs it in bf16
below. On a CPU tensor each wrapper runs its plain PyTorch version, which
follows the equations of the forward (`gcl.gcl_fwd`):

    msg_p = relu(x[src_p] * G[dist_p]),  msg_n = relu(x[src_n] * G[dist_n])
    h_track = (msg_p + msg_n) * r_tr * m
    y0 = relu(x * g0) * m
    h_onset = (colsum(y0) - y0) * r_on * m
    z = relu(x[src_pn] * G[dist_pn])            (valid sources only)
    h_next = (colsum(z) - z) * r_nx * m
    h_self = y0 * single
    out = ([h_track | h_self | h_onset | h_next | x] @ Wbig + b) * m

with the track block of Wbig chosen by each row's own track. In bf16 every
plain version carries values in fp32 and rounds them to bf16 where the
Pallas body casts to its compute dtype (`_bwd_data_kernel`,
`_bwd_weight_kernel` and `_bwd_fused_kernel` round at the same places:
`rounded_data`, `rounded_weight`). The training layer takes the data and
weight pair in fp32, and in bf16 above 48 steps, as JAX's `gcl_fused`
takes it in both dtypes at every grid (`gcl_pallas.py:493-516`); in bf16
up to 48 steps it takes the fused single pass, which gives the pair's
outputs. `GclFused` refuses a grid the kernels do not take before its
forward.

Column form (tensor parallelism, `parallel.mesh`): Wbig may hold n of the
d output columns, (8d, n) with n % 128 == 0 dividing d, and g those n
columns, (nbar, n_cells, n). Then dWbig is (8d, n), dbias the n columns,
and dx and dgate are partial: summed over those n columns only, so that
their sum over the M column shards is the square launch's. The fp32 fused
backward (`csrc/gcl_bwd_fused.cu`, on no training path) takes n = d only.
"""
from __future__ import annotations

import torch

from . import counts
from .gcl import (BASE_STEPS, MAX_STEPS, N_AUX, bar_statics,
                  check_cuda_args, check_grid, col_sum, count_cols, gcl_fwd,
                  launch, messages, on_card, pack_weights, rows, wide)



def _contract(h, gg):
    """sum over cells of h^T gg: (d, n) from h (..., d) and gg (..., n)."""
    return h.reshape(-1, h.shape[-1]).t() @ gg.reshape(-1, gg.shape[-1])


def gcl_bwd_data_plain(x, g, aux, gate_table, wbig):
    """Plain-PyTorch `gcl_bwd_data`: the same arguments, the same result.
    A 2-byte x takes `rounded_data` (the Pallas body's bf16 roundings); a
    wider one is computed op by op in its dtype."""
    if wide(x.dtype) != x.dtype:
        return rounded_data(x, g, aux, gate_table, wbig)
    nbar, n, d = x.shape
    s = gate_table.shape[0]
    t = n // s
    st = bar_statics(aux, gate_table, x.dtype)
    gm = g * st.m
    dh4 = gm @ wbig[t * d:].t()
    dh_self, dh_on, dh_nx, dx = dh4.split(d, dim=-1)
    dx = dx.clone()
    dh_tr = torch.cat([gm[:, i * s:(i + 1) * s] @ wbig[i * d:(i + 1) * d].t()
                       for i in range(t)], dim=1)
    dmsg = dh_tr * st.rec_track
    dnx = dh_nx * st.rec_nx
    dz = col_sum(dnx, s) - dnx
    dcol = dh_on * st.rec_on
    dy0 = col_sum(dcol, s) - dcol + dh_self * st.single
    dgate = torch.zeros_like(gate_table)
    for src, dist, ok, gv, up in ((st.src_p, st.dist_p, st.ok_p, st.g_p, dmsg),
                                  (st.src_n, st.dist_n, st.ok_n, st.g_n, dmsg),
                                  (st.src_pn, st.dist_pn, st.ok_pn, st.g_pn,
                                   dz)):
        xv = rows(x, src)
        dpre = torch.where((xv * gv > 0) & (ok > 0), up, torch.zeros_like(up))
        dx.scatter_add_(1, src[..., None].expand(nbar, n, d), dpre * gv)
        dgate.index_add_(0, dist.reshape(-1), (dpre * xv).reshape(-1, d))
    g0 = gate_table[0]
    dpre0 = torch.where((x * g0 > 0) & (st.m > 0), dy0, torch.zeros_like(dy0))
    dx = dx + dpre0 * g0
    dgate[0] += (dpre0 * x).sum(dim=(0, 1))
    return dx, dgate, gm.sum(dim=(0, 1))


def gcl_bwd_weight_plain(x, g, aux, gate_table):
    """Plain-PyTorch `gcl_bwd_weight`: the same arguments, the same result.
    A 2-byte x takes `rounded_weight` (the Pallas body's bf16 roundings); a
    wider one is computed op by op in its dtype."""
    if wide(x.dtype) != x.dtype:
        return rounded_weight(x, g, aux, gate_table)
    n = x.shape[1]
    s = gate_table.shape[0]
    t = n // s
    st = bar_statics(aux, gate_table, x.dtype)
    gm = g * st.m
    h_tr, h_self, h_on, h_nx = messages(x, st, gate_table[0], s)
    blocks = [_contract(h_tr[:, i * s:(i + 1) * s], gm[:, i * s:(i + 1) * s])
              for i in range(t)]
    blocks += [_contract(h, gm) for h in (h_self, h_on, h_nx, x)]
    return torch.cat(blocks, dim=0)


def check_split_dtype(kernel: str, dt, s: int) -> None:
    """Raise unless the data or weight backward's kernels take dtype dt at
    bars of 4 x s cells: fp32 at every grid, bf16 above MAX_STEPS (the
    long-bar forms, bf16 training's backward there); bf16 training up to
    MAX_STEPS runs `gcl_bwd_fused`, and no path runs the pair in bf16."""
    if dt == torch.float32 or (dt == torch.bfloat16 and s > MAX_STEPS):
        return
    if dt == torch.bfloat16:
        raise ValueError(f"{kernel} takes bfloat16 at bars of more than "
                         f"{MAX_STEPS} steps only (its long-bar form), got "
                         f"S={s}: bf16 training up to {MAX_STEPS} steps runs "
                         f"gcl_bwd_fused")
    raise ValueError(f"{kernel} takes float32 or bfloat16, got {dt}")


def gcl_bwd_data(x, g, aux, gate_table, wbig):
    """Data half of the GCL backward for upstream g (nbar, n, w), w = d or
    a column shard's width (wbig (8d, w)); x, g, gate_table and wbig in one
    dtype, fp32, or bf16 above MAX_STEPS on a card.

    Returns (dx (nbar, n, d) in x's dtype, dgate_table (S, d), dbias (w,)),
    the last two fp32; dgate and dbias sum over every bar, dx and dgate
    over the w columns. Above MAX_STEPS the long-bar kernel takes an
    upstream scratch of (nbar, 3, n, d) floats, and in bf16 a fourth such
    plane for dx before it is rounded."""
    if not on_card("gcl_bwd_data", x):
        return gcl_bwd_data_plain(x, g, aux, gate_table, wbig)
    nbar, n, d = x.shape
    s = gate_table.shape[0]
    w = wbig.shape[-1]
    dt = x.dtype
    f32 = torch.float32
    check_split_dtype("gcl_bwd_data", dt, s)
    check_cuda_args("gcl_bwd_data", x, {
        "x": (x, (nbar, n, d), dt), "g": (g, (nbar, n, w), dt),
        "aux": (aux, (nbar, N_AUX, n), torch.int32),
        "gate_table": (gate_table, (s, d), dt),
        "wbig": (wbig, (8 * d, w), dt)}, n_out=w, s=s)
    dx = torch.empty_like(x)
    part = torch.empty((max(nbar, 1), s * d + w), dtype=f32,
                       device=x.device)
    out = torch.empty(s * d + w, dtype=f32, device=x.device)
    ptrs = (x.data_ptr(), g.data_ptr(), aux.data_ptr(), gate_table.data_ptr(),
            wbig.data_ptr(), dx.data_ptr(), part.data_ptr(), out.data_ptr())
    if s > MAX_STEPS:
        # the upstream planes between the long-bar form's two kernels (and
        # in bf16 dH_root m, which dx takes in fp32 until it is rounded)
        planes = 3 if dt == f32 else 4
        up = torch.empty((nbar, planes, n, d), dtype=f32, device=x.device)
        ptrs += (up.data_ptr(),)
    ptrs += (nbar,)
    name = "gcl_bwd_data" if dt == f32 else "gcl_bwd_data_bf16"
    launch(name, s, ptrs, (d, w), x.device)
    counts.count(name, s)
    count_cols(name, w, d)
    return dx, out[:s * d].view(s, d), out[s * d:]


def gcl_bwd_weight(x, g, aux, gate_table):
    """Weight half of the GCL backward for upstream g (nbar, n, w), w = d
    or a column shard's width: dWbig (8d, w) fp32, in the packed block
    order of `pack_weights`; x, g and gate_table in one dtype, fp32, or
    bf16 above MAX_STEPS on a card."""
    if not on_card("gcl_bwd_weight", x):
        return gcl_bwd_weight_plain(x, g, aux, gate_table)
    nbar, n, d = x.shape
    s = gate_table.shape[0]
    w = g.shape[-1]
    dt = x.dtype
    check_split_dtype("gcl_bwd_weight", dt, s)
    check_cuda_args("gcl_bwd_weight", x, {
        "x": (x, (nbar, n, d), dt), "g": (g, (nbar, n, w), dt),
        "aux": (aux, (nbar, N_AUX, n), torch.int32),
        "gate_table": (gate_table, (s, d), dt)}, n_out=w, s=s)
    dwbig = torch.empty((8 * d, w), dtype=torch.float32, device=x.device)
    name = "gcl_bwd_weight" if dt == torch.float32 else "gcl_bwd_weight_bf16"
    launch(name, s, (
        x.data_ptr(), g.data_ptr(), aux.data_ptr(), gate_table.data_ptr(),
        dwbig.data_ptr(), nbar), (d, w), x.device)
    counts.count(name, s)
    count_cols(name, w, d)
    return dwbig


def fused_messages(x, st, gate_table, s: int):
    """(h_track, h_self, h_onset, h_next), each (nbar, n, d) in
    `wide(x.dtype)`: the messages as `_bwd_fused_kernel` rebuilds them for
    the dW product, rounded to x's dtype where its body casts (so in bf16
    each is a bf16 value). st is `bar_statics(aux, gate_table, x.dtype)`."""
    cdt = x.dtype
    f32 = wide(cdt)

    def rnd(v):
        return v.to(cdt).to(f32)

    xf = x.to(f32)
    m = st.m.to(f32)
    r_tr, r_on, r_nx = (r.to(f32) for r in (st.rec_track, st.rec_on,
                                            st.rec_nx))

    def relu_pre(src, ok, gv):
        """relu(x[src] * G[dist]) through the gathered relation, 0 where
        the relation is not valid."""
        ok = ok.to(f32)
        return rnd(rows(xf, src) * ok * (gv.to(f32) * ok)).clamp(min=0)

    msg_sum = rnd(relu_pre(st.src_p, st.ok_p, st.g_p)
                  + relu_pre(st.src_n, st.ok_n, st.g_n))
    h_tr = rnd(msg_sum * r_tr)
    y = rnd(xf * gate_table[0].to(f32)).clamp(min=0) * m
    h_on = rnd(rnd(rnd(col_sum(y, s)) - y) * r_on)
    z = relu_pre(st.src_pn, st.ok_pn, st.g_pn)
    h_nx = rnd(rnd(rnd(col_sum(z, s)) - z) * r_nx)
    return h_tr, y * st.single.to(f32), h_on, h_nx


def rounded_data(x, g, aux, gate_table, wbig):
    """(dx in x's dtype, dgate, dbias): the data half of the backward as
    `_bwd_data_kernel` (and `_bwd_fused_kernel`) compute it in x's dtype.
    Every value is carried in `wide(x.dtype)` (fp32 for bf16) and `rnd`
    rounds it to x's dtype where the Pallas body casts to its compute dtype
    (the identity in fp32): the reciprocals, pre = x[src] g and pre0 = x
    g0, dnx and dcol before their column sums, and the shares relu'(pre) up
    g and relu'(pre) up x[src] before the scatters; dgate and dbias are
    sums in `wide(x.dtype)`."""
    cdt = x.dtype
    f32 = wide(cdt)

    def rnd(v):
        return v.to(cdt).to(f32)

    nbar, n, d = x.shape
    s = gate_table.shape[0]
    t = n // s
    gate_table = gate_table.to(cdt)
    st = bar_statics(aux, gate_table, cdt)
    xf, w = x.to(f32), wbig.to(cdt).to(f32)
    m = st.m.to(f32)
    gm = g.to(f32) * m
    r_tr, r_on, r_nx = (r.to(f32) for r in (st.rec_track, st.rec_on,
                                            st.rec_nx))
    dh4 = gm @ w[t * d:].t()
    dh_self, dh_on, dh_nx, dx = dh4.split(d, dim=-1)
    dx = dx.clone()
    dh_tr = torch.cat([gm[:, i * s:(i + 1) * s] @ w[i * d:(i + 1) * d].t()
                       for i in range(t)], dim=1)
    dgate = torch.zeros((s, d), dtype=f32, device=x.device)

    def scatter(src, dist, ok, gv, up):
        """relu'(pre) * up through the gathered relation (src, dist, ok):
        its share of dx and dgate."""
        xg, gr = rows(xf, src) * ok.to(f32), gv.to(f32) * ok.to(f32)
        dpre = up * (rnd(xg * gr) > 0).to(f32)
        dx.scatter_add_(1, src[..., None].expand(nbar, n, d), rnd(dpre * gr))
        dgate.index_add_(0, dist.reshape(-1), rnd(dpre * xg).reshape(-1, d))

    # track relations
    dmsg = dh_tr * r_tr
    scatter(st.src_p, st.dist_p, st.ok_p, st.g_p, dmsg)
    scatter(st.src_n, st.dist_n, st.ok_n, st.g_n, dmsg)
    # onset and self
    g0 = gate_table[0].to(f32)
    pre0 = rnd(xf * g0)
    dcol = rnd(dh_on * r_on)
    dy = col_sum(dcol, s) - dcol + dh_self * st.single.to(f32)
    dpre0 = dy * m * (pre0 > 0).to(f32)
    dx.add_(dpre0 * g0)
    dgate[0] += (dpre0 * xf).sum(dim=(0, 1))
    # next relation
    dnx = rnd(dh_nx * r_nx)
    scatter(st.src_pn, st.dist_pn, st.ok_pn, st.g_pn, col_sum(dnx, s) - dnx)
    return dx.to(cdt), dgate, gm.sum(dim=(0, 1))


def rounded_weight(x, g, aux, gate_table):
    """dWbig in `wide(x.dtype)`: the weight half of the backward as
    `_bwd_weight_kernel` (and `_bwd_fused_kernel`) compute it in x's dtype,
    the messages rebuilt with their roundings (`fused_messages`) and
    contracted with the masked upstream in `wide(x.dtype)`."""
    cdt = x.dtype
    f32 = wide(cdt)
    s = gate_table.shape[0]
    t = x.shape[1] // s
    gate_table = gate_table.to(cdt)
    st = bar_statics(aux, gate_table, cdt)
    gm = g.to(f32) * st.m.to(f32)
    h_tr, h_self, h_on, h_nx = fused_messages(x, st, gate_table, s)
    blocks = [_contract(h_tr[:, i * s:(i + 1) * s], gm[:, i * s:(i + 1) * s])
              for i in range(t)]
    blocks += [_contract(h, gm) for h in (h_self, h_on, h_nx, x.to(f32))]
    return torch.cat(blocks, dim=0)


def gcl_bwd_fused_plain(x, g, aux, gate_table, wbig):
    """Plain-PyTorch `gcl_bwd_fused`: the same arguments, the same result.

    The math of `_bwd_fused_kernel` in x's dtype, the two halves of the
    split backward with their roundings (`rounded_data`,
    `rounded_weight`)."""
    return (*rounded_data(x, g, aux, gate_table, wbig),
            rounded_weight(x, g, aux, gate_table))


def fused_chunks(nbar: int, d: int, sms: int) -> int:
    """Bar chunks of `gcl_bwd_fused` (of its dH kernel in bf16): one CTA per
    SM over the (d / 32) column tiles times the chunks."""
    return max(1, min(nbar, sms // (d // 32)))


def check_fused_form(dt, s: int, w: int, d: int) -> None:
    """Raise unless the fused backward's kernels take dtype dt at bars of 4
    x s cells and output width w of d: bf16 at every grid `gcl.check_grid`
    takes, fp32 (`csrc/gcl_bwd_fused.cu`, on no training path) at 4 x 32
    cells and w = d only."""
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"gcl_bwd_fused takes float32 or bfloat16, got {dt}")
    if dt == torch.float32 and w != d:
        raise ValueError(f"the fp32 fused backward takes the square weights "
                         f"only (n = d = {d}), got n = {w}")
    if dt == torch.float32 and s != BASE_STEPS:
        raise ValueError(
            f"the fp32 fused backward (csrc/gcl_bwd_fused.cu, on no training "
            f"path) takes 4x32-cell bars (resolution 8) only, got S={s}: "
            f"fp32 training runs gcl_bwd_data and gcl_bwd_weight")


def gcl_bwd_fused(x, g, aux, gate_table, wbig):
    """The whole GCL backward in one pass for upstream g (nbar, n, w), w =
    d or (bf16 only on a card) a column shard's width (wbig (8d, w)).

    x, g, gate_table (S, d) and wbig in one dtype, fp32 or bf16. Returns
    (dx (nbar, n, d) in x's dtype, dgate_table (S, d), dbias (w,), dwbig
    (8d, w) in the block order of `pack_weights`), the last three fp32 sums
    over every bar; dx and dgate sum over the w columns."""
    if not on_card("gcl_bwd_fused", x):
        return gcl_bwd_fused_plain(x, g, aux, gate_table, wbig)
    nbar, n, d = x.shape
    s = gate_table.shape[0]
    w = wbig.shape[-1]
    dt = x.dtype
    f32 = torch.float32
    check_fused_form(dt, s, w, d)
    check_cuda_args("gcl_bwd_fused", x, {
        "x": (x, (nbar, n, d), dt), "g": (g, (nbar, n, w), dt),
        "aux": (aux, (nbar, N_AUX, n), torch.int32),
        "gate_table": (gate_table, (s, d), dt),
        "wbig": (wbig, (8 * d, w), dt)}, n_out=w, s=s)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    chunks = fused_chunks(nbar, d, sms)
    dx = torch.empty_like(x)
    part_gb = torch.empty((chunks, s * d + w), dtype=f32, device=x.device)
    dwbig = torch.empty((8 * d, w), dtype=f32, device=x.device)
    out = torch.empty(s * d + w, dtype=f32, device=x.device)
    if dt == f32:
        # the fp32 form sums dWbig over per-chunk partials
        name = "gcl_bwd_fused"
        part_w = torch.empty((chunks, 8 * d, d), dtype=f32, device=x.device)
        scratch = (part_w.data_ptr(), part_gb.data_ptr())
        sizes = (d, chunks)
    else:
        # the bf16 form's dW kernel keeps its sums on chip
        name = "gcl_bwd_fused_bf16"
        scratch = (part_gb.data_ptr(),)
        sizes = (d, w, chunks)
    launch(name, s, (x.data_ptr(), g.data_ptr(), aux.data_ptr(),
                     gate_table.data_ptr(), wbig.data_ptr(), dx.data_ptr(),
                     *scratch, dwbig.data_ptr(), out.data_ptr(), nbar), sizes,
           x.device)
    counts.count("gcl_bwd_fused", s)
    if dt != f32:
        count_cols(name, w, d)
    return dx, out[:s * d].view(s, d), out[s * d:], dwbig


class GclFused(torch.autograd.Function):
    """The training GCL layer: `gcl_fwd` forward; backward by `gcl_bwd_data`
    and `gcl_bwd_weight` in fp32 and above MAX_STEPS (JAX's route in both
    dtypes), by `gcl_bwd_fused` in bf16 up to MAX_STEPS (the same outputs
    in one pass). No message intermediate is saved; the backward kernels
    recompute them from x.
    Each grad comes back in its input's dtype. With a column shard of the
    weights (rel_weight (6, d, n), root (d, n), bias (n,)) the output is
    those n columns and the grads of x and gate_table are partial sums."""

    @staticmethod
    def forward(ctx, x, gate_table, rel_weight, root, bias, aux, mask):
        if on_card("gcl_fused", x):  # refused before the forward runs
            check_grid("gcl_fused", x.shape[1], gate_table.shape[0], x.dtype)
        n_tracks = mask.shape[-2]
        wbig = pack_weights(rel_weight, root, n_tracks).contiguous()
        ctx.save_for_backward(x, gate_table, wbig, aux, mask)
        ctx.dtypes = (rel_weight.dtype, root.dtype, bias.dtype)
        return gcl_fwd(x, aux, gate_table, wbig, bias)

    @staticmethod
    def backward(ctx, g):
        x, gate_table, wbig, aux, mask = ctx.saved_tensors
        n_tracks = mask.shape[-2]
        d = x.shape[-1]
        g = g.contiguous().to(x.dtype)
        if x.dtype == torch.float32 or gate_table.shape[0] > MAX_STEPS:
            dx, dgate, dbias = gcl_bwd_data(x, g, aux, gate_table, wbig)
            dwbig = gcl_bwd_weight(x, g, aux, gate_table)
        else:
            dx, dgate, dbias, dwbig = gcl_bwd_fused(x, g, aux, gate_table,
                                                    wbig)
        blocks = dwbig.split(d, dim=0)
        # W0 is packed twice (track 0 and the self loop); root is the last
        d_rel = torch.stack([blocks[0] + blocks[n_tracks]]
                            + list(blocks[1:n_tracks])
                            + list(blocks[n_tracks + 1:n_tracks + 3]))
        droot = blocks[n_tracks + 3]
        rdt, odt, bdt = ctx.dtypes
        return (dx, dgate.to(gate_table.dtype), d_rel.to(rdt),
                droot.to(odt), dbias.to(bdt), None, None)


def gcl_fused(x, gate_table, rel_weight, root, bias, aux, mask):
    """Differentiable GCL layer on flat bars: x (nbar, n, d) contiguous,
    fp32 or bf16, and gate_table (S, d), rel_weight (6, d, w), root (d, w),
    bias (w,) in its dtype (w = d, or a column shard's width); aux (nbar,
    N_AUX, n) int32, mask (..., T, S) (only its track count is read).
    Returns (gcl(x) + bias) * m, (nbar, n, w)."""
    return GclFused.apply(x, gate_table, rel_weight, root, bias, aux, mask)
