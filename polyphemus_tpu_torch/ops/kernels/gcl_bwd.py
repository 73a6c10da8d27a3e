"""Lattice graph-conv layer backward, and the training autograd function.

Counterpart of `polyphemus_tpu/ops/kernels/gcl_pallas_bwd.py`
(`gcl_backward_pallas`: kernel A `_bwd_data_kernel`, kernel B
`_bwd_weight_kernel`; `gcl_backward_fused`: `_bwd_fused_kernel`) and of the
custom VJP `gcl_fused` of `gcl_pallas.py`. On a CUDA tensor `gcl_bwd_data`
launches `csrc/gcl_bwd_data.cu`, `gcl_bwd_weight` `csrc/gcl_bwd_weight.cu`
and `gcl_bwd_fused` `csrc/gcl_bwd_fused.cu`; on a CPU tensor each runs its
plain PyTorch version, which follows the equations of the forward
(`gcl.gcl_fwd`):

    msg_p = relu(x[src_p] * G[dist_p]),  msg_n = relu(x[src_n] * G[dist_n])
    h_track = (msg_p + msg_n) * r_tr * m
    y0 = relu(x * g0) * m
    h_onset = (colsum(y0) - y0) * r_on * m
    z = relu(x[src_pn] * G[dist_pn])            (valid sources only)
    h_next = (colsum(z) - z) * r_nx * m
    h_self = y0 * single
    out = ([h_track | h_self | h_onset | h_next | x] @ Wbig + b) * m

with the track block of Wbig chosen by each row's own track. The training
layer takes the data and weight pair in fp32 and the fused single pass in
bf16.
"""
from __future__ import annotations

import torch

from . import _build
from .gcl import (N_AUX, bar_statics, check_cuda_args, col_sum, gcl_fwd,
                  messages, on_card, pack_weights, rows, wide)

# kernel launches (not plain-path calls) since the counts were last reset
data_launches = 0
weight_launches = 0
fused_launches = 0


def gcl_bwd_data_plain(x, g, aux, gate_table, wbig):
    """Plain-PyTorch `gcl_bwd_data`: the same arguments, the same result."""
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
    """Plain-PyTorch `gcl_bwd_weight`: the same arguments, the same result."""
    nbar, n, d = x.shape
    s = gate_table.shape[0]
    t = n // s
    st = bar_statics(aux, gate_table, x.dtype)
    gm = g * st.m
    h_tr, h_self, h_on, h_nx = messages(x, st, gate_table[0], s)

    def contract(h, gg):
        return h.reshape(-1, d).t() @ gg.reshape(-1, d)

    blocks = [contract(h_tr[:, i * s:(i + 1) * s], gm[:, i * s:(i + 1) * s])
              for i in range(t)]
    blocks += [contract(h, gm) for h in (h_self, h_on, h_nx, x)]
    return torch.cat(blocks, dim=0)


def gcl_bwd_data(x, g, aux, gate_table, wbig):
    """Data half of the GCL backward for upstream g (nbar, n, d).

    Returns (dx (nbar, n, d), dgate_table (S, d), dbias (d,)); dgate and
    dbias sum over every bar."""
    global data_launches
    if not on_card("gcl_bwd_data", x):
        return gcl_bwd_data_plain(x, g, aux, gate_table, wbig)
    nbar, n, d = x.shape
    f32 = torch.float32
    check_cuda_args("gcl_bwd_data", x, {
        "x": (x, (nbar, n, d), f32), "g": (g, (nbar, n, d), f32),
        "aux": (aux, (nbar, N_AUX, n), torch.int32),
        "gate_table": (gate_table, (32, d), f32),
        "wbig": (wbig, (8 * d, d), f32)})
    dx = torch.empty_like(x)
    part = torch.empty((max(nbar, 1), 33 * d), dtype=f32, device=x.device)
    out = torch.empty(33 * d, dtype=f32, device=x.device)
    err = _build.launcher("gcl_bwd_data")(
        x.data_ptr(), g.data_ptr(), aux.data_ptr(), gate_table.data_ptr(),
        wbig.data_ptr(), dx.data_ptr(), part.data_ptr(), out.data_ptr(),
        nbar, d, _build.stream_handle(x.device))
    _build.check("gcl_bwd_data", err)
    data_launches += 1
    return dx, out[:32 * d].view(32, d), out[32 * d:]


def weight_chunks(nbar: int, d: int) -> int:
    """Bar chunks of `gcl_bwd_weight`: enough CTAs (64 x 64 tiles of the
    eight blocks, times the chunks) to fill the card twice over."""
    tiles = 8 * (d // 64) ** 2
    return max(1, min(nbar, -(-2048 // tiles)))


def gcl_bwd_weight(x, g, aux, gate_table):
    """Weight half of the GCL backward for upstream g (nbar, n, d): dWbig
    (8d, d), in the packed block order of `pack_weights`."""
    global weight_launches
    if not on_card("gcl_bwd_weight", x):
        return gcl_bwd_weight_plain(x, g, aux, gate_table)
    nbar, n, d = x.shape
    f32 = torch.float32
    check_cuda_args("gcl_bwd_weight", x, {
        "x": (x, (nbar, n, d), f32), "g": (g, (nbar, n, d), f32),
        "aux": (aux, (nbar, N_AUX, n), torch.int32),
        "gate_table": (gate_table, (32, d), f32)})
    chunks = weight_chunks(nbar, d)
    part = torch.empty((chunks, 8 * d, d), dtype=f32, device=x.device)
    dwbig = torch.empty((8 * d, d), dtype=f32, device=x.device)
    err = _build.launcher("gcl_bwd_weight")(
        x.data_ptr(), g.data_ptr(), aux.data_ptr(), gate_table.data_ptr(),
        part.data_ptr(), dwbig.data_ptr(), nbar, d, chunks,
        _build.stream_handle(x.device))
    _build.check("gcl_bwd_weight", err)
    weight_launches += 1
    return dwbig


def gcl_bwd_fused_plain(x, g, aux, gate_table, wbig):
    """Plain-PyTorch `gcl_bwd_fused`: the same arguments, the same result.

    The math of `_bwd_fused_kernel` in x's dtype: every value is carried in
    `wide(x.dtype)` (fp32 for bf16) and `rnd` rounds it to x's dtype where
    the Pallas body casts to its compute dtype (the identity in fp32)."""
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
        its share of dx and dgate; returns relu(pre)."""
        xg, gr = rows(xf, src) * ok.to(f32), gv.to(f32) * ok.to(f32)
        pre = rnd(xg * gr)
        dpre = up * (pre > 0).to(f32)
        dx.scatter_add_(1, src[..., None].expand(nbar, n, d), rnd(dpre * gr))
        dgate.index_add_(0, dist.reshape(-1), rnd(dpre * xg).reshape(-1, d))
        return pre.clamp(min=0)

    # track relations: h_track and their share of dx, dgate
    dmsg = dh_tr * r_tr
    msg_sum = rnd(scatter(st.src_p, st.dist_p, st.ok_p, st.g_p, dmsg)
                  + scatter(st.src_n, st.dist_n, st.ok_n, st.g_n, dmsg))
    h_tr = rnd(msg_sum * r_tr)
    # onset and self
    g0 = gate_table[0].to(f32)
    pre0 = rnd(xf * g0)
    y = pre0.clamp(min=0) * m
    h_on = rnd(rnd(rnd(col_sum(y, s)) - y) * r_on)
    h_self = y * st.single.to(f32)
    dcol = rnd(dh_on * r_on)
    dy = col_sum(dcol, s) - dcol + dh_self * st.single.to(f32)
    dpre0 = dy * m * (pre0 > 0).to(f32)
    dx.add_(dpre0 * g0)
    dgate[0] += (dpre0 * xf).sum(dim=(0, 1))
    # next relation
    dnx = rnd(dh_nx * r_nx)
    z = scatter(st.src_pn, st.dist_pn, st.ok_pn, st.g_pn,
                col_sum(dnx, s) - dnx)
    h_nx = rnd(rnd(rnd(col_sum(z, s)) - z) * r_nx)

    def contract(h, gg):
        return h.reshape(-1, d).t() @ gg.reshape(-1, d)

    blocks = [contract(h_tr[:, i * s:(i + 1) * s], gm[:, i * s:(i + 1) * s])
              for i in range(t)]
    blocks += [contract(h, gm) for h in (h_self, h_on, h_nx, xf)]
    return dx.to(cdt), dgate, gm.sum(dim=(0, 1)), torch.cat(blocks, dim=0)


def fused_chunks(nbar: int, d: int, sms: int) -> int:
    """Bar chunks of `gcl_bwd_fused`: one CTA per SM over the (d / 32)
    column tiles times the chunks."""
    return max(1, min(nbar, sms // (d // 32)))


def gcl_bwd_fused(x, g, aux, gate_table, wbig):
    """The whole GCL backward in one pass for upstream g (nbar, n, d).

    x, g, gate_table (S, d) and wbig (8d, d) in one dtype, fp32 or bf16.
    Returns (dx (nbar, n, d) in x's dtype, dgate_table (S, d), dbias (d,),
    dwbig (8d, d) in the block order of `pack_weights`), the last three
    fp32 sums over every bar."""
    global fused_launches
    if not on_card("gcl_bwd_fused", x):
        return gcl_bwd_fused_plain(x, g, aux, gate_table, wbig)
    nbar, n, d = x.shape
    dt = x.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"gcl_bwd_fused takes float32 or bfloat16, got {dt}")
    check_cuda_args("gcl_bwd_fused", x, {
        "x": (x, (nbar, n, d), dt), "g": (g, (nbar, n, d), dt),
        "aux": (aux, (nbar, N_AUX, n), torch.int32),
        "gate_table": (gate_table, (32, d), dt),
        "wbig": (wbig, (8 * d, d), dt)})
    f32 = torch.float32
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    chunks = fused_chunks(nbar, d, sms)
    dx = torch.empty_like(x)
    part_w = torch.empty((chunks, 8 * d, d), dtype=f32, device=x.device)
    part_gb = torch.empty((chunks, 33 * d), dtype=f32, device=x.device)
    dwbig = torch.empty((8 * d, d), dtype=f32, device=x.device)
    out = torch.empty(33 * d, dtype=f32, device=x.device)
    name = "gcl_bwd_fused" if dt == f32 else "gcl_bwd_fused_bf16"
    err = _build.launcher(name)(
        x.data_ptr(), g.data_ptr(), aux.data_ptr(), gate_table.data_ptr(),
        wbig.data_ptr(), dx.data_ptr(), part_w.data_ptr(), part_gb.data_ptr(),
        dwbig.data_ptr(), out.data_ptr(), nbar, d, chunks,
        _build.stream_handle(x.device))
    _build.check(name, err)
    fused_launches += 1
    return dx, out[:32 * d].view(32, d), out[32 * d:], dwbig


class GclFused(torch.autograd.Function):
    """The training GCL layer: `gcl_fwd` forward; backward by `gcl_bwd_data`
    and `gcl_bwd_weight` in fp32, by `gcl_bwd_fused` in bf16. No message
    intermediate is saved; the backward kernels recompute them from x.
    Each grad comes back in its input's dtype."""

    @staticmethod
    def forward(ctx, x, gate_table, rel_weight, root, bias, aux, mask):
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
        if x.dtype == torch.float32:
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
    fp32 or bf16, and gate_table (S, d), rel_weight (6, d, d), root (d, d),
    bias (d,) in its dtype; aux (nbar, N_AUX, n) int32, mask (..., T, S)
    (only its track count is read). Returns (gcl(x) + bias) * m, (nbar, n,
    d)."""
    return GclFused.apply(x, gate_table, rel_weight, root, bias, aux, mask)
