"""Eval GCL stack: K epilogue-fused lattice graph-conv layers per launch.

Counterpart of `polyphemus_tpu/ops/kernels/gcl_pallas.py`
(`gcl_apply_pallas` with `epilogue_affine`, and `gcl_apply_pallas_chain`).
On a CUDA tensor `gcl_eval` launches `csrc/gcl_eval.cu`; on a CPU tensor it
runs `gcl_eval_plain`, the same function in plain PyTorch.

Per layer and bar (n = T*S = 128 cells):
    out = relu(((gcl(x) + bias) * m * A + B) * m) + x
with gcl(x) = [h_track | h_self | h_onset | h_next | x] @ [W_t; W0; W_on;
W_next; root], W_t the row block's own track weight. A, B are the folded
eval batch-norm affine (identity without batch-norm).
"""
from __future__ import annotations

import torch

from .. import lattice
from . import _build

# aux channel layout (all int32, per flat cell i = t*S + c)
PREV_SRC, OK_P, DIST_P = 0, 1, 2
NEXT_SRC, OK_N, DIST_N = 3, 4, 5
PN_SRC, OK_PN, MSRC, DIST_PN = 6, 7, 8, 9
CNT_ON, CNT_NX, MASK_CH, SINGLE = 10, 11, 12, 13
N_AUX = 14

# kernel launches (not plain-path calls) since the count was last reset
launches = 0


def build_kernel_aux(mask: torch.Tensor) -> torch.Tensor:
    """mask (..., T, S) bool -> aux (..., N_AUX, T*S) int32."""
    t, s = mask.shape[-2], mask.shape[-1]
    nbr = lattice.build_neighbors(mask)
    iota_s = torch.arange(s, device=mask.device)
    row_base = (torch.arange(t, device=mask.device) * s)[:, None]
    shape = mask.shape

    def flat(v):
        v = v.expand(shape) if v.shape != shape else v
        return v.reshape(shape[:-2] + (t * s,)).to(torch.int32)

    pcol_b = nbr.prev_col[..., None, :].expand(shape)
    msrc = torch.gather(mask, -1, pcol_b).to(torch.int64)
    m_i = mask.to(torch.int64)
    chans = [None] * N_AUX
    chans[PREV_SRC] = flat(row_base + nbr.prev_in_row)
    chans[OK_P] = flat(nbr.prev_in_row_ok)
    chans[DIST_P] = flat((iota_s - nbr.prev_in_row).clamp(0, s - 1))
    chans[NEXT_SRC] = flat(row_base + nbr.next_in_row)
    chans[OK_N] = flat(nbr.next_in_row_ok)
    chans[DIST_N] = flat((nbr.next_in_row - iota_s).clamp(0, s - 1))
    chans[PN_SRC] = flat(row_base + pcol_b)
    chans[OK_PN] = flat(nbr.prev_col_ok[..., None, :])
    chans[MSRC] = flat(msrc)
    chans[DIST_PN] = flat((iota_s - nbr.prev_col).clamp(0, s - 1)[..., None, :])
    chans[CNT_ON] = flat(nbr.col_count[..., None, :] - m_i)
    chans[CNT_NX] = flat(msrc.sum(dim=-2, keepdim=True) - msrc)
    chans[MASK_CH] = flat(m_i)
    chans[SINGLE] = flat(nbr.single_node[..., None, None])
    return torch.stack(chans, dim=-2)


def pack_weights(rel_weight, root, n_tracks: int):
    """(n_rel, d, d) + (d, d) -> (8d, d): [W_t0..t3 | W0(self) | W_on |
    W_next | root]. W0 appears twice: as track 0's weight and the self
    loop's."""
    blocks = [rel_weight[i] for i in range(n_tracks)]
    blocks += [rel_weight[0], rel_weight[n_tracks], rel_weight[n_tracks + 1],
               root]
    return torch.cat(blocks, dim=0)


def gcl_eval_plain(x, aux, gate_table, wbigs, biases, eas, ebs):
    """Plain-PyTorch `gcl_eval`: the same arguments, the same result."""
    nbar, n, d = x.shape
    s = gate_table.shape[0]
    t = n // s
    dt = x.dtype

    def ch(c):
        return aux[:, c, :].to(torch.int64)

    def rows(v, idx):  # v at source cells idx (nbar, n)
        return torch.gather(v, 1, idx[..., None].expand(nbar, n, d))

    def recip(cnt, valid):
        r = 1.0 / cnt.clamp(min=1).to(dt)
        return torch.where(valid, r, torch.zeros((), dtype=dt,
                                                 device=x.device))

    m = (ch(MASK_CH) > 0).to(dt)[..., None]
    ok_p, ok_n = ch(OK_P), ch(OK_N)
    ok_pn = ((ch(OK_PN) > 0) & (ch(MSRC) > 0)).to(dt)[..., None]
    g_p, g_n, g_pn = (gate_table[ch(DIST_P)], gate_table[ch(DIST_N)],
                      gate_table[ch(DIST_PN)])
    cnt = ok_p + ok_n
    rec_track = recip(cnt, cnt > 0)[..., None] * m
    rec_on = recip(ch(CNT_ON), ch(CNT_ON) > 0)[..., None] * m
    rec_nx = recip(ch(CNT_NX), (ch(OK_PN) > 0) & (ch(CNT_NX) > 0))[..., None] * m
    single = ch(SINGLE).to(dt)[..., None]
    okp_f, okn_f = ok_p.to(dt)[..., None], ok_n.to(dt)[..., None]
    g0 = gate_table[0]

    def col_sum(v):  # same-column sum over the T tracks, broadcast back
        return v.reshape(nbar, t, s, d).sum(1, keepdim=True).expand(
            nbar, t, s, d).reshape(nbar, n, d)

    x_k = x
    for k in range(wbigs.shape[0]):
        wbig = wbigs[k]
        msg_p = torch.relu(rows(x_k, ch(PREV_SRC)) * g_p) * okp_f
        msg_n = torch.relu(rows(x_k, ch(NEXT_SRC)) * g_n) * okn_f
        h_track = (msg_p + msg_n) * rec_track
        y0 = torch.relu(x_k * g0) * m
        h_onset = (col_sum(y0) - y0) * rec_on
        z = torch.relu(rows(x_k, ch(PN_SRC)) * g_pn) * ok_pn
        h_next = (col_sum(z) - z) * rec_nx
        h_self = y0 * single
        hcat = torch.cat([h_self, h_onset, h_next, x_k], dim=-1)
        out = hcat @ wbig[t * d:] + biases[k]
        out = out + torch.cat(
            [h_track[:, i * s:(i + 1) * s] @ wbig[i * d:(i + 1) * d]
             for i in range(t)], dim=1)
        out = out * m
        x_k = torch.relu((out * eas[k] + ebs[k]) * m) + x_k
    return x_k


def _check_cuda_args(x, aux, gate_table, wbigs, biases, eas, ebs):
    nbar, n, d = x.shape
    k = wbigs.shape[0]
    want = {"x": (x, (nbar, n, d), torch.float32),
            "aux": (aux, (nbar, N_AUX, n), torch.int32),
            "gate_table": (gate_table, (32, d), torch.float32),
            "wbigs": (wbigs, (k, 8 * d, d), torch.float32),
            "biases": (biases, (k, d), torch.float32),
            "eas": (eas, (k, d), torch.float32),
            "ebs": (ebs, (k, d), torch.float32)}
    if n != 128 or d % 128 != 0 or k < 1:
        raise ValueError(f"gcl_eval kernel takes 4x32-cell bars and d % 128 "
                         f"== 0, got cells={n} d={d} layers={k}")
    for name, (v, shape, dtype) in want.items():
        if v.device != x.device:
            raise ValueError(f"gcl_eval: {name} is on {v.device}, x on "
                             f"{x.device}")
        if tuple(v.shape) != shape or v.dtype != dtype:
            raise ValueError(f"gcl_eval: {name} must be {dtype} {shape}, got "
                             f"{v.dtype} {tuple(v.shape)}")
        if not v.is_contiguous() or v.data_ptr() % 16:
            raise ValueError(f"gcl_eval: {name} must be contiguous and "
                             f"16-byte aligned")


def gcl_eval(x, aux, gate_table, wbigs, biases, eas, ebs):
    """K stacked epilogue-fused eval GCL layers over bars of n cells.

    x (nbar, n, d) f32 masked node states; aux (nbar, N_AUX, n) int32 from
    `build_kernel_aux`; gate_table (S, d); wbigs (K, 8d, d) from
    `pack_weights`; biases, eas, ebs (K, d). Returns (nbar, n, d).
    """
    global launches
    if x.device.type == "cpu":
        return gcl_eval_plain(x, aux, gate_table, wbigs, biases, eas, ebs)
    if x.device.type != "cuda":
        raise ValueError(f"gcl_eval: unsupported device {x.device}")
    _check_cuda_args(x, aux, gate_table, wbigs, biases, eas, ebs)
    nbar, _, d = x.shape
    k = wbigs.shape[0]
    out = torch.empty_like(x)
    scratch = torch.empty_like(x) if k > 1 else out
    fn = _build.launcher("gcl_eval")
    err = fn(x.data_ptr(), aux.data_ptr(), gate_table.data_ptr(),
             wbigs.data_ptr(), biases.data_ptr(), eas.data_ptr(),
             ebs.data_ptr(), out.data_ptr(), scratch.data_ptr(),
             nbar, d, k, _build.stream_handle(x.device))
    _build.check("gcl_eval", err)
    launches += 1
    return out
