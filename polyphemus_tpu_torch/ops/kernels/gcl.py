"""Lattice graph-conv layer forward: the eval stack and the training layer.

Counterpart of `polyphemus_tpu/ops/kernels/gcl_pallas.py`
(`gcl_apply_pallas` with and without `epilogue_affine`, and
`gcl_apply_pallas_chain`). Both wrappers launch `csrc/gcl_eval.cu` on a
CUDA tensor and run their plain PyTorch version on a CPU tensor:

  * `gcl_eval`: K epilogue-fused layers per launch (generation, and the
    GCN of an eval step). Per layer and bar (n = T*S = 128 cells),
        out = relu(((gcl(x) + bias) * m * A + B) * m) + x,
    A, B the folded eval batch-norm affine (identity without batch-norm);
  * `gcl_fwd`: one layer without the epilogue, out = (gcl(x) + bias) * m,
    the forward of the training autograd function (`gcl_bwd.gcl_fused`).

gcl(x) = [h_track | h_self | h_onset | h_next | x] @ [W_t; W0; W_on; W_next;
root], W_t the row block's own track weight.

The compute dtype is x's (fp32 or bf16). In bf16 the plain versions round
to bf16 where the Pallas body casts to its compute dtype (`_bar_statics`,
`_layer_math` of `gcl_pallas.py`): each elementwise product, the mean
reciprocals, the same-column sums, and each of the two projection products
(`base = dot(...) + bias`, then `+ dot(h_track, W_t)`); every product takes
bf16 inputs and sums in fp32. In fp32 no rounding step changes a value.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import lattice
from . import _build

# aux channel layout (all int32, per flat cell i = t*S + c)
PREV_SRC, OK_P, DIST_P = 0, 1, 2
NEXT_SRC, OK_N, DIST_N = 3, 4, 5
PN_SRC, OK_PN, MSRC, DIST_PN = 6, 7, 8, 9
CNT_ON, CNT_NX, MASK_CH, SINGLE = 10, 11, 12, 13
N_AUX = 14

# kernel launches (not plain-path calls) since the counts were last reset:
# `gcl_eval` and `gcl_fwd`, each in fp32 and in bf16
launches = 0
eval_bf16_launches = 0
fwd_launches = 0
fwd_bf16_launches = 0


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


class BarStatics(NamedTuple):
    """The per-bar parts of the GCL math that do not depend on x: source
    rows and gate rows of the three gathered relations (with their validity
    as 0/1 floats), the masked mean reciprocals, the mask and the
    single-node flag, each (nbar, n) or (nbar, n, d)."""

    m: torch.Tensor
    src_p: torch.Tensor
    src_n: torch.Tensor
    src_pn: torch.Tensor
    g_p: torch.Tensor
    g_n: torch.Tensor
    g_pn: torch.Tensor
    dist_p: torch.Tensor
    dist_n: torch.Tensor
    dist_pn: torch.Tensor
    ok_p: torch.Tensor
    ok_n: torch.Tensor
    ok_pn: torch.Tensor
    rec_track: torch.Tensor
    rec_on: torch.Tensor
    rec_nx: torch.Tensor
    single: torch.Tensor


def wide(dt):
    """The dtype the plain versions carry dt's values in: dt, and fp32 for
    a 2-byte dt."""
    return torch.promote_types(dt, torch.float32)


def bar_statics(aux, gate_table, dt) -> BarStatics:
    """Decode aux (nbar, N_AUX, n) into `BarStatics` for gate_table (S, d);
    the reciprocals are taken in `wide(dt)` and rounded to dt."""
    def ch(c):
        return aux[:, c, :].to(torch.int64)

    def recip(cnt, valid):
        r = (1.0 / cnt.clamp(min=1).to(wide(dt))).to(dt)
        return torch.where(valid, r, torch.zeros((), dtype=dt,
                                                 device=aux.device))

    m = (ch(MASK_CH) > 0).to(dt)[..., None]
    ok_p, ok_n = ch(OK_P), ch(OK_N)
    cnt = ok_p + ok_n
    return BarStatics(
        m=m, src_p=ch(PREV_SRC), src_n=ch(NEXT_SRC), src_pn=ch(PN_SRC),
        g_p=gate_table[ch(DIST_P)], g_n=gate_table[ch(DIST_N)],
        g_pn=gate_table[ch(DIST_PN)],
        dist_p=ch(DIST_P), dist_n=ch(DIST_N), dist_pn=ch(DIST_PN),
        ok_p=ok_p.to(dt)[..., None], ok_n=ok_n.to(dt)[..., None],
        ok_pn=((ch(OK_PN) > 0) & (ch(MSRC) > 0)).to(dt)[..., None],
        rec_track=recip(cnt, cnt > 0)[..., None] * m,
        rec_on=recip(ch(CNT_ON), ch(CNT_ON) > 0)[..., None] * m,
        rec_nx=recip(ch(CNT_NX), (ch(OK_PN) > 0) & (ch(CNT_NX) > 0))[
            ..., None] * m,
        single=ch(SINGLE).to(dt)[..., None])


def rows(v, idx):
    """v (nbar, n, d) at the source cells idx (nbar, n)."""
    return torch.gather(v, 1, idx[..., None].expand(v.shape))


def col_sum(v, s: int):
    """Same-column sum over the tracks of v (nbar, T*s, d), summed in
    `wide(v.dtype)` and rounded to v's dtype, broadcast back to every
    track."""
    nbar, n, d = v.shape
    t = n // s
    return v.to(wide(v.dtype)).reshape(nbar, t, s, d).sum(
        1, keepdim=True).to(v.dtype).expand(nbar, t, s, d).reshape(nbar, n, d)


def mm(a, b):
    """a @ b in a's dtype: the inputs' values multiplied and summed in
    `wide(a.dtype)`, the result rounded once."""
    w = wide(a.dtype)
    return (a.to(w) @ b.to(w)).to(a.dtype)


def messages(x, st: BarStatics, g0, s: int):
    """(h_track, h_self, h_onset, h_next), each (nbar, n, d): the mean
    messages of the lattice relations, as the forward kernel builds them."""
    msg_p = torch.relu(rows(x, st.src_p) * st.g_p) * st.ok_p
    msg_n = torch.relu(rows(x, st.src_n) * st.g_n) * st.ok_n
    h_track = (msg_p + msg_n) * st.rec_track
    y0 = torch.relu(x * g0) * st.m
    h_onset = (col_sum(y0, s) - y0) * st.rec_on
    z = torch.relu(rows(x, st.src_pn) * st.g_pn) * st.ok_pn
    h_next = (col_sum(z, s) - z) * st.rec_nx
    return h_track, y0 * st.single, h_onset, h_next


def _gcl_core(x, st: BarStatics, gate_table, wbig, bias):
    """(gcl(x) + bias) * m for one layer: [h_track | h_self | h_onset |
    h_next | x] @ wbig with each row's own track block."""
    nbar, n, d = x.shape
    s = gate_table.shape[0]
    t = n // s
    h_track, h_self, h_onset, h_next = messages(x, st, gate_table[0], s)
    hcat = torch.cat([h_self, h_onset, h_next, x], dim=-1)
    out = mm(hcat, wbig[t * d:]) + bias
    out = out + torch.cat(
        [mm(h_track[:, i * s:(i + 1) * s], wbig[i * d:(i + 1) * d])
         for i in range(t)], dim=1)
    return out * st.m


def gcl_eval_plain(x, aux, gate_table, wbigs, biases, eas, ebs):
    """Plain-PyTorch `gcl_eval`: the same arguments, the same result, in
    x's dtype (the other tensors are taken in it)."""
    dt = x.dtype
    gate_table, wbigs, biases, eas, ebs = (
        v.to(dt) for v in (gate_table, wbigs, biases, eas, ebs))
    st = bar_statics(aux, gate_table, dt)
    x_k = x
    for k in range(wbigs.shape[0]):
        out = _gcl_core(x_k, st, gate_table, wbigs[k], biases[k])
        x_k = torch.relu((out * eas[k] + ebs[k]) * st.m) + x_k
    return x_k


def gcl_fwd_plain(x, aux, gate_table, wbig, bias):
    """Plain-PyTorch `gcl_fwd`: the same arguments, the same result, in
    x's dtype (the other tensors are taken in it)."""
    dt = x.dtype
    gate_table = gate_table.to(dt)
    return _gcl_core(x, bar_statics(aux, gate_table, dt), gate_table,
                     wbig.to(dt), bias.to(dt))


def check_cuda_args(kernel: str, x, want: dict) -> None:
    """Raise unless x is (nbar, 128, d) with d % 128 == 0 and every tensor of
    `want` ({name: (tensor, shape, dtype)}) sits on x's device with that
    shape and dtype, contiguous and 16-byte aligned."""
    nbar, n, d = x.shape
    if n != 128 or d % 128 != 0:
        raise ValueError(f"{kernel} kernel takes 4x32-cell bars and d % 128 "
                         f"== 0, got cells={n} d={d}")
    for name, (v, shape, dtype) in want.items():
        if v.device != x.device:
            raise ValueError(f"{kernel}: {name} is on {v.device}, x on "
                             f"{x.device}")
        if tuple(v.shape) != tuple(shape) or v.dtype != dtype:
            raise ValueError(f"{kernel}: {name} must be {dtype} {shape}, got "
                             f"{v.dtype} {tuple(v.shape)}")
        if not v.is_contiguous() or v.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} must be contiguous and "
                             f"16-byte aligned")


def on_card(kernel: str, x) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel}: unsupported device {x.device}")
    return x.device.type == "cuda"


def gcl_eval(x, aux, gate_table, wbigs, biases, eas, ebs):
    """K stacked epilogue-fused eval GCL layers over bars of n cells.

    x (nbar, n, d) f32 or bf16 masked node states; aux (nbar, N_AUX, n)
    int32 from `build_kernel_aux`; gate_table (S, d); wbigs (K, 8d, d) from
    `pack_weights`; biases, eas, ebs (K, d), each in x's dtype. Returns
    (nbar, n, d) in x's dtype.
    """
    global launches, eval_bf16_launches
    if not on_card("gcl_eval", x):
        return gcl_eval_plain(x, aux, gate_table, wbigs, biases, eas, ebs)
    nbar, n, d = x.shape
    k = wbigs.shape[0]
    if k < 1:
        raise ValueError("gcl_eval: no layers")
    dt = x.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"gcl_eval takes float32 or bfloat16, got {dt}")
    check_cuda_args("gcl_eval", x, {
        "x": (x, (nbar, n, d), dt), "aux": (aux, (nbar, N_AUX, n), torch.int32),
        "gate_table": (gate_table, (32, d), dt),
        "wbigs": (wbigs, (k, 8 * d, d), dt), "biases": (biases, (k, d), dt),
        "eas": (eas, (k, d), dt), "ebs": (ebs, (k, d), dt)})
    out = torch.empty_like(x)
    scratch = torch.empty_like(x) if k > 1 else out
    name = "gcl_eval" if dt == torch.float32 else "gcl_eval_bf16"
    err = _build.launcher(name)(
        x.data_ptr(), aux.data_ptr(), gate_table.data_ptr(), wbigs.data_ptr(),
        biases.data_ptr(), eas.data_ptr(), ebs.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), nbar, d, k, _build.stream_handle(x.device))
    _build.check(name, err)
    if dt == torch.float32:
        launches += 1
    else:
        eval_bf16_launches += 1
    return out


def gcl_fwd(x, aux, gate_table, wbig, bias):
    """One training-forward GCL layer over bars of n cells.

    x (nbar, n, d) f32 or bf16; aux (nbar, N_AUX, n) int32 from
    `build_kernel_aux`; gate_table (S, d), wbig (8d, d) from `pack_weights`
    and bias (d,) in x's dtype. Returns (gcl(x) + bias) * m, (nbar, n, d)
    in x's dtype.
    """
    global fwd_launches, fwd_bf16_launches
    if not on_card("gcl_fwd", x):
        return gcl_fwd_plain(x, aux, gate_table, wbig, bias)
    nbar, n, d = x.shape
    dt = x.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"gcl_fwd takes float32 or bfloat16, got {dt}")
    check_cuda_args("gcl_fwd", x, {
        "x": (x, (nbar, n, d), dt), "aux": (aux, (nbar, N_AUX, n), torch.int32),
        "gate_table": (gate_table, (32, d), dt),
        "wbig": (wbig, (8 * d, d), dt), "bias": (bias, (d,), dt)})
    out = torch.empty_like(x)
    name = "gcl_fwd" if dt == torch.float32 else "gcl_fwd_bf16"
    err = _build.launcher(name)(
        x.data_ptr(), aux.data_ptr(), gate_table.data_ptr(), wbig.data_ptr(),
        bias.data_ptr(), out.data_ptr(), nbar, d,
        _build.stream_handle(x.device))
    _build.check(name, err)
    if dt == torch.float32:
        fwd_launches += 1
    else:
        fwd_bf16_launches += 1
    return out
