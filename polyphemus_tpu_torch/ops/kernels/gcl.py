"""Lattice graph-conv layer forward: the eval stack and the training layer.

Counterpart of `polyphemus_tpu/ops/kernels/gcl_pallas.py`
(`gcl_apply_pallas` with and without `epilogue_affine`, and
`gcl_apply_pallas_chain`). On a CUDA tensor both wrappers launch
`csrc/gcl_eval_fp32.cu` in fp32 (fp32 FMAs on the CUDA cores) and
`csrc/gcl_eval_bf16_tc.cu` in bf16 (on the tensor cores): `gcl_eval` their
eval form, `gcl_fwd` the same kernel without the epilogue. Those take bars
of 4 x 32 cells (resolution 8); both wrappers send bars of 4 x S cells at
another S that is a multiple of 4 up to `MAX_STEPS` (resolutions 1-12) to
`csrc/gcl_eval_grid_fp32.cu` and `csrc/gcl_eval_grid_bf16_tc.cu` (their
eval form, and their training forward without the epilogue). Above
`MAX_STEPS` (resolutions 13 and up) `gcl_eval` launches
`csrc/gcl_eval_long_fp32.cu` or `csrc/gcl_eval_long_bf16_tc.cu` once a
layer (a CTA holds a tile of a bar, so chained layers cannot meet in one
launch), and `gcl_fwd` the training forward of the same sources, with the
square weights or a column shard. On a CPU tensor both wrappers run their
plain PyTorch version:

  * `gcl_eval`: K epilogue-fused layers per launch (generation, and the
    GCN of an eval step). Per layer and bar (n = T*S cells),
        out = relu(((gcl(x) + bias) * m * A + B) * m) + x,
    A, B the folded eval batch-norm affine (identity without batch-norm);
  * `gcl_fwd`: one layer without the epilogue, out = (gcl(x) + bias) * m,
    the forward of the training autograd function (`gcl_bwd.gcl_fused`).

gcl(x) = [h_track | h_self | h_onset | h_next | x] @ [W_t; W0; W_on; W_next;
root], W_t the row block's own track weight.

Column form (tensor parallelism, `parallel.mesh`): the packed weights may
hold n of the d output columns, (8d, n) with n % 128 == 0 dividing d, and
bias, ea, eb their n entries. Both wrappers then return those n columns of
the layer, (nbar, n_cells, n); `gcl_eval` takes them at K = 1 only, its
residual being x's columns col0..col0+n-1. n = d is the square launch.

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
from . import _build, counts

# aux channel layout (all int32, per flat cell i = t*S + c)
PREV_SRC, OK_P, DIST_P = 0, 1, 2
NEXT_SRC, OK_N, DIST_N = 3, 4, 5
PN_SRC, OK_PN, MSRC, DIST_PN = 6, 7, 8, 9
CNT_ON, CNT_NX, MASK_CH, SINGLE = 10, 11, 12, 13
N_AUX = 14

# the bar grids on the card: 4 tracks of S steps, S a multiple of 4;
# BASE_STEPS = 32 (resolution 8) is the grid of the first kernels, every
# other one up to MAX_STEPS goes to the `*_grid*.cu` sources, and above it
# the eval layer to the `gcl_eval_long_*.cu` ones, training to those and
# the long-bar backward sources (fp32: the split pair `gcl_bwd_*_long.cu`;
# bf16: the fused `gcl_bwd_fused_long_bf16_tc.cu`), square or in the column
# form
TRACKS, MAX_STEPS, BASE_STEPS = 4, 48, 32

# the wrappers count their launches in `counts.launches`; the column-form
# launches (n < d) among those of every GCL kernel, by the kernel names of
# `kernels.launch_counts`; counted beside the totals (the split backward's
# bf16 forms take S > MAX_STEPS only, on no training path: bf16 training
# runs the fused backward at every grid)
COL_KERNELS = ("gcl_eval", "gcl_eval_bf16", "gcl_fwd", "gcl_fwd_bf16",
               "gcl_bwd_data", "gcl_bwd_weight", "gcl_bwd_fused_bf16",
               "gcl_bwd_data_bf16", "gcl_bwd_weight_bf16")
col_launches: dict[str, int] = dict.fromkeys(COL_KERNELS, 0)


def count_cols(name: str, n: int, d: int) -> None:
    """Count a launch of kernel `name` in its column form (n < d)."""
    if n < d:
        col_launches[name] += 1


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
    """(n_rel, d, n) + (d, n) -> (8d, n): [W_t0..t3 | W0(self) | W_on |
    W_next | root]. W0 appears twice: as track 0's weight and the self
    loop's. n is d, or a column shard's width."""
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
    h_next | x] @ wbig with each row's own track block; (nbar, n_cells, n)
    for wbig (8d, n)."""
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


def gcl_eval_plain(x, aux, gate_table, wbigs, biases, eas, ebs, col0=0):
    """Plain-PyTorch `gcl_eval`: the same arguments, the same result, in
    x's dtype (the other tensors are taken in it)."""
    dt = x.dtype
    gate_table, wbigs, biases, eas, ebs = (
        v.to(dt) for v in (gate_table, wbigs, biases, eas, ebs))
    st = bar_statics(aux, gate_table, dt)
    n = wbigs.shape[-1]
    x_k = x
    for k in range(wbigs.shape[0]):
        out = _gcl_core(x_k, st, gate_table, wbigs[k], biases[k])
        x_k = torch.relu((out * eas[k] + ebs[k]) * st.m) \
            + x_k[..., col0:col0 + n]
    return x_k


def gcl_fwd_plain(x, aux, gate_table, wbig, bias):
    """Plain-PyTorch `gcl_fwd`: the same arguments, the same result, in
    x's dtype (the other tensors are taken in it)."""
    dt = x.dtype
    gate_table = gate_table.to(dt)
    return _gcl_core(x, bar_statics(aux, gate_table, dt), gate_table,
                     wbig.to(dt), bias.to(dt))


def _check_tracks(kernel: str, n: int, s: int) -> None:
    if n != TRACKS * s:
        raise ValueError(f"{kernel} kernel takes bars of {TRACKS} tracks, "
                         f"got {n} cells of {s} steps")


def check_grid(kernel: str, n: int, s: int, dt=torch.float32) -> None:
    """Raise unless a training kernel takes bars of n cells on the card in
    dtype dt, with the square weights or a column shard alike: 4 x s cells
    with s a multiple of 4, every resolution (the fused backward in bf16;
    the fp32 one's grid is 4 x 32 only, `gcl_bwd.check_fused_form`). dt
    changes nothing here: the wrappers refuse a dtype their kernels do not
    take, and the fp64 training layer runs the plain versions on the card
    (chip_smoke's fp64 witness)."""
    _check_tracks(kernel, n, s)
    if s < 4 or s % 4:
        raise ValueError(f"{kernel} kernel takes bars of 4 x S cells with S "
                         f"a multiple of 4, got S={s}")


def check_eval_grid(kernel: str, n: int, s: int, dt=None) -> None:
    """Raise unless bars of n cells are 4 x s with s a multiple of 4, the
    grids of the eval layer on the card (every resolution; dt is
    `check_grid`'s, and changes nothing here)."""
    _check_tracks(kernel, n, s)
    if s < 4 or s % 4:
        raise ValueError(f"{kernel} kernel takes bars of 4 x S cells with S "
                         f"a multiple of 4, got S={s}")


def check_cuda_args(kernel: str, x, want: dict, n_out=None, s=None,
                    grid=check_grid) -> None:
    """Raise unless x is (nbar, n, d) over bars of n = 4 s cells that
    `grid` takes in x's dtype (`check_grid`, the training kernels' grids,
    or `check_eval_grid`; s: the gate table's rows, by default 32) with d %
    128 == 0, the output width n_out (default d) has n_out % 128 == 0 and
    divides d, and every tensor of `want` ({name: (tensor, shape, dtype)})
    sits on x's device with that shape and dtype, contiguous and 16-byte
    aligned."""
    nbar, n, d = x.shape
    if d % 128 != 0:
        raise ValueError(f"{kernel} kernel takes d % 128 == 0, got d={d}")
    n_out = d if n_out is None else n_out
    grid(kernel, n, BASE_STEPS if s is None else s, x.dtype)
    if n_out <= 0 or n_out % 128 != 0 or d % n_out != 0:
        raise ValueError(f"{kernel} kernel takes an output width n with n % "
                         f"128 == 0 dividing d, got n={n_out} d={d}")
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


def launch(kernel: str, s: int, ptrs: tuple, sizes: tuple, device) -> None:
    """Launch `kernel` on `ptrs` (its pointers and nbar) and the `sizes`
    after them, on the current stream of `device`: its 4 x 32-cell form, or
    at another S up to MAX_STEPS its grid form (`<kernel>_grid`,
    `<kernel>_grid_bf16` for a bf16 kernel), above MAX_STEPS its long-bar
    form (`<kernel>_long`, `<kernel>_long_bf16`), each of which takes the
    steps s of a bar before the sizes."""
    stream = _build.stream_handle(device)
    if s != BASE_STEPS:
        base = kernel.removesuffix("_bf16")
        form = "_grid" if s <= MAX_STEPS else "_long"
        kernel = base + form + kernel[len(base):]
        sizes = (s, *sizes)
    _build.check(kernel, _build.launcher(kernel)(*ptrs, *sizes, stream))


def on_card(kernel: str, x) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel}: unsupported device {x.device}")
    return x.device.type == "cuda"


def gcl_eval(x, aux, gate_table, wbigs, biases, eas, ebs, col0=0):
    """K stacked epilogue-fused eval GCL layers over bars of n cells.

    x (nbar, n, d) f32 or bf16 masked node states over bars of n = 4 S
    cells; aux (nbar, N_AUX, n) int32 from `build_kernel_aux`; gate_table
    (S, d); wbigs (K, 8d, w) from
    `pack_weights`; biases, eas, ebs (K, w), each in x's dtype. Returns
    (nbar, n, w) in x's dtype. w is d, or at K = 1 the width of the column
    shard that starts at output column col0 (its residual x[..., col0:col0
    + w]). On the card every S % 4 == 0 is taken; above MAX_STEPS the K
    layers are K launches of the long-bar kernel.
    """
    k, w = wbigs.shape[0], wbigs.shape[-1]
    d = x.shape[-1]
    if k < 1:
        raise ValueError("gcl_eval: no layers")
    if (k > 1 and w != d) or col0 < 0 or col0 % w or col0 + w > d:
        raise ValueError(f"gcl_eval takes a column shard (width {w}, first "
                         f"column {col0}) of d = {d} columns at K = 1 only, "
                         f"got K = {k}")
    if not on_card("gcl_eval", x):
        return gcl_eval_plain(x, aux, gate_table, wbigs, biases, eas, ebs,
                              col0)
    nbar, n, _ = x.shape
    s = gate_table.shape[0]
    dt = x.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"gcl_eval takes float32 or bfloat16, got {dt}")
    check_cuda_args("gcl_eval", x, {
        "x": (x, (nbar, n, d), dt), "aux": (aux, (nbar, N_AUX, n), torch.int32),
        "gate_table": (gate_table, (s, d), dt),
        "wbigs": (wbigs, (k, 8 * d, w), dt), "biases": (biases, (k, w), dt),
        "eas": (eas, (k, w), dt), "ebs": (ebs, (k, w), dt)}, n_out=w, s=s,
        grid=check_eval_grid)
    name = "gcl_eval" if dt == torch.float32 else "gcl_eval_bf16"
    if s > MAX_STEPS:
        return _gcl_eval_long(name, x, aux, gate_table, wbigs, biases, eas,
                              ebs, col0)
    out = torch.empty((nbar, n, w), dtype=dt, device=x.device)
    scratch = torch.empty_like(x) if k > 1 else out
    launch(name, s, (x.data_ptr(), aux.data_ptr(), gate_table.data_ptr(),
                     wbigs.data_ptr(), biases.data_ptr(), eas.data_ptr(),
                     ebs.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                     nbar), (d, w, col0, k), x.device)
    counts.count(name, s, k)
    count_cols(name, w, d)
    return out


def _gcl_eval_long(name, x, aux, gate_table, wbigs, biases, eas, ebs,
                   col0):
    """`gcl_eval` over bars of 4 x S cells, S > MAX_STEPS, on the card: one
    launch of the long-bar kernel a layer, ping-ponging between the output
    and a scratch buffer so that the last layer writes the output; a column
    shard (width w < d, K = 1) is one launch writing (nbar, n, w)."""
    nbar, n, d = x.shape
    s = gate_table.shape[0]
    k, w = wbigs.shape[0], wbigs.shape[-1]
    out = torch.empty((nbar, n, w), dtype=x.dtype, device=x.device)
    scratch = torch.empty_like(x) if k > 1 else out
    src = x
    for i in range(k):
        dst = out if (k - 1 - i) % 2 == 0 else scratch
        launch(name, s, (src.data_ptr(), aux.data_ptr(),
                         gate_table.data_ptr(), wbigs[i].data_ptr(),
                         biases[i].data_ptr(), eas[i].data_ptr(),
                         ebs[i].data_ptr(), dst.data_ptr(), nbar),
               (d, w, col0), x.device)
        counts.count(name, s)
        count_cols(name, w, d)
        src = dst
    return out


def gcl_fwd(x, aux, gate_table, wbig, bias):
    """One training-forward GCL layer over bars of n cells.

    x (nbar, n, d) f32 or bf16; aux (nbar, N_AUX, n) int32 from
    `build_kernel_aux`; gate_table (S, d), wbig (8d, w) from `pack_weights`
    and bias (w,) in x's dtype, w = d or a column shard's width. Returns
    (gcl(x) + bias) * m, (nbar, n, w) in x's dtype. On the card bars of 4
    x 32 cells go to the eval kernels' training forward, the other grids up
    to MAX_STEPS to the grid kernels', and above it to the long-bar
    kernels' (`gcl_fwd_long`, `gcl_fwd_long_bf16`).
    """
    if not on_card("gcl_fwd", x):
        return gcl_fwd_plain(x, aux, gate_table, wbig, bias)
    nbar, n, d = x.shape
    s = gate_table.shape[0]
    w = wbig.shape[-1]
    dt = x.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"gcl_fwd takes float32 or bfloat16, got {dt}")
    check_cuda_args("gcl_fwd", x, {
        "x": (x, (nbar, n, d), dt), "aux": (aux, (nbar, N_AUX, n), torch.int32),
        "gate_table": (gate_table, (s, d), dt),
        "wbig": (wbig, (8 * d, w), dt), "bias": (bias, (w,), dt)}, n_out=w,
        s=s)
    out = torch.empty((nbar, n, w), dtype=dt, device=x.device)
    name = "gcl_fwd" if dt == torch.float32 else "gcl_fwd_bf16"
    launch(name, s, (x.data_ptr(), aux.data_ptr(), gate_table.data_ptr(),
                     wbig.data_ptr(), bias.data_ptr(), out.data_ptr(), nbar),
           (d, w), x.device)
    counts.count(name, s)
    count_cols(name, w, d)
    return out
