"""Dense bar-lattice graph operations (eval form), in PyTorch.

Counterpart of `polyphemus_tpu/ops/lattice.py`. Nodes are all
`n_tracks x n_timesteps` cells of a bar, with a boolean activation mask; the
six edge relations are pure functions of the mask:

  * TRACK t (t in 0..3): consecutive active cells within row t, both ways;
  * ONSET: all pairs of active cells in the same column, both ways;
  * NEXT: every cross-track pair from an active column to the next active
    column, forward only.

Message semantics follow the reference GCL: per-edge message
`relu(x_src * gate(dist))`, mean-aggregated per relation per destination,
then `sum_r h_r @ W_r + x @ root + bias`. Quirks reproduced: an empty bar
gets a fake activation at cell [0, 0] (`ensure_nonempty_bars`), and a bar
with a single active cell gets a self-edge of relation 0 at distance 0.

`gcl_apply` is the plain reference the `gcl_eval` kernel is tested against.
Message dropout (training) is not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


def ensure_nonempty_bars(mask: torch.Tensor) -> torch.Tensor:
    """Force cell [0, 0] active in bars with no activations.

    mask: (..., n_tracks, n_timesteps) bool.
    """
    empty = ~mask.any(dim=-1, keepdim=True).any(dim=-2, keepdim=True)
    cell00 = torch.zeros(mask.shape[-2:], dtype=torch.bool, device=mask.device)
    cell00[0, 0] = True
    return mask | (empty & cell00)


class LatticeNeighbors(NamedTuple):
    """Static-shape neighbour structure derived from an activation mask.

    Index tensors are int64 (torch's gather index type) and clipped into
    range; validity is carried in the companion boolean.
    """

    # Previous/next active cell in the same row: (..., T, S)
    prev_in_row: torch.Tensor
    prev_in_row_ok: torch.Tensor
    next_in_row: torch.Tensor
    next_in_row_ok: torch.Tensor
    # Previous active column (any track): (..., S)
    prev_col: torch.Tensor
    prev_col_ok: torch.Tensor
    # Active tracks per column: (..., S)
    col_count: torch.Tensor
    # Bars with exactly one active cell (self-loop quirk): (...,) bool
    single_node: torch.Tensor


def _prev_scan(m: torch.Tensor) -> torch.Tensor:
    """Index of the previous True along the last axis (exclusive), or -1."""
    s = m.shape[-1]
    iota = torch.arange(s, device=m.device)
    vals = torch.where(m, iota, torch.full_like(iota, -1))
    incl = torch.cummax(vals, dim=-1).values
    first = torch.full(m.shape[:-1] + (1,), -1, dtype=incl.dtype,
                       device=m.device)
    return torch.cat([first, incl[..., :-1]], dim=-1)


def _next_scan(m: torch.Tensor) -> torch.Tensor:
    """Index of the next True along the last axis (exclusive), or S."""
    s = m.shape[-1]
    iota = torch.arange(s, device=m.device)
    vals = torch.where(m, iota, torch.full_like(iota, s))
    incl = torch.cummin(vals.flip(-1), dim=-1).values.flip(-1)
    last = torch.full(m.shape[:-1] + (1,), s, dtype=incl.dtype,
                      device=m.device)
    return torch.cat([incl[..., 1:], last], dim=-1)


def build_neighbors(mask: torch.Tensor) -> LatticeNeighbors:
    """Lattice neighbour indices from mask (..., T, S) bool."""
    s = mask.shape[-1]
    prev_row = _prev_scan(mask)
    next_row = _next_scan(mask)
    col_active = mask.any(dim=-2)  # (..., S)
    prev_col = _prev_scan(col_active)
    m_i = mask.to(torch.int64)
    return LatticeNeighbors(
        prev_in_row=prev_row.clamp(min=0),
        prev_in_row_ok=prev_row >= 0,
        next_in_row=next_row.clamp(max=s - 1),
        next_in_row_ok=next_row < s,
        prev_col=prev_col.clamp(min=0),
        prev_col_ok=prev_col >= 0,
        col_count=m_i.sum(dim=-2),
        single_node=m_i.sum(dim=(-1, -2)) == 1,
    )


def _gather_time(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather x (..., S, d) at time indices idx (..., S) -> (..., S, d)."""
    idx = idx.expand(x.shape[:-1])
    return torch.gather(x, -2, idx[..., None].expand(x.shape))


def relational_messages(x, mask, nbr: LatticeNeighbors, gate_table):
    """Mean-aggregated per-relation messages over the lattice (eval form).

    x: (..., T, S, d) node states, zero at inactive cells; mask (..., T, S);
    gate_table (S, d). Returns (h_track, h_onset, h_next, h_self), each
    (..., T, S, d): row t of h_track holds relation t; h_self is the
    single-node self-edge message, routed through relation 0's weight.
    """
    s = mask.shape[-1]
    dt = x.dtype
    iota = torch.arange(s, device=x.device)
    m_f = mask.to(dt)[..., None]

    # TRACK relations: previous/next active cell in the same row
    xp = _gather_time(x, nbr.prev_in_row)
    gp = gate_table[(iota - nbr.prev_in_row).clamp(0, s - 1)]
    ok_p = nbr.prev_in_row_ok[..., None].to(dt)
    msg_p = torch.relu(xp * gp) * ok_p
    xn = _gather_time(x, nbr.next_in_row)
    gn = gate_table[(nbr.next_in_row - iota).clamp(0, s - 1)]
    ok_n = nbr.next_in_row_ok[..., None].to(dt)
    msg_n = torch.relu(xn * gn) * ok_n
    cnt = ok_p + ok_n
    h_track = torch.where(cnt > 0, (msg_p + msg_n) / cnt.clamp(min=1),
                          torch.zeros((), dtype=dt, device=x.device))
    h_track = h_track * m_f

    # ONSET relation: the other active tracks of the same column
    y0 = torch.relu(x * gate_table[0]) * m_f
    cnt_on = (nbr.col_count[..., None, :] - mask.to(torch.int64))[..., None]
    col_sum = y0.sum(dim=-3, keepdim=True)
    h_onset = (col_sum - y0) / cnt_on.clamp(min=1).to(dt)
    h_onset = torch.where((cnt_on > 0) & (m_f > 0), h_onset,
                          torch.zeros((), dtype=dt, device=x.device))

    # NEXT relation: every cross-track cell of the previous active column
    pcol_b = nbr.prev_col[..., None, :].expand(mask.shape)
    xsrc = _gather_time(x, pcol_b)
    msrc = torch.gather(mask, -1, pcol_b)
    gnx = gate_table[(iota - nbr.prev_col).clamp(0, s - 1)]
    z = torch.relu(xsrc * gnx[..., None, :, :]) * msrc[..., None].to(dt)
    cnt_src = msrc.to(torch.int64).sum(dim=-2)[..., None, :]
    cnt_nx = (cnt_src - msrc.to(torch.int64))[..., None]
    ok_nx = nbr.prev_col_ok[..., None, :, None] & (cnt_nx > 0) & (m_f > 0)
    zsum = z.sum(dim=-3, keepdim=True)
    h_next = torch.where(ok_nx, (zsum - z) / cnt_nx.clamp(min=1).to(dt),
                         torch.zeros((), dtype=dt, device=x.device))

    # single-node self loop (relation 0, distance 0)
    single = nbr.single_node[..., None, None, None].to(dt)
    h_self = torch.relu(x * gate_table[0]) * m_f * single
    return h_track, h_onset, h_next, h_self


def gcl_apply(x, mask, nbr: LatticeNeighbors, gate_table, rel_weight, root,
              bias):
    """One dense relational graph-conv layer, eval form:
    out = (sum_r mean_msgs_r @ W_r + x @ root + bias) * mask.

    rel_weight (6, d, d); root (d, d); bias (d,).
    """
    h_track, h_onset, h_next, h_self = relational_messages(
        x, mask, nbr, gate_table)
    n_tracks = mask.shape[-2]
    out = torch.einsum("...tsd,tde->...tse", h_track, rel_weight[:n_tracks])
    hcat = torch.cat([h_self, h_onset, h_next, x], dim=-1)
    wcat = torch.cat([rel_weight[0], rel_weight[n_tracks],
                      rel_weight[n_tracks + 1], root], dim=0)
    out = out + hcat @ wcat + bias
    return out * mask[..., None].to(x.dtype)
