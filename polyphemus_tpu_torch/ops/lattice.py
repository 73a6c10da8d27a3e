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

`gcl_apply` is the plain reference the `gcl_eval` kernel is tested against,
and, with message dropout, the GCL of a training forward (plain PyTorch with
autograd, as the JAX package runs it in XLA outside every Pallas kernel).
Message dropout has two modes: "edge", the reference's exact per-edge masks,
and "aggregate", one mask over the per-relation aggregates. Masks come from
an explicit `torch.Generator`, or ready-made through `keep` in the JAX
package's draw order (its `jax.random` streams cannot be drawn here).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..parallel import mesh as pmesh


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


def relational_messages(x, mask, nbr: LatticeNeighbors, gate_table, *,
                        edge_dropout_p: float = 0.0,
                        generator: Optional[torch.Generator] = None,
                        keep=None):
    """Mean-aggregated per-relation messages over the lattice.

    x: (..., T, S, d) node states, zero at inactive cells; mask (..., T, S);
    gate_table (S, d). Returns (h_track, h_onset, h_next, h_self), each
    (..., T, S, d): row t of h_track holds relation t; h_self is the
    single-node self-edge message, routed through relation 0's weight.

    Per-edge dropout (`edge_dropout_p` > 0): the reference's dropout of
    every edge message before aggregation. TRACK and self messages are one
    per (destination, direction), so elementwise masks on them are per-edge;
    ONSET and NEXT expand to explicit (dst track, src track, step) message
    tensors (4x their message memory, training only) so that every ordered
    edge draws its own mask. The masks are drawn from `generator` on x's
    device in the order p, n, onset, next, self, or taken from `keep`, five
    bool tensors of those shapes in that order (True keeps).
    """
    s = mask.shape[-1]
    t = mask.shape[-2]
    dt = x.dtype
    iota = torch.arange(s, device=x.device)
    m_f = mask.to(dt)[..., None]
    zero = torch.zeros((), dtype=dt, device=x.device)

    ed = edge_dropout_p > 0.0
    if ed:
        masks = iter(keep) if keep is not None else None
        scale = 1.0 - edge_dropout_p
        not_eye = ~torch.eye(t, dtype=torch.bool, device=x.device)[:, :, None]

        def drop(msg):
            km = (next(masks) if masks is not None
                  else keep_mask(msg.shape, scale, generator, msg.device))
            return torch.where(km, msg / scale, zero)

    # TRACK relations: previous/next active cell in the same row
    xp = _gather_time(x, nbr.prev_in_row)
    gp = gate_table[(iota - nbr.prev_in_row).clamp(0, s - 1)]
    ok_p = nbr.prev_in_row_ok[..., None].to(dt)
    msg_p = torch.relu(xp * gp) * ok_p
    xn = _gather_time(x, nbr.next_in_row)
    gn = gate_table[(nbr.next_in_row - iota).clamp(0, s - 1)]
    ok_n = nbr.next_in_row_ok[..., None].to(dt)
    msg_n = torch.relu(xn * gn) * ok_n
    if ed:
        # a destination has at most one prev and one next edge: a mask per
        # (cell, feature, direction) is a mask per edge
        msg_p = drop(msg_p)
        msg_n = drop(msg_n)
    cnt = ok_p + ok_n
    h_track = torch.where(cnt > 0, (msg_p + msg_n) / cnt.clamp(min=1), zero)
    h_track = h_track * m_f

    # ONSET relation: the other active tracks of the same column
    y0 = torch.relu(x * gate_table[0]) * m_f
    cnt_on = (nbr.col_count[..., None, :] - mask.to(torch.int64))[..., None]
    if not ed:
        col_sum = y0.sum(dim=-3, keepdim=True)
        h_onset = (col_sum - y0) / cnt_on.clamp(min=1).to(dt)
    else:
        # axis -4 is the destination track, -3 the source track
        valid_on = mask[..., :, None, :] & mask[..., None, :, :] & not_eye
        msgs_on = drop(y0[..., None, :, :, :] * valid_on[..., None].to(dt))
        h_onset = msgs_on.sum(dim=-3) / cnt_on.clamp(min=1).to(dt)
    h_onset = torch.where((cnt_on > 0) & (m_f > 0), h_onset, zero)

    # NEXT relation: every cross-track cell of the previous active column
    pcol_b = nbr.prev_col[..., None, :].expand(mask.shape)
    xsrc = _gather_time(x, pcol_b)
    msrc = torch.gather(mask, -1, pcol_b)
    gnx = gate_table[(iota - nbr.prev_col).clamp(0, s - 1)]
    z = torch.relu(xsrc * gnx[..., None, :, :]) * msrc[..., None].to(dt)
    cnt_src = msrc.to(torch.int64).sum(dim=-2)[..., None, :]
    cnt_nx = (cnt_src - msrc.to(torch.int64))[..., None]
    ok_nx = nbr.prev_col_ok[..., None, :, None] & (cnt_nx > 0) & (m_f > 0)
    if not ed:
        zsum = z.sum(dim=-3, keepdim=True)
        h_next = (zsum - z) / cnt_nx.clamp(min=1).to(dt)
    else:
        valid_nx = (msrc[..., None, :, :] & mask[..., :, None, :] & not_eye
                    & nbr.prev_col_ok[..., None, None, :])
        msgs_nx = drop(z[..., None, :, :, :] * valid_nx[..., None].to(dt))
        h_next = msgs_nx.sum(dim=-3) / cnt_nx.clamp(min=1).to(dt)
    h_next = torch.where(ok_nx, h_next, zero)

    # single-node self loop (relation 0, distance 0)
    single = nbr.single_node[..., None, None, None].to(dt)
    h_self = torch.relu(x * gate_table[0]) * m_f * single
    if ed:
        h_self = drop(h_self)
    return h_track, h_onset, h_next, h_self


def keep_mask(shape, keep_p: float, generator, device,
              batch_dim: int = 0) -> torch.Tensor:
    """Bool mask of `shape`, True with probability `keep_p`, drawn from
    `generator` (None: torch's default generator) on `device`. Axis
    `batch_dim` is batch-major: under a process group the mask is this
    rank's rows of the global batch's (`parallel.mesh.global_rows`)."""
    return pmesh.global_rows(
        lambda s: torch.rand(s, generator=generator, device=device), shape,
        batch_dim) < keep_p


def gcl_apply(x, mask, nbr: LatticeNeighbors, gate_table, rel_weight, root,
              bias, *, message_dropout: float = 0.0,
              generator: Optional[torch.Generator] = None,
              message_dropout_mode: str = "edge", keep=None):
    """One dense relational graph-conv layer:
    out = (sum_r mean_msgs_r @ W_r + x @ root + bias) * mask.

    rel_weight (6, d, d); root (d, d); bias (d,). With `message_dropout` >
    0, the messages are dropped in `message_dropout_mode`: "edge" (exact
    per-edge masks, see `relational_messages`) or "aggregate" (one iid mask
    over the stacked (h_track, h_onset, h_next, h_self), drawn from
    `generator` or given as `keep`, bool (4, ..., T, S, d)).
    """
    if message_dropout_mode not in ("edge", "aggregate"):
        raise ValueError(f"unknown message_dropout_mode "
                         f"{message_dropout_mode!r}")
    active = message_dropout > 0.0
    exact = active and message_dropout_mode == "edge"
    h_track, h_onset, h_next, h_self = relational_messages(
        x, mask, nbr, gate_table,
        edge_dropout_p=message_dropout if exact else 0.0,
        generator=generator, keep=keep if exact else None)
    if active and not exact:
        scale = 1.0 - message_dropout
        stacked = torch.stack([h_track, h_onset, h_next, h_self])
        km = (keep if keep is not None
              else keep_mask(stacked.shape, scale, generator, x.device,
                             batch_dim=1))
        stacked = torch.where(km, stacked / scale,
                              torch.zeros((), dtype=x.dtype, device=x.device))
        h_track, h_onset, h_next, h_self = stacked.unbind(0)
    n_tracks = mask.shape[-2]
    out = torch.einsum("...tsd,tde->...tse", h_track, rel_weight[:n_tracks])
    hcat = torch.cat([h_self, h_onset, h_next, x], dim=-1)
    wcat = torch.cat([rel_weight[0], rel_weight[n_tracks],
                      rel_weight[n_tracks + 1], root], dim=0)
    out = out + hcat @ wcat + bias
    return out * mask[..., None].to(x.dtype)
