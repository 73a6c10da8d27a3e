"""Chord tail: chord decode -> unembed -> argmax, token ids only.

Counterpart of `polyphemus_tpu/ops/kernels/chord_tail.py::chord_tail_tokens`.
On a CUDA tensor `chord_tail_tokens` launches `csrc/chord_tail.cu`, which
keeps the slot hiddens and logits on chip; on a CPU tensor it runs
`chord_tail_plain`, the same function in plain PyTorch.
"""
from __future__ import annotations

import math

import torch

from . import _build

# kernel launches (not plain-path calls) since the count was last reset
launches = 0


def chord_tail_plain(x, chord_kernel, chord_bias, pk_drums, pb_drums, pk_nd,
                     pb_nd, dk, db, *, n_slots: int):
    """Plain-PyTorch `chord_tail_tokens`: the same arguments and result."""
    d = x.shape[-1]
    h = d // 2
    ids = []
    for s in range(n_slots):
        slot_h = x @ chord_kernel[:, s * d:(s + 1) * d] + chord_bias[s * d:(s + 1) * d]
        ph, dh = slot_h[..., :h], slot_h[..., h:]
        pitch = torch.cat([ph[..., :1, :, :] @ pk_drums + pb_drums,
                           ph[..., 1:, :, :] @ pk_nd + pb_nd], dim=-3)
        dur = dh @ dk + db
        ids.append(torch.stack([pitch.argmax(-1), dur.argmax(-1)], dim=-1))
    return torch.stack(ids, dim=-2).to(torch.int32)


def _check_cuda_args(x, params):
    t, s, d = x.shape[-3:]
    if t != 4 or s != 32 or d % 128 != 0:
        raise ValueError(f"chord_tail kernel takes 4x32-cell bars and d % 128 "
                         f"== 0, got T={t} S={s} d={d}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("chord_tail: x must be contiguous float32")
    for name, v in params.items():
        if v.device != x.device:
            raise ValueError(f"chord_tail: {name} is on {v.device}, x on "
                             f"{x.device}")
        if v.dtype != torch.float32 or not v.is_contiguous() or v.data_ptr() % 16:
            raise ValueError(f"chord_tail: {name} must be contiguous, 16-byte "
                             f"aligned float32")


def chord_tail_tokens(x, chord_kernel, chord_bias, pk_drums, pb_drums, pk_nd,
                      pb_nd, dk, db, *, n_slots: int):
    """x (..., T, S, d) -> token ids (..., T, S, n_slots, 2) int32.

    chord_kernel (d, n_slots*d), chord_bias (n_slots*d,); pitch unembeds
    (d/2, P) with biases (P,) for the drum row and the melodic rows; the
    duration unembed (d/2, D) with bias (D,). Ids are the first index among
    equal maxima, as `torch.argmax` gives.
    """
    global launches
    args = (x, chord_kernel, chord_bias, pk_drums, pb_drums, pk_nd, pb_nd,
            dk, db)
    if x.device.type == "cpu":
        return chord_tail_plain(*args, n_slots=n_slots)
    if x.device.type != "cuda":
        raise ValueError(f"chord_tail: unsupported device {x.device}")
    d = x.shape[-1]
    h = d // 2
    vp, vd = pk_drums.shape[1], dk.shape[1]
    want = {"chord_kernel": (d, n_slots * d), "chord_bias": (n_slots * d,),
            "pk_drums": (h, vp), "pb_drums": (vp,), "pk_nd": (h, vp),
            "pb_nd": (vp,), "dk": (h, vd), "db": (vd,)}
    params = dict(zip(want, args[1:]))
    for name, shape in want.items():
        if tuple(params[name].shape) != shape:
            raise ValueError(f"chord_tail: {name} must be {shape}, got "
                             f"{tuple(params[name].shape)}")
    _check_cuda_args(x, params)
    lead = x.shape[:-3]
    nbar = math.prod(lead)
    ids = torch.empty(lead + x.shape[-3:-1] + (n_slots, 2), dtype=torch.int32,
                      device=x.device)
    fn = _build.launcher("chord_tail")
    err = fn(*(a.data_ptr() for a in args), ids.data_ptr(), nbar, d, n_slots,
             vp, vd, _build.stream_handle(x.device))
    _build.check("chord_tail", err)
    launches += 1
    return ids
