"""Chord tail: chord decode -> unembed -> argmax, token ids only.

Counterpart of `polyphemus_tpu/ops/kernels/chord_tail.py::chord_tail_tokens`.
On a CUDA tensor `chord_tail_tokens` launches `csrc/chord_tail.cu`, which
keeps the slot hiddens and logits on chip; on a CPU tensor it runs
`chord_tail_plain`, the same function in plain PyTorch.

x and the weights are fp32 or bf16 (the biases fp32 or bf16, as the model
holds them). In bf16 it computes what the Pallas body computes for a bf16
x: the slot projection multiplies bf16 values and sums in fp32 plus the
fp32-upcast bias, the slot hiddens stay fp32 (not rounded to bf16), and the
unembeds take them against the bf16-valued weights, summed in fp32, plus
fp32 biases. That is not the XLA slot scan's bf16 arithmetic, which rounds
the hiddens and the logits to bf16.
"""
from __future__ import annotations

import math

import torch

from . import _build

# kernel launches (not plain-path calls) since the counts were last reset,
# with x in fp32 and in bf16
launches = 0
bf16_launches = 0


def chord_tail_plain(x, chord_kernel, chord_bias, pk_drums, pb_drums, pk_nd,
                     pb_nd, dk, db, *, n_slots: int):
    """Plain-PyTorch `chord_tail_tokens`: the same arguments and result.
    Every operand is upcast to fp32 (fp64 stays fp64) first, which is
    exact: a bf16 x gets the fp32 sums of bf16 products that the kernel
    takes."""
    wide = torch.promote_types(x.dtype, torch.float32)
    x, chord_kernel, chord_bias, pk_drums, pb_drums, pk_nd, pb_nd, dk, db = (
        a.to(wide) for a in (x, chord_kernel, chord_bias, pk_drums, pb_drums,
                             pk_nd, pb_nd, dk, db))
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


_DTYPES = (torch.float32, torch.bfloat16)


def _check_cuda_args(x, params):
    t, s, d = x.shape[-3:]
    if t != 4 or s != 32 or d % 128 != 0:
        raise ValueError(f"chord_tail kernel takes 4x32-cell bars and d % 128 "
                         f"== 0, got T={t} S={s} d={d}")
    if x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError(f"chord_tail: x must be contiguous float32 or "
                         f"bfloat16, got {x.dtype}")
    for name, v in params.items():
        if v.device != x.device:
            raise ValueError(f"chord_tail: {name} is on {v.device}, x on "
                             f"{x.device}")
        if v.dtype not in _DTYPES:
            raise ValueError(f"chord_tail: {name} must be float32 or "
                             f"bfloat16, got {v.dtype}")
        if name == "chord_kernel" and (v.dtype != x.dtype
                                       or not v.is_contiguous()
                                       or v.data_ptr() % 16):
            raise ValueError(f"chord_tail: chord_kernel must be contiguous, "
                             f"16-byte aligned {x.dtype} as x")


def chord_tail_tokens(x, chord_kernel, chord_bias, pk_drums, pb_drums, pk_nd,
                      pb_nd, dk, db, *, n_slots: int):
    """x (..., T, S, d) -> token ids (..., T, S, n_slots, 2) int32.

    chord_kernel (d, n_slots*d), chord_bias (n_slots*d,); pitch unembeds
    (d/2, P) with biases (P,) for the drum row and the melodic rows; the
    duration unembed (d/2, D) with bias (D,). Ids are the first index among
    equal maxima, as `torch.argmax` gives.
    """
    global launches, bf16_launches
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
    # the biases and the unembeds go in as contiguous fp32 (exact for bf16
    # values): bf16 vocabulary rows of 131 or 99 values are not aligned for
    # vector loads, and these operands are small
    small = [a.to(torch.float32).contiguous() for a in args[2:]]
    if small[0].data_ptr() % 16:
        raise ValueError("chord_tail: chord_bias must be 16-byte aligned")
    name = "chord_tail" if x.dtype == torch.float32 else "chord_tail_bf16"
    fn = _build.launcher(name)
    err = fn(x.data_ptr(), chord_kernel.data_ptr(),
             *(a.data_ptr() for a in small), ids.data_ptr(), nbar, d,
             n_slots, vp, vd, _build.stream_handle(x.device))
    _build.check(name, err)
    if x.dtype == torch.float32:
        launches += 1
    else:
        bf16_launches += 1
    return ids
