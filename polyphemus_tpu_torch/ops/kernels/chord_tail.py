"""Chord tail: chord decode -> unembed -> argmax, token ids only.

Counterpart of `polyphemus_tpu/ops/kernels/chord_tail.py::chord_tail_tokens`.
On a CUDA tensor `chord_tail_tokens` launches `csrc/chord_tail_fp32.cu` (x in
fp32, on the CUDA cores) or `csrc/chord_tail_bf16_tc.cu` (x in bf16, on the
tensor cores), which keep the slot hiddens and logits on chip; on a CPU
tensor it runs `chord_tail_plain`, the same function in plain PyTorch. The
kernels take bars of 4 x S cells at any S that is a multiple of 4 (every
resolution), in tiles of the flat cell axis.

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
import weakref

import torch
import torch.nn.functional as F

from . import _build, counts
from .gcl import TRACKS


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
# the half-widths of h that the kernels' tiles compute
# (`csrc/chord_tail_fp32.cu`, `csrc/chord_tail_bf16_tc.cu`); they take
# d % 128 == 0 up to 1536
HALF_WIDTHS = (64, 128, 192, 256, 384, 512, 768)
MAX_D = 2 * HALF_WIDTHS[-1]
# columns of each packed unembed, and the vocabulary sizes the kernels'
# pitch and duration tiles cover
UNEMBED_WIDTH, MAX_PITCH, MAX_DUR = 144, 144, 112


def half_width(d: int) -> int:
    """The half-width H of h that the kernels compute at width d: d/2, or
    the next of their tiles' half-widths up."""
    return next(w for w in HALF_WIDTHS if w >= d // 2)


def pack(dtype, chord_kernel, chord_bias, pk_drums, pb_drums, pk_nd, pb_nd,
         dk, db):
    """The weight operands of the kernel for x in dtype (fp32 or bf16),
    contiguous: ck (d, n_slots * 2H) in dtype and cb (n_slots * 2H,) fp32,
    each half of each slot's columns
    zero-padded from d/2 to H = `half_width(d)` (the weights as they are
    when H = d/2 and they have that dtype); u (H, 3 * 144) in dtype: the
    drum, melodic and duration unembeds side by side, each zero-padded to
    144 columns and to H rows; ub (3 * 144,) fp32, their biases padded
    alike. A padded column of h is an exact zero (zero weights, zero bias)
    and meets zero unembed rows, so the logits are the unpadded ones; the
    kernels' argmax stops at the vocabulary edge, so a padded vocabulary
    column is never read. In bf16 every cast is exact for bf16 weights (the
    wrapper takes no other) and for any bias."""
    d = chord_kernel.shape[0]
    h, hp = d // 2, half_width(d)
    ns = chord_kernel.shape[1] // d
    ck = chord_kernel.to(dtype).contiguous()
    cb = chord_bias.to(torch.float32).contiguous()
    if hp != h:
        ck = F.pad(ck.reshape(d, ns, 2, h), (0, hp - h)).reshape(d, -1)
        cb = F.pad(cb.reshape(ns, 2, h), (0, hp - h)).reshape(-1)
    w = UNEMBED_WIDTH
    u = ck.new_zeros((hp, 3 * w))
    ub = cb.new_zeros((3 * w,))
    for i, (k, b) in enumerate(((pk_drums, pb_drums), (pk_nd, pb_nd),
                                (dk, db))):
        u[:h, i * w:i * w + k.shape[1]] = k
        ub[i * w:i * w + b.shape[0]] = b
    return ck, cb, u, ub


# the last packing for each dtype: weak references to its weights, their
# versions, and what was packed (None where that is the weight itself, which
# the cache does not keep alive)
_packed: dict = {}


def _operands(dtype, weights):
    """`pack(dtype, *weights)`, packed again only when a weight is another
    tensor than at the last packing for dtype or was changed in place
    since."""
    versions = [t._version for t in weights]
    if dtype in _packed:
        refs, was, kept = _packed[dtype]
        if was == versions and all(r() is t for r, t in zip(refs, weights)):
            return [weights[i] if p is None else p for i, p in enumerate(kept)]
    out = pack(dtype, *weights)
    _packed[dtype] = ([weakref.ref(t) for t in weights], versions,
                      [None if p is weights[i] else p
                       for i, p in enumerate(out)])
    return out


def _check_cuda_args(x, params):
    t, s, d = x.shape[-3:]
    if t != TRACKS or s < 4 or s % 4 or d % 128 != 0:
        raise ValueError(f"chord_tail kernel takes bars of {TRACKS} x S "
                         f"cells with S a multiple of 4 and d % 128 == 0, "
                         f"got T={t} S={s} d={d}")
    if x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError(f"chord_tail: x must be contiguous float32 or "
                         f"bfloat16, got {x.dtype}")
    if x.dtype == torch.bfloat16 and x.data_ptr() % 16:
        raise ValueError("chord_tail: a bfloat16 x must be 16-byte aligned")
    if d > MAX_D:
        raise ValueError(f"chord_tail: the kernels take d up to {MAX_D}, got "
                         f"d={d}")
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
        # the bf16 kernel takes the unembeds in bf16: a wider weight would
        # be rounded where the plain version is not
        if (name in ("pk_drums", "pk_nd", "dk") and x.dtype == torch.bfloat16
                and v.dtype != torch.bfloat16):
            raise ValueError(f"chord_tail: with a bfloat16 x, {name} must be "
                             f"bfloat16, got {v.dtype}")


def chord_tail_tokens(x, chord_kernel, chord_bias, pk_drums, pb_drums, pk_nd,
                      pb_nd, dk, db, *, n_slots: int):
    """x (..., T, S, d) -> token ids (..., T, S, n_slots, 2) int32.

    chord_kernel (d, n_slots*d), chord_bias (n_slots*d,); pitch unembeds
    (d/2, P) with biases (P,) for the drum row and the melodic rows; the
    duration unembed (d/2, D) with bias (D,). Ids are the first index among
    equal maxima, as `torch.argmax` gives.
    """
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
    if vp > MAX_PITCH or vd > MAX_DUR:
        raise ValueError(f"chord_tail: the kernels take at most {MAX_PITCH} "
                         f"pitch and {MAX_DUR} duration tokens, got vp={vp} "
                         f"and vd={vd}")
    lead = x.shape[:-3]
    nbar, s = math.prod(lead), x.shape[-2]
    ids = torch.empty(lead + x.shape[-3:-1] + (n_slots, 2), dtype=torch.int32,
                      device=x.device)
    # the weights packed (`pack`), once for as long as they last
    ops = _operands(x.dtype, args[1:])
    if x.dtype == torch.float32:
        # the fp32 kernel's TMA copies take x k-major, (d, nbar 4 S)
        name = "chord_tail"
        x = x.reshape(-1, d).t().contiguous()
    else:
        name = "chord_tail_bf16"
    if ops[1].data_ptr() % 16:
        raise ValueError("chord_tail: chord_bias must be 16-byte aligned")
    fn = _build.launcher(name)
    err = fn(x.data_ptr(), *(a.data_ptr() for a in ops), ids.data_ptr(),
             nbar, s, d, n_slots, vp, vd, _build.stream_handle(x.device))
    _build.check(name, err)
    counts.count(name, s)
    return ids
