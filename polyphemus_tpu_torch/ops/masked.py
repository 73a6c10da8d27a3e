"""Masked statistics ops: batch-norm and attention pooling over padded
lattices.

Counterpart of `polyphemus_tpu/ops/masked.py`. The dense layout keeps every
lattice cell, so the batch-norm statistics and the pooling softmax are taken
under the activation mask, as the reference's packed node sets see only real
nodes. Training mode normalises with the masked biased batch statistics and
updates the running ones with the unbiased variance (torch's momentum
convention, momentum 0.1); eval mode uses the running statistics.

Every statistic is taken in x's dtype, as the JAX package's are: under the
bf16 policy the count too (it sums in fp32 and rounds to bf16, so n / (n -
1) reads 1 above 256 rows), and the running update runs on the bf16 copies
of the running statistics.
"""
from __future__ import annotations

import torch


def masked_moments(x, mask, dims):
    """Mean, biased variance and count of x over `dims`, counting only the
    mask-true entries. x (..., d); mask broadcastable to x.shape[:-1]. The
    sums run in fp32 or wider (a 2-byte x's squares too, as XLA fuses them
    into the sum) and round to x's dtype."""
    m = mask.to(x.dtype)[..., None]
    cnt = m.sum(dim=dims)
    cnt_safe = cnt.clamp(min=1.0)
    mean = (x * m).sum(dim=dims) / cnt_safe
    wide = torch.promote_types(x.dtype, torch.float32)
    sq = (x.to(wide).square() * m).sum(dim=dims).to(x.dtype)
    var = sq / cnt_safe - mean.square()
    return mean, var.clamp(min=0.0), cnt


@torch.no_grad()
def running_update(running_mean, running_var, mean, var, count, *,
                   momentum: float = 0.1):
    """Outside autograd: (new_mean, new_var) with new = (1 - momentum) *
    old + momentum * batch, the variance unbiased by n / (n - 1) over the
    `count` rows the batch statistics saw. Each result takes the dtype that
    its operands promote to (fp32 statistics update bf16 running ones in
    fp32)."""
    n = torch.as_tensor(count, device=var.device).clamp(min=1.0)
    unbias = torch.where(n > 1, n / (n - 1.0).clamp(min=1.0),
                         torch.ones_like(n))
    return ((1 - momentum) * running_mean + momentum * mean,
            (1 - momentum) * running_var + momentum * var * unbias)


def batch_norm_masked(x, scale, bias, running_mean, running_var, *,
                      mask=None, training: bool = False,
                      momentum: float = 0.1, eps: float = 1e-5):
    """BatchNorm over every leading axis of x (..., d).

    Eval: the running statistics, mask unused. Training: the masked batch
    statistics (mask None = all valid); the running buffers are updated in
    place, outside autograd. Returns y."""
    if not training:
        return (x - running_mean) * torch.rsqrt(running_var + eps) * scale \
            + bias
    if mask is None:
        mask = torch.ones(x.shape[:-1], dtype=torch.bool, device=x.device)
    mask = mask.expand(x.shape[:-1])
    dims = tuple(range(x.dim() - 1))
    mean, var, count = masked_moments(x, mask, dims)
    new_mean, new_var = running_update(running_mean, running_var,
                                       mean.detach(), var.detach(), count,
                                       momentum=momentum)
    running_mean.copy_(new_mean)
    running_var.copy_(new_var)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def folded_affine(scale, bias, running_mean, running_var, *,
                  eps: float = 1e-5):
    """Eval batch-norm as y = x * A + B, for fusing into kernel epilogues."""
    a = scale * torch.rsqrt(running_var + eps)
    return a, bias - running_mean * a


def masked_softmax(logits, mask, dim: int):
    """Softmax over `dim` with inactive entries at zero probability, in fp32
    whatever the input dtype."""
    dt = logits.dtype
    x = logits.to(torch.float32)
    neg = torch.finfo(torch.float32).min
    x = torch.where(mask, x, torch.full_like(x, neg))
    x = x - x.amax(dim=dim, keepdim=True).detach()
    ex = torch.exp(x) * mask.to(torch.float32)
    denom = ex.sum(dim=dim, keepdim=True).clamp(min=1e-30)
    return (ex / denom).to(dt)


def attention_pool_bars(x, gates, mask):
    """Soft-attention pooling of lattice cells into one vector per bar.

    x (..., T, S, d); gates (..., T, S, 1) raw logits; mask (..., T, S).
    Returns (..., d), computed in fp32."""
    lead = x.shape[:-3]
    d = x.shape[-1]
    cells = x.shape[-3] * x.shape[-2]
    w = masked_softmax(gates.reshape(lead + (cells,)),
                       mask.reshape(lead + (cells,)), dim=-1)
    xf = x.reshape(lead + (cells, d))
    return torch.einsum("...c,...cd->...d", w.to(torch.float32),
                        xf.to(torch.float32)).to(x.dtype)
