"""Masked batch-norm, eval form (running statistics only).

Counterpart of `polyphemus_tpu/ops/masked.py::batch_norm_masked` with
`use_running=True`: in eval mode the mask does not enter, because the
statistics are the stored running ones. Training statistics wait for the
training slice.
"""
from __future__ import annotations

import torch


def batch_norm_masked(x, scale, bias, running_mean, running_var, *,
                      eps: float = 1e-5):
    """Eval batch-norm over the last axis: (x - mean) * rsqrt(var + eps)
    * scale + bias."""
    return (x - running_mean) * torch.rsqrt(running_var + eps) * scale + bias


def folded_affine(scale, bias, running_mean, running_var, *,
                  eps: float = 1e-5):
    """Eval batch-norm as y = x * A + B, for fusing into kernel epilogues."""
    a = scale * torch.rsqrt(running_var + eps)
    return a, bias - running_mean * a
