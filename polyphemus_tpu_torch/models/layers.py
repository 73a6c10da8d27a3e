"""Shared neural building blocks, eval form.

Counterparts of `polyphemus_tpu/models/layers.py`: `MaskedBatchNorm` (eval
form and its folded affine) and `CNNDecoder`. The JAX package's `Conv3x3`
is an im2col matmul chosen for the TPU; here it is `F.conv2d`, with the
(3, 3, Cin, Cout) kernel permuted to (Cout, Cin, 3, 3) by the converter.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import masked as mops


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the last axis, eval form (running statistics). The
    masked training statistics wait for the training slice."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        return mops.batch_norm_masked(x, self.weight, self.bias,
                                      self.running_mean, self.running_var,
                                      eps=self.eps)

    def folded_affine(self):
        """Eval batch-norm as y = x*A + B, for kernel epilogues."""
        return mops.folded_affine(self.weight, self.bias, self.running_mean,
                                  self.running_var, eps=self.eps)


class CNNDecoder(nn.Module):
    """Embedding -> per-bar structure logits (T, S).

    Linear -> relu -> Linear -> relu -> unflatten to (N, T, S/4, 16) in
    channels-last order (the JAX package's layout: `lin1`'s outputs are
    ordered (h, w, c), so its rows are not permuted) -> nearest upsample x4
    along time -> conv 16->8 [-> BN] -> relu -> conv 8->1.
    """

    def __init__(self, input_dim: int, dense_dim: int, n_tracks: int = 4,
                 n_timesteps: int = 32, batch_norm: bool = False):
        super().__init__()
        self.h, self.w = n_tracks, n_timesteps // 4
        self.lin0 = nn.Linear(input_dim, dense_dim)
        self.lin1 = nn.Linear(dense_dim, 16 * self.h * self.w)
        self.conv0 = nn.Conv2d(16, 8, 3, padding=1)
        self.bn0 = MaskedBatchNorm(8) if batch_norm else None
        self.conv1 = nn.Conv2d(8, 1, 3, padding=1)

    def forward(self, x):
        x = torch.relu(self.lin0(x))
        x = torch.relu(self.lin1(x))
        x = x.reshape(x.shape[0], self.h, self.w, 16).permute(0, 3, 1, 2)
        x = x.repeat_interleave(4, dim=3)
        x = self.conv0(x)
        if self.bn0 is not None:
            x = self.bn0(x.movedim(1, -1)).movedim(-1, 1)
        x = self.conv1(F.relu(x))
        return x[:, 0]  # (N, T, S)
