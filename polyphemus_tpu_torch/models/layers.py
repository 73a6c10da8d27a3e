"""Shared neural building blocks.

Counterparts of `polyphemus_tpu/models/layers.py`: `MaskedBatchNorm`
(training and eval forms, its folded affine, and the hooks the fused content
encoder uses), `Dropout` (drawn from an explicit `torch.Generator`), `MLP`,
`CNNEncoder` and `CNNDecoder`. The JAX package's `Conv3x3` is an im2col
matmul chosen for the TPU; here it is `F.conv2d`, with the (3, 3, Cin, Cout)
kernel permuted to (Cout, Cin, 3, 3) by the converter. Both CNNs keep the
JAX package's channels-last (h, w, c) order at their Linear boundaries.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import masked as mops
from ..parallel import mesh as pmesh


class Linear(nn.Linear):
    """`nn.Linear` that, on a 2-byte float input, rounds the product before
    it adds the bias, as the JAX package's `x @ kernel + bias` does under
    bf16 (`F.linear` would round once, after the bias)."""

    def forward(self, x):
        if x.element_size() > 2:
            return super().forward(x)
        return F.linear(x, self.weight) + self.bias


class RowParallelLinear(Linear):
    """`Linear` whose weight's input columns are sharded over the model
    axis under tensor parallelism (`parallel.mesh`): the rank's columns of
    x (whole, through `copy_to_model`) times its weight shard, the partial
    products summed over the model group, then the whole bias."""

    def forward(self, x):
        if pmesh.model_size() == 1:
            return super().forward(x)
        lo, hi = pmesh.shard_range(x.shape[-1])
        part = F.linear(pmesh.copy_to_model(x)[..., lo:hi], self.weight)
        return pmesh.reduce_from_model(part) + self.bias


class ColumnParallelLinear(Linear):
    """`Linear` whose weight's output rows and bias are sharded over the
    model axis under tensor parallelism (`parallel.mesh`): the rank's
    output columns, gathered."""

    def forward(self, x):
        if pmesh.model_size() == 1:
            return super().forward(x)
        return pmesh.gather_from_model(
            super().forward(pmesh.copy_to_model(x)))


class Conv2d(nn.Conv2d):
    """`nn.Conv2d` that, on a 2-byte float input, rounds the convolution
    before it adds the bias, as the JAX package's im2col product + bias
    does under bf16."""

    def forward(self, x):
        if x.element_size() > 2:
            return super().forward(x)
        return self._conv_forward(x, self.weight, None) \
            + self.bias[:, None, None]


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the last axis with masked statistics.

    x (..., features); mask broadcastable to x.shape[:-1] (None = all
    valid). In training mode the masked batch statistics normalise and the
    running buffers update (momentum 0.1, unbiased variance); in eval mode
    the running statistics normalise."""

    def __init__(self, features: int, momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x, mask=None):
        return mops.batch_norm_masked(
            x, self.weight, self.bias, self.running_mean, self.running_var,
            mask=mask, training=self.training, momentum=self.momentum,
            eps=self.eps)

    def folded_affine(self):
        """Eval batch-norm as y = x*A + B, for kernel epilogues."""
        return mops.folded_affine(self.weight, self.bias, self.running_mean,
                                  self.running_var, eps=self.eps)

    def affine_from_stats(self, mean, var):
        """BN as y = x*A + B for statistics computed elsewhere."""
        return mops.folded_affine(self.weight, self.bias, mean, var,
                                  eps=self.eps)

    def update_running(self, mean, var, count):
        """The running update for statistics computed elsewhere, in place.
        A result in another dtype than the buffers' replaces them: under the
        bf16 policy the fused front's fp32 statistics keep an fp32 result,
        as the JAX package's do."""
        new = mops.running_update(self.running_mean, self.running_var,
                                  mean.detach(), var.detach(), count,
                                  momentum=self.momentum)
        if new[0].dtype == self.running_mean.dtype:
            self.running_mean.copy_(new[0])
            self.running_var.copy_(new[1])
        else:
            self.running_mean, self.running_var = new

    def running_stats(self):
        return self.running_mean, self.running_var


class Dropout(nn.Module):
    """Inverted dropout whose mask is drawn from `self.generator` (None:
    torch's default generator); identity in eval mode or at p = 0. The
    leading axis of x is batch-major; under a process group the mask is
    this rank's rows of the global batch's (`parallel.mesh.global_rows`)."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.generator: Optional[torch.Generator] = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = pmesh.global_rows(
            lambda shape: torch.rand(shape, generator=self.generator,
                                     device=x.device), x.shape) >= self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))


class MLP(nn.Module):
    """Linear stack with pre-layer dropout."""

    def __init__(self, in_dim: int, features: Sequence[int],
                 activation: bool = True, dropout: float = 0.1):
        super().__init__()
        self.activation = activation
        dims = [in_dim] + list(features)
        self.layers = nn.ModuleList(
            Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.drop = Dropout(dropout)

    def forward(self, x):
        for lin in self.layers:
            x = lin(self.drop(x))
            if self.activation:
                x = torch.relu(x)
        return x


def _bn_channels(bn, x):
    """Masked BN over the channel axis 1 of an NCHW tensor."""
    return bn(x.movedim(1, -1)).movedim(-1, 1)


class CNNEncoder(nn.Module):
    """Per-bar structure (N, T, S) -> embedding (N, output_dim).

    conv 1->8 [-> BN] -> relu -> max-pool (1, 4) -> conv 8->16 [-> BN] ->
    relu -> channels-last flatten (h, w, c) -> dropout -> Linear -> relu ->
    dropout -> Linear."""

    def __init__(self, output_dim: int, dense_dim: int, n_tracks: int = 4,
                 n_timesteps: int = 32, batch_norm: bool = False,
                 dropout: float = 0.1):
        super().__init__()
        self.conv0 = Conv2d(1, 8, 3, padding=1)
        self.bn0 = MaskedBatchNorm(8) if batch_norm else None
        self.conv1 = Conv2d(8, 16, 3, padding=1)
        self.bn1 = MaskedBatchNorm(16) if batch_norm else None
        self.lin0 = Linear(16 * n_tracks * (n_timesteps // 4), dense_dim)
        self.lin1 = Linear(dense_dim, output_dim)
        self.drop = Dropout(dropout)

    def forward(self, x):
        x = self.conv0(x[:, None])
        if self.bn0 is not None:
            x = _bn_channels(self.bn0, x)
        x = F.max_pool2d(torch.relu(x), (1, 4), stride=(1, 4))
        x = self.conv1(x)
        if self.bn1 is not None:
            x = _bn_channels(self.bn1, x)
        x = torch.relu(x).permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = torch.relu(self.lin0(self.drop(x)))
        return self.lin1(self.drop(x))


class CNNDecoder(nn.Module):
    """Embedding -> per-bar structure logits (T, S).

    dropout -> Linear -> relu -> dropout -> Linear -> relu -> unflatten to
    (N, T, S/4, 16) in channels-last order (the JAX package's layout:
    `lin1`'s outputs are ordered (h, w, c), so its rows are not permuted) ->
    nearest upsample x4 along time -> conv 16->8 [-> BN] -> relu -> conv
    8->1.
    """

    def __init__(self, input_dim: int, dense_dim: int, n_tracks: int = 4,
                 n_timesteps: int = 32, batch_norm: bool = False,
                 dropout: float = 0.1):
        super().__init__()
        self.h, self.w = n_tracks, n_timesteps // 4
        self.lin0 = Linear(input_dim, dense_dim)
        self.lin1 = Linear(dense_dim, 16 * self.h * self.w)
        self.conv0 = Conv2d(16, 8, 3, padding=1)
        self.bn0 = MaskedBatchNorm(8) if batch_norm else None
        self.conv1 = Conv2d(8, 1, 3, padding=1)
        self.drop = Dropout(dropout)

    def forward(self, x):
        x = torch.relu(self.lin0(self.drop(x)))
        x = torch.relu(self.lin1(self.drop(x)))
        x = x.reshape(x.shape[0], self.h, self.w, 16).permute(0, 3, 1, 2)
        x = x.repeat_interleave(4, dim=3)
        x = self.conv0(x)
        if self.bn0 is not None:
            x = _bn_channels(self.bn0, x)
        x = self.conv1(F.relu(x))
        return x[:, 0]  # (N, T, S)
