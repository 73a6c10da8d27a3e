"""Residual relational GNN over the bar lattice.

Counterpart of `polyphemus_tpu/models/gnn.py::GCN`. One `edge_nn` Linear is
shared by every layer of a stack and evaluated once per forward as an (S, d)
gate table.

  * Eval mode: each group of `chain` layers runs as one `gcl_eval` call
    (GCL + folded batch-norm + relu + residual per layer) in x's dtype; the
    last group is shorter when `chain` does not divide the layer count.
  * Training mode: per layer, dropout -> `gcl_fused` (the training forward
    kernel, with the backward kernels behind it) -> masked batch-norm with
    batch statistics -> * m -> relu -> + residual, as the JAX package's
    lattice path.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.kernels import gcl as gcl_k
from ..ops.kernels import gcl_bwd
from .layers import Dropout, MaskedBatchNorm


class GCLParams(nn.Module):
    """One relational graph-conv layer's parameters (RGCNConv layout:
    rel_weight (n_relations, d_in, d_out), root, bias)."""

    def __init__(self, in_dim: int, out_dim: int, num_relations: int = 6):
        super().__init__()
        self.rel_weight = nn.Parameter(torch.empty(num_relations, in_dim,
                                                   out_dim))
        self.root = nn.Parameter(torch.empty(in_dim, out_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim))
        nn.init.xavier_uniform_(self.root)
        for w in self.rel_weight:
            nn.init.xavier_uniform_(w)


class GCN(nn.Module):
    """x (..., T, S, d) masked node states -> (..., T, S, d).

    `message_dropout > 0` (the reference's per-edge dropout) needs the
    lattice path with per-edge masks, which the port does not have: training
    with it raises rather than train without it."""

    def __init__(self, dim: int, n_layers: int, num_relations: int = 6,
                 num_dists: int = 32, batch_norm: bool = False,
                 chain: int = 1, dropout: float = 0.0,
                 message_dropout: float = 0.0):
        super().__init__()
        self.dim = dim
        self.chain = chain
        self.message_dropout = message_dropout
        self.edge_nn = nn.Linear(num_dists, dim)
        self.layers = nn.ModuleList(
            GCLParams(dim, dim, num_relations) for _ in range(n_layers))
        self.norm_layers = nn.ModuleList(
            MaskedBatchNorm(dim) for _ in range(n_layers)) if batch_norm \
            else None
        self.drop = Dropout(dropout)

    def forward(self, x, mask, *, chain=None):
        d = self.dim
        n_tracks = mask.shape[-2]
        n = n_tracks * mask.shape[-1]
        # gate_table[dist] = edge_nn(one_hot(dist)) = kernel[dist] + bias
        gate_table = (self.edge_nn.weight.t() + self.edge_nn.bias).contiguous()
        lead, cells = x.shape[:-3], x.shape[-3:-1]
        aux = gcl_k.build_kernel_aux(mask).reshape(-1, gcl_k.N_AUX, n)
        xf = x.reshape(-1, n, d).contiguous()
        if self.training:
            xf = self._layer_stack(xf, mask, aux, gate_table)
        else:
            xf = self._eval_stack(xf, aux, gate_table, chain or self.chain)
        return xf.reshape(lead + cells + (d,))

    def _eval_stack(self, xf, aux, gate_table, chain):
        n_tracks = xf.shape[1] // gate_table.shape[0]
        per_layer = []
        for i, p in enumerate(self.layers):
            if self.norm_layers is not None:
                ea, eb = self.norm_layers[i].folded_affine()
            else:
                ea, eb = torch.ones_like(p.bias), torch.zeros_like(p.bias)
            per_layer.append((gcl_k.pack_weights(p.rel_weight, p.root,
                                                 n_tracks), p.bias, ea, eb))
        for lo in range(0, len(per_layer), chain):
            grp = per_layer[lo:lo + chain]
            xf = gcl_k.gcl_eval(
                xf, aux, gate_table,
                *(torch.stack([g[j] for g in grp]).contiguous()
                  for j in range(4)))
        return xf

    def _layer_stack(self, xf, mask, aux, gate_table):
        if self.message_dropout > 0:
            raise NotImplementedError(
                "message_dropout > 0 needs the lattice GCL with per-edge "
                "dropout, which is not ported")
        m = mask.reshape(xf.shape[:2])
        m_f = m[..., None].to(xf.dtype)
        for i, p in enumerate(self.layers):
            h = gcl_bwd.gcl_fused(self.drop(xf).contiguous(), gate_table,
                                  p.rel_weight, p.root, p.bias, aux, mask)
            if self.norm_layers is not None:
                h = self.norm_layers[i](h, m) * m_f
            xf = xf + torch.relu(h)
        return xf
