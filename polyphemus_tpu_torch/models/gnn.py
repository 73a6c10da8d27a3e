"""Residual relational GNN over the bar lattice, eval form.

Counterpart of the eval path of `polyphemus_tpu/models/gnn.py::GCN`. One
`edge_nn` Linear is shared by every layer of a stack and evaluated once per
forward as an (S, d) gate table. Each group of `chain` layers runs as one
`gcl_eval` call (GCL + folded batch-norm + relu + residual per layer); the
last group is shorter when `chain` does not divide the layer count.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.kernels import gcl as gcl_k
from .layers import MaskedBatchNorm


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
    """x (..., T, S, d) masked node states -> (..., T, S, d)."""

    def __init__(self, dim: int, n_layers: int, num_relations: int = 6,
                 num_dists: int = 32, batch_norm: bool = False,
                 chain: int = 1):
        super().__init__()
        self.dim = dim
        self.chain = chain
        self.edge_nn = nn.Linear(num_dists, dim)
        self.layers = nn.ModuleList(
            GCLParams(dim, dim, num_relations) for _ in range(n_layers))
        self.norm_layers = nn.ModuleList(
            MaskedBatchNorm(dim) for _ in range(n_layers)) if batch_norm \
            else None

    def forward(self, x, mask, *, chain=None):
        chain = chain or self.chain
        d = self.dim
        n_tracks = mask.shape[-2]
        # gate_table[dist] = edge_nn(one_hot(dist)) = kernel[dist] + bias
        gate_table = (self.edge_nn.weight.t() + self.edge_nn.bias).contiguous()
        lead, cells = x.shape[:-3], x.shape[-3:-1]
        aux = gcl_k.build_kernel_aux(mask).reshape(-1, gcl_k.N_AUX,
                                                   n_tracks * mask.shape[-1])
        xf = x.reshape(-1, n_tracks * mask.shape[-1], d).contiguous()
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
        return xf.reshape(lead + cells + (d,))
