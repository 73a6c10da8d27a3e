"""Residual relational GNN over the bar lattice.

Counterpart of `polyphemus_tpu/models/gnn.py::GCN`. One `edge_nn` Linear is
shared by every layer of a stack and evaluated once per forward as an (S, d)
gate table.

  * Eval mode: each group of `chain` layers runs as one `gcl_eval` call
    (GCL + folded batch-norm + relu + residual per layer) in x's dtype; the
    last group is shorter when `chain` does not divide the layer count.
  * Training mode: per layer, dropout -> GCL -> masked batch-norm with
    batch statistics -> * m -> relu -> + residual, as the JAX package's
    lattice path. The GCL is `gcl_fused` (the training forward kernel, with
    the backward kernels behind it) or, with message dropout, the lattice
    `gcl_apply` with its dropout (plain PyTorch with autograd): the fused
    kernels have no place to drop a message, and the JAX package routes
    the same way.

Under tensor parallelism (`parallel.mesh`, M > 1) each rank holds a column
shard of every layer's `rel_weight` and `root` (d / M output columns) and
launches the kernels' column forms on it: the layer's input and the gate
table pass through `copy_to_model` (their grads, partial sums over the
shard's columns, are summed over the model group), the bias through the
copy and then its slice, and the shards' outputs are gathered before the
batch-norm and the residual, which run whole on every rank. The eval stack
runs one layer per launch there (a layer needs the whole output of the one
before it).
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops import lattice
from ..ops.kernels import gcl as gcl_k
from ..ops.kernels import gcl_bwd
from ..parallel import mesh as pmesh
from .layers import Dropout, MaskedBatchNorm


class GCLParams(nn.Module):
    """One relational graph-conv layer's parameters (RGCNConv layout:
    rel_weight (n_relations, d_in, d_out), root, bias). Under tensor
    parallelism `rel_weight` and `root` hold the rank's output columns."""

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

    `message_dropout` > 0 (the reference's per-edge message dropout, in
    `message_dropout_mode` "edge" or "aggregate") takes the training forward
    through the lattice GCL; its masks, like every dropout mask of the
    stack, come from `self.drop.generator` (`VAE.set_dropout_generator`).
    Eval mode ignores it."""

    def __init__(self, dim: int, n_layers: int, num_relations: int = 6,
                 num_dists: int = 32, batch_norm: bool = False,
                 chain: int = 1, dropout: float = 0.0,
                 message_dropout: float = 0.0,
                 message_dropout_mode: str = "edge"):
        super().__init__()
        self.dim = dim
        self.chain = chain
        self.message_dropout = message_dropout
        self.message_dropout_mode = message_dropout_mode
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
        if pmesh.model_size() > 1:
            return self._eval_columns(xf, aux, gate_table, n_tracks)
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

    def _eval_columns(self, xf, aux, gate_table, n_tracks):
        """The eval stack on the rank's column shards, one layer a launch:
        relu((agg @ W[:, cols] + b[cols]) * ea[cols] + eb[cols]) * m +
        x[..., cols], then gathered."""
        lo, hi = pmesh.shard_range(self.dim)
        for i, p in enumerate(self.layers):
            if self.norm_layers is not None:
                ea, eb = self.norm_layers[i].folded_affine()
            else:
                ea, eb = torch.ones_like(p.bias), torch.zeros_like(p.bias)
            out = gcl_k.gcl_eval(
                xf, aux, gate_table,
                gcl_k.pack_weights(p.rel_weight, p.root, n_tracks)[None],
                *(v[lo:hi][None].contiguous() for v in (p.bias, ea, eb)),
                col0=lo)
            xf = pmesh.gather_from_model(out)
        return xf

    def _layer_stack(self, xf, mask, aux, gate_table):
        m = mask.reshape(xf.shape[:2])
        m_f = m[..., None].to(xf.dtype)
        if self.message_dropout > 0:
            cells = mask.reshape((-1,) + mask.shape[-2:])
            nbr = lattice.build_neighbors(cells)
        tp = pmesh.model_size() > 1
        if tp:
            gate_table = pmesh.copy_to_model(gate_table)
            lo, hi = pmesh.shard_range(self.dim)
        for i, p in enumerate(self.layers):
            xd = self.drop(xf)
            bias = p.bias
            if tp:
                xd = pmesh.copy_to_model(xd)
                bias = pmesh.copy_to_model(bias)[lo:hi]
            if self.message_dropout > 0:
                h = lattice.gcl_apply(
                    xd.reshape(cells.shape + (self.dim,)), cells, nbr,
                    gate_table, p.rel_weight, p.root, bias,
                    message_dropout=self.message_dropout,
                    generator=self.drop.generator,
                    message_dropout_mode=self.message_dropout_mode,
                ).reshape(xf.shape[:-1] + bias.shape)
            else:
                h = gcl_bwd.gcl_fused(xd.contiguous(), gate_table,
                                      p.rel_weight, p.root, bias, aux, mask)
            if tp:
                h = pmesh.gather_from_model(h)
            if self.norm_layers is not None:
                h = self.norm_layers[i](h, m) * m_f
            xf = xf + torch.relu(h)
        return xf
