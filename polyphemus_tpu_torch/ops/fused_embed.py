"""Histogram-fused content-encoder front end.

Counterpart of `polyphemus_tpu/ops/fused_embed.py`. The embeddings are table
lookups, so:

  * the masked batch-norm statistics of `table[id] + bias` over the active
    cells are exact functions of the per-vocabulary histogram of the ids:
        E[x]  = (hist @ table) / N + b
        E[x²] = (hist @ table²) / N + 2 b (hist @ table) / N + b²
  * the BN affine (x·A + B) and the chord projection fold into per-slot
    tables T_s[v] = (A ⊙ table[v]) @ W_chord[slot s rows],
so the stage becomes 2 × 15 row lookups plus a constant and no
(cells, 15, d) tensor exists. The lookups are `F.embedding` (the JAX
package's one-hot matmuls stand in for gathers a TPU serialises).

Dtypes follow the JAX package under the bf16 policy: the statistics are
fp32 (fp32 histogram and tables; `mean = s1 + bias` promotes), so the
training-mode affine and fused tables are fp32 and the caller casts the
result back to the compute dtype.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class GroupStats(NamedTuple):
    mean: torch.Tensor
    var: torch.Tensor    # biased (normalisation) variance
    count: torch.Tensor


def embedding_stats(table, emb_bias, ids, cell_mask) -> GroupStats:
    """Exact masked-BN batch statistics of the rows `table[id] + bias`.

    ids (..., n_slots) int; cell_mask (...) bool: every slot of an active
    cell counts once, as BN over the packed rows does."""
    w = cell_mask[..., None].expand(ids.shape).to(torch.float32)
    vocab = table.shape[0]
    hist = torch.zeros(vocab, dtype=torch.float32, device=table.device)
    hist.index_add_(0, ids.reshape(-1).long(), w.reshape(-1))
    n = w.sum().clamp(min=1.0)
    t32 = table.to(torch.float32)
    s1 = (hist @ t32) / n
    s2 = (hist @ t32.square()) / n
    mean = s1 + emb_bias
    ex2 = s2 + 2.0 * emb_bias * s1 + emb_bias.square()
    var = (ex2 - mean.square()).clamp(min=0.0)
    return GroupStats(mean, var, w.sum())


def fused_tables(table, emb_bias, a, b, w_slot_rows):
    """table (vocab, h), emb_bias (h,), BN affine a, b (h,), w_slot_rows
    (n_slots, h, d) -> (T (n_slots, vocab, d), const (n_slots, d)) with
    T_s[v] + const_s == ((table[v] + emb_bias) * a + b) @ w_slot_rows[s],
    in the dtype the operands promote to."""
    scaled, offset = table * a, emb_bias * a + b
    w = w_slot_rows.to(scaled.dtype)
    t = torch.einsum("vh,shd->svd", scaled, w)
    const = torch.einsum("h,shd->sd", offset, w)
    return t, const


def gather_sum(tables, const, ids):
    """sum_s tables[s][ids[..., s]] + const[s] -> (..., d)."""
    out = const.sum(dim=0)
    for s in range(tables.shape[0]):
        out = out + F.embedding(ids[..., s].long(), tables[s])
    return out
