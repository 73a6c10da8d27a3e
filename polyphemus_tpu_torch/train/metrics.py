"""Training metrics: the nine of the reference trainer — note, pitch,
pitch_drums, pitch_non_drums, dur, s_acc, s_precision, s_recall, s_f1.

Counterpart of `polyphemus_tpu/train/metrics.py`. `ref_parity=True`
reproduces the reference bug where the structure metrics are computed on
targets reinterpreted as logits: after the sigmoid >= 0.5 threshold every
cell predicts active, so s_acc = s_precision = the target density and
s_recall = 1. Metrics carry no gradient. Under a process group
(`parallel.mesh`) every count is summed over the ranks before a ratio is
taken: each rank reports the global batch's metrics.
"""
from __future__ import annotations

import torch

from .. import constants
from ..parallel import mesh as pmesh


def _ratio(num, den):
    return num / torch.as_tensor(den, dtype=torch.float32).clamp(min=1e-12)


def _f(v):
    return v.to(torch.float32).sum()


def _global(*counts):
    """The 0-d fp32 `counts`, each summed over the ranks (one
    all-reduce)."""
    return pmesh.all_reduce_sum(torch.stack(counts)).unbind()


@torch.no_grad()
def structure_metrics(s_logits, mask, *, ref_parity: bool = False):
    s_true = mask
    s_pred = (torch.ones_like(mask) if ref_parity
              else torch.sigmoid(s_logits) >= 0.5)
    tp, agree, pred, true, cells = _global(
        _f(s_pred & s_true), _f(s_pred == s_true), _f(s_pred), _f(s_true),
        torch.full((), float(s_true.numel()), device=s_true.device))
    s_acc = _ratio(agree, cells)
    s_precision = _ratio(tp, pred)
    s_recall = _ratio(tp, true)
    s_f1 = _ratio(2 * s_recall * s_precision, s_recall + s_precision)
    return {"s_acc": s_acc, "s_precision": s_precision,
            "s_recall": s_recall, "s_f1": s_f1}


@torch.no_grad()
def compute_accuracies(s_logits, c_logits, tokens, mask,
                       *, ref_parity: bool = False):
    """The nine metrics from the content logits (..., 15, 230)."""
    targets = tokens[..., 1:, :]
    pitch_true, dur_true = targets[..., 0], targets[..., 1]
    act = mask[..., None].expand(pitch_true.shape)
    pitch_rec = c_logits[..., :constants.N_PITCH_TOKENS].argmax(-1)
    dur_rec = c_logits[..., constants.N_PITCH_TOKENS:].argmax(-1)
    np_pad = act & (pitch_true != constants.PitchToken.PAD)
    nd_pad = act & (dur_true != constants.DurationToken.PAD)
    correct_p = (pitch_rec == pitch_true) & np_pad
    correct_d = (dur_rec == dur_true) & nd_pad
    drum = torch.zeros_like(act)
    drum[..., 0, :, :] = True
    c_both, n_p, c_p, c_p_dr, n_p_dr, c_p_nd, n_p_nd, c_d, n_d = _global(
        _f(correct_p & correct_d), _f(np_pad), _f(correct_p),
        _f(correct_p & drum), _f(np_pad & drum), _f(correct_p & ~drum),
        _f(np_pad & ~drum), _f(correct_d), _f(nd_pad))
    out = {
        "note": _ratio(c_both, n_p),
        "pitch": _ratio(c_p, n_p),
        "pitch_drums": _ratio(c_p_dr, n_p_dr),
        "pitch_non_drums": _ratio(c_p_nd, n_p_nd),
        "dur": _ratio(c_d, n_d),
    }
    out.update(structure_metrics(s_logits, mask, ref_parity=ref_parity))
    return out


@torch.no_grad()
def accuracies_from_stats(stats, s_logits, mask, *,
                          ref_parity: bool = False):
    """The nine metrics from the per-slot statistics of `VAE.train_stats`."""
    keys = ("c_both", "n_p", "c_p", "c_p_dr", "n_p_dr", "c_p_nd", "n_p_nd",
            "c_d", "n_d")
    c = dict(zip(keys, _global(*(stats[k].detach() for k in keys))))
    out = {
        "note": _ratio(c["c_both"], c["n_p"]),
        "pitch": _ratio(c["c_p"], c["n_p"]),
        "pitch_drums": _ratio(c["c_p_dr"], c["n_p_dr"]),
        "pitch_non_drums": _ratio(c["c_p_nd"], c["n_p_nd"]),
        "dur": _ratio(c["c_d"], c["n_d"]),
    }
    out.update(structure_metrics(s_logits, mask, ref_parity=ref_parity))
    return {k: v.detach() for k, v in out.items()}
