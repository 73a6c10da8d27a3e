"""Training metrics: the nine of the reference trainer — note, pitch,
pitch_drums, pitch_non_drums, dur, s_acc, s_precision, s_recall, s_f1.

Counterpart of `polyphemus_tpu/train/metrics.py`. `ref_parity=True`
reproduces the reference bug where the structure metrics are computed on
targets reinterpreted as logits: after the sigmoid >= 0.5 threshold every
cell predicts active, so s_acc = s_precision = the target density and
s_recall = 1. Metrics carry no gradient.
"""
from __future__ import annotations

import torch

from .. import constants


def _ratio(num, den):
    return num / torch.as_tensor(den, dtype=torch.float32).clamp(min=1e-12)


def _f(v):
    return v.to(torch.float32).sum()


@torch.no_grad()
def structure_metrics(s_logits, mask, *, ref_parity: bool = False):
    s_true = mask
    s_pred = (torch.ones_like(mask) if ref_parity
              else torch.sigmoid(s_logits) >= 0.5)
    tp = _f(s_pred & s_true)
    s_acc = _ratio(_f(s_pred == s_true), s_true.numel())
    s_precision = _ratio(tp, _f(s_pred))
    s_recall = _ratio(tp, _f(s_true))
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
    out = {
        "note": _ratio(_f(correct_p & correct_d), _f(np_pad)),
        "pitch": _ratio(_f(correct_p), _f(np_pad)),
        "pitch_drums": _ratio(_f(correct_p & drum), _f(np_pad & drum)),
        "pitch_non_drums": _ratio(_f(correct_p & ~drum), _f(np_pad & ~drum)),
        "dur": _ratio(_f(correct_d), _f(nd_pad)),
    }
    out.update(structure_metrics(s_logits, mask, ref_parity=ref_parity))
    return out


@torch.no_grad()
def accuracies_from_stats(stats, s_logits, mask, *,
                          ref_parity: bool = False):
    """The nine metrics from the per-slot statistics of `VAE.train_stats`."""
    out = {
        "note": _ratio(stats["c_both"], stats["n_p"]),
        "pitch": _ratio(stats["c_p"], stats["n_p"]),
        "pitch_drums": _ratio(stats["c_p_dr"], stats["n_p_dr"]),
        "pitch_non_drums": _ratio(stats["c_p_nd"], stats["n_p_nd"]),
        "dur": _ratio(stats["c_d"], stats["n_d"]),
    }
    out.update(structure_metrics(s_logits, mask, ref_parity=ref_parity))
    return {k: v.detach() for k, v in out.items()}
