"""Training losses: the seven components of the reference trainer — tot,
pitch, dur, structure, reconstruction, kld, beta*kld.

Counterpart of `polyphemus_tpu/train/losses.py`. Dense layout: c_logits
(B, nb, T, S, 15, 230); targets are token ids (B, nb, T, S, 16, 2) (slot 0 =
SOS, dropped). Cross-entropies ignore PAD tokens and inactive lattice cells.
The loss math runs in fp32.

`ref_parity=True` reproduces the reference's structure-loss bug, where the
targets are passed as logits (the structure loss becomes BCE(target,
target)).
"""
from __future__ import annotations

import torch

from .. import constants


def _masked_ce(logits, labels, weights):
    """Mean cross-entropy over the elements with weights > 0."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = logp.gather(-1, labels.long()[..., None])[..., 0]
    w = weights.to(logits.dtype)
    return -(ll * w).sum() / w.sum().clamp(min=1.0)


def structure_loss(s_logits, mask, *, ref_parity: bool = False):
    """BCE-with-logits on the structure tensor; ref_parity feeds the
    targets back as logits (the reference bug)."""
    s_target = mask.to(torch.float32)
    s_in = s_target if ref_parity else s_logits.to(torch.float32)
    return (s_in.clamp(min=0) - s_in * s_target
            + torch.log1p(torch.exp(-s_in.abs()))).mean()


def kld_loss(mu, log_var):
    mu, log_var = mu.to(torch.float32), log_var.to(torch.float32)
    kld = -0.5 * (1 + log_var - mu.square() - log_var.exp()).sum(dim=1)
    return kld.mean()


def _assemble(pitch_loss, dur_loss, s_loss, kld, beta):
    rec = pitch_loss + dur_loss + s_loss
    tot = rec + beta * kld
    return tot, {"tot": tot, "pitch": pitch_loss, "dur": dur_loss,
                 "structure": s_loss, "reconstruction": rec, "kld": kld,
                 "beta*kld": beta * kld}


def compute_losses(s_logits, c_logits, tokens, mask, mu, log_var, beta,
                   *, ref_parity: bool = False):
    """Returns (tot_loss, dict of the seven scalar losses) from the content
    logits."""
    c_logits = c_logits.to(torch.float32)
    targets = tokens[..., 1:, :]
    pitch_true, dur_true = targets[..., 0], targets[..., 1]
    act = mask[..., None].expand(pitch_true.shape)
    pitch_w = act & (pitch_true != constants.PitchToken.PAD)
    dur_w = act & (dur_true != constants.DurationToken.PAD)
    pitch_loss = _masked_ce(c_logits[..., :constants.N_PITCH_TOKENS],
                            pitch_true, pitch_w)
    dur_loss = _masked_ce(c_logits[..., constants.N_PITCH_TOKENS:], dur_true,
                          dur_w)
    return _assemble(pitch_loss, dur_loss,
                     structure_loss(s_logits, mask, ref_parity=ref_parity),
                     kld_loss(mu, log_var), beta)


def losses_from_stats(stats, s_logits, mask, mu, log_var, beta,
                      *, ref_parity: bool = False):
    """The seven losses from the per-slot content statistics of
    `VAE.train_stats`: the logits tensor never exists."""
    pitch_loss = stats["pitch_nll"] / stats["n_p"].clamp(min=1.0)
    dur_loss = stats["dur_nll"] / stats["n_d"].clamp(min=1.0)
    return _assemble(pitch_loss, dur_loss,
                     structure_loss(s_logits, mask, ref_parity=ref_parity),
                     kld_loss(mu, log_var), beta)

