"""The Polyphemus VAE, decoder half, eval form.

Counterpart of `polyphemus_tpu/models/vae.py`: `StructureDecoder`,
`ContentDecoder` (emit 'logits' or 'tokens'), `Decoder` and a `VAE` shell
with `decode` and `decode_tokens`. The encoder is not ported yet.

Layout (as in the JAX package):
  mask:     (B, n_bars, T, S) bool — the structure tensor;
  tokens:   (B, n_bars, T, S, 15, 2) int32 — (pitch, dur) ids per slot;
  c_logits: (B, n_bars, T, S, 15, 230).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .. import constants
from ..config import ModelConfig
from ..ops import lattice
from ..ops.kernels import chord_tail as chord_k
from .gnn import GCN
from .layers import CNNDecoder, MaskedBatchNorm


class DenseParams(nn.Module):
    """A (in, out) kernel and its bias, for layers whose application is
    scheduled by hand (the chord tail reads the kernel in this layout)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_dim, out_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim))
        nn.init.normal_(self.kernel, std=in_dim ** -0.5)


class StructureDecoder(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.bars_decoder = nn.Linear(cfg.d, cfg.d * cfg.n_bars)
        self.cnn_decoder = CNNDecoder(cfg.d, cfg.d, cfg.n_tracks,
                                      cfg.n_timesteps, cfg.batch_norm)

    def forward(self, z_s):
        cfg = self.cfg
        out = self.bars_decoder(z_s).reshape(-1, cfg.d)
        out = self.cnn_decoder(out)
        return out.reshape(z_s.shape[0], cfg.n_bars, cfg.n_tracks,
                           cfg.n_timesteps)


def _gumbel_argmax(logits, temperature, generator):
    """A categorical sample of softmax(logits / temperature)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=logits.dtype).clamp_(min=1e-20)
    return (logits / temperature - torch.log(-torch.log(u))).argmax(-1)


class ContentDecoder(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        d, h = cfg.d, cfg.d // 2
        n_slots = constants.MAX_SIMU_TOKENS - 1
        self.bars_decoder = nn.Linear(d, d * cfg.n_bars)
        self.graph_decoder = GCN(d, cfg.gnn_n_layers,
                                 num_relations=constants.N_EDGE_TYPES,
                                 num_dists=cfg.n_timesteps,
                                 batch_norm=cfg.batch_norm,
                                 chain=cfg.gcl_chain)
        self.chord_decoder = DenseParams(d, n_slots * d)
        self.drums_pitch_emb = DenseParams(h, constants.N_PITCH_TOKENS)
        self.non_drums_pitch_emb = DenseParams(h, constants.N_PITCH_TOKENS)
        self.dur_emb = DenseParams(h, constants.N_DUR_TOKENS)

    def _unembed(self, slot_h, track_axis):
        """Slot hiddens (..., T, ..., d) -> pitch and duration logits."""
        h = self.cfg.d // 2
        ph, dh = slot_h[..., :h], slot_h[..., h:]
        pd, pn = self.drums_pitch_emb, self.non_drums_pitch_emb
        drums = ph.narrow(track_axis, 0, 1) @ pd.kernel + pd.bias
        melodic = ph.narrow(track_axis, 1, ph.shape[track_axis] - 1) \
            @ pn.kernel + pn.bias
        pitch = torch.cat([drums, melodic], dim=track_axis)
        return pitch, dh @ self.dur_emb.kernel + self.dur_emb.bias

    def forward(self, z_c, mask, *, emit: str = "logits",
                temperature: float = 0.0,
                generator: Optional[torch.Generator] = None,
                gcl_chain: Optional[int] = None):
        cfg = self.cfg
        d = cfg.d
        n_slots = constants.MAX_SIMU_TOKENS - 1
        z_bars = self.bars_decoder(z_c).reshape(z_c.shape[0], cfg.n_bars, d)
        # each bar latent broadcast to its active cells
        x = z_bars[:, :, None, None, :] * mask[..., None].to(z_bars.dtype)
        x = self.graph_decoder(x, mask, chain=gcl_chain)
        ck, cb = self.chord_decoder.kernel, self.chord_decoder.bias

        if emit == "logits":
            y = (x @ ck + cb).reshape(x.shape[:-1] + (n_slots, d))
            pitch, dur = self._unembed(y, track_axis=-4)
            return torch.cat([pitch, dur], dim=-1)
        if emit != "tokens":
            raise ValueError(f"unknown emit {emit!r}")
        if temperature == 0:
            pd, pn, du = (self.drums_pitch_emb, self.non_drums_pitch_emb,
                          self.dur_emb)
            return chord_k.chord_tail_tokens(
                x, ck, cb, pd.kernel, pd.bias, pn.kernel, pn.bias,
                du.kernel, du.bias, n_slots=n_slots)
        ids = []
        for s in range(n_slots):
            slot_h = x @ ck[:, s * d:(s + 1) * d] + cb[s * d:(s + 1) * d]
            pitch, dur = self._unembed(slot_h, track_axis=-3)
            ids.append(torch.stack(
                [_gumbel_argmax(pitch, temperature, generator),
                 _gumbel_argmax(dur, temperature, generator)], dim=-1))
        return torch.stack(ids, dim=-2).to(torch.int32)


class Decoder(nn.Module):
    """Decoder head: z -> structure logits -> threshold -> content."""

    def __init__(self, cfg: ModelConfig, sigmoid_thresh: float = 0.5):
        super().__init__()
        self.cfg = cfg
        self.sigmoid_thresh = sigmoid_thresh
        self.lin_decoder = nn.Linear(cfg.d, 2 * cfg.d)
        self.batch_norm = MaskedBatchNorm(2 * cfg.d)
        self.s_decoder = StructureDecoder(cfg)
        self.c_decoder = ContentDecoder(cfg)

    def forward(self, z, mask=None, *, emit: str = "logits",
                structure_temp: float = 0.0, content_temp: float = 0.0,
                generator: Optional[torch.Generator] = None,
                gcl_chain: Optional[int] = None):
        d = self.cfg.d
        z = torch.relu(self.batch_norm(self.lin_decoder(z)))
        z_s, z_c = z[:, :d], z[:, d:]
        s_logits = self.s_decoder(z_s)
        if mask is None:
            if structure_temp > 0:
                probs = torch.sigmoid(s_logits / structure_temp)
                mask = torch.bernoulli(probs, generator=generator).bool()
            else:
                mask = torch.sigmoid(s_logits) >= self.sigmoid_thresh
            mask = lattice.ensure_nonempty_bars(mask)
        c_out = self.c_decoder(z_c, mask, emit=emit, temperature=content_temp,
                               generator=generator, gcl_chain=gcl_chain)
        return s_logits, c_out, mask


class VAE(nn.Module):
    """Shell holding the decoder; `decode` and `decode_tokens` as in the JAX
    package (the encoder and the training forward wait)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.decoder = Decoder(cfg)

    def decode(self, z, mask=None, *, gcl_chain: Optional[int] = None):
        """(s_logits, c_logits, mask) — the logits path."""
        return self.decoder(z, mask, gcl_chain=gcl_chain)

    def decode_tokens(self, z, mask=None, *, structure_temp: float = 0.0,
                      content_temp: float = 0.0,
                      generator: Optional[torch.Generator] = None,
                      gcl_chain: Optional[int] = None):
        """(s_logits, token ids, mask): unembed + argmax (or sampling at a
        temperature > 0) per slot, without the logits tensor."""
        return self.decoder(z, mask, emit="tokens",
                            structure_temp=structure_temp,
                            content_temp=content_temp, generator=generator,
                            gcl_chain=gcl_chain)
