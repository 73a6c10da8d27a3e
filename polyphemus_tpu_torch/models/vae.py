"""The Polyphemus VAE: encoder, reparameterisation, decoder.

Counterpart of `polyphemus_tpu/models/vae.py`: `EmbedLinear`,
`ContentEncoder` (the histogram-fused front and the plain one),
`StructureEncoder`, `Encoder`, `StructureDecoder`, `ContentDecoder` (emit
'logits', 'tokens' or 'train_stats'), `Decoder` and `VAE` with `forward`,
`encode`, `train_stats`, `decode` and `decode_tokens`. `train()` and
`eval()` select the training form (batch statistics, dropout, the GCL
training kernels) or the eval form (running statistics, the fused eval GCL
kernel).

The compute dtype is the parameters' (fp32, or bf16 under the training
policy of `train/trainer.py`); the fp32 islands sit where the JAX package
has them: the histogram statistics of the fused front, the attention-pooling
softmax, the per-slot log-softmax and counts, and the losses.

Layout (as in the JAX package):
  mask:     (B, n_bars, T, S) bool — the structure tensor;
  tokens:   (B, n_bars, T, S, 16, 2) int — (pitch, dur) ids per slot, slot 0
            the SOS slot the encoder drops;
  c_logits: (B, n_bars, T, S, 15, 230).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import constants
from ..config import ModelConfig
from ..ops import fused_embed as fe
from ..ops import lattice
from ..ops import masked as mops
from ..ops.kernels import chord_tail as chord_k
from .gnn import GCN
from .layers import MLP, CNNDecoder, CNNEncoder, Dropout, MaskedBatchNorm

N_SLOTS = constants.MAX_SIMU_TOKENS - 1
STAT_KEYS = ("pitch_nll", "dur_nll", "n_p", "n_d", "c_p", "c_d", "c_both",
             "c_p_dr", "c_p_nd", "n_p_dr", "n_p_nd")


class DenseParams(nn.Module):
    """A (in, out) kernel and its bias, for layers whose application is
    scheduled by hand (the chord tail reads the kernel in this layout)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_dim, out_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim))
        nn.init.normal_(self.kernel, std=in_dim ** -0.5)


class EmbedLinear(DenseParams):
    """Token-id embedding equal to a Linear applied to a one-hot input:
    kernel (vocab, features) row lookup + bias."""

    def forward(self, ids):
        return F.embedding(ids, self.kernel) + self.bias

    def tables(self):
        return self.kernel, self.bias


def _gumbel_argmax(logits, temperature, generator):
    """A categorical sample of softmax(logits / temperature)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=logits.dtype).clamp_(min=1e-20)
    return (logits / temperature - torch.log(-torch.log(u))).argmax(-1)


def _slot_seeds(generator, device, n: int) -> list:
    """Independent seeds for n per-slot dropout draws (recomputable inside
    a checkpointed slot)."""
    return torch.randint(0, 2 ** 62, (n,), generator=generator,
                         device=device).tolist()


# ------------------------------------------------------------------ encoder
class ContentEncoder(nn.Module):
    """Token embeddings -> masked BN -> chord projection -> GCN -> attention
    pooling per bar -> (B, d)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        d, h = cfg.d, cfg.d // 2
        self.drums_pitch_emb = EmbedLinear(constants.N_PITCH_TOKENS, h)
        self.non_drums_pitch_emb = EmbedLinear(constants.N_PITCH_TOKENS, h)
        self.dur_emb = EmbedLinear(constants.N_DUR_TOKENS, h)
        self.bn_drums = MaskedBatchNorm(h)
        self.bn_non_drums = MaskedBatchNorm(h)
        self.bn_dur = MaskedBatchNorm(h)
        self.chord_encoder = DenseParams(N_SLOTS * d, d)
        self.graph_encoder = GCN(d, cfg.gnn_n_layers,
                                 num_relations=constants.N_EDGE_TYPES,
                                 num_dists=cfg.n_timesteps,
                                 batch_norm=cfg.batch_norm,
                                 dropout=cfg.dropout,
                                 message_dropout=cfg.message_dropout)
        self.gate_mlp = MLP(d, [1], activation=False, dropout=cfg.dropout)
        self.gate_bn = MaskedBatchNorm(1)
        self.bars_encoder = nn.Linear(cfg.n_bars * d, d)
        self.drop = Dropout(cfg.dropout)

    def _fused_front(self, pitch_ids, dur_ids, mask):
        """Embedding + BN + chord projection through per-slot lookup tables
        (`ops/fused_embed.py`): no (cells, slots, d) intermediate."""
        d, h = self.cfg.d, self.cfg.d // 2
        ck, cb = self.chord_encoder.kernel, self.chord_encoder.bias
        pids_dr, pids_nd = pitch_ids[..., :1, :, :], pitch_ids[..., 1:, :, :]
        dids_dr, dids_nd = dur_ids[..., :1, :, :], dur_ids[..., 1:, :, :]
        m_dr, m_nd = mask[..., :1, :], mask[..., 1:, :]
        w_slots = ck.reshape(N_SLOTS, d, d)
        w_p, w_d = w_slots[:, :h, :], w_slots[:, h:, :]

        def affine(bn, table, ebias, ids, cmask):
            if not self.training:
                return bn.affine_from_stats(*bn.running_stats())
            st = fe.embedding_stats(table, ebias, ids, cmask)
            bn.update_running(st.mean, st.var, st.count)
            return bn.affine_from_stats(st.mean, st.var)

        pk_d, pb_d = self.drums_pitch_emb.tables()
        pk_n, pb_n = self.non_drums_pitch_emb.tables()
        dk, db = self.dur_emb.tables()
        a_pd, b_pd = affine(self.bn_drums, pk_d, pb_d, pids_dr, m_dr)
        a_pn, b_pn = affine(self.bn_non_drums, pk_n, pb_n, pids_nd, m_nd)
        # the shared duration BN: drums group first, then non-drums (its
        # running statistics update twice, in that order)
        a_dd, b_dd = affine(self.bn_dur, dk, db, dids_dr, m_dr)
        a_dn, b_dn = affine(self.bn_dur, dk, db, dids_nd, m_nd)

        t_pd, c_pd = fe.fused_tables(pk_d, pb_d, a_pd, b_pd, w_p)
        t_pn, c_pn = fe.fused_tables(pk_n, pb_n, a_pn, b_pn, w_p)
        t_dd, c_dd = fe.fused_tables(dk, db, a_dd, b_dd, w_d)
        t_dn, c_dn = fe.fused_tables(dk, db, a_dn, b_dn, w_d)
        x_dr = (fe.gather_sum(t_pd, c_pd, pids_dr)
                + fe.gather_sum(t_dd, c_dd, dids_dr) + cb)
        x_nd = (fe.gather_sum(t_pn, c_pn, pids_nd)
                + fe.gather_sum(t_dn, c_dn, dids_nd) + cb)
        return torch.cat([x_dr, x_nd], dim=-3).to(ck.dtype)

    def _plain_front(self, pitch_ids, dur_ids, mask):
        """Per-slot embeddings (..., 15, d/2), masked BN, chord Linear."""
        d, h = self.cfg.d, self.cfg.d // 2
        drums_pitch = self.drums_pitch_emb(pitch_ids[..., :1, :, :])
        nd_pitch = self.non_drums_pitch_emb(pitch_ids[..., 1:, :, :])
        drums_dur = self.dur_emb(dur_ids[..., :1, :, :])
        nd_dur = self.dur_emb(dur_ids[..., 1:, :, :])
        m_dr = mask[..., :1, :, None].expand(drums_pitch.shape[:-1])
        m_nd = mask[..., 1:, :, None].expand(nd_pitch.shape[:-1])
        drums_pitch = self.bn_drums(drums_pitch, m_dr)
        nd_pitch = self.bn_non_drums(nd_pitch, m_nd)
        drums_dur = self.bn_dur(drums_dur, m_dr)
        nd_dur = self.bn_dur(nd_dur, m_nd)
        # the chord projection split into its pitch-row and duration-row
        # blocks: the same math as [pitch; dur] per slot @ kernel
        ck3 = self.chord_encoder.kernel.reshape(N_SLOTS, d, d)
        w_p = ck3[:, :h, :].reshape(N_SLOTS * h, d)
        w_d = ck3[:, h:, :].reshape(N_SLOTS * h, d)

        def flat(t):
            return t.reshape(t.shape[:-2] + (N_SLOTS * h,))

        x_dr = flat(drums_pitch) @ w_p + flat(drums_dur) @ w_d
        x_nd = flat(nd_pitch) @ w_p + flat(nd_dur) @ w_d
        return torch.cat([x_dr, x_nd], dim=-3) + self.chord_encoder.bias

    def forward(self, tokens, mask):
        cfg = self.cfg
        toks = tokens[..., 1:, :].long()  # drop the SOS slot
        pitch_ids, dur_ids = toks[..., 0], toks[..., 1]
        front = (self._fused_front if cfg.fused_content_encoder
                 else self._plain_front)
        x = torch.relu(front(pitch_ids, dur_ids, mask))
        x = self.drop(x) * mask[..., None].to(x.dtype)
        x = self.graph_encoder(x, mask)
        gates = self.gate_bn(self.gate_mlp(x), mask)
        pooled = mops.attention_pool_bars(x, gates, mask)  # (B, nb, d)
        return self.bars_encoder(pooled.reshape(pooled.shape[0], -1))


class StructureEncoder(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.cnn_encoder = CNNEncoder(cfg.d, cfg.d, cfg.n_tracks,
                                      cfg.n_timesteps, cfg.batch_norm,
                                      cfg.dropout)
        self.bars_encoder = nn.Linear(cfg.n_bars * cfg.d, cfg.d)

    def forward(self, s_float):
        cfg = self.cfg
        b = s_float.shape[0]
        x = self.cnn_encoder(s_float.reshape(b * cfg.n_bars, cfg.n_tracks,
                                             cfg.n_timesteps))
        return self.bars_encoder(x.reshape(b, cfg.n_bars * cfg.d))


class Encoder(nn.Module):
    """(tokens, mask) -> (mu, log_var), each (B, d)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        d = cfg.d
        self.c_encoder = ContentEncoder(cfg)
        self.s_encoder = StructureEncoder(cfg)
        self.linear_merge = nn.Linear(2 * d, d)
        self.bn_linear_merge = MaskedBatchNorm(d)
        self.linear_mu = nn.Linear(d, d)
        self.linear_log_var = nn.Linear(d, d)
        self.drop = Dropout(cfg.dropout)

    def forward(self, tokens, mask):
        z_c = self.c_encoder(tokens, mask)
        z_s = self.s_encoder(mask.to(z_c.dtype))
        z_g = self.linear_merge(self.drop(torch.cat([z_c, z_s], dim=-1)))
        z_g = self.drop(torch.relu(self.bn_linear_merge(z_g)))
        return self.linear_mu(z_g), self.linear_log_var(z_g)


# ------------------------------------------------------------------ decoder
class StructureDecoder(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.bars_decoder = nn.Linear(cfg.d, cfg.d * cfg.n_bars)
        self.cnn_decoder = CNNDecoder(cfg.d, cfg.d, cfg.n_tracks,
                                      cfg.n_timesteps, cfg.batch_norm,
                                      cfg.dropout)

    def forward(self, z_s):
        cfg = self.cfg
        out = self.bars_decoder(z_s).reshape(-1, cfg.d)
        out = self.cnn_decoder(out)
        return out.reshape(z_s.shape[0], cfg.n_bars, cfg.n_tracks,
                           cfg.n_timesteps)


class ContentDecoder(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        d, h = cfg.d, cfg.d // 2
        self.bars_decoder = nn.Linear(d, d * cfg.n_bars)
        self.graph_decoder = GCN(d, cfg.gnn_n_layers,
                                 num_relations=constants.N_EDGE_TYPES,
                                 num_dists=cfg.n_timesteps,
                                 batch_norm=cfg.batch_norm,
                                 chain=cfg.gcl_chain, dropout=cfg.dropout,
                                 message_dropout=cfg.message_dropout)
        self.chord_decoder = DenseParams(d, N_SLOTS * d)
        self.drums_pitch_emb = DenseParams(h, constants.N_PITCH_TOKENS)
        self.non_drums_pitch_emb = DenseParams(h, constants.N_PITCH_TOKENS)
        self.dur_emb = DenseParams(h, constants.N_DUR_TOKENS)
        self.drop = Dropout(cfg.dropout)

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

    def _slot_stats(self, x, w, b, pt, dt, act, is_drum, seed):
        """Masked-CE sums and accuracy counts of one note slot (the
        training statistics; `seed` draws this slot's dropout mask)."""
        f32 = torch.float32
        slot_h = x @ w + b
        if seed is not None:
            p = self.drop.p
            gen = torch.Generator(device=x.device).manual_seed(seed)
            keep = torch.rand(slot_h.shape, generator=gen,
                              device=x.device) >= p
            slot_h = torch.where(keep, slot_h / (1.0 - p),
                                 torch.zeros_like(slot_h))
        pitch, dur = self._unembed(slot_h, track_axis=-3)
        lp_p = torch.log_softmax(pitch.to(f32), dim=-1)
        lp_d = torch.log_softmax(dur.to(f32), dim=-1)
        nll_p = -lp_p.gather(-1, pt[..., None])[..., 0]
        nll_d = -lp_d.gather(-1, dt[..., None])[..., 0]
        w_p = act & (pt != constants.PitchToken.PAD)
        w_d = act & (dt != constants.DurationToken.PAD)
        cp = (lp_p.argmax(-1) == pt) & w_p
        cd = (lp_d.argmax(-1) == dt) & w_d

        def count(v):
            return v.to(f32).sum()

        return ((nll_p * w_p.to(f32)).sum(), (nll_d * w_d.to(f32)).sum(),
                count(w_p), count(w_d), count(cp), count(cd),
                count(cp & cd), count(cp & is_drum), count(cp & ~is_drum),
                count(w_p & is_drum), count(w_p & ~is_drum))

    def _train_stats(self, x, mask, targets):
        """Per-slot loss statistics against targets (..., 15, 2): neither
        the logits nor the slot hiddens are kept for the backward (each
        slot is recomputed there)."""
        d = self.cfg.d
        ck, cb = self.chord_decoder.kernel, self.chord_decoder.bias
        targets = targets.long()
        is_drum = torch.zeros_like(mask)
        is_drum[..., 0, :] = True
        drop = self.training and self.drop.p > 0
        seeds = (_slot_seeds(self.drop.generator, x.device, N_SLOTS) if drop
                 else [None] * N_SLOTS)
        stats = [torch.zeros((), device=x.device)] * len(STAT_KEYS)
        for s in range(N_SLOTS):
            upd = checkpoint(self._slot_stats, x, ck[:, s * d:(s + 1) * d],
                             cb[s * d:(s + 1) * d], targets[..., s, 0],
                             targets[..., s, 1], mask, is_drum, seeds[s],
                             use_reentrant=False)
            stats = [a + u for a, u in zip(stats, upd)]
        return dict(zip(STAT_KEYS, stats))

    def forward(self, z_c, mask, *, emit: str = "logits",
                temperature: float = 0.0,
                generator: Optional[torch.Generator] = None,
                gcl_chain: Optional[int] = None, targets=None):
        cfg = self.cfg
        d = cfg.d
        z_bars = self.bars_decoder(z_c).reshape(z_c.shape[0], cfg.n_bars, d)
        # each bar latent broadcast to its active cells
        x = z_bars[:, :, None, None, :] * mask[..., None].to(z_bars.dtype)
        x = self.graph_decoder(x, mask, chain=gcl_chain)
        ck, cb = self.chord_decoder.kernel, self.chord_decoder.bias

        if emit == "train_stats":
            if targets is None:
                raise ValueError("emit='train_stats' needs targets")
            return self._train_stats(x, mask, targets)
        if emit == "logits":
            y = (x @ ck + cb).reshape(x.shape[:-1] + (N_SLOTS, d))
            pitch, dur = self._unembed(self.drop(y), track_axis=-4)
            return torch.cat([pitch, dur], dim=-1)
        if emit != "tokens":
            raise ValueError(f"unknown emit {emit!r}")
        if temperature == 0:
            pd, pn, du = (self.drums_pitch_emb, self.non_drums_pitch_emb,
                          self.dur_emb)
            return chord_k.chord_tail_tokens(
                x, ck, cb, pd.kernel, pd.bias, pn.kernel, pn.bias,
                du.kernel, du.bias, n_slots=N_SLOTS)
        ids = []
        for s in range(N_SLOTS):
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
        self.drop = Dropout(cfg.dropout)

    def forward(self, z, mask=None, *, emit: str = "logits",
                structure_temp: float = 0.0, content_temp: float = 0.0,
                generator: Optional[torch.Generator] = None,
                gcl_chain: Optional[int] = None, targets=None):
        d = self.cfg.d
        z = self.drop(torch.relu(self.batch_norm(self.lin_decoder(z))))
        z_s, z_c = z[:, :d], z[:, d:]
        s_logits = self.s_decoder(z_s)
        if mask is None:
            raw = s_logits.detach()
            if structure_temp > 0:
                probs = torch.sigmoid(raw / structure_temp)
                mask = torch.bernoulli(probs, generator=generator).bool()
            else:
                mask = torch.sigmoid(raw) >= self.sigmoid_thresh
            mask = lattice.ensure_nonempty_bars(mask)
        c_out = self.c_decoder(z_c, mask, emit=emit, temperature=content_temp,
                               generator=generator, gcl_chain=gcl_chain,
                               targets=targets)
        return s_logits, c_out, mask


class VAE(nn.Module):
    """encode -> reparameterise -> decode. The reparameterisation noise
    `eps` (B, d) is the caller's, or drawn from `generator`."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)

    def set_dropout_generator(self, generator: Optional[torch.Generator]):
        """Draw every dropout mask of the model from `generator`."""
        for mod in self.modules():
            if isinstance(mod, Dropout):
                mod.generator = generator

    def _latent(self, tokens, mask, eps, generator):
        mask = lattice.ensure_nonempty_bars(mask)
        mu, log_var = self.encoder(tokens, mask)
        if eps is None:
            eps = torch.randn(mu.shape, generator=generator, device=mu.device,
                              dtype=mu.dtype)
        eps = eps.to(mu.dtype)  # the noise rides the compute dtype
        return mask, mu + torch.exp(0.5 * log_var) * eps, mu, log_var

    def forward(self, tokens, mask, *, eps=None,
                generator: Optional[torch.Generator] = None):
        """((s_logits, c_logits), mu, log_var) — the logits path."""
        mask, z, mu, log_var = self._latent(tokens, mask, eps, generator)
        s_logits, c_logits, _ = self.decoder(z, mask)
        return (s_logits, c_logits), mu, log_var

    def train_stats(self, tokens, mask, *, eps=None,
                    generator: Optional[torch.Generator] = None):
        """((s_logits, stats), mu, log_var): the same pass as `forward`
        with per-slot loss statistics (`STAT_KEYS`) in place of the content
        logits, which never exist whole; `train.losses` and `train.metrics`
        map them to the seven losses and nine metrics."""
        mask, z, mu, log_var = self._latent(tokens, mask, eps, generator)
        s_logits, stats, _ = self.decoder(z, mask, emit="train_stats",
                                          targets=tokens[..., 1:, :])
        return (s_logits, stats), mu, log_var

    def encode(self, tokens, mask):
        """(mu, log_var), each (B, d)."""
        return self.encoder(tokens, lattice.ensure_nonempty_bars(mask))

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
