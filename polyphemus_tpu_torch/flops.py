"""Analytic FLOP accounting and MFU, with the card's peaks.

Counterpart of `polyphemus_tpu/flops.py`, with the same formulas: *model*
FLOPs, the matmul and convolution work the architecture requires (2·M·N·K
per GEMM), not the work of an implementation (the GCL kernels' gathers and
edge gates count as zero). MFU = model FLOP rate / the card's peak for the
compute dtype.

The peaks are keyed by the name `torch.cuda.get_device_name()` returns and
by compute dtype. fp32 counts the CUDA cores: every fp32 path of the port
keeps TF32 off, so no fp32 product runs on the tensor cores. bf16 counts the
tensor cores' dense rate.

Per-sequence counts for the flagship LMD2 config (d=512, 8 layers, 2 bars):
generation ≈ 8.1 GFLOP, training fwd ≈ 16.5 GFLOP, training step ≈ 3x fwd.
"""
from __future__ import annotations

import torch

from . import constants
from .config import ModelConfig

# peak FLOP/s of one card: {torch.cuda.get_device_name(): {dtype: FLOP/s}}
PEAK_FLOPS = {
    # H100 SXM5 (700 W): the data sheet's 67 and 1979 (with sparsity)
    "NVIDIA H100 80GB HBM3": {
        torch.float32: 66.9e12,    # NVIDIA Hopper whitepaper: FP32 non-tensor
        torch.bfloat16: 989.4e12,  # NVIDIA Hopper whitepaper: BF16 dense
    },
}

_N_SLOTS = constants.MAX_SIMU_TOKENS - 1  # 15
_PV = constants.N_PITCH_TOKENS  # 131
_DV = constants.N_DUR_TOKENS  # 99


def peak_flops(device, dtype: torch.dtype) -> float:
    """The peak FLOP/s of `device` (a card's name, or a CUDA device) for
    compute in `dtype`. Raises KeyError naming the card when it or the
    dtype is not in `PEAK_FLOPS`."""
    name = device if isinstance(device, str) else \
        torch.cuda.get_device_name(device)
    try:
        return PEAK_FLOPS[name][dtype]
    except KeyError:
        raise KeyError(f"no peak FLOP/s of {name!r} in {dtype} in "
                       f"flops.PEAK_FLOPS") from None


def _gemm(m: float, n: float, k: float) -> float:
    return 2.0 * m * n * k


def gcn_flops(cfg: ModelConfig) -> float:
    """One GCN stack, per sequence. Per cell, each layer applies five d x d
    projections (its track relation, self, onset, next, root); edge gating
    is elementwise and not counted."""
    n_cells = cfg.n_bars * cfg.n_tracks * cfg.n_timesteps
    return cfg.gnn_n_layers * _gemm(n_cells, cfg.d, cfg.d) * 5


def _cnn_encoder_flops(cfg: ModelConfig) -> float:
    """CNNEncoder per bar (models/layers.py)."""
    t, s, d = cfg.n_tracks, cfg.n_timesteps, cfg.d
    conv0 = _gemm(t * s, 8, 1 * 9)
    conv1 = _gemm(t * (s // 4), 16, 8 * 9)
    lin0 = _gemm(1, d, 16 * t * (s // 4))
    lin1 = _gemm(1, d, d)
    return conv0 + conv1 + lin0 + lin1


def _cnn_decoder_flops(cfg: ModelConfig) -> float:
    """CNNDecoder per bar (models/layers.py)."""
    t, s, d = cfg.n_tracks, cfg.n_timesteps, cfg.d
    lin0 = _gemm(1, d, d)
    lin1 = _gemm(1, 16 * t * (s // 4), d)
    conv0 = _gemm(t * s, 8, 16 * 9)
    conv1 = _gemm(t * s, 1, 8 * 9)
    return lin0 + lin1 + conv0 + conv1


def encoder_flops(cfg: ModelConfig) -> float:
    """VAE encoder, per sequence (models/vae.py Encoder)."""
    d = cfg.d
    n_cells = cfg.n_bars * cfg.n_tracks * cfg.n_timesteps
    chord_enc = _gemm(n_cells, d, _N_SLOTS * d)
    gate = _gemm(n_cells, 1, d)
    pool = 2.0 * n_cells * d  # elementwise weight + segment sum
    bars_enc_c = _gemm(1, d, cfg.n_bars * d)
    s_enc = cfg.n_bars * _cnn_encoder_flops(cfg) + _gemm(1, d, cfg.n_bars * d)
    head = _gemm(1, d, 2 * d) + 2 * _gemm(1, d, d)
    return (chord_enc + gcn_flops(cfg) + gate + pool + bars_enc_c
            + s_enc + head)


def decoder_flops(cfg: ModelConfig) -> float:
    """VAE decoder = the whole generation pipeline, per sequence
    (structure decode + lattice + content decode + unembed)."""
    d, h = cfg.d, cfg.d // 2
    n_cells = cfg.n_bars * cfg.n_tracks * cfg.n_timesteps
    lin_dec = _gemm(1, 2 * d, d)
    s_dec = _gemm(1, cfg.n_bars * d, d) + cfg.n_bars * _cnn_decoder_flops(cfg)
    bars_dec_c = _gemm(1, cfg.n_bars * d, d)
    chord_dec = _gemm(n_cells, _N_SLOTS * d, d)
    unembed = _N_SLOTS * (_gemm(n_cells, _PV, h) + _gemm(n_cells, _DV, h))
    return (lin_dec + s_dec + bars_dec_c + gcn_flops(cfg)
            + chord_dec + unembed)


def generation_flops_per_seq(cfg: ModelConfig) -> float:
    """z -> token ids (`generate.make_generator`)."""
    return decoder_flops(cfg)


def train_fwd_flops_per_seq(cfg: ModelConfig) -> float:
    return encoder_flops(cfg) + decoder_flops(cfg)


def train_step_flops_per_seq(cfg: ModelConfig) -> float:
    """fwd + bwd ~= 3x fwd matmul FLOPs (each GEMM backward needs two GEMMs
    of the forward's size); optimizer update FLOPs are negligible."""
    return 3.0 * train_fwd_flops_per_seq(cfg)


def mfu(seq_per_sec: float, flops_per_seq: float, peak: float) -> float:
    """Model FLOPs utilization in percent of `peak` FLOP/s."""
    return 100.0 * seq_per_sec * flops_per_seq / peak
