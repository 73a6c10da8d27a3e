"""Typed configuration, JSON-compatible with `polyphemus_tpu.config`.

The field names are those of the reference's training.json, so one
`config.json` loads in both packages; keys a package does not know are
ignored. The TPU tiling knobs of the JAX package (`use_pallas_gcl`,
`gcl_bars_per_block`, `tail_bars_per_block`) have no counterpart here: on a
CUDA device the hand-written kernels always run.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping

from . import constants


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    d: int = 512
    gnn_n_layers: int = 8
    n_bars: int = 2
    resolution: int = constants.DEFAULT_RESOLUTION
    dropout: float = 0.0
    # Per-message dropout inside each GCL (training only; the reference
    # hard-codes p=0.1). Not ported: training with it > 0 raises.
    message_dropout: float = 0.0
    message_dropout_mode: str = "edge"
    batch_norm: bool = True
    # GCL layers fused per `gcl_eval` launch on the generation path. A
    # scheduling choice only: the outputs do not depend on it.
    # `generate.make_generator` runs 2 when this is left at 1.
    gcl_chain: int = 1
    # Content-encoder front: the histogram-fused one (`ops/fused_embed.py`,
    # no per-slot embedding tensors) or the plain per-slot embeddings. The
    # same math and parameters.
    fused_content_encoder: bool = True

    @property
    def n_timesteps(self) -> int:
        return constants.timesteps_per_bar(self.resolution)

    @property
    def n_tracks(self) -> int:
        return constants.N_TRACKS


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 5e-06
    betas: tuple[float, float] = (0.9, 0.98)
    eps: float = 1e-09
    weight_decay: float = 0.0


@dataclasses.dataclass(frozen=True)
class LRSchedulerConfig:
    peak_lr: float = 1e-4
    warmup_steps: int = 8000
    final_lr_scale: float = 0.01
    decay_steps: int = 800_000
    ramp_warmup: bool = False


@dataclasses.dataclass(frozen=True)
class BetaSchedulerConfig:
    anneal_start: int = 40_000
    anneal_end: int = 500_000
    beta_max: float = 0.01
    step_size: float = 0.001


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    data_axis: int = -1
    model_axis: int = 1


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 256
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    lr_scheduler: LRSchedulerConfig = dataclasses.field(default_factory=LRSchedulerConfig)
    beta_scheduler: BetaSchedulerConfig = dataclasses.field(default_factory=BetaSchedulerConfig)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)
    iters_to_accumulate: int = 1
    bf16: bool = False
    fused_ce: bool = True
    seed: int = 0
    ref_parity: bool = False


def _filter_kwargs(cls, d: Mapping[str, Any]) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


def train_config_from_dict(raw: Mapping[str, Any]) -> TrainConfig:
    """Build a TrainConfig from a reference-style training.json dict."""
    model = ModelConfig(**_filter_kwargs(ModelConfig, raw.get("model", {})))
    opt_raw = dict(raw.get("optimizer", {}))
    if "betas" in opt_raw:
        opt_raw["betas"] = tuple(opt_raw["betas"])
    optimizer = OptimizerConfig(**_filter_kwargs(OptimizerConfig, opt_raw))
    lr = LRSchedulerConfig(**_filter_kwargs(LRSchedulerConfig, raw.get("lr_scheduler", {})))
    beta = BetaSchedulerConfig(**_filter_kwargs(BetaSchedulerConfig, raw.get("beta_scheduler", {})))
    parallel = ParallelConfig(**_filter_kwargs(ParallelConfig, raw.get("parallel", {})))
    top = _filter_kwargs(TrainConfig, raw)
    for k in ("model", "optimizer", "lr_scheduler", "beta_scheduler", "parallel"):
        top.pop(k, None)
    return TrainConfig(model=model, optimizer=optimizer, lr_scheduler=lr,
                       beta_scheduler=beta, parallel=parallel, **top)


def train_config_to_dict(cfg: TrainConfig) -> dict:
    d = dataclasses.asdict(cfg)
    d["optimizer"]["betas"] = list(d["optimizer"]["betas"])
    return d


def load_train_config(path: str) -> TrainConfig:
    with open(path) as f:
        return train_config_from_dict(json.load(f))


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    """Rendering config: MIDI programs per track and the soundfont path
    (audio rendering is not ported yet)."""

    midi_programs: Mapping[str, int] = dataclasses.field(
        default_factory=lambda: dict(constants.DEFAULT_MIDI_PROGRAMS))
    soundfont_path: str = constants.DEFAULT_SOUNDFONT_PATH

