"""polyphemus_tpu_torch — the PyTorch/CUDA port of polyphemus_tpu.

The VAE (encoder and decoder), batched generation with its HTTP service,
and training in fp32 or under the bf16 compute policy (`cli.train`: losses,
metrics, schedules, Adam with gradient accumulation, checkpoints) run on an
NVIDIA Hopper card through
hand-written CUDA kernels (`ops/kernels`, sources in `csrc/`), each beside a
plain PyTorch version that the CPU tests hold against the JAX package.
"""

__version__ = "0.1.0"

from . import constants  # noqa: F401
from .config import (GenerationConfig, ModelConfig, TrainConfig,  # noqa: F401
                     load_train_config)
