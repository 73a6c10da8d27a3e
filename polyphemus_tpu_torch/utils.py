"""Seeding, parameter tables, profiling and step timing.

Counterpart of `polyphemus_tpu/utils.py`'s `set_seed`, `param_count`,
`print_params`, `profile_trace` and `StepTimer`. Its XLA and TPU helpers
(compiler options, the compile cache, the backend wait) have no
counterpart here.
"""
from __future__ import annotations

import contextlib
import os
import random
import time
from typing import Iterator, Optional

import numpy as np
import torch


def set_seed(seed: int) -> None:
    """Seed Python's, numpy's and torch's global generators (the CPU's and
    every card's)."""
    np.random.seed(seed)
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    torch.manual_seed(seed)


def param_count(module: torch.nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


def print_params(module: torch.nn.Module, log_fn=print) -> int:
    """Per-parameter table + total (reference utils.py:31-48)."""
    rows = [(name, p.numel()) for name, p in module.named_parameters()]
    width = max((len(n) for n, _ in rows), default=10)
    log_fn(f"{'Module':<{width}} | Parameters")
    log_fn("-" * (width + 13))
    for name, n in rows:
        log_fn(f"{name:<{width}} | {n}")
    total = sum(n for _, n in rows)
    log_fn(f"Total Trainable Parameters: {total}")
    return total


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]) -> Iterator[None]:
    """`torch.profiler` trace of the block's host work and, where there is
    a card, its device work, written into `log_dir` as a Chrome trace
    (`trace.json`, for Perfetto or chrome://tracing) and a table of time by
    kernel (`kernels.txt`). No-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
        table = prof.key_averages().table(
            sort_by=("self_device_time_total" if cuda
                     else "self_cpu_time_total"), row_limit=40)
        with open(os.path.join(log_dir, "kernels.txt"), "w") as f:
            f.write(table + "\n")


class StepTimer:
    """Rolling per-step wall-clock stats for train/gen loops."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times: list[float] = []
        self._last: Optional[float] = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self.times.append(dt)
            if len(self.times) > self.window:
                self.times.pop(0)
        self._last = now
        return dt

    @property
    def mean(self) -> float:
        return float(np.mean(self.times)) if self.times else 0.0

    @property
    def steps_per_sec(self) -> float:
        m = self.mean
        return 1.0 / m if m > 0 else 0.0
