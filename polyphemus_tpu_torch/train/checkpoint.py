"""Training checkpoints with resume.

Counterpart of `polyphemus_tpu/train/checkpoint.py`, keeping its two-name
scheme: a rolling `checkpoint` and `best_model` on validation improvement.
Each is one file, `<name>.pt`, holding {"model": state dict, "optimizer":
optimizer state, "step": completed updates, "meta": counters and
histories}. `checkpoint.pt` is also what `convert.load_checkpoint` and
`generate.load_model` read, so a training directory serves as it is.
Saves are synchronous and atomic (written beside, then renamed).
"""
from __future__ import annotations

import os

import torch


def path(model_dir: str, name: str) -> str:
    return os.path.join(model_dir, name + ".pt")


def save_checkpoint(model_dir: str, name: str, model, optimizer, step: int,
                    meta: dict) -> None:
    os.makedirs(model_dir, exist_ok=True)
    obj = {"model": {k: v.detach().cpu()
                     for k, v in model.state_dict().items()},
           "optimizer": optimizer.state_dict(), "step": int(step),
           "meta": meta}
    target = path(model_dir, name)
    tmp = target + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, target)


def load_checkpoint(model_dir: str, name: str, model, optimizer) -> tuple:
    """Load `<name>.pt` into model and optimizer; returns (step, meta)."""
    obj = torch.load(path(model_dir, name), map_location="cpu",
                     weights_only=True)
    model.load_state_dict(obj["model"])
    optimizer.load_state_dict(obj["optimizer"])
    return int(obj["step"]), dict(obj["meta"])


def latest_exists(model_dir: str, name: str = "checkpoint") -> bool:
    return os.path.exists(path(model_dir, name))
