"""Weights: the JAX variable tree -> the port's state dict, and the port's
own model directory (`checkpoint.pt` + `config.json`).

`from_jax_variables` takes the JAX package's `{"params", "batch_stats"}`
tree as nested dicts of numpy arrays and does every layout change here:

  * Dense kernel (in, out)           -> nn.Linear weight (out, in)
  * Conv kernel (kh, kw, in, out)    -> nn.Conv2d weight (out, in, kh, kw)
  * BatchNorm scale/bias + mean/var  -> weight/bias + running_mean/var
  * GCL rel_weight/root/bias and the hand-applied DenseParams (chord
    decoder, unembeddings) keep their orientation.

The encoder subtree is accepted and ignored (the encoder is not ported
yet). A missing key raises KeyError naming its path.
"""
from __future__ import annotations

import json
import os
from typing import Mapping

import numpy as np
import torch

from .config import TrainConfig, load_train_config, train_config_to_dict


def _get(tree: Mapping, path: str):
    node = tree
    for part in path.split("/"):
        if not isinstance(node, Mapping) or part not in node:
            raise KeyError(path)
        node = node[part]
    return node


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def from_jax_variables(variables: Mapping) -> dict:
    """JAX `{"params", "batch_stats"}` (numpy leaves) -> the port's state
    dict for `models.VAE`."""
    sd: dict = {}

    def p(path):
        return _get(variables, "params/decoder/" + path)

    def st(path):
        return _get(variables, "batch_stats/decoder/" + path)

    def linear(ours, theirs):
        sd[f"{ours}.weight"] = _t(p(f"{theirs}/kernel")).t().contiguous()
        sd[f"{ours}.bias"] = _t(p(f"{theirs}/bias"))

    def dense(ours, theirs):
        sd[f"{ours}.kernel"] = _t(p(f"{theirs}/kernel"))
        sd[f"{ours}.bias"] = _t(p(f"{theirs}/bias"))

    def conv(ours, theirs):
        k = np.asarray(p(f"{theirs}/kernel"))  # (kh, kw, in, out)
        sd[f"{ours}.weight"] = _t(k.transpose(3, 2, 0, 1))
        sd[f"{ours}.bias"] = _t(p(f"{theirs}/bias"))

    def bn(ours, theirs):
        sd[f"{ours}.weight"] = _t(p(f"{theirs}/scale"))
        sd[f"{ours}.bias"] = _t(p(f"{theirs}/bias"))
        sd[f"{ours}.running_mean"] = _t(st(f"{theirs}/mean"))
        sd[f"{ours}.running_var"] = _t(st(f"{theirs}/var"))

    pre = "decoder."
    linear(pre + "lin_decoder", "lin_decoder")
    bn(pre + "batch_norm", "batch_norm")

    s = pre + "s_decoder."
    linear(s + "bars_decoder", "s_decoder/bars_decoder")
    for name in ("lin0", "lin1"):
        linear(f"{s}cnn_decoder.{name}", f"s_decoder/cnn_decoder/{name}")
    for name in ("conv0", "conv1"):
        conv(f"{s}cnn_decoder.{name}", f"s_decoder/cnn_decoder/{name}")
    if "bn0" in p("s_decoder/cnn_decoder"):
        bn(s + "cnn_decoder.bn0", "s_decoder/cnn_decoder/bn0")

    c = pre + "c_decoder."
    linear(c + "bars_decoder", "c_decoder/bars_decoder")
    for name in ("chord_decoder", "drums_pitch_emb", "non_drums_pitch_emb",
                 "dur_emb"):
        dense(c + name, f"c_decoder/{name}")
    g = "c_decoder/graph_decoder"
    linear(c + "graph_decoder.edge_nn", g + "/edge_nn")
    layers = p(g)
    n_layers = sum(1 for k in layers if k.startswith("layers_"))
    for i in range(n_layers):
        for leaf in ("rel_weight", "root", "bias"):
            sd[f"{c}graph_decoder.layers.{i}.{leaf}"] = _t(
                p(f"{g}/layers_{i}/{leaf}"))
        if "norm_layers_0" in layers:
            bn(f"{c}graph_decoder.norm_layers.{i}", f"{g}/norm_layers_{i}")
    return sd


# ------------------------------------------------------------ model directory
CHECKPOINT = "checkpoint.pt"
CONFIG = "config.json"


def save_checkpoint(model_dir: str, model, cfg: TrainConfig) -> None:
    """Write the port's model directory: `checkpoint.pt` (the state dict)
    and `config.json` (loadable by both packages)."""
    os.makedirs(model_dir, exist_ok=True)
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save(sd, os.path.join(model_dir, CHECKPOINT))
    with open(os.path.join(model_dir, CONFIG), "w") as f:
        json.dump(train_config_to_dict(cfg), f, indent=2)


def load_checkpoint(model_dir: str, device="cpu"):
    """Read a directory written by `save_checkpoint`.

    Returns (VAE in eval mode on `device`, TrainConfig)."""
    from .models import VAE

    ckpt = os.path.join(model_dir, CHECKPOINT)
    if not os.path.exists(ckpt):
        raise FileNotFoundError(f"no {CHECKPOINT} in {model_dir}")
    cfg_path = os.path.join(model_dir, CONFIG)
    cfg = load_train_config(cfg_path) if os.path.exists(cfg_path) \
        else TrainConfig()
    model = VAE(cfg.model)
    sd = torch.load(ckpt, map_location="cpu", weights_only=True)
    model.load_state_dict(sd)
    return model.to(device).eval(), cfg
