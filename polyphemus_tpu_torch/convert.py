"""Weights: the JAX variable tree <-> the port's state dict, and the port's
own model directory (`checkpoint.pt` + `config.json`).

`from_jax_variables` takes the JAX package's `{"params", "batch_stats"}`
tree (encoder and decoder) as nested dicts of numpy arrays;
`to_jax_variables` is its inverse. Both walk one table (`_layout`) of
(port module, JAX path, kind), and every layout change happens here:

  * Dense kernel (in, out)           <-> nn.Linear weight (out, in)
  * Conv kernel (kh, kw, in, out)    <-> nn.Conv2d weight (out, in, kh, kw)
  * BatchNorm scale/bias + mean/var  <-> weight/bias + running_mean/var
  * GCL rel_weight/root/bias, the embeddings and the hand-applied
    DenseParams (chord projections, unembeddings) keep their orientation.

A missing key raises KeyError naming its path.
"""
from __future__ import annotations

import json
import os
from typing import Mapping

import numpy as np
import torch

from .config import TrainConfig, load_train_config, train_config_to_dict

LINEAR, DENSE, CONV, BN, GCL = "linear", "dense", "conv", "bn", "gcl"


def _get(tree: Mapping, path: str):
    node = tree
    for part in path.split("/"):
        if not isinstance(node, Mapping) or part not in node:
            raise KeyError(path)
        node = node[part]
    return node


def _set(tree: dict, path: str, value) -> None:
    parts = path.split("/")
    for part in parts[:-1]:
        tree = tree.setdefault(part, {})
    tree[parts[-1]] = value


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def _layout(n_layers: int, batch_norm: bool) -> list:
    """[(port module prefix, JAX path under params/batch_stats, kind)]."""
    out = []

    def cnn(ours, theirs, bns):
        for name in ("lin0", "lin1", "conv0", "conv1"):
            out.append((f"{ours}.{name}", f"{theirs}/{name}",
                        CONV if name.startswith("conv") else LINEAR))
        for name in bns if batch_norm else ():
            out.append((f"{ours}.{name}", f"{theirs}/{name}", BN))

    def gcn(ours, theirs):
        out.append((f"{ours}.edge_nn", f"{theirs}/edge_nn", LINEAR))
        for i in range(n_layers):
            out.append((f"{ours}.layers.{i}", f"{theirs}/layers_{i}", GCL))
            if batch_norm:
                out.append((f"{ours}.norm_layers.{i}",
                            f"{theirs}/norm_layers_{i}", BN))

    # decoder
    out += [("decoder.lin_decoder", "decoder/lin_decoder", LINEAR),
            ("decoder.batch_norm", "decoder/batch_norm", BN),
            ("decoder.s_decoder.bars_decoder", "decoder/s_decoder/bars_decoder",
             LINEAR)]
    cnn("decoder.s_decoder.cnn_decoder", "decoder/s_decoder/cnn_decoder",
        ("bn0",))
    c = "decoder.c_decoder"
    out.append((f"{c}.bars_decoder", "decoder/c_decoder/bars_decoder", LINEAR))
    for name in ("chord_decoder", "drums_pitch_emb", "non_drums_pitch_emb",
                 "dur_emb"):
        out.append((f"{c}.{name}", f"decoder/c_decoder/{name}", DENSE))
    gcn(f"{c}.graph_decoder", "decoder/c_decoder/graph_decoder")
    # encoder
    cnn("encoder.s_encoder.cnn_encoder", "encoder/s_encoder/cnn_encoder",
        ("bn0", "bn1"))
    out.append(("encoder.s_encoder.bars_encoder",
                "encoder/s_encoder/bars_encoder", LINEAR))
    c = "encoder.c_encoder"
    for name in ("drums_pitch_emb", "non_drums_pitch_emb", "dur_emb",
                 "chord_encoder"):
        out.append((f"{c}.{name}", f"encoder/c_encoder/{name}", DENSE))
    for name in ("bn_drums", "bn_non_drums", "bn_dur", "gate_bn"):
        out.append((f"{c}.{name}", f"encoder/c_encoder/{name}", BN))
    out += [(f"{c}.bars_encoder", "encoder/c_encoder/bars_encoder", LINEAR),
            (f"{c}.gate_mlp.layers.0", "encoder/c_encoder/gate_mlp/layers_0",
             LINEAR)]
    gcn(f"{c}.graph_encoder", "encoder/c_encoder/graph_encoder")
    for name in ("linear_merge", "linear_mu", "linear_log_var"):
        out.append((f"encoder.{name}", f"encoder/{name}", LINEAR))
    out.append(("encoder.bn_linear_merge", "encoder/bn_linear_merge", BN))
    return out


def _same(a):
    return a


def _leaves(kind: str) -> list:
    """[(port leaf, JAX collection, JAX leaf, port->JAX, JAX->port)] on
    numpy arrays."""
    if kind == LINEAR:
        return [("weight", "params", "kernel", np.transpose, np.transpose),
                ("bias", "params", "bias", _same, _same)]
    if kind == DENSE:
        return [("kernel", "params", "kernel", _same, _same),
                ("bias", "params", "bias", _same, _same)]
    if kind == CONV:
        return [("weight", "params", "kernel",
                 lambda a: a.transpose(2, 3, 1, 0),
                 lambda a: a.transpose(3, 2, 0, 1)),
                ("bias", "params", "bias", _same, _same)]
    if kind == BN:
        return [("weight", "params", "scale", _same, _same),
                ("bias", "params", "bias", _same, _same),
                ("running_mean", "batch_stats", "mean", _same, _same),
                ("running_var", "batch_stats", "var", _same, _same)]
    return [(leaf, "params", leaf, _same, _same)
            for leaf in ("rel_weight", "root", "bias")]


def from_jax_variables(variables: Mapping) -> dict:
    """JAX `{"params", "batch_stats"}` (numpy leaves) -> the port's state
    dict for `models.VAE`."""
    graph = _get(variables, "params/decoder/c_decoder/graph_decoder")
    n_layers = sum(1 for k in graph if k.startswith("layers_"))
    sd: dict = {}
    for ours, theirs, kind in _layout(n_layers, "norm_layers_0" in graph):
        for leaf, coll, jleaf, _, from_jax in _leaves(kind):
            a = from_jax(np.asarray(_get(variables, f"{coll}/{theirs}/{jleaf}")))
            sd[f"{ours}.{leaf}"] = _t(np.ascontiguousarray(a))
    return sd


def to_jax_variables(sd: Mapping) -> dict:
    """The port's state dict (or any dict with its key names, such as
    parameter grads) -> `{"params", "batch_stats"}` of numpy arrays in the
    JAX package's layout. Running statistics missing from `sd` (a grads
    dict has none) are left out; any other missing key raises KeyError."""
    prefix = "decoder.c_decoder.graph_decoder."
    n_layers = sum(1 for k in sd if k.startswith(prefix + "layers.")
                   and k.endswith(".root"))
    bn = (prefix + "norm_layers.0.weight") in sd
    tree: dict = {"params": {}, "batch_stats": {}}
    for ours, theirs, kind in _layout(n_layers, bn):
        for leaf, coll, jleaf, to_jax, _ in _leaves(kind):
            key = f"{ours}.{leaf}"
            if key not in sd and coll == "batch_stats":
                continue
            if key not in sd:
                raise KeyError(key)
            a = to_jax(sd[key].detach().cpu().numpy())
            _set(tree[coll], f"{theirs}/{jleaf}", np.ascontiguousarray(a))
    return tree


# ------------------------------------------------------------ model directory
CHECKPOINT = "checkpoint.pt"
CONFIG = "config.json"


def save_config(model_dir: str, cfg: TrainConfig) -> None:
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, CONFIG), "w") as f:
        json.dump(train_config_to_dict(cfg), f, indent=2)


def save_checkpoint(model_dir: str, model, cfg: TrainConfig) -> None:
    """Write the port's model directory: `checkpoint.pt` (the state dict)
    and `config.json` (loadable by both packages)."""
    os.makedirs(model_dir, exist_ok=True)
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save(sd, os.path.join(model_dir, CHECKPOINT))
    save_config(model_dir, cfg)


def load_checkpoint(model_dir: str, device="cpu"):
    """Read a directory written by `save_checkpoint` or by the trainer
    (whose `checkpoint.pt` also holds the optimizer state and step).

    Returns (VAE in eval mode on `device`, TrainConfig)."""
    from .models import VAE

    ckpt = os.path.join(model_dir, CHECKPOINT)
    if not os.path.exists(ckpt):
        raise FileNotFoundError(f"no {CHECKPOINT} in {model_dir}")
    cfg_path = os.path.join(model_dir, CONFIG)
    cfg = load_train_config(cfg_path) if os.path.exists(cfg_path) \
        else TrainConfig()
    model = VAE(cfg.model)
    obj = torch.load(ckpt, map_location="cpu", weights_only=True)
    model.load_state_dict(obj["model"] if "model" in obj else obj)
    return model.to(device).eval(), cfg
