"""Weights: the JAX variable tree <-> the port's state dict, and the three
model directories the port serves: its own (`checkpoint.pt` +
`config.json`), the JAX package's (`checkpoint.msgpack` + `config.json`, read
by a msgpack decoder of this module) and the reference's torch directory
(`checkpoint` + `configuration`).

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
import struct
from typing import Mapping

import numpy as np
import torch

from .config import (TrainConfig, load_train_config, train_config_from_dict,
                     train_config_to_dict)

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
    ckpt = os.path.join(model_dir, CHECKPOINT)
    if not os.path.exists(ckpt):
        raise FileNotFoundError(f"no {CHECKPOINT} in {model_dir}")
    cfg = _dir_config(model_dir)
    obj = torch.load(ckpt, map_location="cpu", weights_only=True)
    return _model_from_state_dict(obj["model"] if "model" in obj else obj,
                                  cfg, device), cfg


def _model_from_state_dict(sd: Mapping, cfg: TrainConfig, device):
    from .models import VAE

    model = VAE(cfg.model)
    model.load_state_dict(sd)
    return model.to(device).eval()


def _dir_config(model_dir: str) -> TrainConfig:
    path = os.path.join(model_dir, CONFIG)
    return load_train_config(path) if os.path.exists(path) else TrainConfig()


# ------------------------------------------------- the JAX checkpoint.msgpack
JAX_CHECKPOINT = "checkpoint.msgpack"
_EXT_NDARRAY = 1   # flax's msgpack extension type of a numpy array


def _bf16_to_f32(raw: bytes) -> np.ndarray:
    u = np.frombuffer(raw, np.uint16).astype(np.uint32) << 16
    return u.view(np.float32)


class _Msgpack:
    """A msgpack decoder for what flax's `serialization.to_bytes` writes
    for a model's variables: maps, arrays, strings, binaries, ints, floats,
    nil and booleans, and the extension type of a numpy array (a nested
    msgpack array of shape, dtype name and C-order bytes). Anything else,
    or a buffer that ends early, raises ValueError naming `path`."""

    def __init__(self, data: bytes, path: str):
        self.data, self.path, self.pos = data, path, 0

    def fail(self, what: str):
        raise ValueError(f"{self.path}: {what} at byte {self.pos}")

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            self.fail(f"truncated msgpack (needs {n} more bytes)")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.value() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return self.take(b & 0x1f).decode()
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in simple:
            return simple[b]
        sized = {0xc4: "B", 0xc5: "H", 0xc6: "I", 0xd9: "B", 0xda: "H",
                 0xdb: "I"}
        if b in sized:
            raw = self.take(self.unpack(sized[b]))
            return raw if b <= 0xc6 else raw.decode()
        scalar = {0xca: "f", 0xcb: "d", 0xcc: "B", 0xcd: "H", 0xce: "I",
                  0xcf: "Q", 0xd0: "b", 0xd1: "h", 0xd2: "i", 0xd3: "q"}
        if b in scalar:
            return self.unpack(scalar[b])
        if b in (0xdc, 0xdd):
            return [self.value()
                    for _ in range(self.unpack("H" if b == 0xdc else "I"))]
        if b in (0xde, 0xdf):
            return self.map(self.unpack("H" if b == 0xde else "I"))
        if 0xd4 <= b <= 0xd8:
            return self.ext(1 << (b - 0xd4))
        if b in (0xc7, 0xc8, 0xc9):
            return self.ext(self.unpack({0xc7: "B", 0xc8: "H", 0xc9: "I"}[b]))
        self.pos -= 1
        self.fail(f"unknown msgpack type byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack("b")
        start = self.pos
        body = self.take(n)
        if code != _EXT_NDARRAY:
            self.pos = start
            self.fail(f"unknown msgpack extension type {code}")
        inner = _Msgpack(body, f"{self.path} (array at byte {start})")
        spec = inner.value()
        if not (isinstance(spec, list) and len(spec) == 3):
            inner.fail("malformed array header")
        shape, dtype, raw = spec
        dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
        arr = (_bf16_to_f32(raw) if dtype == "bfloat16"
               else np.frombuffer(raw, np.dtype(dtype)))
        if arr.size != int(np.prod(shape)):
            inner.fail(f"{arr.size} values for shape {shape}")
        return arr.reshape(shape)


def read_msgpack(path: str):
    """The tree that flax's `serialization.msgpack_restore` returns for the
    file at `path`, with numpy leaves (bfloat16 arrays read as float32)."""
    with open(path, "rb") as f:
        dec = _Msgpack(f.read(), path)
    tree = dec.value()
    if dec.pos != len(dec.data):
        dec.fail("trailing bytes after the msgpack value")
    return tree


def load_jax_checkpoint(model_dir: str, device="cpu"):
    """Read the JAX package's model directory (`checkpoint.msgpack` of
    `{"params", "batch_stats"}`, and `config.json` when present), as its
    `generate.load_model` does. Returns (VAE in eval mode on `device`,
    TrainConfig)."""
    cfg = _dir_config(model_dir)
    raw = read_msgpack(os.path.join(model_dir, JAX_CHECKPOINT))
    if not isinstance(raw, dict) or "params" not in raw:
        raise ValueError(f"{os.path.join(model_dir, JAX_CHECKPOINT)}: no "
                         f"'params' tree")
    variables = {"params": raw["params"],
                 "batch_stats": raw.get("batch_stats", {})}
    return _model_from_state_dict(from_jax_variables(variables), cfg,
                                  device), cfg


# --------------------------------------------- the reference's torch directory
# The reference's state-dict layout -> the JAX package's variable tree: a
# copy of `polyphemus_tpu/convert.py:convert_state_dict` (numpy only), whose
# tree `from_jax_variables` then maps to the port's state dict.
def _ref_lin(sd, name):
    return {"kernel": np.ascontiguousarray(sd[f"{name}.weight"].T),
            "bias": np.asarray(sd[f"{name}.bias"])}


def _ref_conv(sd, name):
    w = np.asarray(sd[f"{name}.weight"])  # (o, i, kh, kw)
    return {"kernel": np.ascontiguousarray(w.transpose(2, 3, 1, 0)),
            "bias": np.asarray(sd[f"{name}.bias"])}


def _ref_bn(sd, name):
    return ({"scale": np.asarray(sd[f"{name}.weight"]),
             "bias": np.asarray(sd[f"{name}.bias"])},
            {"mean": np.asarray(sd[f"{name}.running_mean"]),
             "var": np.asarray(sd[f"{name}.running_var"])})


def _ref_cnn_encoder(sd, pfx, batch_norm, p, s):
    """The reference's nn.Sequential indices depend on batch_norm; its
    flatten is (c, h, w), the JAX package's (h, w, c)."""
    c0, c1 = ("0", "4") if batch_norm else ("0", "3")
    p["conv0"] = _ref_conv(sd, f"{pfx}.conv.{c0}")
    p["conv1"] = _ref_conv(sd, f"{pfx}.conv.{c1}")
    if batch_norm:
        p["bn0"], s["bn0"] = _ref_bn(sd, f"{pfx}.conv.1")
        p["bn1"], s["bn1"] = _ref_bn(sd, f"{pfx}.conv.5")
    w = np.asarray(sd[f"{pfx}.lin.1.weight"])  # (dense, 16*4*8)
    dense = w.shape[0]
    kernel = w.reshape(dense, 16, 4, 8).transpose(2, 3, 1, 0).reshape(-1, dense)
    p["lin0"] = {"kernel": np.ascontiguousarray(kernel),
                 "bias": np.asarray(sd[f"{pfx}.lin.1.bias"])}
    p["lin1"] = _ref_lin(sd, f"{pfx}.lin.4")


def _ref_cnn_decoder(sd, pfx, batch_norm, p, s):
    p["lin0"] = _ref_lin(sd, f"{pfx}.lin.1")
    w = np.asarray(sd[f"{pfx}.lin.4.weight"])  # (16*4*8, dense), rows (c,h,w)
    dense = w.shape[1]
    kernel = w.reshape(16, 4, 8, dense).transpose(3, 1, 2, 0).reshape(dense, -1)
    b = np.asarray(sd[f"{pfx}.lin.4.bias"]).reshape(16, 4, 8)
    p["lin1"] = {"kernel": np.ascontiguousarray(kernel),
                 "bias": np.ascontiguousarray(b.transpose(1, 2, 0).reshape(-1))}
    c0, c1 = ("1", "4") if batch_norm else ("1", "3")
    p["conv0"] = _ref_conv(sd, f"{pfx}.conv.{c0}")
    p["conv1"] = _ref_conv(sd, f"{pfx}.conv.{c1}")
    if batch_norm:
        p["bn0"], s["bn0"] = _ref_bn(sd, f"{pfx}.conv.2")


def _ref_gcn(sd, pfx, n_layers, batch_norm, p, s):
    """The shared edge_nn appears under every layer of the reference's
    state dict; it is read once, from layer 0."""
    p["edge_nn"] = _ref_lin(sd, f"{pfx}.layers.0.nn")
    for i in range(n_layers):
        p[f"layers_{i}"] = {
            "rel_weight": np.asarray(sd[f"{pfx}.layers.{i}.weight"]),
            "root": np.asarray(sd[f"{pfx}.layers.{i}.root"]),
            "bias": np.asarray(sd[f"{pfx}.layers.{i}.bias"])}
        if batch_norm:
            p[f"norm_layers_{i}"], s[f"norm_layers_{i}"] = _ref_bn(
                sd, f"{pfx}.norm_layers.{i}.module")


def reference_to_jax_variables(sd: Mapping, n_layers: int,
                               batch_norm: bool) -> dict:
    """The reference's VAE state dict (numpy values) -> the JAX package's
    `{"params", "batch_stats"}`. A missing key raises KeyError."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    params: dict = {"encoder": {}, "decoder": {}}
    stats: dict = {"encoder": {}, "decoder": {}}
    se_p, se_s = {"cnn_encoder": {}}, {"cnn_encoder": {}}
    _ref_cnn_encoder(sd, "encoder.s_encoder.cnn_encoder", batch_norm,
                     se_p["cnn_encoder"], se_s["cnn_encoder"])
    se_p["bars_encoder"] = _ref_lin(sd, "encoder.s_encoder.bars_encoder")
    params["encoder"]["s_encoder"], stats["encoder"]["s_encoder"] = se_p, se_s

    ce_p, ce_s = {}, {}
    for n in ("drums_pitch_emb", "non_drums_pitch_emb", "dur_emb",
              "chord_encoder", "bars_encoder"):
        ce_p[n] = _ref_lin(sd, f"encoder.c_encoder.{n}")
    for n in ("bn_drums", "bn_non_drums", "bn_dur"):
        ce_p[n], ce_s[n] = _ref_bn(sd, f"encoder.c_encoder.{n}")
    ce_p["graph_encoder"], ce_s["graph_encoder"] = {}, {}
    _ref_gcn(sd, "encoder.c_encoder.graph_encoder", n_layers, batch_norm,
             ce_p["graph_encoder"], ce_s["graph_encoder"])
    ce_p["gate_mlp"] = {"layers_0": _ref_lin(
        sd, "encoder.c_encoder.graph_attention.gate_nn.0.layers.0")}
    ce_p["gate_bn"], ce_s["gate_bn"] = _ref_bn(
        sd, "encoder.c_encoder.graph_attention.gate_nn.1")
    params["encoder"]["c_encoder"], stats["encoder"]["c_encoder"] = ce_p, ce_s

    enc = params["encoder"]
    enc["linear_merge"] = _ref_lin(sd, "encoder.linear_merge")
    enc["bn_linear_merge"], stats["encoder"]["bn_linear_merge"] = _ref_bn(
        sd, "encoder.bn_linear_merge")
    enc["linear_mu"] = _ref_lin(sd, "encoder.linear_mu")
    enc["linear_log_var"] = _ref_lin(sd, "encoder.linear_log_var")

    dec = params["decoder"]
    dec["lin_decoder"] = _ref_lin(sd, "decoder.lin_decoder")
    dec["batch_norm"], stats["decoder"]["batch_norm"] = _ref_bn(
        sd, "decoder.batch_norm")
    sdn_p, sdn_s = {"cnn_decoder": {}}, {"cnn_decoder": {}}
    sdn_p["bars_decoder"] = _ref_lin(sd, "decoder.s_decoder.bars_decoder")
    _ref_cnn_decoder(sd, "decoder.s_decoder.cnn_decoder", batch_norm,
                     sdn_p["cnn_decoder"], sdn_s["cnn_decoder"])
    dec["s_decoder"], stats["decoder"]["s_decoder"] = sdn_p, sdn_s

    cd_p, cd_s = {}, {"graph_decoder": {}}
    for n in ("bars_decoder", "chord_decoder", "drums_pitch_emb",
              "non_drums_pitch_emb", "dur_emb"):
        cd_p[n] = _ref_lin(sd, f"decoder.c_decoder.{n}")
    cd_p["graph_decoder"] = {}
    _ref_gcn(sd, "decoder.c_decoder.graph_decoder", n_layers, batch_norm,
             cd_p["graph_decoder"], cd_s["graph_decoder"])
    dec["c_decoder"], stats["decoder"]["c_decoder"] = cd_p, cd_s
    return {"params": params, "batch_stats": stats}


REF_CHECKPOINT, REF_CONFIG = "checkpoint", "configuration"


def load_torch_model_dir(model_dir: str, device="cpu"):
    """Read the reference's model directory: `checkpoint` (a `torch.save`
    dict whose `model_state_dict` is the reference VAE's) and
    `configuration` (its training-config dict), as the JAX package's
    `convert.load_torch_checkpoint` does. Returns (VAE in eval mode on
    `device`, TrainConfig)."""
    ckpt = torch.load(os.path.join(model_dir, REF_CHECKPOINT),
                      map_location="cpu", weights_only=False)
    conf = torch.load(os.path.join(model_dir, REF_CONFIG),
                      map_location="cpu", weights_only=False)
    cfg = train_config_from_dict(conf)
    sd = {k: v.detach().numpy() for k, v in ckpt["model_state_dict"].items()}
    variables = reference_to_jax_variables(sd, cfg.model.gnn_n_layers,
                                           cfg.model.batch_norm)
    return _model_from_state_dict(from_jax_variables(variables), cfg,
                                  device), cfg


def load_model_dir(model_dir: str, device="cpu"):
    """(VAE in eval mode on `device`, TrainConfig) from any of the three
    model directories, looked for in the JAX package's order: its
    `checkpoint.msgpack`, the reference's `checkpoint`, then the port's
    `checkpoint.pt`."""
    if os.path.exists(os.path.join(model_dir, JAX_CHECKPOINT)):
        return load_jax_checkpoint(model_dir, device)
    if os.path.exists(os.path.join(model_dir, REF_CHECKPOINT)):
        return load_torch_model_dir(model_dir, device)
    if os.path.exists(os.path.join(model_dir, CHECKPOINT)):
        return load_checkpoint(model_dir, device)
    raise FileNotFoundError(
        f"no {JAX_CHECKPOINT}, reference {REF_CHECKPOINT} or {CHECKPOINT} in "
        f"{model_dir}")
