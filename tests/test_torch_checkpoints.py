"""The port's model directories: the JAX package's `checkpoint.msgpack`
(read by the port's own msgpack decoder), the reference's torch directory
(`checkpoint` + `configuration`) and the port's `checkpoint.pt`, each
loaded by `generate.load_model` into the state dict the JAX package's own
readers give."""
import dataclasses
import os

import jax
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from polyphemus_tpu.cli.convert import main as jax_convert_main
from polyphemus_tpu.config import TrainConfig, save_train_config
from polyphemus_tpu.convert import convert_state_dict, convert_torch_model_dir
from polyphemus_tpu.train.checkpoint import save_checkpoint as jax_save
from polyphemus_tpu_torch import convert
from polyphemus_tpu_torch.generate import load_model

from . import torch_ref
from .torch_port_case import build, small_cfg


def write_reference_dir(path, cfg, seed=2):
    """A reference-format torch model directory, as
    tests/test_generate_cli.py::test_load_model_torch_dir builds it."""
    from polyphemus_tpu.config import train_config_to_dict

    sd = torch_ref.random_state_dict(cfg, seed=seed)
    os.makedirs(path)
    torch.save({"model_state_dict": sd}, os.path.join(path, "checkpoint"))
    raw = train_config_to_dict(TrainConfig(model=cfg))
    torch.save({"model": raw["model"]}, os.path.join(path, "configuration"))
    return sd


def write_jax_dir(path, cfg, seed=0, with_opt_state=True):
    """A JAX model directory written by the JAX package's checkpoint writer
    (params, batch_stats and, as its trainer saves them, Adam's state)."""
    variables, _, _ = build(cfg, seed=seed)
    tree = {"params": variables["params"],
            "batch_stats": variables["batch_stats"]}
    if with_opt_state:
        tree["opt_state"] = optax.adam(1e-3).init(variables["params"])
    jax_save(str(path), "checkpoint", tree, {"step": 3})
    save_train_config(TrainConfig(model=cfg), os.path.join(path,
                                                           "config.json"))
    return variables


def assert_same_state(model, sd):
    got = model.state_dict()
    assert set(got) == set(sd)
    for k, v in sd.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("bn", [True, False], ids=["bn", "nobn"])
def test_jax_msgpack_loads_exactly(tmp_path, bn):
    cfg = small_cfg(batch_norm=bn, n_layers=2)
    write_jax_dir(tmp_path, cfg, seed=4)
    with open(tmp_path / "checkpoint.msgpack", "rb") as f:
        raw = serialization.msgpack_restore(f.read())
    want = convert.from_jax_variables(
        {"params": raw["params"], "batch_stats": raw["batch_stats"]})
    model, tcfg = load_model(str(tmp_path), device="cpu")
    assert tcfg.model.d == cfg.d and tcfg.model.batch_norm == bn
    assert_same_state(model, want)
    # the decoder reads the rest of the tree (Adam's state, scalars) too
    mine = convert.read_msgpack(str(tmp_path / "checkpoint.msgpack"))
    flat = jax.tree_util.tree_leaves(raw)
    assert [np.asarray(v).tolist() for v in jax.tree_util.tree_leaves(mine)] \
        == [np.asarray(v).tolist() for v in flat]


def test_jax_convert_cli_dir_loads(tmp_path):
    """A reference directory converted by the JAX package's convert CLI
    loads as the JAX package converts it."""
    cfg = small_cfg(n_layers=2)
    write_reference_dir(str(tmp_path / "ref"), cfg)
    jax_convert_main([str(tmp_path / "ref"), str(tmp_path / "jax")])
    variables, _ = convert_torch_model_dir(str(tmp_path / "ref"))
    model, _ = load_model(str(tmp_path / "jax"), device="cpu")
    assert_same_state(model, convert.from_jax_variables(variables))


def test_bfloat16_arrays_read_as_their_values(tmp_path):
    leaf = jax.numpy.asarray([1.5, -2.25, 3e-3], jax.numpy.bfloat16)
    tree = {"a": {"b": leaf}, "n": -7, "s": "x", "f": 0.25}
    (tmp_path / "t.msgpack").write_bytes(serialization.to_bytes(tree))
    got = convert.read_msgpack(str(tmp_path / "t.msgpack"))
    np.testing.assert_array_equal(got["a"]["b"],
                                  np.asarray(leaf.astype(np.float32)))
    assert got["n"] == -7 and got["s"] == "x" and got["f"] == 0.25


@pytest.mark.parametrize("bn", [True, False], ids=["bn", "nobn"])
def test_reference_torch_dir_loads(tmp_path, bn):
    cfg = small_cfg(batch_norm=bn, n_layers=2)
    sd = write_reference_dir(str(tmp_path / "ref"), cfg)
    want = convert.from_jax_variables(convert_state_dict(
        {k: v.numpy() for k, v in sd.items()}, cfg))
    model, tcfg = load_model(str(tmp_path / "ref"), device="cpu")
    assert tcfg.model.n_bars == cfg.n_bars and tcfg.model.batch_norm == bn
    assert_same_state(model, want)


def test_port_dir_still_loads(tmp_path):
    _, _, model = build(small_cfg(n_layers=2), seed=5)
    pcfg = convert.TrainConfig(model=model.cfg)
    convert.save_checkpoint(str(tmp_path), model, pcfg)
    loaded, _ = load_model(str(tmp_path), device="cpu")
    assert_same_state(loaded, model.state_dict())


@pytest.mark.parametrize("cut", [1, 100, 0.5])
def test_truncated_msgpack_raises_with_its_path(tmp_path, cut):
    write_jax_dir(tmp_path, small_cfg(n_layers=1), with_opt_state=False)
    path = tmp_path / "checkpoint.msgpack"
    blob = path.read_bytes()
    n = int(len(blob) * cut) if isinstance(cut, float) else len(blob) - cut
    path.write_bytes(blob[:n])
    with pytest.raises(ValueError, match=f"{path}.*truncated"):
        load_model(str(tmp_path), device="cpu")


def test_unknown_msgpack_input_raises(tmp_path):
    path = tmp_path / "checkpoint.msgpack"
    path.write_bytes(b"\x81\xa6params\xc1")  # 0xc1 is never used
    with pytest.raises(ValueError, match=f"{path}.*unknown msgpack type"):
        load_model(str(tmp_path), device="cpu")
    path.write_bytes(b"\x81\xa6params\xd4\x05\x00")  # extension type 5
    with pytest.raises(ValueError, match="unknown msgpack extension"):
        load_model(str(tmp_path), device="cpu")


def test_missing_checkpoint_names_all_three(tmp_path):
    with pytest.raises(FileNotFoundError, match="checkpoint.msgpack.*"
                                                "checkpoint.pt"):
        load_model(str(tmp_path), device="cpu")


def test_truncated_reference_state_dict_names_the_key(tmp_path):
    cfg = dataclasses.replace(small_cfg(n_layers=2))
    sd = write_reference_dir(str(tmp_path / "ref"), cfg)
    del sd["decoder.c_decoder.dur_emb.bias"]
    torch.save({"model_state_dict": sd},
               os.path.join(tmp_path / "ref", "checkpoint"))
    with pytest.raises(KeyError, match="dur_emb.bias"):
        load_model(str(tmp_path / "ref"), device="cpu")
