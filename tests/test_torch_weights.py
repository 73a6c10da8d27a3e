"""Weights and model directories of the port: `from_jax_variables` (every
transpose, a KeyError naming the path of a missing key, the encoder subtree
mapped), its inverse `to_jax_variables` (exact round trip of the whole
tree), `save_checkpoint`/`load_checkpoint`, and one `config.json` loading
in both packages."""
import copy
import os
import json

import numpy as np
import pytest
import torch

from polyphemus_tpu.config import load_train_config as jax_load_config
from polyphemus_tpu_torch.config import TrainConfig, load_train_config
from polyphemus_tpu_torch.convert import (from_jax_variables, load_checkpoint,
                                          save_checkpoint, to_jax_variables)
from polyphemus_tpu_torch.models import VAE

from .torch_port_case import build, port_cfg, small_cfg


@pytest.mark.parametrize("bn", [True, False], ids=["bn", "nobn"])
def test_state_dict_is_complete(bn):
    cfg = small_cfg(batch_norm=bn)
    variables, _, model = build(cfg)
    sd = from_jax_variables(variables)
    assert set(sd) == set(model.state_dict())
    p = variables["params"]["decoder"]
    np.testing.assert_array_equal(sd["decoder.lin_decoder.weight"].numpy(),
                                  p["lin_decoder"]["kernel"].T)
    k = p["s_decoder"]["cnn_decoder"]["conv0"]["kernel"]
    np.testing.assert_array_equal(
        sd["decoder.s_decoder.cnn_decoder.conv0.weight"].numpy(),
        k.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["decoder.c_decoder.chord_decoder.kernel"].numpy(),
        p["c_decoder"]["chord_decoder"]["kernel"])


@pytest.mark.parametrize("path", [
    ("params", "decoder", "c_decoder", "chord_decoder", "bias"),
    ("params", "decoder", "c_decoder", "graph_decoder", "layers_1", "root"),
    ("batch_stats", "decoder", "batch_norm", "var"),
    ("params", "decoder", "s_decoder"),
])
def test_truncated_tree_raises_keyerror_with_path(path):
    variables, _, _ = build(small_cfg())
    broken = copy.deepcopy(variables)
    node = broken
    for part in path[:-1]:
        node = node[part]
    del node[path[-1]]
    with pytest.raises(KeyError) as e:
        from_jax_variables(broken)
    assert "/".join(path) in str(e.value)


def test_encoder_subtree_is_ignored():
    """No longer ignored: the encoder maps like the decoder (CNN kernels
    transposed, BN statistics carried), and a tree without it raises."""
    variables, _, _ = build(small_cfg())
    sd = from_jax_variables(variables)
    p = variables["params"]["encoder"]
    k = p["s_encoder"]["cnn_encoder"]["conv1"]["kernel"]
    np.testing.assert_array_equal(
        sd["encoder.s_encoder.cnn_encoder.conv1.weight"].numpy(),
        k.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["encoder.c_encoder.gate_mlp.layers.0.weight"].numpy(),
        p["c_encoder"]["gate_mlp"]["layers_0"]["kernel"].T)
    np.testing.assert_array_equal(
        sd["encoder.c_encoder.bn_dur.running_var"].numpy(),
        variables["batch_stats"]["encoder"]["c_encoder"]["bn_dur"]["var"])
    stripped = {k: {"decoder": v["decoder"]} for k, v in variables.items()}
    with pytest.raises(KeyError, match="params/encoder"):
        from_jax_variables(stripped)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("bn", [True, False], ids=["bn", "nobn"])
def test_to_jax_variables_inverts_exactly(bn):
    variables, _, model = build(small_cfg(batch_norm=bn))
    want, got = _flat(variables), _flat(to_jax_variables(model.state_dict()))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    grads = {n: torch.ones_like(p) for n, p in model.named_parameters()}
    tree = to_jax_variables(grads)
    assert tree["batch_stats"] == {}
    assert set(_flat(tree["params"])) == set(_flat(variables["params"]))


def test_checkpoint_roundtrip_and_shared_config(tmp_path):
    cfg = small_cfg(gcl_chain=2)
    _, _, model = build(cfg)
    save_checkpoint(str(tmp_path), model, TrainConfig(model=port_cfg(cfg)))
    loaded, tcfg = load_checkpoint(str(tmp_path))
    assert tcfg.model == port_cfg(cfg)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(loaded.state_dict()[k], v, rtol=0, atol=0)
    # the port's config.json loads in the JAX package, and back
    jcfg = jax_load_config(tmp_path / "config.json")
    assert (jcfg.model.d, jcfg.model.gnn_n_layers, jcfg.model.gcl_chain) == \
        (cfg.d, cfg.gnn_n_layers, 2)
    raw = json.loads((tmp_path / "config.json").read_text())
    raw["model"]["use_pallas_gcl"] = True  # a JAX-only key is ignored
    (tmp_path / "config.json").write_text(json.dumps(raw))
    assert load_train_config(tmp_path / "config.json").model == port_cfg(cfg)


def test_example_config_loads_in_both_packages():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "training_lmd2.json")
    ours, theirs = load_train_config(path), jax_load_config(path)
    assert (ours.model.d, ours.model.gnn_n_layers, ours.model.n_bars,
            ours.batch_size, ours.iters_to_accumulate) == \
        (theirs.model.d, theirs.model.gnn_n_layers, theirs.model.n_bars,
         theirs.batch_size, theirs.iters_to_accumulate)
    VAE(ours.model)  # the flagship builds
