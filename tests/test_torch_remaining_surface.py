"""The port's remaining single-card surface against the JAX package's, on
the CPU: `generate.mtp_from_logits`, `plotting` (the same files, images read
back equal), `cli.stats` from a meta file the port's trainer wrote,
`cli.convert` from a reference and from a JAX model directory (the output
loads, decodes as JAX does, and resumes training with fresh optimizer
state), and `cli.download_models` with a stubbed `huggingface_hub`."""
import os
import sys
import types

import jax.numpy as jnp
import matplotlib
import matplotlib.image
import numpy as np
import pytest
import torch

from polyphemus_tpu import plotting as jplotting
from polyphemus_tpu.cli import download_models as jdownload
from polyphemus_tpu.cli.stats import main as jax_stats
from polyphemus_tpu.generate import load_model as jax_load_model
from polyphemus_tpu.generate import make_generator as jax_make_generator
from polyphemus_tpu.generate import mtp_from_logits as jax_mtp
from polyphemus_tpu.generate import song_from_tokens as jax_song
from polyphemus_tpu_torch import generate as G
from polyphemus_tpu_torch import plotting
from polyphemus_tpu_torch.cli import download_models
from polyphemus_tpu_torch.cli.convert import main as convert_main
from polyphemus_tpu_torch.cli.stats import main as stats_main
from polyphemus_tpu_torch.config import TrainConfig
from polyphemus_tpu_torch.models import VAE
from polyphemus_tpu_torch.train.trainer import Trainer

from .test_fast_render import random_sample
from .test_torch_checkpoints import write_jax_dir, write_reference_dir
from .test_torch_trainer_surface import batches, tiny_trainer
from .torch_port_case import (LOGIT_TIE, assert_masks_match, random_z,
                              small_cfg, top2_gap)


@pytest.fixture
def same_svg(monkeypatch):
    """matplotlib's SVG ids and date repeat between two saves (a fixed hash
    salt, a fixed date)."""
    monkeypatch.setenv("SOURCE_DATE_EPOCH", "0")
    with matplotlib.rc_context({"svg.hashsalt": "polyphemus"}):
        yield


def assert_same_png(a, b):
    ia, ib = matplotlib.image.imread(a), matplotlib.image.imread(b)
    assert ia.shape == ib.shape and ia.shape[0] > 100
    np.testing.assert_array_equal(ia, ib)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_mtp_from_logits_equals_jax(dtype):
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 2, 4, 32, 15, 230)).astype(np.float32)
    mask = rng.random((2, 2, 4, 32)) < 0.3
    if dtype == "bfloat16":
        c_p = torch.from_numpy(logits).bfloat16()
        c_j = jnp.asarray(logits).astype(jnp.bfloat16)
    else:
        c_p, c_j = torch.from_numpy(logits), jnp.asarray(logits)
    got = G.mtp_from_logits(c_p, torch.from_numpy(mask))
    want = np.asarray(jax_mtp(c_j, jnp.asarray(mask)).astype(jnp.float32))
    assert got.dtype == c_p.dtype and got.shape == c_p.shape
    np.testing.assert_array_equal(got.float().numpy(), want)
    # inactive cells are silence; active cells pass through
    off = got[~torch.from_numpy(mask)].float()
    assert (off[:, 0, 129] == 1).all() and (off[:, 1:, 130] == 1).all()
    assert off.sum().item() == off.shape[0] * 15
    assert torch.equal(got[torch.from_numpy(mask)],
                       c_p[torch.from_numpy(mask)])


def test_structure_and_pianoroll_plots_equal_jax(tmp_path, same_svg):
    tokens, mask = random_sample(np.random.default_rng(1))
    plotting.plot_structure(mask, str(tmp_path / "port"), name="s")
    jplotting.plot_structure(mask, str(tmp_path / "jax"), name="s")
    assert (tmp_path / "port" / "s.svg").read_bytes() == \
        (tmp_path / "jax" / "s.svg").read_bytes()
    plotting.plot_pianoroll(G.song_from_tokens(tokens, mask, 8),
                            str(tmp_path / "port"), name="p")
    jplotting.plot_pianoroll(jax_song(tokens, mask, 8),
                             str(tmp_path / "jax"), name="p")
    assert_same_png(tmp_path / "port" / "p.png", tmp_path / "jax" / "p.png")


@pytest.fixture
def trained_dir(tmp_path):
    """A model directory whose meta file the port's trainer wrote, with
    validation histories."""
    tr = tiny_trainer(tmp_path / "model", eval_every=2)
    data = batches(4)
    tr.fit(lambda: iter(data), 1, valid_iter_fn=lambda: iter(data[:1]),
           seed=1)
    assert len(tr.val_losses["tot"]) == 2
    return tmp_path / "model"


def test_loss_and_accuracy_plots_equal_jax(tmp_path, trained_dir):
    meta = plotting._load_meta(str(trained_dir))
    assert meta == jplotting._load_meta(str(trained_dir))
    assert len(meta["tr_losses"]["tot"]) == 4
    for name, port_fn, jax_fn, keys in (
            ("losses", plotting.plot_losses, jplotting.plot_losses,
             ["tot", "pitch", "kld"]),
            ("accs", plotting.plot_accuracies, jplotting.plot_accuracies,
             ["note", "s_f1"])):
        port_fn(str(trained_dir), keys, plot_val=True,
                save_path=str(tmp_path / f"{name}_port.png"))
        jax_fn(str(trained_dir), keys, plot_val=True,
               save_path=str(tmp_path / f"{name}_jax.png"))
        assert_same_png(tmp_path / f"{name}_port.png",
                        tmp_path / f"{name}_jax.png")


def test_stats_cli_equals_jax(tmp_path, trained_dir):
    stats_main([str(trained_dir), "--out", str(tmp_path / "port"), "--val"])
    jax_stats([str(trained_dir), "--out", str(tmp_path / "jax"), "--val"])
    for name in ("losses.png", "accuracies.png"):
        assert_same_png(tmp_path / "port" / name, tmp_path / "jax" / name)
    stats_main([str(trained_dir)])  # default: into the model directory
    assert (trained_dir / "losses.png").exists()
    assert (trained_dir / "accuracies.png").exists()


@pytest.mark.parametrize("source", ["reference", "jax"])
def test_convert_cli_output_decodes_as_jax(tmp_path, source):
    cfg = small_cfg(n_layers=2)
    src = tmp_path / "src"
    if source == "reference":
        write_reference_dir(str(src), cfg, seed=3)
    else:
        write_jax_dir(src, cfg, seed=3)
    out = tmp_path / "port"
    convert_main([str(src), str(out)])
    assert sorted(os.listdir(out)) == ["checkpoint.pt", "config.json"]

    model, pcfg = G.load_model(str(out), device="cpu")
    assert (pcfg.model.d, pcfg.model.gnn_n_layers) == (cfg.d, 2)
    z = random_z(4, cfg.d, seed=8)
    m_p, t_p, _, c_p = G.make_generator(model, return_logits=True,
                                        device="cpu")(z)
    jmodel, variables, _ = jax_load_model(str(src))
    m_j, t_j, s_j, c_j = (np.asarray(a) for a in jax_make_generator(
        jmodel, variables, return_logits=True)(jnp.asarray(z)))
    assert_masks_match(m_p.numpy(), m_j, s_j)
    np.testing.assert_array_equal(m_p.numpy(), m_j)
    # the logits at the parity tolerance, then the tie rule: ids equal
    # wherever the top-2 gap is clear of LOGIT_TIE (these random weights
    # leave about 0.1 % of the ids inside it, more than `assert_ids_match`
    # caps for a trained model's logits)
    np.testing.assert_allclose(c_p.numpy(), c_j, rtol=2e-4, atol=2e-4)
    gaps = np.stack([top2_gap(c_j[..., :131]), top2_gap(c_j[..., 131:])], -1)
    clear = gaps >= LOGIT_TIE
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(t_p.numpy()[clear], t_j[clear])


def test_converted_dir_resumes_with_fresh_optimizer_state(tmp_path):
    cfg = small_cfg(n_layers=2)
    write_reference_dir(str(tmp_path / "ref"), cfg, seed=5)
    out = str(tmp_path / "port")
    convert_main([str(tmp_path / "ref"), out])
    want, pcfg = G.load_model(out, device="cpu")
    tcfg = TrainConfig(batch_size=4, model=pcfg.model)
    tr = Trainer(out, VAE(tcfg.model), tcfg, device="cpu")
    tr.resume()
    assert tr.step == 0 and tr.tot_batches == 0
    assert not tr.optimizer.state_dict()["state"]
    for k, v in want.state_dict().items():
        assert torch.equal(tr.model.state_dict()[k], v), k
    losses, _ = tr.train_step(*batches(1)[0])
    assert tr.step == 1 and np.isfinite(float(losses["tot"]))


def test_download_models_with_a_stubbed_hub(tmp_path, monkeypatch, capsys):
    assert download_models.REPO_ID == jdownload.REPO_ID
    calls = []

    def snapshot_download(repo_id, local_dir):
        calls.append((repo_id, local_dir))
        return local_dir

    hub = types.ModuleType("huggingface_hub")
    hub.snapshot_download = snapshot_download
    monkeypatch.setitem(sys.modules, "huggingface_hub", hub)
    download_models.main([str(tmp_path)])
    assert calls == [(jdownload.REPO_ID, str(tmp_path))]
    assert f"downloaded in {tmp_path}" in capsys.readouterr().out

    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    with pytest.raises(SystemExit) as port_exit:
        download_models.main([str(tmp_path)])
    with pytest.raises(SystemExit) as jax_exit:
        jdownload.main([str(tmp_path)])
    assert "huggingface_hub is not installed" in str(port_exit.value)
    assert str(port_exit.value) == str(jax_exit.value)
