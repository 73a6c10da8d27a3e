"""The port's training runtime on the CPU: a checkpoint saved mid-run and
resumed into a fresh model gives the same next step; `cli.train` with
`--device cpu` trains on a tiny directory of reference-format `.npz` files
(metrics.jsonl with the JAX trainer's keys, all finite; evaluation and
`best_model`; `--resume` continues the update count), and the trained
directory serves through `generate.load_model`; the dataset reads back what
`write_sample` wrote; flags for what is not ported are refused."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from polyphemus_tpu_torch.cli import train as train_cli
from polyphemus_tpu_torch.config import TrainConfig, train_config_to_dict
from polyphemus_tpu_torch.data import (BatchLoader, PolyphemusDataset,
                                       synthetic_batch, write_sample)
from polyphemus_tpu_torch.generate import load_model, make_generator
from polyphemus_tpu_torch.models import VAE
from polyphemus_tpu_torch.train import trainer as ptrainer

from .torch_port_case import port_cfg, small_cfg

LOSSES = ("tot", "pitch", "dur", "structure", "reconstruction", "kld",
          "beta*kld")
METRICS = ("note", "pitch", "pitch_drums", "pitch_non_drums", "dur", "s_acc",
           "s_precision", "s_recall", "s_f1")


def tiny_cfg(accum=1, batch=4):
    return TrainConfig(batch_size=batch, model=port_cfg(small_cfg(n_layers=2)),
                       iters_to_accumulate=accum)


def fresh_model(cfg, seed):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return VAE(cfg.model)


def test_resume_gives_the_same_next_step(tmp_path):
    cfg = tiny_cfg(accum=2)
    rng = np.random.default_rng(0)
    batches = [tuple(torch.from_numpy(a) for a in synthetic_batch(rng, 4, 2))
               for _ in range(2)]
    eps = [torch.from_numpy(rng.standard_normal((4, cfg.model.d)).astype(
        np.float32)) for _ in range(2)]
    a = ptrainer.Trainer(str(tmp_path), fresh_model(cfg, 1), cfg,
                         device="cpu")
    a.train_step(*batches[0], eps=eps[0])
    a.save("checkpoint")
    want, _ = a.train_step(*batches[1], eps=eps[1])

    b = ptrainer.Trainer(str(tmp_path), fresh_model(cfg, 2), cfg,
                         device="cpu")
    b.resume()
    assert b.step == 1
    got, _ = b.train_step(*batches[1], eps=eps[1])
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=1e-6)
    for (name, p), q in zip(a.model.named_parameters(),
                            b.model.parameters()):
        torch.testing.assert_close(q, p, rtol=1e-6, atol=1e-6, msg=name)
    for (name, v), w in zip(a.model.named_buffers(), b.model.buffers()):
        torch.testing.assert_close(w, v, rtol=1e-6, atol=1e-6, msg=name)


def make_dataset(directory, n, n_bars=2, seed=0):
    os.makedirs(directory, exist_ok=True)
    toks, mask = synthetic_batch(np.random.default_rng(seed), n, n_bars)
    for i in range(n):
        write_sample(os.path.join(directory, f"s{i:03d}.npz"), toks[i],
                     mask[i])
    return toks, mask


def test_dataset_reads_what_write_sample_wrote(tmp_path):
    toks, mask = make_dataset(tmp_path / "data", 5)
    ds = PolyphemusDataset(str(tmp_path / "data"), n_bars=2)
    assert len(ds) == 5
    t, m = ds[3]
    np.testing.assert_array_equal(t, toks[3])
    np.testing.assert_array_equal(m, mask[3])
    batches = list(BatchLoader(ds, 2, shuffle=False, num_workers=2))
    assert len(batches) == 2 and batches[0][0].shape == (2,) + toks.shape[1:]


def test_cli_trains_resumes_and_serves(tmp_path):
    make_dataset(tmp_path / "data", 16)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(train_config_to_dict(tiny_cfg(accum=2))))
    argv = [str(tmp_path / "data"), str(tmp_path / "out"), str(cfg_path),
            "--model_name", "m", "--device", "cpu", "--num_workers", "2",
            "--tr_split", "0.5", "--vl_split", "0.25", "--eval",
            "--max_epochs", "1", "--save_every", "1"]
    trainer = train_cli.main(argv)
    model_dir = tmp_path / "out" / "m"
    assert trainer.step == 2
    lines = [json.loads(s) for s in
             (model_dir / "metrics.jsonl").read_text().splitlines()]
    train_lines = [r for r in lines if "loss/tot" in r]
    assert [r["batch"] for r in train_lines] == [0, 1]
    for r in train_lines:
        vals = [r[f"loss/{k}"] for k in LOSSES] + [r[f"acc/{k}"]
                                                  for k in METRICS]
        assert np.isfinite(vals).all(), r
        assert {"epoch", "lr", "beta"} <= set(r)
    assert any("val_loss/tot" in r for r in lines)
    assert (model_dir / "best_model.pt").exists()

    resumed = train_cli.main(argv + ["--resume"])
    assert resumed.step == 4

    model, cfg = load_model(str(model_dir), "cpu")
    assert cfg.model == tiny_cfg().model
    mask, tokens = make_generator(model, device="cpu")(
        torch.zeros(2, cfg.model.d))
    assert tokens.shape == mask.shape + (15, 2)


def test_cli_refuses_what_is_not_ported(tmp_path):
    make_dataset(tmp_path / "data", 2)
    (tmp_path / "data" / "shards.json").write_text("{}")
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(train_config_to_dict(tiny_cfg())))
    base = [str(tmp_path / "data"), str(tmp_path / "out"), str(cfg_path),
            "--device", "cpu"]
    with pytest.raises(NotImplementedError, match="fastloader"):
        train_cli.main(base)
    with pytest.raises(NotImplementedError, match="tensorboard"):
        train_cli.main(base + ["--tensorboard"])


def test_non_finite_streak_aborts(tmp_path):
    cfg = tiny_cfg()
    trainer = ptrainer.Trainer(str(tmp_path), fresh_model(cfg, 0), cfg,
                               device="cpu")
    nan = {k: torch.tensor(float("nan")) for k in LOSSES}
    ok = {k: torch.tensor(1.0) for k in LOSSES}
    for i in range(trainer.max_nan_steps - 1):
        trainer._record(i, 0, nan, {})
    trainer._record(9, 0, ok, {})  # a finite loss resets the streak
    for i in range(trainer.max_nan_steps - 1):
        trainer._record(10 + i, 0, nan, {})
    with pytest.raises(FloatingPointError, match="consecutive"):
        trainer._record(20, 0, nan, {})


def test_message_dropout_is_refused_in_training():
    cfg = tiny_cfg()
    model = VAE(dataclasses.replace(cfg.model, message_dropout=0.1)).train()
    toks, mask = (torch.from_numpy(a) for a in synthetic_batch(
        np.random.default_rng(0), 2, 2))
    with pytest.raises(NotImplementedError, match="message_dropout"):
        model.train_stats(toks, mask)
