"""The port's trainer surface beyond the step, at d = 32 on the CPU: the
meta file `<name>.json` beside every checkpoint (read by the JAX package's
`plotting._load_meta` with the `.pt` meta's keys and values), the
`AsyncSaver` (saves written in the order submitted, a worker error raised
on the next `submit` or `wait`, the snapshot taken at `submit`), the
TensorBoard mirror of metrics.jsonl (the same tags and values), a
profiler trace of a window of steps, and `utils` (`StepTimer`,
`param_count`, `print_params`) against the JAX package's on converted
weights."""
import json
import os

import numpy as np
import pytest
import torch

from polyphemus_tpu import plotting
from polyphemus_tpu import utils as jutils
from polyphemus_tpu_torch import utils
from polyphemus_tpu_torch.config import TrainConfig
from polyphemus_tpu_torch.data import synthetic_batch
from polyphemus_tpu_torch.models import VAE
from polyphemus_tpu_torch.train import checkpoint as ckpt
from polyphemus_tpu_torch.train import trainer as ptrainer

from .torch_port_case import build, port_cfg, small_cfg


def tiny_trainer(path, **kw):
    cfg = TrainConfig(batch_size=4, model=port_cfg(small_cfg(n_layers=2)))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = VAE(cfg.model)
    return ptrainer.Trainer(str(path), model, cfg, device="cpu", **kw)


def batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [tuple(torch.from_numpy(a) for a in synthetic_batch(rng, 4, 2))
            for _ in range(n)]


def test_meta_file_is_what_jax_plotting_reads(tmp_path):
    tr = tiny_trainer(tmp_path)
    data = batches(2)
    tr.fit(lambda: iter(data), 1, seed=1)
    assert tr.step == 2
    assert (tmp_path / "checkpoint.json").exists()
    meta = plotting._load_meta(str(tmp_path))
    pt_meta = torch.load(ckpt.path(str(tmp_path), "checkpoint"),
                         weights_only=True)["meta"]
    assert set(meta) == set(pt_meta)
    for k, v in pt_meta.items():
        assert meta[k] == v, k
    assert len(meta["tr_losses"]["tot"]) == 2 and meta["tot_batches"] == 2


def test_async_saver_writes_in_order(tmp_path, monkeypatch):
    tr = tiny_trainer(tmp_path)
    order = []
    write = ckpt.write_checkpoint

    def spy(model_dir, name, snap, meta):
        order.append((name, snap["step"]))
        write(model_dir, name, snap, meta)

    monkeypatch.setattr(ckpt, "write_checkpoint", spy)
    saver = ckpt.AsyncSaver()
    for i in range(5):
        saver.submit(tr.model, tr.optimizer, i, str(tmp_path),
                     f"n{i % 2}", {"i": i})
    saver.wait()
    assert order == [(f"n{i % 2}", i) for i in range(5)]
    for name, last in (("n0", 4), ("n1", 3)):
        assert json.loads((tmp_path / f"{name}.json").read_text()) == \
            {"i": last}
        assert torch.load(ckpt.path(str(tmp_path), name),
                          weights_only=True)["step"] == last


def test_async_saver_reraises_a_worker_error(tmp_path):
    tr = tiny_trainer(tmp_path)
    (tmp_path / "file").write_text("not a directory")
    bad = str(tmp_path / "file" / "model")
    saver = ckpt.AsyncSaver()
    saver.submit(tr.model, tr.optimizer, 0, bad, "checkpoint", {})
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        saver.wait()
    saver.wait()  # raised once, then clear
    one = ckpt.AsyncSaver(max_pending=1)
    one.submit(tr.model, tr.optimizer, 0, bad, "checkpoint", {})
    # the next submit takes the only slot once the failed save is done
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        one.submit(tr.model, tr.optimizer, 1, str(tmp_path), "ok", {})
    one.submit(tr.model, tr.optimizer, 2, str(tmp_path), "ok", {})
    one.wait()
    assert torch.load(ckpt.path(str(tmp_path), "ok"),
                      weights_only=True)["step"] == 2


def test_async_saver_saves_the_weights_at_submit(tmp_path):
    tr = tiny_trainer(tmp_path)
    tr.train_step(*batches(1)[0])
    want = {k: v.clone() for k, v in tr.model.state_dict().items()}
    want_opt = {k: v["exp_avg"].clone()
                for k, v in tr.optimizer.state_dict()["state"].items()}
    saver = ckpt.AsyncSaver()
    saver.submit(tr.model, tr.optimizer, 1, str(tmp_path), "checkpoint", {})
    with torch.no_grad():
        for p in tr.model.parameters():
            p.add_(1.0)
        for st in tr.optimizer.state.values():
            st["exp_avg"].add_(1.0)
    saver.wait()
    got = torch.load(ckpt.path(str(tmp_path), "checkpoint"),
                     weights_only=True)
    for k, v in want.items():
        assert torch.equal(got["model"][k], v), k
    for k, v in want_opt.items():
        assert torch.equal(got["optimizer"]["state"][k]["exp_avg"], v), k


def test_resume_waits_for_a_save_in_flight(tmp_path):
    tr = tiny_trainer(tmp_path)
    tr.train_step(*batches(1)[0])
    tr.save("checkpoint", blocking=False)
    want = {k: v.clone() for k, v in tr.model.state_dict().items()}
    tr.resume()
    assert tr.step == 1
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_tensorboard_mirrors_the_metrics(tmp_path):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)

    tr = tiny_trainer(tmp_path, tensorboard=True, eval_every=2)
    data = batches(2)
    tr.fit(lambda: iter(data), 1, valid_iter_fn=lambda: iter(data[:1]),
           seed=1)
    acc = EventAccumulator(str(tmp_path / "tb"))
    acc.Reload()
    recs = [json.loads(s) for s in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    for rec in recs:
        for tag, v in rec.items():
            if tag in ("batch", "epoch", "seq_s"):
                continue
            events = {e.step: e.value for e in acc.Scalars(tag)}
            np.testing.assert_allclose(events[rec["batch"]], v, rtol=1e-6,
                                       err_msg=tag)
    assert "loss/tot" in acc.Tags()["scalars"]
    assert "val_loss/tot" in acc.Tags()["scalars"]


def test_fit_writes_a_profiler_trace(tmp_path):
    tr = tiny_trainer(tmp_path / "m")
    data = batches(3)
    tr.fit(lambda: iter(data), 1, profile_dir=str(tmp_path / "prof"),
           profile_steps=(1, 2))
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]
    assert (tmp_path / "prof" / "kernels.txt").stat().st_size > 0


def test_profile_trace_writes_the_block_and_is_a_no_op_without_a_dir(
        tmp_path):
    with utils.profile_trace(None):
        pass
    assert not os.listdir(tmp_path)
    with utils.profile_trace(str(tmp_path / "prof")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
    assert "mm" in (tmp_path / "prof" / "kernels.txt").read_text()


def test_step_timer_and_param_count_agree_with_jax(monkeypatch):
    clock = iter([1.0, 1.5, 1.75, 3.0, 3.125] * 2)
    for mod in (utils, jutils):
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
    timers = [utils.StepTimer(window=3), jutils.StepTimer(window=3)]
    for t in timers:
        dts = [t.tick() for _ in range(5)]
        assert dts[0] is None
    assert timers[0].times == timers[1].times == [0.25, 1.25, 0.125]
    assert timers[0].mean == timers[1].mean
    assert timers[0].steps_per_sec == timers[1].steps_per_sec
    variables, _, model = build(small_cfg(n_layers=2))
    lines = []
    total = utils.print_params(model, log_fn=lines.append)
    assert total == utils.param_count(model) == jutils.param_count(
        variables["params"])
    assert lines[-1] == f"Total Trainable Parameters: {total}"
    assert len(lines) == 3 + len(list(model.parameters()))


def test_set_seed_repeats_draws(monkeypatch):
    monkeypatch.delenv("PYTHONHASHSEED", raising=False)  # restored after
    utils.set_seed(3)
    a = (np.random.rand(), torch.rand(2))
    utils.set_seed(3)
    b = (np.random.rand(), torch.rand(2))
    assert a[0] == b[0] and torch.equal(a[1], b[1])
    assert os.environ["PYTHONHASHSEED"] == "3"
