"""Data-parallel training of the port (`polyphemus_tpu_torch/parallel/`) on
the CPU: W gloo processes under `torchrun` train the model that one process
trains on the same global batch and seed.

  * `BatchLoader(shard=...)`: at one microbatch the rows of the JAX
    package's loader, batch for batch; at 2 and 4 microbatches the shards
    partition every global microbatch;
  * the masked batch-norm over 2 ranks: the moments, the output, the input
    grad, the summed weight grads and the running statistics of one
    process on the concatenated rows (fp32, 1e-6 relative);
  * one 2-rank `TrainStep` (d = 32, 2 layers, batch 8, accumulate 2, the
    global eps given): without dropout against JAX's step by the rules of
    tests/test_torch_train_step.py (losses and metrics 2e-4, every grad,
    the updated params and running statistics 5e-4); with dropout 0.1 (and
    message dropout in both modes, and the plain front and logits path)
    against the port's one-process step on the same generator seed, by the
    same rules (JAX's dropout masks come from `jax.random` streams that
    the port cannot draw);
  * the train CLI under `torchrun` at W = 1 and W = 2 (dropout 0.1,
    accumulate 2, `--eval`, 6 steps): per-step train losses equal at rtol
    1e-5, validation at 1e-3, every step once in metrics.jsonl, the
    checkpoints and meta file written by rank 0 alone;
  * `maybe_initialize_distributed` and the refusals: no-ops without the
    environment; a W that the model axis does not divide, a model axis
    that does not divide d, a column shard narrower than the kernels'
    tile on a card, a data axis other than W / M, and a data axis that
    does not divide the microbatch (the CLI exits non-zero before its
    first step; the same 2 ranks train at model axis 2).

Every subprocess has a timeout and every process group its own
(`tests/torch_parallel_worker.py`); `torchrun --standalone` takes a free
port.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from polyphemus_tpu.config import TrainConfig
from polyphemus_tpu.data import BatchLoader as JBatchLoader
from polyphemus_tpu.data.dataset import synthetic_batch
from polyphemus_tpu_torch import config as pconfig
from polyphemus_tpu_torch.config import train_config_to_dict
from polyphemus_tpu_torch.data import BatchLoader, shard_rows
from polyphemus_tpu_torch.models import VAE
from polyphemus_tpu_torch.models.layers import MaskedBatchNorm
from polyphemus_tpu_torch.ops import masked as mops
from polyphemus_tpu_torch.parallel import mesh as pmesh
from polyphemus_tpu_torch.train import trainer as ptrainer

from .test_torch_train_step import (MB, check_against_jax, jax_eps,
                                    jax_reference_step, microbatch_rngs,
                                    near_tie_slack)
from .test_torch_train_cli import LOSSES, make_dataset
from .torch_port_case import build, jax_tree, port_cfg, small_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_parallel_worker.py")
RUN_TIMEOUT = 300  # seconds, a whole torchrun


def torchrun(nproc, *args):
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(nproc), WORKER, *map(str, args)],
        capture_output=True, text=True, timeout=RUN_TIMEOUT,
        env=dict(os.environ, OMP_NUM_THREADS="1"))


def run_ok(nproc, *args):
    out = torchrun(nproc, *args)
    assert out.returncode == 0, (out.stdout[-3000:], out.stderr[-3000:])
    return out


# ------------------------------------------------------------ the loader
class _IdxDS:
    """Dataset whose samples encode their own index."""

    def __len__(self):
        return 64

    def __getitem__(self, i):
        t = np.full((2, 4, 32, 16, 2), i, np.int16)
        return t, np.ones((2, 4, 32), bool)


def ids(batch):
    return batch[0][:, 0, 0, 0, 0, 0].tolist()


@pytest.mark.parametrize("pcount", [2, 4])
def test_shards_at_one_microbatch_are_the_jax_loaders(pcount):
    for pid in range(pcount):
        kw = dict(shuffle=True, seed=3, num_workers=1, shard=(pid, pcount))
        got = list(BatchLoader(_IdxDS(), 8, **kw))
        want = list(JBatchLoader(_IdxDS(), 8, **kw))
        assert len(got) == len(want) == 8
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[0], w[0])
            np.testing.assert_array_equal(g[1], w[1])


@pytest.mark.parametrize("accum,pcount", [(2, 2), (2, 4), (4, 2)])
def test_shards_partition_every_global_microbatch(accum, pcount):
    """Local microbatch i of every process, in rank order, is global
    microbatch i (mirrors tests/test_multihost.py's partition test)."""
    full = list(BatchLoader(_IdxDS(), 16, seed=3, num_workers=1))
    shards = [list(BatchLoader(_IdxDS(), 16, seed=3, num_workers=1,
                               shard=(pid, pcount), microbatches=accum))
              for pid in range(pcount)]
    mb = 16 // accum
    per = mb // pcount
    for b, batch in enumerate(full):
        for i in range(accum):
            local = sum((ids(shards[pid][b])[i * per:(i + 1) * per]
                         for pid in range(pcount)), [])
            assert local == ids(batch)[i * mb:(i + 1) * mb]


def test_loader_refuses_an_uneven_split():
    with pytest.raises(ValueError, match="does not split evenly"):
        BatchLoader(_IdxDS(), 6, shard=(0, 4))
    with pytest.raises(ValueError, match="does not split evenly"):
        BatchLoader(_IdxDS(), 8, shard=(0, 2), microbatches=8)
    # 64 samples in batches of 24: the last batch of 16 does not split
    # into 3 microbatches
    loader = BatchLoader(_IdxDS(), 24, shard=(1, 2), microbatches=3,
                         drop_last=False, num_workers=1)
    with pytest.raises(ValueError, match="does not split evenly"):
        list(loader)
    assert shard_rows(8, 2, 1, 2).tolist() == [2, 3, 6, 7]


# -------------------------------------------------------- the batch-norm
def test_masked_batch_norm_over_two_ranks_is_one_process(tmp_path):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((8, 40, 16)).astype(np.float32)
                         * 3.0 + 1.0)
    mask = torch.from_numpy(rng.random((8, 40)) < 0.3)
    grad_out = torch.from_numpy(rng.standard_normal(x.shape).astype(
        np.float32))
    bn = MaskedBatchNorm(16)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.uniform_(-0.5, 0.5)
        bn.running_mean.uniform_(-1, 1)
    torch.save({"x": x, "mask": mask, "grad_out": grad_out,
                "bn": bn.state_dict()}, tmp_path / "in.pt")
    run_ok(2, "bn", tmp_path / "in.pt", tmp_path)
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]

    xr = x.clone().requires_grad_(True)
    mean, var, count = mops.masked_moments(x, mask, (0, 1))
    y = bn(xr, mask)
    (y * grad_out).sum().backward()
    tol = dict(rtol=1e-6, atol=1e-6)
    for r in ranks:
        torch.testing.assert_close(r["mean"], mean, **tol)
        torch.testing.assert_close(r["var"], var, **tol)
        torch.testing.assert_close(r["count"], count, rtol=0, atol=0)
        torch.testing.assert_close(r["running_mean"], bn.running_mean, **tol)
        torch.testing.assert_close(r["running_var"], bn.running_var, **tol)
    torch.testing.assert_close(torch.cat([r["y"] for r in ranks]),
                               y.detach(), **tol)
    torch.testing.assert_close(torch.cat([r["x_grad"] for r in ranks]),
                               xr.grad, **tol)
    for name in ("weight", "bias"):
        torch.testing.assert_close(
            sum(r[f"{name}_grad"] for r in ranks),
            getattr(bn, name).grad, rtol=1e-6, atol=1e-5)


# ------------------------------------------------------- one train step
def two_rank_step(tmp_path, model, pcfg, toks, mask, eps, seed=None):
    """(losses, accs, the model after the step with its summed grads) of
    a 2-rank `TrainStep` on the global batch; both ranks' reports and
    states are equal."""
    torch.save({"cfg": train_config_to_dict(pcfg),
                "state": model.state_dict(),
                "tokens": torch.from_numpy(toks),
                "mask": torch.from_numpy(mask),
                "eps": torch.from_numpy(eps), "seed": seed},
               tmp_path / "in.pt")
    run_ok(2, "step", tmp_path / "in.pt", tmp_path)
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    for k in ("losses", "accs", "state", "grads"):
        for name, v in ranks[0][k].items():
            torch.testing.assert_close(ranks[1][k][name], v, rtol=0, atol=0,
                                       msg=f"{k}/{name}")
    after = VAE(pcfg.model)
    after.load_state_dict(ranks[0]["state"])
    for name, p in after.named_parameters():
        p.grad = ranks[0]["grads"][name]
    return ranks[0]["losses"], ranks[0]["accs"], after


def test_two_rank_step_matches_jax(tmp_path):
    accum, seed = 2, 0
    mcfg = small_cfg(n_layers=2)
    cfg = TrainConfig(batch_size=MB * accum, model=mcfg,
                      iters_to_accumulate=accum)
    variables, jmodel, model = build(mcfg, seed=seed)
    toks, mask = synthetic_batch(np.random.default_rng(seed + 1),
                                 MB * accum, mcfg.n_bars)
    rng = jax.random.key(seed + 7)
    eps = jax_eps(jmodel, jax_tree(variables["params"]),
                  microbatch_rngs(rng, accum), mcfg.d)
    pcfg = pconfig.TrainConfig(batch_size=MB * accum, model=port_cfg(mcfg),
                               iters_to_accumulate=accum)
    slack = near_tie_slack(model, pcfg, toks, mask, eps)
    losses, accs, after = two_rank_step(tmp_path, model, pcfg, toks, mask,
                                        eps)
    want = jax_reference_step(jmodel, cfg, variables, toks, mask, rng)
    check_against_jax(want, losses, accs, after, slack)


def as_jax_step(model, pcfg, losses, accs, tol=2e-4):
    """The port's one-process step in the form `check_against_jax` takes
    (flat numpy losses, metrics, grads, params and batch statistics)."""
    from polyphemus_tpu_torch.convert import to_jax_variables

    from .test_torch_train_step import flatten

    grads = flatten(to_jax_variables(
        {n: p.grad for n, p in model.named_parameters()})["params"])
    tree = to_jax_variables(model.state_dict())
    return ({k: float(v) for k, v in losses.items()},
            {k: float(v) for k, v in accs.items()}, grads,
            flatten(tree["params"]), flatten(tree["batch_stats"]))


@pytest.mark.parametrize("extra", [
    {},
    {"message_dropout": 0.1, "message_dropout_mode": "aggregate",
     "fused_content_encoder": False, "fused_ce": False},
    {"message_dropout": 0.1, "message_dropout_mode": "edge"}],
    ids=["dropout", "aggregate_plain_front_logits", "edge"])
def test_two_rank_step_with_dropout_is_the_one_process_step(tmp_path,
                                                            extra):
    """Dropout 0.1 (and message dropout): every mask of a rank is its rows
    of the one-process draw, so the 2-rank step is the one-process step.
    The ranks can be only as close as fp32 resolves the step: at seed 0
    the one-process fp32 grads of every case lie within 1e-4 of its max
    from an fp64 step's (at seed 1 the plain dropout case's decoder-GCN
    grads lie 3 % away, in one process as in two)."""
    accum, seed = 2, 0
    extra = dict(extra)
    fused_ce = extra.pop("fused_ce", True)
    mc = dataclasses.replace(port_cfg(small_cfg(n_layers=2)), dropout=0.1,
                             **extra)
    pcfg = pconfig.TrainConfig(batch_size=8, model=mc,
                               iters_to_accumulate=accum, fused_ce=fused_ce)
    torch.manual_seed(seed)
    model = VAE(mc)
    toks, mask = synthetic_batch(np.random.default_rng(seed), 8, mc.n_bars)
    eps = np.random.default_rng(seed + 1).standard_normal(
        (8, mc.d)).astype(np.float32)
    slack = near_tie_slack(model, pcfg, toks, mask, eps)
    losses, accs, after = two_rank_step(tmp_path, model, pcfg, toks, mask,
                                        eps, seed=5)
    gen = torch.Generator().manual_seed(5)
    model.set_dropout_generator(gen)
    step = ptrainer.make_train_step(model, pcfg,
                                    ptrainer.make_optimizer(model, pcfg))
    one = step(torch.from_numpy(toks), torch.from_numpy(mask),
               eps=torch.from_numpy(eps), generator=gen)
    check_against_jax(as_jax_step(model, pcfg, *one), losses, accs, after,
                      slack)


# ------------------------------------------------------------- the CLI
CLI_STEPS = 6


def cli_run(tmp_path, data, cfg_path, nproc):
    out = tmp_path / f"w{nproc}"
    out.mkdir()
    run_ok(nproc, "cli", out, data, out, cfg_path, "--model_name", "m",
           "--device", "cpu", "--num_workers", "2", "--tr_split", "0.75",
           "--vl_split", "0.25", "--eval", "--max_epochs", "1",
           "--save_every", "3", "--seed", "3")
    model_dir = out / "m"
    rows = [json.loads(line) for line in
            (model_dir / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in rows if "loss/tot" in r]
    val = [r for r in rows if "val_loss/tot" in r]
    assert [r["batch"] for r in train] == list(range(CLI_STEPS))
    assert len(val) == 1 and len(rows) == CLI_STEPS + 1
    assert (out / "writes_rank0.txt").read_text().split() == [
        "checkpoint", "best_model", "checkpoint", "checkpoint"]
    for r in range(1, nproc):
        assert not (out / f"writes_rank{r}.txt").exists()
    for name in ("checkpoint", "best_model"):
        json.loads((model_dir / f"{name}.json").read_text())
    ck = torch.load(model_dir / "checkpoint.pt", weights_only=True)
    assert ck["step"] == CLI_STEPS
    return train, val, ck


def test_cli_under_torchrun_trains_the_one_process_model(tmp_path):
    make_dataset(tmp_path / "data", 64, seed=2)
    cfg = pconfig.TrainConfig(
        batch_size=8, iters_to_accumulate=2,
        model=dataclasses.replace(port_cfg(small_cfg(n_layers=2)),
                                  dropout=0.1),
        optimizer=pconfig.OptimizerConfig(eps=1e-6))
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(train_config_to_dict(cfg)))
    (t1, v1, c1), (t2, v2, c2) = (
        cli_run(tmp_path, tmp_path / "data", cfg_path, w) for w in (1, 2))
    for k in LOSSES:
        np.testing.assert_allclose([r[f"loss/{k}"] for r in t2],
                                   [r[f"loss/{k}"] for r in t1], rtol=1e-5,
                                   atol=1e-7, err_msg=k)
        np.testing.assert_allclose(v2[0][f"val_loss/{k}"],
                                   v1[0][f"val_loss/{k}"], rtol=1e-3,
                                   atol=1e-6, err_msg=k)
    for name, v in c1["model"].items():
        torch.testing.assert_close(c2["model"][name], v, rtol=1e-4,
                                   atol=1e-4, msg=name)


# ----------------------------------------- initialisation and refusals
def test_without_a_group_every_function_is_a_no_op(monkeypatch):
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert pmesh.maybe_initialize_distributed("cpu") is None
    assert not pmesh.active()
    assert (pmesh.rank(), pmesh.world(), pmesh.is_primary()) == (0, 1, True)
    t = torch.arange(6.0).reshape(2, 3)
    assert pmesh.all_reduce_sum(t) is t and pmesh.rank_share(t) is t
    g = torch.Generator().manual_seed(0)
    got = pmesh.global_rows(lambda s: torch.rand(s, generator=g), (4, 3), 1)
    torch.testing.assert_close(
        got, torch.rand((4, 3), generator=torch.Generator().manual_seed(0)))
    assert pmesh.data_layout(pconfig.TrainConfig(batch_size=6,
                                                 iters_to_accumulate=4)) \
        == {"data": 1, "model": 1}


def layout_cfg(**parallel):
    return pconfig.TrainConfig(batch_size=8, iters_to_accumulate=2,
                               parallel=pconfig.ParallelConfig(**parallel))


def test_data_layout_refuses_what_it_cannot_run(monkeypatch):
    """Each refusal a ValueError naming its numbers, before any group is
    made: one process at model axis 2 (in the layout and in the
    Trainer), a data axis other than W / M; then, for W = 6 and W = 2
    processes, a model axis of 3 that does not divide d = 512 and, on a
    card, shards of d / 2 = 16 columns of a d = 32 model."""
    with pytest.raises(ValueError, match="1 processes not divisible by "
                                         "parallel.model_axis=2"):
        pmesh.data_layout(layout_cfg(model_axis=2))
    with pytest.raises(ValueError, match="data_axis=2 but the run has 1"):
        pmesh.data_layout(layout_cfg(data_axis=2))
    with pytest.raises(ValueError, match="not divisible by parallel."
                                         "model_axis=2"):
        ptrainer.Trainer("unused", VAE(port_cfg(small_cfg(n_layers=1))),
                         layout_cfg(model_axis=2), device="cpu")
    monkeypatch.setattr(pmesh, "world", lambda: 6)
    with pytest.raises(ValueError, match="model_axis=3 must divide the "
                                         "sharded widths d=512, 15d=7680 "
                                         "and n_bars d=1024"):
        pmesh.data_layout(layout_cfg(model_axis=3))
    monkeypatch.setattr(pmesh, "world", lambda: 2)
    small = dataclasses.replace(layout_cfg(model_axis=2),
                                model=port_cfg(small_cfg(n_layers=1)))
    with pytest.raises(ValueError, match="d / M = 16, not a multiple of "
                                         "128"):
        pmesh.data_layout(small, "cuda")
    assert pmesh.model_size() == 1 and not pmesh._groups


def test_one_rank_from_the_environment_and_the_refusals(tmp_path):
    """`torchrun` with one rank: the group comes up from the environment,
    on gloo for the CPU, and trains; with 2 ranks a microbatch of 3 rows
    is refused before any step, and so is a model axis of 4, while the
    same 2 ranks train at a model axis of 2."""
    make_dataset(tmp_path / "data", 12, seed=1)
    base = dataclasses.replace(
        pconfig.TrainConfig(batch_size=4, iters_to_accumulate=2),
        model=port_cfg(small_cfg(n_layers=1)))
    cases = {"ok": (1, base),
             "microbatch": (2, dataclasses.replace(base, batch_size=6)),
             "model_axis": (2, dataclasses.replace(
                 base, parallel=pconfig.ParallelConfig(model_axis=4))),
             "tensor": (2, dataclasses.replace(
                 base, parallel=pconfig.ParallelConfig(model_axis=2)))}
    outs = {}
    for name, (nproc, cfg) in cases.items():
        cfg_path = tmp_path / f"{name}.json"
        cfg_path.write_text(json.dumps(train_config_to_dict(cfg)))
        outs[name] = torchrun(
            nproc, "cli", tmp_path, tmp_path / "data", tmp_path / name,
            cfg_path, "--model_name", "m", "--device", "cpu",
            "--num_workers", "1", "--tr_split", "1.0", "--max_epochs", "1")
    ok = outs["ok"]
    assert ok.returncode == 0, ok.stderr[-3000:]
    assert "Devices: 1 mesh={'data': 1, 'model': 1}" in ok.stdout
    assert "Kernel launches (rank 0)" in ok.stdout
    assert (tmp_path / "ok" / "m" / "metrics.jsonl").exists()
    tensor = outs["tensor"]
    assert tensor.returncode == 0, tensor.stderr[-3000:]
    assert "Devices: 2 mesh={'data': 1, 'model': 2}" in tensor.stdout
    assert "Kernel launches (rank 1)" in tensor.stdout
    assert (tmp_path / "tensor" / "m" / "checkpoint.pt").exists()
    for name, why in (("microbatch", "cannot share a microbatch"),
                      ("model_axis", "2 processes not divisible by "
                                     "parallel.model_axis=4")):
        out = outs[name]
        assert out.returncode != 0 and why in out.stderr, out.stderr[-3000:]
        assert not (tmp_path / name / "m").exists()


def test_parallel_imports_nothing_of_jax_and_starts_no_group():
    """`parallel.mesh` stands alone as the rest of the port does
    (tests/test_torch_isolation.py walks it too): importing it loads
    nothing of JAX or the JAX package and joins no process group."""
    code = ("import sys; import polyphemus_tpu_torch.parallel.mesh as m; "
            "bad = [k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'flax', 'optax', 'polyphemus_tpu')]; "
            "assert not bad, bad; assert not m.active()")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
