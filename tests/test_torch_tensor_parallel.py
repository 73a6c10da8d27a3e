"""Tensor parallelism of the port (`parallel.model_axis` M > 1,
`polyphemus_tpu_torch/parallel/mesh.py`) on the CPU, in gloo processes
under `torchrun` (tests/torch_parallel_worker.py):

  (a) the GCL kernels' column forms, through their plain versions (d = 32,
      5 bars, fp32 and bf16, n = d / 2 and d / 4): each shard of
      `gcl_fwd`, `gcl_eval` (K = 1), `gcl_bwd_weight` and of dWbig and
      dbias of `gcl_bwd_data` / `gcl_bwd_fused` is the square form's
      columns (fp32: rtol = atol = 1e-5, the products' summation order;
      bf16: 2e-2 x max |square|), the partial dx and dgate summed over the
      shards are the square form's (fp32: 1e-5 x max |square|; bf16:
      2e-2); the square form is held to the Pallas kernels in interpret
      mode on the same numpy inputs (fp32: forward 2e-4, backward 5e-4,
      as tests/test_torch_gcl_train.py; bf16: 2e-2 x max |JAX|);
  (b) one fp32 `TrainStep` (d = 32, 2 layers, batch 8, accumulate 2) at
      M = 2 over 2 ranks and at D = 2 x M = 2 over 4 ranks, against JAX's
      step on `make_mesh(2)` over the 8 faked CPU devices (data 4 x model
      2) with `param_sharding` (the XLA GCL of
      tests/test_torch_train_step.py) and against the port's one-process
      step, by the rules of that file (losses and metrics 2e-4; every
      gathered grad, the new params and the batch-norm statistics 5e-4);
      each rank holds 1 / M of every sharded parameter and of its Adam
      moments, the rest whole; the eval step (the column-form eval stack)
      gives one process's losses (2e-4);
  (c) a bf16 step at M = 2 against the one-process bf16 step (losses 3e-2
      relative, the bf16 tolerance of tests/test_torch_parallel.py's
      card phase); message dropout ("edge", dropout 0.1) at M = 2 against
      one process by the rules of (b); the train CLI under `torchrun` at
      M = 2 resuming a one-process run's checkpoint: its losses are the
      one-process continuation's (rtol 1e-4), and its `checkpoint.pt`
      (the one-process layout) loads into a one-process `Trainer` and into
      `GenerationService`, whose pieces are the one-process run's.
"""
import dataclasses
import functools
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyphemus_tpu.config import ParallelConfig, TrainConfig
from polyphemus_tpu.data.dataset import synthetic_batch
from polyphemus_tpu.ops.kernels import gcl_pallas, gcl_pallas_bwd
from polyphemus_tpu.parallel import mesh as jmesh
from polyphemus_tpu_torch import config as pconfig
from polyphemus_tpu_torch.cli import train as train_cli
from polyphemus_tpu_torch.config import train_config_to_dict
from polyphemus_tpu_torch.models import VAE
from polyphemus_tpu_torch.ops.kernels import gcl, gcl_bwd
from polyphemus_tpu_torch.parallel import mesh as pmesh
from polyphemus_tpu_torch.serve import GenerationService
from polyphemus_tpu_torch.train import trainer as ptrainer

from .test_torch_parallel import as_jax_step, run_ok
from .test_torch_train_cli import LOSSES, make_dataset
from .test_torch_train_step import (MB, check_against_jax, jax_eps,
                                    jax_reference_step, microbatch_rngs,
                                    near_tie_slack)
from .torch_port_case import build, jax_tree, port_cfg, small_cfg

T, S, D = 4, 32, 32
COL_TOL = dict(rtol=1e-5, atol=1e-5)
SUM_REL = 1e-5
FWD_TOL = dict(rtol=2e-4, atol=2e-4)
BWD_TOL = dict(rtol=5e-4, atol=5e-4)
BF16_REL = 2e-2
BF16_LOSS_RTOL = 3e-2


# ------------------------------------------------- (a) the column forms
def layer_inputs(seed=0, nbar=5):
    """numpy mask, x, upstream g, gate table, weights, bias and eval
    affine of one layer; bars 0 and 1 are the lattice's edge cases."""
    rng = np.random.default_rng(seed)
    mask = rng.random((nbar, T, S)) < 0.3
    mask[0] = False
    mask[0, 2, 17] = True                # single node off track 0
    mask[1] = False
    mask[1, 0, 0] = True                 # fixed empty bar
    x = rng.standard_normal((nbar, T, S, D)).astype(np.float32) \
        * mask[..., None]
    g = rng.standard_normal((nbar, T, S, D)).astype(np.float32)
    gate = (rng.standard_normal((S, D)) * 0.5).astype(np.float32)
    rel_w = (rng.standard_normal((6, D, D)) * D ** -0.5).astype(np.float32)
    root = (rng.standard_normal((D, D)) * D ** -0.5).astype(np.float32)
    bias, eb = ((rng.standard_normal(D) * 0.2).astype(np.float32)
                for _ in range(2))
    ea = (1.0 + 0.2 * rng.standard_normal(D)).astype(np.float32)
    return mask, x, g, gate, rel_w, root, bias, ea, eb


def as_dtype(a, bf16):
    """a in the compute dtype, rounded through JAX's cast in bf16 so both
    packages see the same values; (JAX array, torch tensor)."""
    j = jnp.asarray(a).astype(jnp.bfloat16 if bf16 else jnp.float32)
    t = torch.from_numpy(np.array(j.astype(jnp.float32)))
    return j, t.to(torch.bfloat16) if bf16 else t


@functools.lru_cache(maxsize=None)
def square_case(bf16):
    """The square forms on `layer_inputs()`: the port's plain versions and
    JAX's Pallas kernels in interpret mode, each as flat fp32 numpy; and
    the port's inputs."""
    mask, *arrays = layer_inputs()
    nbar = mask.shape[0]
    (x, g, gate, rel_w, root, bias, ea, eb) = (as_dtype(a, bf16)
                                                for a in arrays)
    aux_j = gcl_pallas.build_kernel_aux(jnp.asarray(mask))
    dt = jnp.bfloat16 if bf16 else jnp.float32
    wbig_j = gcl_pallas.pack_weights(rel_w[0], root[0], T, dtype=dt)
    jax_out = {
        "fwd": gcl_pallas.gcl_apply_pallas(x[0], aux_j, gate[0], wbig_j,
                                           bias[0]),
        "eval": gcl_pallas.gcl_apply_pallas(x[0], aux_j, gate[0], wbig_j,
                                            bias[0],
                                            epilogue_affine=(ea[0], eb[0])),
        "fused": gcl_pallas_bwd.gcl_backward_fused(x[0], aux_j, gate[0],
                                                   wbig_j, g[0])}
    if not bf16:
        jax_out["split"] = gcl_pallas_bwd.gcl_backward_pallas(
            x[0], aux_j, gate[0], wbig_j, g[0])

    def flat(v):
        return np.asarray(jnp.asarray(v, jnp.float32)).reshape(nbar, T * S,
                                                               -1)

    want = {"fwd": flat(jax_out["fwd"]), "eval": flat(jax_out["eval"])}
    for name in ("fused", "split"):
        if name in jax_out:  # (dx, dgate, dwbig, dbias) -> port order
            dx, dg, dw, db = jax_out[name]
            want[name] = [flat(dx), *(np.asarray(v, np.float32)
                                      for v in (dg, db, dw))]
    aux = gcl.build_kernel_aux(torch.from_numpy(mask)).reshape(
        nbar, gcl.N_AUX, T * S)
    port = dict(x=x[1].reshape(nbar, T * S, D), g=g[1].reshape(
        nbar, T * S, D), aux=aux, gate=gate[1], rel_w=rel_w[1],
        root=root[1], bias=bias[1], ea=ea[1], eb=eb[1])
    return want, port


def port_forms(p, lo, hi):
    """The port's plain forms on output columns lo..hi-1 (all d of them:
    the square form): fwd, eval (K = 1), the fused backward and, in fp32,
    the data and weight backward, each as fp32 tensors."""
    c = slice(lo, hi)
    wbig = gcl.pack_weights(p["rel_w"][..., c], p["root"][:, c], T)
    g = p["g"][..., c].contiguous()
    out = {"fwd": gcl.gcl_fwd(p["x"], p["aux"], p["gate"], wbig,
                              p["bias"][c]),
           "eval": gcl.gcl_eval(p["x"], p["aux"], p["gate"], wbig[None],
                                *(p[k][c][None] for k in ("bias", "ea",
                                                          "eb")), col0=lo),
           "fused": gcl_bwd.gcl_bwd_fused(p["x"], g, p["aux"], p["gate"],
                                          wbig)}
    if p["x"].dtype == torch.float32:
        out["split"] = list(gcl_bwd.gcl_bwd_data(p["x"], g, p["aux"],
                                                 p["gate"], wbig)) + [
            gcl_bwd.gcl_bwd_weight(p["x"], g, p["aux"], p["gate"])]
    return {k: [t.float() for t in v] if isinstance(v, (list, tuple))
            else v.float() for k, v in out.items()}


def close(got, want, bf16, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    if bf16:
        scale = float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        assert err <= BF16_REL * scale, (what, err, scale)
    else:
        np.testing.assert_allclose(got, want, **tol, err_msg=what)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_column_forms_are_the_square_forms_shards(bf16, m):
    want, p = square_case(bf16)
    before = dict(gcl.col_launches)
    square = port_forms(p, 0, D)
    # the square form against the Pallas kernels (interpret mode)
    close(square["fwd"], want["fwd"], bf16, FWD_TOL, "fwd vs Pallas")
    close(square["eval"], want["eval"], bf16, FWD_TOL, "eval vs Pallas")
    for name in ("fused", "split"):
        for o, a, b in zip(("dx", "dgate", "dbias", "dwbig"), square.get(
                name, ()), want.get(name, ())):
            close(a, b, bf16, BWD_TOL, f"{name} {o} vs Pallas")
    n = D // m
    sums = {}
    for r in range(m):
        lo, hi = r * n, (r + 1) * n
        shard = port_forms(p, lo, hi)
        for name in ("fwd", "eval"):
            assert shard[name].shape == square[name].shape[:-1] + (n,)
            close(shard[name], square[name][..., lo:hi], bf16, COL_TOL,
                  f"{name} shard {r}")
        for name, (dx, dgate, dbias, dwbig) in (
                (k, shard[k]) for k in ("fused", "split") if k in shard):
            sq = square[name]
            assert dx.shape == sq[0].shape and dgate.shape == sq[1].shape
            close(dbias, sq[2][lo:hi], bf16, COL_TOL, f"{name} dbias {r}")
            close(dwbig, sq[3][:, lo:hi], bf16, COL_TOL, f"{name} dW {r}")
            part = sums.setdefault(name, [0.0, 0.0])
            part[0], part[1] = part[0] + dx, part[1] + dgate
    for name, (dx, dgate) in sums.items():
        for o, a, b in (("dx", dx, square[name][0]),
                        ("dgate", dgate, square[name][1])):
            scale = float(b.abs().max())
            err = float((a - b).abs().max())
            assert err <= (BF16_REL if bf16 else SUM_REL) * scale, (
                f"{name} {o} summed over {m} shards", err, scale)
    assert gcl.col_launches == before  # the CPU takes the plain path


def test_column_forms_refuse_a_chain_and_a_shard_past_the_width():
    _, p = square_case(False)
    w = gcl.pack_weights(p["rel_w"][..., :16], p["root"][:, :16], T)
    bias = p["bias"][:16]
    with pytest.raises(ValueError, match="at K = 1 only, got K = 2"):
        gcl.gcl_eval(p["x"], p["aux"], p["gate"], torch.stack([w, w]),
                     *(torch.stack([bias, bias]),) * 3)
    with pytest.raises(ValueError, match="first column 24"):
        gcl.gcl_eval(p["x"], p["aux"], p["gate"], w[None],
                     *(bias[None],) * 3, col0=24)


# ---------------------------------------------------- (b) the train step
def mesh_step(tmp_path, nproc, model, pcfg, toks, mask, eps, seed=None):
    """(losses, accs, the model after the step with its gathered grads,
    eval losses, rank 0's report) of a `TrainStep` over `nproc` ranks at
    pcfg's model axis, then an `eval_step` on the same rows; every rank
    reports the same global losses, metrics, grads and state."""
    torch.save({"cfg": train_config_to_dict(pcfg),
                "state": model.state_dict(),
                "tokens": torch.from_numpy(toks),
                "mask": torch.from_numpy(mask),
                "eps": torch.from_numpy(eps), "seed": seed, "eval": True},
               tmp_path / "in.pt")
    run_ok(nproc, "step", tmp_path / "in.pt", tmp_path)
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(nproc)]
    for k in ("losses", "accs", "state", "grads"):
        for name, v in ranks[0][k].items():
            for r in ranks[1:]:
                torch.testing.assert_close(r[k][name], v, rtol=0, atol=0,
                                           msg=f"{k}/{name}")
    for r in ranks[1:]:
        assert r["eval"][0] == ranks[0]["eval"][0]
    after = VAE(pcfg.model)
    after.load_state_dict(ranks[0]["state"])
    for name, p in after.named_parameters():
        p.grad = ranks[0]["grads"][name]
    return (ranks[0]["losses"], ranks[0]["accs"], after,
            ranks[0]["eval"][0], ranks[0])


def check_shards(report, model, m):
    """Every sharded parameter and both its Adam moments held as 1 / M of
    the whole along its dimension; every other parameter whole."""
    sharded = 0
    for name, p in model.named_parameters():
        want = list(p.shape)
        dim = pmesh.shard_dim(name)
        if dim is not None:
            want[dim] //= m
            sharded += 1
        assert list(report["shapes"][name]) == want, name
        assert [list(s) for s in report["moment_shapes"][name]] == \
            [want, want], name
    # rel_weight and root of each layer of the 2 GCNs; the chord
    # encoder's kernel, the chord decoder's kernel and bias, the 2 bars
    # encoders' weights, the 2 bars decoders' weights and biases
    assert sharded == 2 * 2 * model.cfg.gnn_n_layers + 1 + 2 + 2 + 4


def one_process_step(model, pcfg, toks, mask, eps, seed=None):
    """The port's one-process step (and eval step) in the form
    `check_against_jax` takes, and the eval losses."""
    gen = torch.Generator().manual_seed(seed) if seed is not None else None
    model.set_dropout_generator(gen)
    pcfg = dataclasses.replace(pcfg, parallel=pconfig.ParallelConfig())
    step = ptrainer.make_train_step(model, pcfg,
                                    ptrainer.make_optimizer(model, pcfg))
    batch = (torch.from_numpy(toks), torch.from_numpy(mask))
    one = step(*batch, eps=torch.from_numpy(eps), generator=gen)
    ev, _ = ptrainer.eval_step(model, pcfg, *batch, step.updates,
                               eps=torch.from_numpy(eps))
    return as_jax_step(model, pcfg, *one), ev


def check_eval(got, want):
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=2e-4,
                                   atol=2e-4, err_msg=f"eval {k}")


STEP_ACCUM, STEP_SEED = 2, 0


@functools.lru_cache(maxsize=None)
def jax_sharded_step():
    """(batch, eps, JAX's step) of the step cases: `jax_reference_step` on
    `make_mesh(2)` over the 8 CPU devices that conftest fakes (data 4 x
    model 2), as tests/test_train.py runs JAX's sharded step; one compile
    serves both cases."""
    mcfg = small_cfg(n_layers=2)
    cfg = TrainConfig(batch_size=MB * STEP_ACCUM, model=mcfg,
                      iters_to_accumulate=STEP_ACCUM,
                      parallel=ParallelConfig(model_axis=2))
    variables, jmodel, _ = build(mcfg, seed=STEP_SEED)
    toks, mask = synthetic_batch(np.random.default_rng(STEP_SEED + 1),
                                 MB * STEP_ACCUM, mcfg.n_bars)
    rng = jax.random.key(STEP_SEED + 7)
    eps = jax_eps(jmodel, jax_tree(variables["params"]),
                  microbatch_rngs(rng, STEP_ACCUM), mcfg.d)
    mesh = jmesh.make_mesh(2)
    assert dict(mesh.shape) == {"data": 4, "model": 2}
    return toks, mask, eps, jax_reference_step(jmodel, cfg, variables, toks,
                                               mask, rng, mesh=mesh)


@pytest.mark.parametrize("data,model_axis", [(1, 2), (2, 2)],
                         ids=["M2", "D2xM2"])
def test_sharded_step_matches_jax_and_one_process(tmp_path, data,
                                                  model_axis):
    accum, mcfg = STEP_ACCUM, small_cfg(n_layers=2)
    nproc = data * model_axis
    toks, mask, eps, want = jax_sharded_step()
    _, _, model = build(mcfg, seed=STEP_SEED)
    pcfg = pconfig.TrainConfig(
        batch_size=MB * accum, model=port_cfg(mcfg),
        iters_to_accumulate=accum,
        parallel=pconfig.ParallelConfig(model_axis=model_axis))
    slack = near_tie_slack(model, pcfg, toks, mask, eps)
    losses, accs, after, ev, report = mesh_step(tmp_path, nproc, model,
                                                pcfg, toks, mask, eps)
    check_shards(report, model, model_axis)
    check_against_jax(want, losses, accs, after, slack)
    one, one_ev = one_process_step(model, pcfg, toks, mask, eps)
    check_against_jax(one, losses, accs, after, slack)
    check_eval(ev, one_ev)


# ------------------------------------- (c) bf16, message dropout, the CLI
def test_bf16_sharded_step_is_the_one_process_step(tmp_path):
    mc = port_cfg(small_cfg(n_layers=2))
    pcfg = pconfig.TrainConfig(batch_size=8, model=mc, iters_to_accumulate=2,
                               bf16=True,
                               parallel=pconfig.ParallelConfig(model_axis=2))
    torch.manual_seed(0)
    model = VAE(mc)
    toks, mask = synthetic_batch(np.random.default_rng(0), 8, mc.n_bars)
    eps = np.random.default_rng(1).standard_normal((8, mc.d)).astype(
        np.float32)
    losses, _, after, ev, report = mesh_step(tmp_path, 2, model, pcfg, toks,
                                             mask, eps)
    check_shards(report, model, 2)
    assert all(p.dtype == torch.float32 for p in after.parameters())
    (one, *_), one_ev = one_process_step(model, pcfg, toks, mask, eps)
    for got, want in ((losses, one), (ev, one_ev)):
        for k, v in want.items():
            assert abs(float(got[k]) - float(v)) <= BF16_LOSS_RTOL * max(
                abs(float(v)), 1e-6), (k, float(got[k]), float(v))


def test_message_dropout_sharded_step_is_the_one_process_step(tmp_path):
    """Dropout 0.1 and per-edge message dropout: the M ranks draw alike,
    and the lattice GCL computes the rank's columns."""
    mc = dataclasses.replace(port_cfg(small_cfg(n_layers=2)), dropout=0.1,
                             message_dropout=0.1,
                             message_dropout_mode="edge")
    pcfg = pconfig.TrainConfig(batch_size=8, model=mc, iters_to_accumulate=2,
                               parallel=pconfig.ParallelConfig(model_axis=2))
    torch.manual_seed(0)
    model = VAE(mc)
    toks, mask = synthetic_batch(np.random.default_rng(0), 8, mc.n_bars)
    eps = np.random.default_rng(1).standard_normal((8, mc.d)).astype(
        np.float32)
    slack = near_tie_slack(model, pcfg, toks, mask, eps)
    losses, accs, after, ev, _ = mesh_step(tmp_path, 2, model, pcfg, toks,
                                           mask, eps, seed=5)
    one, one_ev = one_process_step(model, pcfg, toks, mask, eps, seed=5)
    check_against_jax(one, losses, accs, after, slack)
    check_eval(ev, one_ev)


CLI_STEPS = 3  # a step an epoch: 24 training samples at batch 8


def cli_argv(data, out, cfg_path, *extra):
    return [str(data), str(out), str(cfg_path), "--model_name", "m",
            "--device", "cpu", "--num_workers", "2", "--tr_split", "0.75",
            "--max_epochs", "1", "--save_every", "0", "--seed", "3", *extra]


def train_records(model_dir):
    rows = [json.loads(line) for line in
            (model_dir / "metrics.jsonl").read_text().splitlines()]
    return [r for r in rows if "loss/tot" in r]


def test_cli_resumes_a_one_process_run_at_model_axis_2(tmp_path):
    """One process trains an epoch; its model directory, copied, resumes
    under `torchrun` at M = 2 and, in place, in one process: the two
    continuations' losses agree, and the sharded run's checkpoint (one
    process's layout) loads into a one-process Trainer and serves the
    one-process continuation's pieces."""
    make_dataset(tmp_path / "data", 32, seed=2)
    base = pconfig.TrainConfig(
        batch_size=8, iters_to_accumulate=2,
        model=dataclasses.replace(port_cfg(small_cfg(n_layers=2)),
                                  dropout=0.1),
        optimizer=pconfig.OptimizerConfig(eps=1e-6))
    paths = {}
    for name, m in (("one", 1), ("tp", 2)):
        paths[name] = tmp_path / f"{name}.json"
        paths[name].write_text(json.dumps(train_config_to_dict(
            dataclasses.replace(base,
                                parallel=pconfig.ParallelConfig(
                                    model_axis=m)))))
    one_dir = tmp_path / "one" / "m"
    train_cli.main(cli_argv(tmp_path / "data", tmp_path / "one",
                            paths["one"]))
    shutil.copytree(tmp_path / "one", tmp_path / "tp")
    # the sharded continuation (rank 0 writes the copied directory)
    out = run_ok(2, "cli", tmp_path, *cli_argv(
        tmp_path / "data", tmp_path / "tp", paths["tp"], "--resume"))
    assert "Devices: 2 mesh={'data': 1, 'model': 2}" in out.stdout
    for r in (0, 1):
        launches = json.loads(out.stdout.split(
            f"Kernel launches (rank {r}): ")[1].splitlines()[0])
        assert set(launches) >= {f"{k}_cols" for k in gcl.COL_KERNELS}
    # and the one-process continuation
    trainer = train_cli.main(cli_argv(tmp_path / "data", tmp_path / "one",
                                      paths["one"], "--resume"))
    assert trainer.step == 2 * CLI_STEPS
    one, tp = (train_records(d) for d in (one_dir, tmp_path / "tp" / "m"))
    assert [r["batch"] for r in one] == [r["batch"] for r in tp] \
        == list(range(2 * CLI_STEPS))
    assert all(r.get("mesh") == {"data": 1, "model": 2}
               for r in tp[CLI_STEPS:])
    for k in LOSSES:
        np.testing.assert_allclose([r[f"loss/{k}"] for r in tp],
                                   [r[f"loss/{k}"] for r in one],
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    ck = {name: torch.load(d / "checkpoint.pt", weights_only=True)
          for name, d in (("one", one_dir), ("tp", tmp_path / "tp" / "m"))}
    assert ck["tp"]["step"] == ck["one"]["step"] == 2 * CLI_STEPS
    for name, v in ck["one"]["model"].items():
        torch.testing.assert_close(ck["tp"]["model"][name], v, rtol=1e-4,
                                   atol=1e-4, msg=name)
    for i, st in ck["one"]["optimizer"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(ck["tp"]["optimizer"]["state"][i][k],
                                       st[k], rtol=1e-3, atol=1e-6)
    resumed = ptrainer.Trainer(str(tmp_path / "tp" / "m"), VAE(base.model),
                               base, device="cpu")
    resumed.resume()
    assert resumed.step == 2 * CLI_STEPS
    for name, p in resumed.model.state_dict().items():
        torch.testing.assert_close(p, ck["tp"]["model"][name], rtol=0,
                                   atol=0, msg=name)
    pieces = {}
    for name, d in (("one", one_dir), ("tp", tmp_path / "tp" / "m")):
        svc = GenerationService(str(d), batch_cap=2, coalesce=False,
                                device="cpu")
        pieces[name] = svc.generate(2, seed=4)
    for a, b in zip(pieces["tp"], pieces["one"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
