"""Tensor parallelism above 48 steps a bar (`parallel.model_axis` M > 1 at
`resolution` 13 and up; 24, the Lakh Pianoroll Dataset's grid, is S = 96)
on the CPU, with the helpers of tests/test_torch_tensor_parallel.py:

  (a) the GCL kernels' column forms at S = 52 and 96, through their plain
      versions (d = 32, 3 bars, fp32 and bf16, n = d / 2 and d / 4): each
      shard of `gcl_fwd`, `gcl_eval` (K = 1, first column c0),
      `gcl_bwd_weight` and of dbias of `gcl_bwd_data` is the square form's
      columns (fp32: rtol = atol = 1e-5; bf16: 2e-2 x max |square|), the
      partial dx and dgate summed over the shards are the square form's
      (fp32: 1e-5 x max |square|; bf16: 2e-2). The backward is the split
      pair in both dtypes, as training runs it above 48 steps. The square
      form is held to JAX's Pallas kernels in interpret mode on the same
      numpy inputs (fp32: forward 2e-4, backward 5e-4; bf16: 2e-2 x max
      |JAX|);
  (b) one fp32 `TrainStep` (d = 32, 2 layers, batch 8, accumulate 2) at
      resolution 13 and M = 2 over 2 gloo ranks, against JAX's step on
      `make_mesh(2)` with `param_sharding` at the same resolution and
      against the port's one-process step, by the rules of
      tests/test_torch_train_step.py (losses and metrics 2e-4; every
      gathered grad, the new params and the batch-norm statistics 5e-4);
      the eval step (the column-form eval stack) gives one process's
      losses (2e-4);
  (c) the bf16 step at M = 2 and resolution 13 against the one-process
      bf16 step: losses and eval losses within 3e-2 relative. The weights
      have `linear_merge`'s output centred on the batch first
      (`chip_smoke.centre_merge_input`, as chip_smoke's bf16 comparisons):
      uncentred, bf16's E[x^2] - mean^2 leaves some merge features'
      batch variance unresolved, and the KLD then follows each run's
      rounding (uncentred at this seed, M = 2 and one process give KLDs
      of 49.1 and 42.7 at resolution 8 as well, every other loss within
      0.2 %).

The card's kernels in these forms are held to the same plain versions in
tests/test_torch_cuda.py::test_long_column_forms_match_plain and
chip_smoke's phase 10b.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from polyphemus_tpu.config import ParallelConfig, TrainConfig
from polyphemus_tpu.data.dataset import synthetic_batch
from polyphemus_tpu.ops.kernels import gcl_pallas, gcl_pallas_bwd
from polyphemus_tpu.parallel import mesh as jmesh
from polyphemus_tpu_torch import config as pconfig
from polyphemus_tpu_torch.models import VAE
from polyphemus_tpu_torch.ops.kernels import gcl, gcl_bwd

from .test_torch_tensor_parallel import (BF16_LOSS_RTOL, BWD_TOL, COL_TOL,
                                         FWD_TOL, as_dtype, check_eval,
                                         check_shards, close, mesh_step,
                                         one_process_step)
from .test_torch_tensor_parallel import BF16_REL, SUM_REL
from .test_torch_train_step import (MB, check_against_jax, jax_eps, jax_init,
                                    jax_reference_step, microbatch_rngs,
                                    near_tie_slack)
from .torch_port_case import jax_tree, port_cfg, small_cfg

T, D, NBAR = 4, 32, 3
STEPS = [52, 96]        # resolutions 13 and 24
RESOLUTION = 13


# ------------------------------------------------- (a) the column forms
def layer_inputs(s, seed):
    """numpy mask, x, upstream g, gate table, weights, bias and eval affine
    of one layer over NBAR bars of 4 x s cells: an empty bar, a single
    node off track 0, and a bar at density 0.3."""
    rng = np.random.default_rng(seed)
    mask = rng.random((NBAR, T, s)) < 0.3
    mask[0] = False
    mask[1] = False
    mask[1, 2, s // 2 + 1] = True
    x = rng.standard_normal((NBAR, T, s, D)).astype(np.float32) \
        * mask[..., None]
    g = rng.standard_normal((NBAR, T, s, D)).astype(np.float32)
    gate = (rng.standard_normal((s, D)) * 0.5).astype(np.float32)
    rel_w = (rng.standard_normal((6, D, D)) * D ** -0.5).astype(np.float32)
    root = (rng.standard_normal((D, D)) * D ** -0.5).astype(np.float32)
    bias, eb = ((rng.standard_normal(D) * 0.2).astype(np.float32)
                for _ in range(2))
    ea = (1.0 + 0.2 * rng.standard_normal(D)).astype(np.float32)
    return mask, x, g, gate, rel_w, root, bias, ea, eb


@functools.lru_cache(maxsize=None)
def square_case(bf16, s):
    """JAX's Pallas forward, eval layer and split backward (interpret
    mode) on `layer_inputs(s)`, each as flat fp32 numpy; and the port's
    inputs."""
    mask, *arrays = layer_inputs(s, seed=s + bf16)
    (x, g, gate, rel_w, root, bias, ea, eb) = (as_dtype(a, bf16)
                                                for a in arrays)
    aux_j = gcl_pallas.build_kernel_aux(jnp.asarray(mask))
    dt = jnp.bfloat16 if bf16 else jnp.float32
    wbig_j = gcl_pallas.pack_weights(rel_w[0], root[0], T, dtype=dt)

    def flat(v):
        return np.asarray(jnp.asarray(v, jnp.float32)).reshape(NBAR, T * s,
                                                               -1)

    want = {"fwd": flat(gcl_pallas.gcl_apply_pallas(
        x[0], aux_j, gate[0], wbig_j, bias[0])),
        "eval": flat(gcl_pallas.gcl_apply_pallas(
            x[0], aux_j, gate[0], wbig_j, bias[0],
            epilogue_affine=(ea[0], eb[0])))}
    dx, dg, dw, db = gcl_pallas_bwd.gcl_backward_pallas(
        x[0], aux_j, gate[0], wbig_j, g[0])
    want["split"] = [flat(dx), *(np.asarray(jnp.asarray(v, jnp.float32))
                                 for v in (dg, db, dw))]
    aux = gcl.build_kernel_aux(torch.from_numpy(mask)).reshape(
        NBAR, gcl.N_AUX, T * s)
    port = dict(x=x[1].reshape(NBAR, T * s, D), g=g[1].reshape(
        NBAR, T * s, D), aux=aux, gate=gate[1], rel_w=rel_w[1],
        root=root[1], bias=bias[1], ea=ea[1], eb=eb[1])
    return want, port


def port_forms(p, lo, hi):
    """The port's plain forms on output columns lo..hi-1 (all d of them:
    the square form): fwd, eval (K = 1, first column lo) and the split
    backward (dx, dgate, dbias, dWbig), each as fp32 tensors."""
    c = slice(lo, hi)
    wbig = gcl.pack_weights(p["rel_w"][..., c], p["root"][:, c], T)
    g = p["g"][..., c].contiguous()
    out = {"fwd": gcl.gcl_fwd(p["x"], p["aux"], p["gate"], wbig,
                              p["bias"][c]),
           "eval": gcl.gcl_eval(p["x"], p["aux"], p["gate"], wbig[None],
                                *(p[k][c][None] for k in ("bias", "ea",
                                                          "eb")), col0=lo),
           "split": list(gcl_bwd.gcl_bwd_data(p["x"], g, p["aux"],
                                              p["gate"], wbig)) + [
               gcl_bwd.gcl_bwd_weight(p["x"], g, p["aux"], p["gate"])]}
    return {k: [t.float() for t in v] if isinstance(v, list) else v.float()
            for k, v in out.items()}


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("s", STEPS)
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_long_column_forms_are_the_square_forms_shards(bf16, s, m):
    want, p = square_case(bf16, s)
    before = dict(gcl.col_launches)
    square = port_forms(p, 0, D)
    close(square["fwd"], want["fwd"], bf16, FWD_TOL, "fwd vs Pallas")
    close(square["eval"], want["eval"], bf16, FWD_TOL, "eval vs Pallas")
    for o, a, b in zip(("dx", "dgate", "dbias", "dwbig"), square["split"],
                       want["split"]):
        close(a, b, bf16, BWD_TOL, f"split {o} vs Pallas")
    n = D // m
    dx_sum, dgate_sum = 0.0, 0.0
    for r in range(m):
        lo, hi = r * n, (r + 1) * n
        shard = port_forms(p, lo, hi)
        for name in ("fwd", "eval"):
            assert shard[name].shape == (NBAR, T * s, n)
            close(shard[name], square[name][..., lo:hi], bf16, COL_TOL,
                  f"{name} shard {r}")
        dx, dgate, dbias, dwbig = shard["split"]
        sq = square["split"]
        assert dx.shape == sq[0].shape and dgate.shape == (s, D)
        assert dbias.shape == (n,) and dwbig.shape == (8 * D, n)
        close(dbias, sq[2][lo:hi], bf16, COL_TOL, f"dbias shard {r}")
        close(dwbig, sq[3][:, lo:hi], bf16, COL_TOL, f"dW shard {r}")
        dx_sum, dgate_sum = dx_sum + dx, dgate_sum + dgate
    for o, a, b in (("dx", dx_sum, square["split"][0]),
                    ("dgate", dgate_sum, square["split"][1])):
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        assert err <= (BF16_REL if bf16 else SUM_REL) * scale, (
            f"{o} summed over {m} shards", err, scale)
    assert gcl.col_launches == before  # the CPU takes the plain path


# ---------------------------------------------------- (b) the train step
ACCUM, SEED = 2, 0


def long_case():
    """(JAX config, numpy variables, JAX model, port model, batch, eps, rng)
    of the fp32 step at RESOLUTION: weights from JAX's `model.init` at the
    grid (`jax_init`)."""
    mcfg = dataclasses.replace(small_cfg(n_layers=2), resolution=RESOLUTION)
    cfg = TrainConfig(batch_size=MB * ACCUM, model=mcfg,
                      iters_to_accumulate=ACCUM,
                      parallel=ParallelConfig(model_axis=2))
    variables, jmodel, model = jax_init(mcfg, SEED)
    toks, mask = synthetic_batch(np.random.default_rng(SEED + 1),
                                 MB * ACCUM, mcfg.n_bars,
                                 n_timesteps=mcfg.n_timesteps)
    assert mask.shape[-1] == 4 * RESOLUTION
    rng = jax.random.key(SEED + 7)
    eps = jax_eps(jmodel, jax_tree(variables["params"]),
                  microbatch_rngs(rng, ACCUM), mcfg.d)
    return cfg, variables, jmodel, model, toks, mask, eps, rng


def test_long_sharded_step_matches_jax_and_one_process(tmp_path):
    """M = 2 over 2 ranks at resolution 13: JAX's step on `make_mesh(2)`
    over the 8 faked CPU devices (data 4 x model 2) with `param_sharding`,
    and the port's one-process step."""
    cfg, variables, jmodel, model, toks, mask, eps, rng = long_case()
    mesh = jmesh.make_mesh(2)
    assert dict(mesh.shape) == {"data": 4, "model": 2}
    want = jax_reference_step(jmodel, cfg, variables, toks, mask, rng,
                              mesh=mesh)
    pcfg = pconfig.TrainConfig(
        batch_size=MB * ACCUM, model=port_cfg(cfg.model),
        iters_to_accumulate=ACCUM,
        parallel=pconfig.ParallelConfig(model_axis=2))
    slack = near_tie_slack(model, pcfg, toks, mask, eps)
    losses, accs, after, ev, report = mesh_step(tmp_path, 2, model, pcfg,
                                                toks, mask, eps)
    check_shards(report, model, 2)
    check_against_jax(want, losses, accs, after, slack)
    one, one_ev = one_process_step(model, pcfg, toks, mask, eps)
    check_against_jax(one, losses, accs, after, slack)
    check_eval(ev, one_ev)


# ------------------------------------------------------------ (c) bf16
def test_long_bf16_sharded_step_is_the_one_process_step(tmp_path):
    mc = dataclasses.replace(port_cfg(small_cfg(n_layers=2)),
                             resolution=RESOLUTION)
    pcfg = pconfig.TrainConfig(batch_size=8, model=mc, iters_to_accumulate=2,
                               bf16=True,
                               parallel=pconfig.ParallelConfig(model_axis=2))
    torch.manual_seed(RESOLUTION)
    model = VAE(mc)
    toks, mask = synthetic_batch(np.random.default_rng(RESOLUTION), 8,
                                 mc.n_bars, n_timesteps=mc.n_timesteps)
    eps = np.random.default_rng(RESOLUTION + 1).standard_normal(
        (8, mc.d)).astype(np.float32)
    chip_smoke.centre_merge_input(model, mc, *(torch.from_numpy(a) for a in
                                               (toks, mask, eps)))
    losses, _, after, ev, report = mesh_step(tmp_path, 2, model, pcfg, toks,
                                             mask, eps)
    check_shards(report, model, 2)
    assert all(p.dtype == torch.float32 for p in after.parameters())
    (one, *_), one_ev = one_process_step(model, pcfg, toks, mask, eps)
    for got, want in ((losses, one), (ev, one_ev)):
        for k, v in want.items():
            assert abs(float(got[k]) - float(v)) <= BF16_LOSS_RTOL * max(
                abs(float(v)), 1e-6), (k, float(got[k]), float(v))
