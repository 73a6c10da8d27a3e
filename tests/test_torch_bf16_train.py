"""The port's train and eval steps under the bf16 compute policy against the
JAX package's (`TrainConfig.bf16`), on the same weights (through
`convert.py`), batch (`synthetic_batch`) and reparameterisation noise (d =
32, 2 GNN layers, microbatches of 32 samples, dropout 0).

The weights are the seeded random ones with `linear_merge`'s bias shifted
by minus its output's batch mean (`chip_smoke.centre_merge_input`). That
leaves a training step's function unchanged (`bn_linear_merge` subtracts
the batch mean again) but not bf16's rounding: at random init its features
vary over the batch by a few percent of their mean, bf16's E[x^2] - mean^2
keeps few bits of that variance, and the KLD and every grad upstream of
the norm follow each framework's rounding (at seed 5, accumulate 2, JAX's
own bf16 KLD ran to 7e16 against 14.3 in fp32).

One train step, at accumulate 1 and 2:

  * the 7 losses within 3e-2 relative and the 9 metrics within 0.05;
  * grads, for every tensor whose exact (fp32) max is at least 1e-3 of the
    largest (a tensor under that floor has a true grad of about 0, a bias
    that feeds a batch-norm, and carries bf16 noise only):
      - where JAX's bf16 grad resolves the tensor (its max abs distance
        from the exact grad within 2 % of the exact max), the port's is
        within 0.1 x max |JAX grad| of it; at least 3 tensors are so held;
      - every tensor's port bf16 grad points the exact grad's way (cosine
        >= 0.85), and over the tensors the port's bf16 grads are no further
        from the exact ones than JAX's (median of max abs distance / exact
        max);
  * params after the Adam update within 2e-2 x max |JAX|, and batch-norm
    running statistics within 2e-2 x their norm's scale in JAX's result,
    max E[x^2] = var + mean^2 over its features for a variance and its
    square root for a mean, all of them fp32 (bf16's E[x^2] - mean^2 errs
    by a share of E[x^2], not of the variance, and a mean by a share of
    its feature's spread, not of its own size);
  * the port's first bf16 loss within 5 % of its fp32 loss (the bound of
    tests/test_bf16_train.py).

Why the grads are held so: JAX's bf16 grads on the CPU differ from the
exact ones by 15-22 % of their max at the median tensor (its cotangent
reductions round partial sums to bf16: its grad of the structure decoder's
last conv bias is a fifth of the exact one), the port's, whose reductions
sum in fp32, by 7-12 %. So a 10 % bound against JAX's bf16 grad holds only
where JAX's own is close to exact; elsewhere the exact grad is the
reference. The exact grads are the port's fp32 step's on the same noise,
which tests/test_torch_train_step.py holds to JAX's fp32 step.

The eval step (running statistics, the `gcl_eval` path) is held to JAX's
eval under the policy with the same loss and metric bounds, with the JAX
GCN on its XLA lattice path and, in the slow case, on `gcl_apply_pallas`
with its eval epilogue (interpret mode).

The JAX side is tests/test_torch_train_step.py's `jax_reference_step`
(`make_train_step`'s computation in the open) with `_forward_loss` under
the policy; the slow train case takes the Pallas GCL (interpret mode) with
its custom VJP. The noise is what `VAE.train_stats` draws under the policy:
bf16 normals from each microbatch's `sample` rng."""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyphemus_tpu.config import TrainConfig
from polyphemus_tpu.data.dataset import synthetic_batch
from polyphemus_tpu.train import schedules as jsched
from polyphemus_tpu.train.trainer import _forward_loss
import chip_smoke
from polyphemus_tpu_torch import config as pconfig
from polyphemus_tpu_torch.convert import to_jax_variables
from polyphemus_tpu_torch.ops.kernels import counts
from polyphemus_tpu_torch.train import trainer as ptrainer

from .test_torch_train_step import flatten, jax_init, jax_reference_step, \
    microbatch_rngs
from .torch_port_case import build, jax_tree, port_cfg, small_cfg

MB = 32             # microbatch size
SEED = 0
LOSS_RTOL = 3e-2
METRIC_ATOL = 0.05
GRAD_FLOOR = 1e-3   # grads matter whose exact max is at least this share
GRAD_REL = 0.1      # port vs JAX bf16: max abs err / max |JAX grad|
RESOLVED = 0.02     # JAX's bf16 grad resolves a tensor within this share
MIN_RESOLVED = 3
GRAD_COS = 0.85     # least cosine of a port bf16 grad with the exact grad
PARAMS_REL = 2e-2   # params after the update: max abs err / max |JAX|
STATS_REL = 2e-2    # running statistics: max abs err / their norm's scale


def jax_eps_bf16(jmodel, params, rngs, d):
    """The bf16 noise `VAE.train_stats` draws under the policy (mu is bf16)
    from each `sample` rng, MB rows each, as fp32 numpy (exact)."""
    def draw(module):
        return jax.random.normal(module.make_rng("sample"), (MB, d),
                                 jnp.bfloat16)

    return np.concatenate([np.asarray(jmodel.apply(
        {"params": params}, method=draw, rngs={"sample": r}).astype(
            jnp.float32)) for r in rngs])


def random_vectors(model, seed):
    """Every bias, batch-norm scale and running statistic of the port model
    drawn as `build`'s reference-layout random weights draw them
    (`tests/torch_ref.py`: biases and batch-norm shifts 0.1 N(0, 1), scales
    1 + 0.1 N(0, 1), running means 0.1 N(0, 1), variances |1 + 0.1 N(0,
    1)|). JAX's `model.init` (`jax_init`: the weights at a grid that
    `build`'s converters do not take) sets them to 0 and 1, and a parameter
    at 0 moves by +-lr in Adam's first step whichever way its grad points:
    where bf16 rounding turns the sign of a grad near 0, the params rule
    (2e-2 x max |JAX|) would compare the signs of that noise."""
    g = torch.Generator().manual_seed(seed)

    def draw(v, base, scale):
        return base + scale * torch.randn(v.shape, generator=g)

    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim == 1:
                p.copy_(draw(p, 1.0, 0.1) if name.endswith("weight")
                        else draw(p, 0.0, 0.1))
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(draw(b, 0.0, 0.1))
            elif name.endswith("running_var"):
                b.copy_(draw(b, 1.0, 0.1).abs())


def setup(accum, use_pallas=False, resolution=8, seed=SEED):
    """The case at `resolution` (4 x 4r cells a bar) from `seed`: weights by
    `build` at 8; at another grid from JAX's `model.init` (`jax_init`), its
    vectors drawn as `build` draws them (`random_vectors`)."""
    mcfg = dataclasses.replace(small_cfg(n_layers=2),
                               use_pallas_gcl=use_pallas,
                               resolution=resolution)
    cfg = TrainConfig(batch_size=MB * accum, model=mcfg,
                      iters_to_accumulate=accum, bf16=True)
    if resolution == 8:
        variables, jmodel, model = build(mcfg, seed=seed)
    else:
        variables, jmodel, model = jax_init(mcfg, seed)
        random_vectors(model, seed)
    toks, mask = synthetic_batch(np.random.default_rng(seed + 1),
                                 MB * accum, mcfg.n_bars,
                                 n_timesteps=mcfg.n_timesteps)
    rng = jax.random.key(seed + 7)
    eps = jax_eps_bf16(jmodel, jax_tree(variables["params"]),
                       microbatch_rngs(rng, accum), mcfg.d)
    pcfg = pconfig.TrainConfig(batch_size=MB * accum, model=port_cfg(mcfg),
                               iters_to_accumulate=accum, bf16=True)
    chip_smoke.centre_merge_input(model, pcfg.model,
                                  *(torch.from_numpy(a[:MB])
                                    for a in (toks, mask, eps)))
    variables = to_jax_variables(model.state_dict())
    return cfg, pcfg, variables, jmodel, model, toks, mask, rng, eps


def run_case(accum, use_pallas=False, resolution=8, seed=SEED):
    """(JAX's bf16 step, the port's bf16 and fp32 (losses, accs, model))
    from the same weights, batch and noise."""
    cfg, pcfg, variables, jmodel, model, toks, mask, rng, eps = setup(
        accum, use_pallas, resolution, seed)
    want = jax_reference_step(jmodel, cfg, variables, toks, mask, rng,
                              mb=MB)
    fp32_model = copy.deepcopy(model)
    out = {}
    for name, m, c in (("bf16", model, pcfg),
                       ("fp32", fp32_model,
                        dataclasses.replace(pcfg, bf16=False))):
        step = ptrainer.make_train_step(m, c, ptrainer.make_optimizer(m, c))
        losses, accs = step(torch.from_numpy(toks), torch.from_numpy(mask),
                            eps=torch.from_numpy(eps))
        assert step.updates == 1
        out[name] = (losses, accs, m)
    return want, out["bf16"], out["fp32"]


def port_grads(model):
    return flatten(to_jax_variables(
        {n: p.grad for n, p in model.named_parameters()})["params"])


def cosine(a, b):
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    den = float(np.linalg.norm(a) * np.linalg.norm(b))
    return float(a @ b) / den if den > 0 else 0.0


def check_losses(lo, ac, losses, accs):
    assert set(losses) == set(lo) and set(accs) == set(ac)
    for k in lo:
        np.testing.assert_allclose(float(losses[k]), lo[k], rtol=LOSS_RTOL,
                                   atol=1e-6, err_msg=k)
    for k in ac:
        np.testing.assert_allclose(float(accs[k]), ac[k], rtol=0,
                                   atol=METRIC_ATOL, err_msg=k)


def check_grads(grads, p_grads, exact):
    assert set(p_grads) == set(grads) == set(exact)
    largest = max(float(np.abs(v).max()) for v in exact.values())
    resolved, port_off, jax_off = 0, [], []
    for k, ref in grads.items():
        top = float(np.abs(exact[k]).max())
        if top < GRAD_FLOOR * largest:
            continue
        jax_err = float(np.abs(ref - exact[k]).max())
        if jax_err <= RESOLVED * top:
            err = float(np.abs(p_grads[k] - ref).max())
            assert err <= GRAD_REL * float(np.abs(ref).max()), (k, err)
            resolved += 1
        cos = cosine(p_grads[k], exact[k])
        assert cos >= GRAD_COS, (k, cos)
        port_off.append(float(np.abs(p_grads[k] - exact[k]).max()) / top)
        jax_off.append(jax_err / top)
    assert resolved >= MIN_RESOLVED, resolved
    assert len(port_off) >= len(grads) // 2
    assert np.median(port_off) <= np.median(jax_off), (
        np.median(port_off), np.median(jax_off))


def check_state(model, new_params, new_stats):
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in model.parameters())
    assert all(b.dtype == torch.float32 for b in model.buffers()
               if b.is_floating_point())
    tree = to_jax_variables(model.state_dict())
    got = flatten(tree["params"])
    assert set(got) == set(new_params)
    for k, ref in new_params.items():
        err = float(np.abs(got[k] - ref).max())
        assert err <= PARAMS_REL * float(np.abs(ref).max()), (k, err)
    got = flatten(tree["batch_stats"])
    assert set(got) == set(new_stats)
    for k, ref in new_stats.items():
        norm = k.rsplit("/", 1)[0]
        ex2 = float(np.max(new_stats[norm + "/var"]
                           + new_stats[norm + "/mean"] ** 2))
        bound = STATS_REL * (ex2 if k.endswith("var") else np.sqrt(ex2))
        err = float(np.abs(got[k] - ref).max())
        assert err <= bound, (k, err, bound)


def check_step(want, bf16, fp32):
    lo, ac, grads, new_params, new_stats = want
    losses, accs, model = bf16
    losses32, _, model32 = fp32
    check_losses(lo, ac, losses, accs)
    check_grads(grads, port_grads(model), port_grads(model32))
    check_state(model, new_params, new_stats)
    assert abs(float(losses["tot"]) - float(losses32["tot"])) \
        <= 0.05 * abs(float(losses32["tot"]))


@pytest.mark.parametrize("accum", [1, 2])
def test_bf16_train_step_matches_jax(accum):
    check_step(*run_case(accum))


def jax_eval(jmodel, cfg, variables, toks, mask, rng):
    """(losses, accs) of JAX's eval step under the policy, as floats."""
    beta = jsched.beta_schedule(cfg.beta_scheduler, 0)
    _, (lo, ac, _) = jax.jit(
        lambda p, bs, t, m, r: _forward_loss(jmodel, cfg, p, bs, t, m, r,
                                             beta, False))(
        jax_tree(variables["params"]), jax_tree(variables["batch_stats"]),
        jnp.asarray(toks), jnp.asarray(mask), rng)
    return ({k: float(v) for k, v in lo.items()},
            {k: float(v) for k, v in ac.items()})


def check_eval(use_pallas):
    cfg, pcfg, variables, jmodel, model, toks, mask, rng, eps = setup(
        1, use_pallas)
    lo, ac = jax_eval(jmodel, cfg, variables, toks, mask, rng)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    launches = dict(counts.launches)
    losses, accs = ptrainer.eval_step(model, pcfg, torch.from_numpy(toks),
                                      torch.from_numpy(mask), 0,
                                      eps=torch.from_numpy(eps))
    assert counts.launches == launches  # CPU: plain
    assert set(losses) == set(lo) and set(accs) == set(ac)
    check_losses(lo, ac, losses, accs)
    for k, v in model.state_dict().items():
        assert v.dtype == before[k].dtype and torch.equal(v, before[k]), k


def test_bf16_eval_step_runs_the_policy():
    """The eval step under the policy against JAX's (XLA lattice GCN); the
    fp32 masters and running statistics untouched."""
    check_eval(use_pallas=False)


@pytest.mark.slow
def test_bf16_eval_step_matches_jax_pallas_gcl():
    """The same against JAX's eval with `gcl_apply_pallas` and its eval
    epilogue (interpret mode), the counterpart of the port's `gcl_eval`."""
    check_eval(use_pallas=True)


@pytest.mark.slow
def test_bf16_train_step_matches_jax_pallas_gcl():
    """The train step against the JAX step with the Pallas GCL (interpret
    mode) and its custom VJP."""
    check_step(*run_case(2, use_pallas=True))
