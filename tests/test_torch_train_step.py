"""One training step of the port against the JAX package's, on the same
weights, batch (`synthetic_batch`) and reparameterisation noise, at
accumulate 1 and 2: the 7 losses and the 9 metrics (rtol = atol = 2e-4;
the accuracies may move by the near-tie share of their denominators, the
rule of tests/torch_port_case.py), every grad, the params after one Adam
update and the new batch-norm running statistics (rtol = atol = 5e-4).

The JAX side runs `make_train_step`'s computation in the open so its grads
can be read: per microbatch `value_and_grad` of `_forward_loss` with the
step's rng (`fold_in(rng, i)` under accumulation) and the batch statistics
chained, grads and losses averaged, one update of `make_optimizer`. Its
GCL is the XLA lattice path (`use_pallas_gcl=False`, held to the Pallas
VJP by tests/test_pallas_grad.py); the Pallas form, through
`make_train_step` itself, is the slow case. The noise is JAX's: the `sample`
rng of each microbatch, evaluated as the model draws it; equal structure
logits then show the port used the same eps. Also: the schedules on a grid
of steps, and the losses and metrics of the logits path."""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from polyphemus_tpu.config import (BetaSchedulerConfig, LRSchedulerConfig,
                                   TrainConfig)
from polyphemus_tpu.data.dataset import synthetic_batch
from polyphemus_tpu.models import VAE
from polyphemus_tpu.parallel import mesh as jmesh
from polyphemus_tpu.train import losses as jlosses
from polyphemus_tpu.train import metrics as jmetrics
from polyphemus_tpu.train import schedules as jsched
from polyphemus_tpu.train.trainer import (TrainState, _forward_loss,
                                          make_optimizer, make_train_step)
from polyphemus_tpu_torch import config as pconfig
from polyphemus_tpu_torch import constants
from polyphemus_tpu_torch.convert import from_jax_variables, to_jax_variables
from polyphemus_tpu_torch.models import VAE as PVAE
from polyphemus_tpu_torch.train import losses, metrics, schedules
from polyphemus_tpu_torch.train import trainer as ptrainer

from .torch_port_case import (LOGIT_TIE, S_LOGIT_TIE, build, jax_tree,
                              port_cfg, small_cfg, top2_gap)

TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=5e-4, atol=5e-4)
MB = 4  # microbatch size of every case: one JAX compile serves them all
_GRAD_FNS: dict = {}


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def microbatch_rngs(rng, accum):
    return [rng] if accum == 1 else [jax.random.fold_in(rng, i)
                                     for i in range(accum)]


def jax_eps(jmodel, params, rngs, d):
    """The reparameterisation noise `VAE.train_stats` draws from each
    microbatch's `sample` rng."""
    def draw(module):
        return jax.random.normal(module.make_rng("sample"), (MB, d),
                                 jnp.float32)

    return np.concatenate([np.asarray(jmodel.apply(
        {"params": params}, method=draw, rngs={"sample": r})) for r in rngs])


def grad_fn_key(cfg, mb):
    """The cache key of `jax_reference_step`'s jitted grad function: what
    its trace reads, the model config (its grid and widths among them) and
    the settings of `_forward_loss` that the cases set, and the microbatch;
    not the batch size or the accumulation, so the cases at accumulate 1 and
    2 share one compile."""
    return cfg.model, cfg.bf16, cfg.fused_ce, cfg.ref_parity, mb


def jax_reference_step(jmodel, cfg, variables, toks, mask, rng, mb=MB,
                       mesh=None):
    """(losses, accs, grads, new params, new batch stats), each flat numpy,
    of one JAX train step over microbatches of mb samples; on `mesh` (a
    (data, model) mesh of `polyphemus_tpu.parallel.mesh`) with the params
    and batch statistics laid out by its `param_sharding` and each
    microbatch by its `batch_sharding`, as the JAX trainer shards them. The
    jitted grad function closes over jmodel and cfg, so it is cached by
    `grad_fn_key`."""
    key = grad_fn_key(cfg, mb)
    if key not in _GRAD_FNS:
        _GRAD_FNS[key] = jax.jit(jax.value_and_grad(
            lambda p, bs, t, m, r: _forward_loss(jmodel, cfg, p, bs, t, m,
                                                 r, 0.0, True),
            has_aux=True))
    grad_fn = _GRAD_FNS[key]
    accum = cfg.iters_to_accumulate
    params = jax_tree(variables["params"])
    stats = jax_tree(variables["batch_stats"])
    batch = jnp.asarray
    if mesh is not None:
        params, stats = (jax.device_put(t, jmesh.param_sharding(mesh, t))
                         for t in (params, stats))

        def batch(a):
            return jax.device_put(jnp.asarray(a), jmesh.batch_sharding(mesh))
    gsum, hist = None, []
    for i, r in enumerate(microbatch_rngs(rng, accum)):
        sl = slice(i * mb, (i + 1) * mb)
        (_, (l_, a_, stats)), g = grad_fn(params, stats, batch(toks[sl]),
                                          batch(mask[sl]), r)
        gsum = g if gsum is None else jax.tree_util.tree_map(jnp.add, gsum, g)
        hist.append((l_, a_))
    grads = jax.tree_util.tree_map(lambda g: g / accum, gsum)
    opt = make_optimizer(cfg)
    updates, _ = opt.update(grads, opt.init(params), params)
    new_params = optax.apply_updates(params, updates)
    lo, ac = ({k: np.mean([float(h[j][k]) for h in hist])
               for k in hist[0][j]} for j in (0, 1))
    return lo, ac, flatten(grads), flatten(new_params), flatten(stats)


def near_tie_slack(model, pcfg, toks, mask, eps):
    """How far each metric may move by near-ties: per microbatch, the
    share of its denominator at positions whose top-2 content-logit gap
    (or |structure logit|) is below the tie rule, averaged like the
    metrics. Computed on a copy (batch statistics, no update)."""
    model = copy.deepcopy(model).train()
    accum = pcfg.iters_to_accumulate
    content, structure = [], []
    for i in range(accum):
        sl = slice(i * MB, (i + 1) * MB)
        t, m = torch.from_numpy(toks[sl]), torch.from_numpy(mask[sl])
        with torch.no_grad():
            (s_l, c_l), _, _ = model(t, m, eps=torch.from_numpy(eps[sl]))
        c_l = c_l.numpy()
        tie = (top2_gap(c_l[..., :131]) < LOGIT_TIE) | \
            (top2_gap(c_l[..., 131:]) < LOGIT_TIE)
        w = mask[sl][..., None] & (toks[sl][..., 1:, 0]
                                   != constants.PitchToken.PAD)
        dens = [w.sum(), w[..., 0, :, :].sum(), w[..., 1:, :, :].sum()]
        content.append((tie & w).sum() / max(min(dens), 1))
        structure.append((np.abs(s_l.numpy()) < S_LOGIT_TIE).mean()
                         / max(mask[sl].mean(), 1e-12))
    return float(np.mean(content)), float(np.mean(structure))


def jax_init(mcfg, seed):
    """(numpy JAX variables, JAX VAE, port VAE on the CPU in eval mode) from
    JAX's jitted `model.init` (an RBG key), as tests/test_torch_resolution.py
    makes them: weights at any grid, where `build`'s reference-layout
    converters take 8 steps a quarter only."""
    jmodel = VAE(mcfg)
    toks, mask = synthetic_batch(np.random.default_rng(seed), 1, mcfg.n_bars,
                                 n_timesteps=mcfg.n_timesteps)
    key = jax.random.key(seed, impl="rbg")
    variables = jax.jit(lambda t, m: jmodel.init(
        {"params": key, "sample": jax.random.fold_in(key, 1)}, t, m,
        deterministic=True))(jnp.asarray(toks), jnp.asarray(mask))
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    model = PVAE(port_cfg(mcfg))
    model.load_state_dict(from_jax_variables(variables))
    return variables, jmodel, model.eval()


def run_case(accum, use_pallas=False, seed=0, n_bars=2, resolution=8):
    mcfg = dataclasses.replace(small_cfg(n_layers=2, n_bars=n_bars),
                               use_pallas_gcl=use_pallas,
                               resolution=resolution)
    cfg = TrainConfig(batch_size=MB * accum, model=mcfg,
                      iters_to_accumulate=accum)
    variables, jmodel, model = (build(mcfg, seed=seed) if resolution == 8
                                else jax_init(mcfg, seed))
    toks, mask = synthetic_batch(np.random.default_rng(seed + 1),
                                 MB * accum, mcfg.n_bars,
                                 n_timesteps=mcfg.n_timesteps)
    rng = jax.random.key(seed + 7)
    eps = jax_eps(jmodel, jax_tree(variables["params"]),
                  microbatch_rngs(rng, accum), mcfg.d)
    pcfg = pconfig.TrainConfig(batch_size=MB * accum, model=port_cfg(mcfg),
                               iters_to_accumulate=accum)
    slack = near_tie_slack(model, pcfg, toks, mask, eps)
    step = ptrainer.make_train_step(model, pcfg,
                                    ptrainer.make_optimizer(model, pcfg))
    p_losses, p_accs = step(torch.from_numpy(toks), torch.from_numpy(mask),
                            eps=torch.from_numpy(eps))
    assert step.updates == 1
    return (cfg, variables, jmodel, toks, mask, rng, model, p_losses, p_accs,
            slack)


def check_against_jax(want, got_losses, got_accs, model, slack):
    lo, ac, grads, new_params, new_stats = want
    assert set(got_losses) == set(lo) and set(got_accs) == set(ac)
    for k in lo:
        np.testing.assert_allclose(float(got_losses[k]), lo[k], **TOL,
                                   err_msg=k)
    for k in ac:
        extra = slack[1] if k.startswith("s_") else slack[0]
        np.testing.assert_allclose(float(got_accs[k]), ac[k], rtol=2e-4,
                                   atol=2e-4 + extra, err_msg=k)
    p_grads = flatten(to_jax_variables(
        {n: p.grad for n, p in model.named_parameters()})["params"])
    assert set(p_grads) == set(grads)
    for k in grads:
        np.testing.assert_allclose(p_grads[k], grads[k], **GRAD_TOL,
                                   err_msg=k)
    tree = to_jax_variables(model.state_dict())
    for name, got, ref in (("params", flatten(tree["params"]), new_params),
                           ("batch_stats", flatten(tree["batch_stats"]),
                            new_stats)):
        assert set(got) == set(ref), name
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], **GRAD_TOL,
                                       err_msg=f"{name}/{k}")


def test_reference_step_grad_fns_are_cached_by_model():
    """Two configs that differ in resolution or in a width the trace closes
    over get grad functions of their own: the cache never hands one model's
    step to another (it once keyed on the GCL form, bf16, n_bars and the
    microbatch only)."""
    base = TrainConfig(batch_size=MB, model=small_cfg(n_layers=2))
    keys = {grad_fn_key(dataclasses.replace(
        base, model=dataclasses.replace(base.model, **change)), MB)
        for change in ({}, {"resolution": 4}, {"resolution": 12}, {"d": 64},
                       {"gnn_n_layers": 3})}
    assert len(keys) == 5
    assert grad_fn_key(base, MB) == grad_fn_key(
        TrainConfig(batch_size=MB, model=small_cfg(n_layers=2)), MB)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(accum):
    (cfg, variables, jmodel, toks, mask, rng, model, p_losses, p_accs,
     slack) = run_case(accum)
    want = jax_reference_step(jmodel, cfg, variables, toks, mask, rng)
    check_against_jax(want, p_losses, p_accs, model, slack)


@pytest.mark.slow
def test_train_step_matches_jax_pallas_gcl():
    """The same against `make_train_step` itself with the Pallas GCL
    (interpret mode) and its custom VJP."""
    accum = 2
    (cfg, variables, jmodel, toks, mask, rng, model, p_losses, p_accs,
     slack) = run_case(accum, use_pallas=True, seed=3)
    want = jax_reference_step(jmodel, cfg, variables, toks, mask, rng)
    check_against_jax(want, p_losses, p_accs, model, slack)
    params = jax_tree(variables["params"])
    opt = make_optimizer(cfg)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=jax_tree(variables["batch_stats"]),
                       opt_state=opt.init(params))
    new_state, j_losses, _ = jax.jit(make_train_step(jmodel, cfg, opt))(
        state, jnp.asarray(toks), jnp.asarray(mask), rng)
    for k, v in j_losses.items():
        np.testing.assert_allclose(float(p_losses[k]), float(v), **TOL)
    got = flatten(to_jax_variables(model.state_dict())["params"])
    for k, v in flatten(jax.device_get(new_state.params)).items():
        np.testing.assert_allclose(got[k], v, **GRAD_TOL, err_msg=k)


def test_schedules_match_jax():
    for ramp in (False, True):
        lr_cfg = LRSchedulerConfig(warmup_steps=8000, ramp_warmup=ramp)
        p_lr = pconfig.LRSchedulerConfig(warmup_steps=8000, ramp_warmup=ramp)
        for step in (0, 1, 2, 100, 7999, 8000, 8001, 50_000, 800_000,
                     2_000_000):
            np.testing.assert_allclose(
                schedules.lr_schedule(p_lr, step),
                float(jsched.lr_schedule(lr_cfg, step)), rtol=1e-5, atol=0)
    b_cfg, p_b = BetaSchedulerConfig(), pconfig.BetaSchedulerConfig()
    for parity in (False, True):
        for step in (0, 39_999, 40_000, 40_001, 91_110, 91_111, 300_000,
                     500_000, 700_000):
            np.testing.assert_allclose(
                schedules.beta_schedule(p_b, step, ref_parity=parity),
                float(jsched.beta_schedule(b_cfg, step, ref_parity=parity)),
                rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("parity", [False, True], ids=["fixed", "ref_parity"])
def test_logits_path_losses_and_metrics_match_jax(parity):
    rng = np.random.default_rng(6)
    toks, mask = synthetic_batch(rng, 3, 2)
    s_logits = rng.standard_normal(mask.shape).astype(np.float32)
    c_logits = rng.standard_normal(mask.shape + (15, 230)).astype(np.float32)
    mu = rng.standard_normal((3, 8)).astype(np.float32)
    lv = 0.1 * rng.standard_normal((3, 8)).astype(np.float32)
    jargs = [jnp.asarray(a) for a in (s_logits, c_logits, toks, mask, mu, lv)]
    targs = [torch.from_numpy(a) for a in (s_logits, c_logits, toks, mask,
                                           mu, lv)]
    _, want = jlosses.compute_losses(*jargs, 0.5, ref_parity=parity)
    _, got = losses.compute_losses(*targs, 0.5, ref_parity=parity)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), **TOL)
    want = jmetrics.compute_accuracies(*jargs[:4], ref_parity=parity)
    got = metrics.compute_accuracies(*targs[:4], ref_parity=parity)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), **TOL)
