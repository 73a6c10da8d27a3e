"""Training runtime: the train and eval steps and the host loop.

Counterpart of `polyphemus_tpu/train/trainer.py`:

  * `make_optimizer`: Adam (AdamW when weight_decay > 0) with the config's
    betas and eps; the LR of update k is `optimizer.lr` for k = 0 and
    `lr_schedule(k)` after that (the reference order, optax's count);
  * `make_train_step`: forward (the per-slot loss statistics when
    `fused_ce`, else the logits), losses, backward, one optimizer update.
    With `iters_to_accumulate` > 1 the batch splits into microbatches run in
    order: the batch-norm running statistics chain through them, the grads
    are averaged over them, and so are the losses and metrics. Beta is read
    at the count of completed updates;
  * `Trainer`: epochs, `metrics.jsonl` with the JAX trainer's keys,
    evaluation, the rolling `checkpoint` and `best_model` saves, resume, and
    an abort after `max_nan_steps` consecutive non-finite losses.

With `cfg.bf16` the train and eval steps run the JAX package's bf16 compute
policy (`compute_dtype`): the model computes on bf16 copies of the fp32
master parameters and batch-norm statistics, the grads flow through the
casts into the fp32 masters that Adam updates, and the new running
statistics come back to the fp32 masters. Checkpoints stay fp32.

Not ported, and refused when asked for: TensorBoard, model parallelism;
checkpoints are written synchronously.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import time
from collections import defaultdict, deque
from typing import Optional

import numpy as np
import torch

from ..config import TrainConfig
from ..generate import exact_fp32
from . import checkpoint as ckpt
from .losses import compute_losses, losses_from_stats
from .metrics import accuracies_from_stats, compute_accuracies
from .schedules import beta_schedule, lr_schedule


def make_optimizer(model, cfg: TrainConfig) -> torch.optim.Optimizer:
    opt = cfg.optimizer
    kw = dict(lr=opt.lr, betas=tuple(opt.betas), eps=opt.eps)
    if opt.weight_decay > 0:
        return torch.optim.AdamW(model.parameters(),
                                 weight_decay=opt.weight_decay, **kw)
    return torch.optim.Adam(model.parameters(), **kw)


@contextlib.contextmanager
def compute_dtype(model, dtype):
    """Run `model` in `dtype` over its fp32 masters.

    Inside, every float parameter reads as a differentiable cast of its
    master (grads flow back into the master) and every float buffer as a
    `dtype` copy. On a normal exit each buffer that was updated (a
    batch-norm running update, in place or as a new tensor in the dtype it
    was computed in) is written to its fp32 master; on any exit the masters
    are back in place. A backward that recomputes part of the forward
    (`torch.utils.checkpoint`) must run inside too."""
    swapped = []
    for mod in model.modules():
        for store in (mod._parameters, mod._buffers):
            for name, master in list(store.items()):
                if master is not None and master.is_floating_point():
                    copy = master.to(dtype)
                    swapped.append((store is mod._buffers, store, name,
                                    master, copy, copy._version))
                    store[name] = copy
    try:
        yield
        with torch.no_grad():
            for is_buffer, store, name, master, copy, version in swapped:
                now = store[name]
                if is_buffer and (now is not copy or now._version != version):
                    master.copy_(now)
    finally:
        for _, store, name, master, _, _ in swapped:
            store[name] = master


def _policy(model, cfg: TrainConfig):
    """The compute-dtype context of one forward (and backward) of `model`
    under `cfg`."""
    return (compute_dtype(model, torch.bfloat16) if cfg.bf16
            else contextlib.nullcontext())


def lr_at(cfg: TrainConfig, updates: int) -> float:
    """The LR of the update that follows `updates` completed ones."""
    return cfg.optimizer.lr if updates == 0 else lr_schedule(
        cfg.lr_scheduler, updates)


def forward_loss(model, cfg: TrainConfig, tokens, mask, beta, *, eps=None,
                 generator=None, with_metrics: bool = True):
    """(total loss, {7 losses}, {9 metrics}) of one (micro)batch in the
    model's current mode."""
    if cfg.fused_ce:
        (s_logits, stats), mu, log_var = model.train_stats(
            tokens, mask, eps=eps, generator=generator)
        tot, losses = losses_from_stats(stats, s_logits, mask, mu, log_var,
                                        beta, ref_parity=cfg.ref_parity)
        accs = (accuracies_from_stats(stats, s_logits, mask,
                                      ref_parity=cfg.ref_parity)
                if with_metrics else {})
    else:
        (s_logits, c_logits), mu, log_var = model(tokens, mask, eps=eps,
                                                  generator=generator)
        tot, losses = compute_losses(s_logits, c_logits, tokens, mask, mu,
                                     log_var, beta,
                                     ref_parity=cfg.ref_parity)
        accs = (compute_accuracies(s_logits, c_logits, tokens, mask,
                                   ref_parity=cfg.ref_parity)
                if with_metrics else {})
    return tot, losses, accs


def _mean(dicts: list) -> dict:
    return {k: torch.stack([torch.as_tensor(d[k]) for d in dicts]).mean()
            for k in dicts[0]}


class TrainStep:
    """step(tokens, mask, *, eps=None, generator=None) -> (losses, accs):
    one optimizer update of `model` in place, in full fp32 (no TF32 in
    matmuls or convolutions) or under the bf16 policy (`cfg.bf16`; bf16
    products reduce in fp32). `eps` (B, d) is the reparameterisation noise
    of the whole batch, else it is drawn from `generator`. `updates` counts
    the completed updates."""

    def __init__(self, model, cfg: TrainConfig, optimizer,
                 with_metrics: bool = True):
        self.model, self.cfg, self.optimizer = model, cfg, optimizer
        self.with_metrics = with_metrics
        self.updates = 0

    def __call__(self, tokens, mask, *, eps=None, generator=None):
        with exact_fp32():
            return self._step(tokens, mask, eps, generator)

    def _step(self, tokens, mask, eps, generator):
        cfg, model = self.cfg, self.model
        accum = max(cfg.iters_to_accumulate, 1)
        b = tokens.shape[0]
        if b % accum:
            raise ValueError(
                f"batch size {b} is not divisible by iters_to_accumulate="
                f"{accum}; every sample must land in a microbatch")
        mb = b // accum
        beta = 0.0 if cfg.ref_parity else beta_schedule(cfg.beta_scheduler,
                                                        self.updates)
        model.train()
        self.optimizer.zero_grad(set_to_none=True)
        losses_h, accs_h = [], []
        for i in range(accum):
            sl = slice(i * mb, (i + 1) * mb)
            with _policy(model, cfg):
                tot, losses, accs = forward_loss(
                    model, cfg, tokens[sl], mask[sl], beta,
                    eps=None if eps is None else eps[sl], generator=generator,
                    with_metrics=self.with_metrics)
                tot.backward()
            losses_h.append({k: v.detach() for k, v in losses.items()})
            accs_h.append(accs)
        if accum > 1:
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(accum)
        for group in self.optimizer.param_groups:
            group["lr"] = lr_at(cfg, self.updates)
        self.optimizer.step()
        self.updates += 1
        if accum == 1:
            return losses_h[0], accs_h[0]
        return _mean(losses_h), (_mean(accs_h) if accs_h[0] else {})


def make_train_step(model, cfg: TrainConfig, optimizer,
                    with_metrics: bool = True) -> TrainStep:
    return TrainStep(model, cfg, optimizer, with_metrics)


@torch.no_grad()
def eval_step(model, cfg: TrainConfig, tokens, mask, updates: int, *,
              eps=None, generator=None):
    """(losses, accs) of one batch in eval mode (running statistics)."""
    beta = 0.0 if cfg.ref_parity else beta_schedule(cfg.beta_scheduler,
                                                    updates)
    model.eval()
    try:
        with exact_fp32(), _policy(model, cfg):
            _, losses, accs = forward_loss(model, cfg, tokens, mask, beta,
                                           eps=eps, generator=generator)
    finally:
        model.train()
    return losses, accs


class Trainer:
    """Host loop: epochs, periodic print/eval/save, early exit, resume."""

    def __init__(self, model_dir: str, model, cfg: TrainConfig, *, device,
                 print_every: int = 1, save_every: int = 10,
                 eval_every: Optional[int] = None, tensorboard: bool = False):
        if tensorboard:
            raise NotImplementedError(
                "TensorBoard is not ported; metrics.jsonl has every number")
        if cfg.parallel.model_axis != 1:
            raise NotImplementedError("model parallelism is not ported")
        self.model_dir = model_dir
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.print_every = print_every
        self.save_every = save_every
        self.eval_every = eval_every
        self.optimizer = make_optimizer(self.model, cfg)
        self.train_step = make_train_step(self.model, cfg, self.optimizer)
        self._jsonl_path = os.path.join(model_dir, "metrics.jsonl")
        self.tr_losses = defaultdict(list)
        self.tr_accuracies = defaultdict(list)
        self.val_losses = defaultdict(list)
        self.val_accuracies = defaultdict(list)
        self.lrs: list = []
        self.betas: list = []
        self.min_val_loss = float("inf")
        self.tot_batches = 0
        self.cur_epoch = 0
        # abort after this many consecutive non-finite losses
        self.max_nan_steps = 5
        self._nan_steps = 0
        self._step_ends: deque = deque(maxlen=51)

    @property
    def step(self) -> int:
        """Completed optimizer updates."""
        return self.train_step.updates

    # ------------------------------------------------------------------ setup
    def to_device(self, tokens, mask):
        """Host numpy (tokens, mask) -> tensors on the trainer's device,
        copied from pinned memory on a card."""
        tokens = torch.from_numpy(np.ascontiguousarray(tokens))
        mask = torch.from_numpy(np.ascontiguousarray(mask))
        if self.device.type == "cuda":
            return (tokens.pin_memory().to(self.device, non_blocking=True),
                    mask.pin_memory().to(self.device, non_blocking=True))
        return tokens.to(self.device), mask.to(self.device)

    def resume(self) -> None:
        step, meta = ckpt.load_checkpoint(self.model_dir, "checkpoint",
                                          self.model, self.optimizer)
        self.train_step.updates = step
        self.tot_batches = int(meta.get("tot_batches", 0))
        self.min_val_loss = float(meta.get("min_val_loss", float("inf")))
        for name in ("tr_losses", "tr_accuracies", "val_losses",
                     "val_accuracies"):
            hist = getattr(self, name)
            for k, v in meta.get(name, {}).items():
                hist[k] = list(v)
        self.lrs = list(meta.get("lrs", []))
        self.betas = list(meta.get("betas", []))

    # ------------------------------------------------------------------ loop
    def fit(self, train_iter_fn, epochs: int, valid_iter_fn=None,
            early_exit: Optional[int] = None, seed: Optional[int] = None):
        """Train for `epochs` over `train_iter_fn()` batches of device
        tensors. Dropout masks and the reparameterisation noise come from one
        generator seeded with `seed` (default: the config's)."""
        gen = torch.Generator(device=self.device).manual_seed(
            self.cfg.seed if seed is None else seed)
        self.model.set_dropout_generator(gen)
        start = time.time()
        stop = False
        self._step_ends.clear()
        for epoch in range(epochs):
            self.cur_epoch = epoch
            for tokens, mask in train_iter_fn():
                losses, accs = self.train_step(tokens, mask, generator=gen)
                self._record(self.tot_batches, epoch, losses, accs)
                n = self.tot_batches + 1
                if n % self.print_every == 0:
                    self._print_stats(epoch, epochs, start)
                if (valid_iter_fn is not None and self.eval_every
                        and n % self.eval_every == 0):
                    self._eval_and_save(valid_iter_fn)
                if self.save_every > 0 and n % self.save_every == 0:
                    self.save("checkpoint")
                if early_exit is not None and n > early_exit:
                    stop = True
                    break
                self.tot_batches += 1
            if stop:
                break
        print(f"Training completed in {time.time() - start:.1f}s")
        self.save("checkpoint")

    def evaluate(self, valid_iter_fn, seed: int = 0):
        """Mean eval-mode (losses, accs) over `valid_iter_fn()`."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        losses_all, accs_all = defaultdict(list), defaultdict(list)
        for tokens, mask in valid_iter_fn():
            losses, accs = eval_step(self.model, self.cfg, tokens, mask,
                                     self.step, generator=gen)
            for k, v in losses.items():
                losses_all[k].append(float(v))
            for k, v in accs.items():
                accs_all[k].append(float(v))
        return ({k: float(np.mean(v)) for k, v in losses_all.items()},
                {k: float(np.mean(v)) for k, v in accs_all.items()})

    def save(self, name: str) -> None:
        meta = {
            "epoch": self.cur_epoch,
            "tot_batches": self.tot_batches,
            "min_val_loss": self.min_val_loss,
            "lrs": list(self.lrs),
            "betas": list(self.betas),
            "tr_losses": {k: list(v) for k, v in self.tr_losses.items()},
            "tr_accuracies": {k: list(v)
                              for k, v in self.tr_accuracies.items()},
            "val_losses": {k: list(v) for k, v in self.val_losses.items()},
            "val_accuracies": {k: list(v)
                               for k, v in self.val_accuracies.items()},
        }
        ckpt.save_checkpoint(self.model_dir, name, self.model, self.optimizer,
                             self.step, meta)

    # ------------------------------------------------------------ internals
    def _record(self, batch_i, epoch_i, losses, accs):
        """Histories, one metrics.jsonl line, and the non-finite streak."""
        self._step_ends.append(time.perf_counter())
        l_host = {k: float(v) for k, v in losses.items()}
        a_host = {k: float(v) for k, v in accs.items()}
        for k, v in l_host.items():
            self.tr_losses[k].append(v)
        for k, v in a_host.items():
            self.tr_accuracies[k].append(v)
        lr = lr_schedule(self.cfg.lr_scheduler, self.step)
        beta = beta_schedule(self.cfg.beta_scheduler, self.step,
                             ref_parity=self.cfg.ref_parity)
        self.lrs.append(lr)
        self.betas.append(beta)
        rec = {"batch": batch_i, "epoch": epoch_i, "lr": lr,
               "beta": beta}
        seq_s = self.seq_per_sec()
        if seq_s is not None:
            rec["seq_s"] = round(seq_s, 1)
        rec.update({f"loss/{k}": v for k, v in l_host.items()})
        rec.update({f"acc/{k}": v for k, v in a_host.items()})
        os.makedirs(self.model_dir, exist_ok=True)
        with open(self._jsonl_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if not math.isfinite(l_host["tot"]):
            self._nan_steps += 1
            if self._nan_steps >= self.max_nan_steps:
                raise FloatingPointError(
                    f"non-finite loss for {self._nan_steps} consecutive "
                    f"steps (batch {batch_i})")
        else:
            self._nan_steps = 0

    def seq_per_sec(self) -> Optional[float]:
        """Sequences per second over the last (up to 50) steps of this fit,
        on the host clock (each step ends in a device sync)."""
        if len(self._step_ends) < 2:
            return None
        span = self._step_ends[-1] - self._step_ends[0]
        return (len(self._step_ends) - 1) / span * self.cfg.batch_size

    def _eval_and_save(self, valid_iter_fn):
        val_losses, val_accs = self.evaluate(valid_iter_fn)
        for k, v in val_losses.items():
            self.val_losses[k].append(v)
        for k, v in val_accs.items():
            self.val_accuracies[k].append(v)
        print(f"Val losses: {val_losses}")
        print(f"Val accuracies: {val_accs}")
        if val_losses:
            rec = {"batch": self.tot_batches, "epoch": self.cur_epoch}
            rec.update({f"val_loss/{k}": v for k, v in val_losses.items()})
            rec.update({f"val_acc/{k}": v for k, v in val_accs.items()})
            with open(self._jsonl_path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        if val_losses.get("tot", float("inf")) < self.min_val_loss:
            print("Validation loss improved; saving best model.")
            self.min_val_loss = val_losses["tot"]
            self.save("best_model")

    def _print_stats(self, epoch, epochs, start):
        k = self.print_every
        avg_l = {key: round(float(np.mean(v[-k:])), 3)
                 for key, v in self.tr_losses.items()}
        avg_a = {key: round(float(np.mean(v[-k:])), 3)
                 for key, v in self.tr_accuracies.items()}
        seq_s = self.seq_per_sec()
        thr = f" {seq_s:.0f} seq/s" if seq_s is not None else ""
        print(f"[{time.time() - start:8.1f}s] epoch {epoch + 1}/{epochs} "
                 f"batch {self.tot_batches + 1}{thr} losses={avg_l} "
                 f"accs={avg_a}")
