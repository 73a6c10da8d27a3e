"""Data parallelism over `torch.distributed`: every rank computes its share
of the global batch's step.

Counterpart of `polyphemus_tpu/parallel/mesh.py`. The JAX package runs one
SPMD program over a (data, model) mesh, so a step over W processes is the
step over the global batch. Here W processes (`torchrun`) each hold the
whole model and their rows of every global microbatch, and the parts of
the step that couple samples are made global by hand:

  * batch-norm statistics: the masked sums and the count are summed over
    the ranks before dividing (`ops/masked.py`, `ops/fused_embed.py`), and
    the gradient flows back through that sum (`all_reduce_sum`);
  * losses: each rank's loss is its share of the global one, so that their
    sum over the ranks is the one-process loss (`train/losses.py`), and
    the gradients are summed once per optimizer step (`all_reduce_grads`);
  * random draws take the global shape and keep this rank's rows
    (`global_rows`), so W ranks draw what one process draws.

Every function here is a no-op without a process group: a single process
runs exactly the code it ran before. The model axis of the JAX mesh
(tensor parallelism) is not ported; `data_layout` refuses it.
"""
from __future__ import annotations

import datetime
import os
from typing import Callable, Optional

import torch
import torch.distributed as dist

# How long a collective waits for the other ranks before it fails: a rank
# that died fails the others instead of hanging them. The longest wait is
# the first step's, which builds the kernels at first use.
TIMEOUT = datetime.timedelta(minutes=5)


def active() -> bool:
    """Whether a process group is up (even one of a single rank)."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world() -> int:
    return dist.get_world_size() if active() else 1


def is_primary() -> bool:
    """Rank 0, the one rank that writes files and prints."""
    return rank() == 0


def maybe_initialize_distributed(device=None, backend: Optional[str] = None,
                                 timeout: datetime.timedelta = TIMEOUT
                                 ) -> Optional[torch.device]:
    """Join the process group that `torchrun` describes in the environment
    (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`);
    a no-op returning None without it, or when a group is already up.

    `device` defaults to `cuda:LOCAL_RANK`; `backend` to NCCL on a CUDA
    device and gloo on the CPU. gloo on a CUDA device is taken when asked
    for (its all-reduce and broadcast take CUDA tensors through the host):
    NCCL refuses two ranks on one card. Nothing falls back from one backend
    to the other: a failed NCCL start raises. Returns the rank's device."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    if active():
        return None
    device = torch.device(device if device is not None
                          else f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}")
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    # NCCL starts eagerly on the rank's card, so a failure raises here
    extra = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend=backend, init_method="env://",
                            timeout=timeout, **extra)
    return device


def destroy() -> None:
    if active():
        dist.destroy_process_group()


def data_layout(cfg) -> dict:
    """The (data, model) layout of a training run over the process group,
    which takes the place of the JAX package's `make_mesh`: {"data": W,
    "model": 1}. Raises for a model axis other than 1, a data axis other
    than -1 or W, and a W that does not divide the microbatch
    (batch_size / iters_to_accumulate): processes cannot be shrunk to a
    divisor as JAX shrinks its data axis, so the run is refused before
    its first step."""
    w = world()
    par = cfg.parallel
    if par.model_axis != 1:
        raise NotImplementedError(
            f"model parallelism (parallel.model_axis={par.model_axis}) is "
            f"not ported: training runs data-parallel only, with "
            f"model_axis=1 (ROADMAP.md, Queue 1 item 9)")
    if par.data_axis not in (-1, w):
        raise ValueError(
            f"parallel.data_axis={par.data_axis} but the run has {w} "
            f"processes: give -1 or {w}")
    accum = max(cfg.iters_to_accumulate, 1)
    mb, rest = divmod(cfg.batch_size, accum)
    if w > 1 and (rest or mb % w):
        raise ValueError(
            f"{w} processes cannot share a microbatch of batch_size="
            f"{cfg.batch_size} / iters_to_accumulate={accum}: every "
            f"process takes the same number of rows of every microbatch")
    return {"data": w, "model": 1}


class _AllReduceSum(torch.autograd.Function):
    """SUM all-reduce whose backward is a SUM all-reduce of the grads: the
    global loss is the sum of the ranks' losses, and each rank's loss
    reads the summed value."""

    @staticmethod
    def forward(ctx, t):
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the ranks, differentiable; `t` itself without a
    process group."""
    return _AllReduceSum.apply(t) if active() else t


def rank_share(mean: torch.Tensor) -> torch.Tensor:
    """This rank's share of a mean over the global batch, from the mean
    over its rows: mean / W (every rank holds as many rows)."""
    return mean / world() if active() else mean


def global_rows(draw: Callable, shape, dim: int = 0) -> torch.Tensor:
    """`draw(shape)` as this rank's rows of a draw at the global size:
    `draw` is called with `shape` whose axis `dim` (the batch-major axis)
    is W times longer, and this rank's W-th of that axis is kept. With a
    generator seeded alike on every rank, W ranks then draw for each
    sample what one process draws for it."""
    if not active():
        return draw(tuple(shape))
    shape, w = tuple(shape), world()
    n = shape[dim]
    full = draw(shape[:dim] + (w * n,) + shape[dim + 1:])
    return full.narrow(dim, rank() * n, n)


@torch.no_grad()
def all_reduce_grads(params) -> None:
    """Sum every parameter's grad over the ranks in place, in one
    coalesced all-reduce. Every rank runs the same graph, so the same
    parameters hold a grad everywhere."""
    if not active():
        return
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


@torch.no_grad()
def broadcast_module(model) -> None:
    """Rank 0's parameters and buffers to every rank."""
    if not active():
        return
    for t in list(model.parameters()) + list(model.buffers()):
        dist.broadcast(t, src=0)
