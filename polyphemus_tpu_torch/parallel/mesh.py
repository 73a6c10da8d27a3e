"""Data and tensor parallelism over `torch.distributed`: W = D x M processes
compute the step that one process computes on the global batch.

Counterpart of `polyphemus_tpu/parallel/mesh.py`. The JAX package runs one
SPMD program over a (data, model) mesh, so a step over W devices is the
step over the global batch. Here W processes (`torchrun`) form the same
mesh by hand: rank r sits at data index r // M and model index r % M, as
`make_mesh`'s reshape places devices (`data_layout`).

Data axis (D). The D ranks of a model index hold their rows of every
global microbatch, and the parts of the step that couple samples are made
global over the data group:

  * batch-norm statistics: the masked sums and the count are summed over
    the data group before dividing (`ops/masked.py`, `ops/fused_embed.py`),
    and the gradient flows back through that sum (`all_reduce_sum`);
  * losses: each rank's loss is its share of the global one, so that their
    sum over the data group is the one-process loss (`train/losses.py`),
    and the gradients are summed once per optimizer step
    (`all_reduce_grads`);
  * random draws take the global shape and keep the data index's rows
    (`global_rows`), so the ranks draw what one process draws, and the M
    ranks of a model group draw alike.

Model axis (M, Megatron-style tensor parallelism). The M ranks of a data
index share its rows, and each holds 1 / M of the parameters that
`SHARDED` names (the JAX package's `_RULES`, in the port's names and
layouts) and of their Adam moments; every other parameter is whole on
every rank. A sharded layer computes its shard's part, between three
autograd functions over the model group:

  * `copy_to_model`: identity forward, SUM all-reduce of the grad backward
    (where a whole tensor enters a sharded computation);
  * `gather_from_model`: all-gather of the column shards forward, this
    rank's slice of the grad backward (column-parallel output);
  * `reduce_from_model`: SUM all-reduce forward, identity backward
    (row-parallel partial products).

Everything after a gather or a reduce, and before a copy, runs alike on the
M ranks. Only `all_reduce`, `all_gather` and `broadcast` are used (gloo,
which the one-card and CPU runs take, has no reduce-scatter).

Every function here is a no-op without a process group: a single process
runs exactly the code it ran before.
"""
from __future__ import annotations

import datetime
import os
from typing import Callable, NamedTuple, Optional

import torch
import torch.distributed as dist

# How long a collective waits for the other ranks before it fails: a rank
# that died fails the others instead of hanging them. The longest wait is
# the first step's, which builds the kernels at first use.
TIMEOUT = datetime.timedelta(minutes=5)

# The parameters sharded over the model axis, by name fragment, and the
# dimension each is cut along (`polyphemus_tpu/parallel/mesh.py::_RULES`;
# `nn.Linear` keeps its weight as (out, in), `DenseParams` and the GCL
# weights as (in, out)). The GCL bias, `edge_nn` and every batch-norm stay
# whole.
SHARDED = (
    ("chord_encoder.kernel", 0),     # (15d, d): input rows
    ("chord_decoder.kernel", 1),     # (d, 15d): output columns
    ("chord_decoder.bias", 0),       # (15d,)
    ("rel_weight", 2),               # (n_rel, d, d): output columns
    ("root", 1),                     # (d, d): output columns
    ("bars_encoder.weight", 1),      # (d, n_bars d): input columns
    ("bars_decoder.weight", 0),      # (n_bars d, d): output rows
    ("bars_decoder.bias", 0),        # (n_bars d,)
)


def shard_dim(name: str) -> Optional[int]:
    """The dimension parameter `name` is sharded along, or None."""
    for frag, dim in SHARDED:
        if frag in name:
            return dim
    return None


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
    for (its collectives take CUDA tensors through the host): NCCL refuses
    two ranks on one card. Nothing falls back from one backend to the
    other: a failed NCCL start raises. Returns the rank's device."""
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
    global _layout
    _layout = None
    _groups.clear()
    if active():
        dist.destroy_process_group()


# ------------------------------------------------------------ the layout
class Layout(NamedTuple):
    """This rank's place on a (data, model) mesh with M > 1."""

    data: int
    model: int
    data_index: int
    model_index: int
    data_group: object      # the D ranks of this model index
    model_group: object     # the M ranks of this data index


_layout: Optional[Layout] = None
# (world, M) -> (model groups by data index, data groups by model index)
_groups: dict = {}


def _mesh_groups(w: int, m: int) -> tuple:
    """Every model group and every data group of a W = D x M mesh, created
    once; every rank creates every group, in the same order."""
    if (w, m) not in _groups:
        d = w // m
        model = [dist.new_group([i * m + j for j in range(m)],
                                timeout=TIMEOUT) for i in range(d)]
        data = [dist.new_group([i * m + j for i in range(d)],
                               timeout=TIMEOUT) for j in range(m)]
        _groups[(w, m)] = (model, data)
    return _groups[(w, m)]


def data_layout(cfg, device=None) -> dict:
    """The (data, model) layout of a training run over the process group,
    which takes the place of the JAX package's `make_mesh`: {"data": D,
    "model": M}, D = W / M. Sets up the mesh's groups for M > 1. Refuses,
    before the first step, with a ValueError: a W that M does not divide; a
    data axis other than -1 or D; an M that does not divide d (and so 15 d
    and n_bars d, the other sharded widths); on a CUDA `device`, a shard
    width d / M that is not a multiple of 128 (the GCL kernels' column
    tile); a D that does not divide the microbatch (batch_size /
    iters_to_accumulate): processes cannot be shrunk to a divisor as JAX
    shrinks its data axis."""
    global _layout
    w = world()
    par = cfg.parallel
    m = par.model_axis
    if m < 1 or w % m:
        raise ValueError(f"{w} processes not divisible by parallel."
                         f"model_axis={m}")
    d_axis = w // m
    if par.data_axis not in (-1, d_axis):
        raise ValueError(
            f"parallel.data_axis={par.data_axis} but the run has {w} "
            f"processes and model_axis={m}: give -1 or {d_axis}")
    mc = cfg.model
    if mc.d % m:
        raise ValueError(
            f"parallel.model_axis={m} must divide the sharded widths d="
            f"{mc.d}, 15d={15 * mc.d} and n_bars d={mc.n_bars * mc.d}")
    if m > 1 and device is not None and torch.device(device).type == "cuda" \
            and (mc.d // m) % 128:
        raise ValueError(
            f"parallel.model_axis={m} gives the GCL kernels column shards of "
            f"d / M = {mc.d // m}, not a multiple of 128")
    accum = max(cfg.iters_to_accumulate, 1)
    mb, rest = divmod(cfg.batch_size, accum)
    if d_axis > 1 and (rest or mb % d_axis):
        raise ValueError(
            f"a data axis of {d_axis} cannot share a microbatch of "
            f"batch_size={cfg.batch_size} / iters_to_accumulate={accum}: "
            f"every data index takes the same number of rows of every "
            f"microbatch")
    _layout = None
    if m > 1:
        r = rank()
        model_groups, data_groups = _mesh_groups(w, m)
        _layout = Layout(d_axis, m, r // m, r % m, data_groups[r % m],
                         model_groups[r // m])
    return {"data": d_axis, "model": m}


def model_size() -> int:
    """M, the ranks that share a data index (1 without tensor parallelism)."""
    return _layout.model if _layout is not None else 1


def model_index() -> int:
    return _layout.model_index if _layout is not None else 0


def data_size() -> int:
    """D, the ranks that hold distinct rows of the batch."""
    return _layout.data if _layout is not None else world()


def data_index() -> int:
    return _layout.data_index if _layout is not None else rank()


def _data_group():
    return _layout.data_group if _layout is not None else None


def _model_group():
    return _layout.model_group


# ---------------------------------------------------------- the data axis
class _AllReduceSum(torch.autograd.Function):
    """SUM all-reduce over a group whose backward is a SUM all-reduce of
    the grads: the global loss is the sum of the ranks' losses, and each
    rank's loss reads the summed value."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the data group, differentiable; `t` itself
    without a process group."""
    return _AllReduceSum.apply(t, _data_group()) if active() else t


def rank_share(mean: torch.Tensor) -> torch.Tensor:
    """This rank's share of a mean over the global batch, from the mean
    over its rows: mean / D (every data index holds as many rows)."""
    return mean / data_size() if active() else mean


def global_rows(draw: Callable, shape, dim: int = 0) -> torch.Tensor:
    """`draw(shape)` as this rank's rows of a draw at the global size:
    `draw` is called with `shape` whose axis `dim` (the batch-major axis)
    is D times longer, and the data index's D-th of that axis is kept.
    With a generator seeded alike on every rank, the ranks then draw for
    each sample what one process draws for it."""
    if not active():
        return draw(tuple(shape))
    shape, d_axis = tuple(shape), data_size()
    n = shape[dim]
    full = draw(shape[:dim] + (d_axis * n,) + shape[dim + 1:])
    return full.narrow(dim, data_index() * n, n)


def _flat_all_reduce(grads, group) -> None:
    """Sum `grads` over `group` in place, in one coalesced all-reduce."""
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


@torch.no_grad()
def all_reduce_grads(params) -> None:
    """Sum every parameter's grad over the data axis in place. Every rank
    runs the same graph, so the same parameters hold a grad everywhere.

    Under tensor parallelism a sharded parameter's grad is its shard's,
    summed over the data group. A whole parameter's grad is the same
    function on the M ranks of a model group, but on a card not the same
    bits (atomics, convolution grads): its grads are summed over every
    rank and divided by M, so that every rank takes the same update and
    the whole parameters never drift apart."""
    if not active():
        return
    params = [p for p in params if p.grad is not None]
    m = model_size()
    if m == 1:
        _flat_all_reduce([p.grad for p in params], None)
        return
    whole = [p.grad for p in params if not hasattr(p, "tp_dim")]
    _flat_all_reduce(whole, None)
    for g in whole:
        g.div_(m)
    _flat_all_reduce([p.grad for p in params if hasattr(p, "tp_dim")],
                     _data_group())


# --------------------------------------------------------- the model axis
class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return t

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=_model_group())
        return grad


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=_model_group())
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim):
        ctx.dim, ctx.width = dim, t.shape[dim]
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(model_size())]
        dist.all_gather(parts, t, group=_model_group())
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, model_index() * ctx.width,
                           ctx.width).contiguous(), None


def copy_to_model(t: torch.Tensor) -> torch.Tensor:
    """t, whose grad is summed over the model group (a whole tensor that
    enters a sharded computation)."""
    return _CopyToModel.apply(t) if model_size() > 1 else t


def reduce_from_model(t: torch.Tensor) -> torch.Tensor:
    """The sum of the model group's partial results t."""
    return _ReduceFromModel.apply(t) if model_size() > 1 else t


def gather_from_model(t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The model group's shards of axis `dim`, concatenated in model
    order."""
    if model_size() == 1:
        return t
    return _GatherFromModel.apply(t, dim % t.dim())


def shard_range(size: int) -> tuple:
    """(start, stop) of this rank's shard of an axis of `size`."""
    n = size // model_size()
    return model_index() * n, (model_index() + 1) * n


# -------------------------------------------------- parameters and state
def _shard(t: torch.Tensor, dim: int) -> torch.Tensor:
    lo, hi = shard_range(t.shape[dim])
    return t.narrow(dim, lo, hi - lo).clone()


@torch.no_grad()
def shard_module(model) -> None:
    """Keep this rank's shard of every parameter `SHARDED` names (marked
    with its `tp_dim`); a no-op at M = 1. The optimizer is made after."""
    if model_size() == 1:
        return
    for name, p in model.named_parameters():
        dim = shard_dim(name)
        if dim is not None and not hasattr(p, "tp_dim"):
            p.data = _shard(p.data, dim)
            p.tp_dim = dim


@torch.no_grad()
def broadcast_module(model) -> None:
    """Rank 0's parameters and buffers to every rank, whole; under tensor
    parallelism each rank then keeps its shards (`shard_module`). Shards
    already cut (a resumed model, whose every rank read the same
    checkpoint) stay as they are."""
    if not active():
        return
    for t in list(model.parameters()) + list(model.buffers()):
        if not hasattr(t, "tp_dim"):
            dist.broadcast(t, src=0)
    shard_module(model)


def shard_state_dict(state: dict) -> dict:
    """A one-process state dict cut to this rank's shards."""
    if model_size() == 1:
        return state
    return {k: _shard(v, shard_dim(k)) if shard_dim(k) is not None else v
            for k, v in state.items()}


@torch.no_grad()
def _gather(t: torch.Tensor, dim: int) -> torch.Tensor:
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(model_size())]
    dist.all_gather(parts, t, group=_model_group())
    return torch.cat(parts, dim=dim)


def full_state_dict(state: dict) -> dict:
    """A sharded state dict (or dict of grads) made whole, in the
    one-process layout; every rank of the model group calls it."""
    if model_size() == 1:
        return state
    return {k: _gather(v, shard_dim(k)) if shard_dim(k) is not None else v
            for k, v in state.items()}


def _moments(model, opt_state: dict, fn) -> dict:
    """`opt_state` (an optimizer's state dict over model.parameters()) with
    fn(tensor, dim) applied to the per-parameter tensors of the sharded
    parameters (Adam's moments; not its step count)."""
    dims = [shard_dim(name) for name, _ in model.named_parameters()]
    state = {}
    for i, st in opt_state["state"].items():
        dim = dims[int(i)]
        state[i] = {k: fn(v, dim) if dim is not None and torch.is_tensor(v)
                    and v.dim() > 0 else v for k, v in st.items()}
    return dict(opt_state, state=state)


def full_optimizer_state(model, opt_state: dict) -> dict:
    """The optimizer state of a sharded model made whole (collective over
    the model group)."""
    if model_size() == 1:
        return opt_state
    return _moments(model, opt_state, _gather)


def shard_optimizer_state(model, opt_state: dict) -> dict:
    """A one-process optimizer state cut to this rank's shards."""
    if model_size() == 1:
        return opt_state
    return _moments(model, opt_state, _shard)
