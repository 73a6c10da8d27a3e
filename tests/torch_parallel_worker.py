"""One rank of the data- and tensor-parallel CPU tests
(tests/test_torch_parallel.py, tests/test_torch_tensor_parallel.py), started
by `torchrun`:

    python -m torch.distributed.run --standalone --nproc_per_node W \
        tests/torch_parallel_worker.py MODE IN OUT [args...]

MODE `bn`: the masked batch-norm on this rank's rows of IN's (x, mask,
grad_out); writes OUT/rank<r>.pt with the moments, the output, the input
grad, the summed weight grads and the running statistics.
MODE `step`: one `TrainStep` of IN's model, config (its
`parallel.model_axis` M: each rank keeps its shards), global batch and eps
(and dropout generator seed) on this rank's data index's rows, then, with
IN's `eval`, one `eval_step` on the same rows; writes OUT/rank<r>.pt with
the global losses and metrics, the summed grads and the state after the
step (whole, gathered from the model group), the eval losses and metrics,
and the shapes this rank holds of every parameter and Adam moment.
MODE `cli`: `cli.train.main(args)`, logging every checkpoint write to
OUT/writes_rank<r>.txt.

Imports only torch and the port: gloo on the CPU, one thread a rank.
"""
import datetime
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from polyphemus_tpu_torch.config import train_config_from_dict  # noqa: E402
from polyphemus_tpu_torch.data import shard_rows  # noqa: E402
from polyphemus_tpu_torch.parallel import mesh as pmesh  # noqa: E402

TIMEOUT = datetime.timedelta(seconds=120)


def bn(inp, out):
    from polyphemus_tpu_torch.models.layers import MaskedBatchNorm
    from polyphemus_tpu_torch.ops import masked as mops

    r, w = pmesh.rank(), pmesh.world()
    d = torch.load(inp)
    n = d["x"].shape[0] // w
    rows = slice(r * n, (r + 1) * n)
    x = d["x"][rows].clone().requires_grad_(True)
    mask = d["mask"][rows]
    mean, var, count = mops.masked_moments(x.detach(), mask, (0, 1))
    bn_mod = MaskedBatchNorm(x.shape[-1])
    bn_mod.load_state_dict(d["bn"])
    y = bn_mod(x, mask)
    (y * d["grad_out"][rows]).sum().backward()
    torch.save({"mean": mean, "var": var, "count": count, "y": y.detach(),
                "x_grad": x.grad, "weight_grad": bn_mod.weight.grad,
                "bias_grad": bn_mod.bias.grad,
                "running_mean": bn_mod.running_mean,
                "running_var": bn_mod.running_var},
               os.path.join(out, f"rank{r}.pt"))


def step(inp, out):
    from polyphemus_tpu_torch.models import VAE
    from polyphemus_tpu_torch.train import trainer as tr

    r = pmesh.rank()
    d = torch.load(inp)
    cfg = train_config_from_dict(d["cfg"])
    pmesh.data_layout(cfg, "cpu")
    model = VAE(cfg.model)
    model.load_state_dict(d["state"])
    pmesh.broadcast_module(model)  # and keep this rank's shards
    rows = torch.from_numpy(shard_rows(
        d["tokens"].shape[0], cfg.iters_to_accumulate, pmesh.data_index(),
        pmesh.data_size()))
    gen = (torch.Generator().manual_seed(d["seed"])
           if d["seed"] is not None else None)
    model.set_dropout_generator(gen)
    opt = tr.make_optimizer(model, cfg)
    train_step = tr.make_train_step(model, cfg, opt)
    batch = (d["tokens"][rows], d["mask"][rows])
    losses, accs = train_step(*batch, eps=d["eps"][rows], generator=gen)
    res = {"losses": losses, "accs": accs,
           "grads": pmesh.full_state_dict(
               {k: p.grad for k, p in model.named_parameters()}),
           "state": pmesh.full_state_dict(model.state_dict()),
           "shapes": {k: tuple(p.shape) for k, p in model.named_parameters()},
           "moment_shapes": {
               k: [tuple(opt.state[p][m].shape)
                   for m in ("exp_avg", "exp_avg_sq")]
               for k, p in model.named_parameters()}}
    if d.get("eval"):
        res["eval"] = tr.eval_step(model, cfg, *batch, train_step.updates,
                                   eps=d["eps"][rows])
    torch.save(res, os.path.join(out, f"rank{r}.pt"))


def cli(out, argv):
    from polyphemus_tpu_torch.cli import train as train_cli
    from polyphemus_tpu_torch.train import checkpoint as ckpt

    write = ckpt.write_checkpoint
    rank = os.environ["RANK"]

    def logged(model_dir, name, snap, meta):
        with open(os.path.join(out, f"writes_rank{rank}.txt"), "a") as f:
            f.write(name + "\n")
        write(model_dir, name, snap, meta)

    ckpt.write_checkpoint = logged
    train_cli.main(argv)


def main():
    torch.set_num_threads(1)
    mode, args = sys.argv[1], sys.argv[2:]
    if mode == "cli":
        cli(args[0], args[1:])
        return
    pmesh.maybe_initialize_distributed("cpu", timeout=TIMEOUT)
    try:
        {"bn": bn, "step": step}[mode](*args)
    finally:
        pmesh.destroy()


if __name__ == "__main__":
    main()
