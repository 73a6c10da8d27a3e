"""Training CLI, with the flags of `polyphemus_tpu.cli.train`.

    python -m polyphemus_tpu_torch.cli.train DATASET_DIR OUTPUT_DIR CONFIG.json \
        [--model_name NAME] [--save_every 10] [--print_every 1] [--eval]
        [--eval_every N] [--num_workers 10] [--tr_split 0.7]
        [--vl_split 0.1] [--max_epochs 100] [--seed N] [--resume]
        [--early_exit N] [--tensorboard] [--profile DIR] [--device cuda]

DATASET_DIR holds per-sample reference-format `.npz` files (`cli.preprocess`
writes them), or is a packed shard directory with its `shards.json`
(`cli.pack_dataset` writes it), read through `data.fastloader`'s native
batch gather; its packed `n_bars` must be the config's. Training runs on
the CUDA device unless `--device cpu` is given, and refuses to start
without a card otherwise. The model directory OUTPUT_DIR/NAME gets
`config.json`, `metrics.jsonl`, `checkpoint.pt` (which
`generate.load_model` serves as it is) and its meta file `checkpoint.json`;
`--tensorboard` mirrors the metrics into `tb/` there, and `--profile DIR`
writes a `torch.profiler` trace of steps 10-15 into DIR.

Over W processes, on W cards or on the CPU:

    torchrun --standalone --nproc_per_node W -m polyphemus_tpu_torch.cli.train \
        DATASET_DIR OUTPUT_DIR CONFIG.json [--device cpu] ...

Each rank runs on `cuda:LOCAL_RANK` (NCCL) unless `--device` is given
(`--device cpu`: gloo) and trains the model one process trains on the same
global batch and seed (`parallel.mesh`). The config's
`parallel.model_axis` M splits the W ranks into D = W / M data indices of
M ranks each: each data index loads its rows of every global batch (D
must divide the microbatch, batch_size / iters_to_accumulate), and its M
ranks share them, each holding 1 / M of the sharded parameters (tensor
parallelism; on a card d / M must be a multiple of 128). Rank 0 alone
writes the model directory, in the one-process layout, and prints. Every
rank prints its kernel launches at the end.
"""
from __future__ import annotations

import argparse
import json
import os
import uuid

import numpy as np
import torch

from ..config import load_train_config
from ..convert import save_config
from ..data import BatchLoader, PolyphemusDataset
from ..data.sharded import INDEX_NAME
from ..generate import resolve_device
from ..models import VAE
from ..ops import kernels
from ..parallel import mesh as pmesh
from ..train import checkpoint as ckpt
from ..train.trainer import Trainer


class _Subset:
    def __init__(self, ds, idxs):
        self.ds, self.idxs = ds, np.asarray(idxs)
        if hasattr(ds, "gather_batch"):
            # keep the batch-level gather through the index view
            self.gather_batch = (
                lambda b: ds.gather_batch(self.idxs[np.asarray(b)]))

    def __len__(self):
        return len(self.idxs)

    def __getitem__(self, i):
        return self.ds[int(self.idxs[i])]


def main(argv=None):
    p = argparse.ArgumentParser(description="Trains Polyphemus (PyTorch).")
    p.add_argument("dataset_dir", type=str)
    p.add_argument("output_dir", type=str)
    p.add_argument("config_file", type=str)
    p.add_argument("--model_name", type=str, default=None)
    p.add_argument("--save_every", type=int, default=10)
    p.add_argument("--print_every", type=int, default=1)
    p.add_argument("--eval", action="store_true", default=False)
    p.add_argument("--eval_every", type=int, default=None)
    p.add_argument("--num_workers", type=int, default=10)
    p.add_argument("--tensorboard", action="store_true", default=False,
                   help="mirror metrics to TensorBoard (model_dir/tb)")
    p.add_argument("--tr_split", type=float, default=0.7)
    p.add_argument("--vl_split", type=float, default=0.1)
    p.add_argument("--max_epochs", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", action="store_true", default=False,
                   help="Resume from <model_dir>/checkpoint.pt.")
    p.add_argument("--early_exit", type=int, default=None)
    p.add_argument("--profile", type=str, default=None,
                   help="Directory for a torch.profiler trace of steps "
                        "10-15.")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA device; under "
                        "torchrun, cuda:LOCAL_RANK)")
    args = p.parse_args(argv)
    device = pmesh.maybe_initialize_distributed(args.device)
    owns_group = device is not None
    try:
        return _train(args, device if owns_group
                      else resolve_device(args.device))
    finally:
        if owns_group:
            pmesh.destroy()


def _train(args, device):
    cfg = load_train_config(args.config_file)
    mc = cfg.model
    layout = pmesh.data_layout(cfg, device)
    rank, world = pmesh.rank(), pmesh.world()
    shard = (pmesh.data_index(), pmesh.data_size())
    log = print if rank == 0 else (lambda *a, **k: None)

    log("Preparing datasets and dataloaders...")
    if os.path.exists(os.path.join(args.dataset_dir, INDEX_NAME)):
        # a packed shard directory: mmapped shards, the native batch gather
        from ..data.fastloader import FastShardedBatcher

        dataset = FastShardedBatcher(args.dataset_dir)
        if dataset.index.get("n_bars") != mc.n_bars:
            raise SystemExit(
                f"dataset packed with n_bars={dataset.index.get('n_bars')} "
                f"but config wants n_bars={mc.n_bars}")
    else:
        dataset = PolyphemusDataset(args.dataset_dir, mc.n_bars)
    n = len(dataset)
    order = np.random.default_rng(args.seed).permutation(n)
    tr_len = int(args.tr_split * n)
    vl_len = int(args.vl_split * n) if args.eval else 0
    tr_set = _Subset(dataset, order[:tr_len])
    vl_set = _Subset(dataset, order[tr_len:tr_len + vl_len])

    model_name = args.model_name or str(uuid.uuid1())
    if world > 1 and args.model_name is None:
        names = [model_name]
        torch.distributed.broadcast_object_list(names, src=0)
        model_name = names[0]
    model_dir = os.path.join(args.output_dir, model_name)
    if rank == 0:
        os.makedirs(args.output_dir, exist_ok=True)
        os.makedirs(model_dir, exist_ok=args.resume)
        save_config(model_dir, cfg)

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        model = VAE(mc)
    eval_every = args.eval_every
    # each data index loads its rows of every global batch (of each
    # microbatch)
    train_loader = BatchLoader(tr_set, cfg.batch_size, shuffle=True,
                               seed=args.seed, num_workers=args.num_workers,
                               shard=shard,
                               microbatches=max(cfg.iters_to_accumulate, 1))
    if args.eval and eval_every is None:
        eval_every = len(train_loader)
    trainer = Trainer(model_dir, model, cfg, device=device,
                      print_every=args.print_every,
                      save_every=args.save_every, eval_every=eval_every,
                      tensorboard=args.tensorboard)
    train_loader.device_put_fn = trainer.to_device
    valid_loader = (BatchLoader(vl_set, cfg.batch_size, shuffle=False,
                                num_workers=args.num_workers,
                                device_put_fn=trainer.to_device,
                                shard=shard)
                    if args.eval else None)
    log(f"Device: {device}")
    log(f"Devices: {world} mesh={layout}")
    if args.resume and ckpt.latest_exists(model_dir):
        log("Resuming from checkpoint...")
        trainer.resume()
    # the whole model's count, also where this rank holds shards
    whole = sum(p.numel() * (layout["model"] if hasattr(p, "tp_dim") else 1)
                for p in model.parameters())
    log(f"Total Trainable Parameters: {whole}")

    log("Starting training...")
    trainer.fit(lambda: iter(train_loader), args.max_epochs,
                valid_iter_fn=(lambda: iter(valid_loader))
                if valid_loader is not None else None,
                early_exit=args.early_exit, seed=args.seed,
                profile_dir=args.profile)
    if pmesh.active():
        # one write: the ranks of `torchrun` write unbuffered to one stream
        print(f"Kernel launches (rank {rank}): "
              f"{json.dumps(kernels.launch_counts())}\n", end="", flush=True)
    return trainer


if __name__ == "__main__":
    main()
