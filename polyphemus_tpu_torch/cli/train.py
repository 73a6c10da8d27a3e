"""Training CLI, with the flags of `polyphemus_tpu.cli.train`.

    python -m polyphemus_tpu_torch.cli.train DATASET_DIR OUTPUT_DIR CONFIG.json \
        [--model_name NAME] [--save_every 10] [--print_every 1] [--eval]
        [--eval_every N] [--num_workers 10] [--tr_split 0.7]
        [--vl_split 0.1] [--max_epochs 100] [--seed N] [--resume]
        [--early_exit N] [--device cuda]

DATASET_DIR holds per-sample reference-format `.npz` files. Training runs on
the CUDA device unless `--device cpu` is given, and refuses to start
without a card otherwise. The model directory OUTPUT_DIR/NAME gets
`config.json`, `metrics.jsonl` and `checkpoint.pt`, which
`generate.load_model` serves as it is. `--tensorboard` and `--profile`
are refused (not ported).
"""
from __future__ import annotations

import argparse
import os
import uuid

import numpy as np
import torch

from ..config import load_train_config
from ..convert import save_config
from ..data import BatchLoader, PolyphemusDataset
from ..generate import resolve_device
from ..models import VAE
from ..train import checkpoint as ckpt
from ..train.trainer import Trainer


class _Subset:
    def __init__(self, ds, idxs):
        self.ds, self.idxs = ds, np.asarray(idxs)

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
                   help="not ported: refused")
    p.add_argument("--tr_split", type=float, default=0.7)
    p.add_argument("--vl_split", type=float, default=0.1)
    p.add_argument("--max_epochs", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", action="store_true", default=False,
                   help="Resume from <model_dir>/checkpoint.pt.")
    p.add_argument("--early_exit", type=int, default=None)
    p.add_argument("--profile", type=str, default=None,
                   help="not ported: refused")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA device)")
    args = p.parse_args(argv)
    if args.tensorboard or args.profile:
        raise NotImplementedError("--tensorboard and --profile are not "
                                  "ported")
    device = resolve_device(args.device)
    cfg = load_train_config(args.config_file)
    mc = cfg.model

    print("Preparing datasets and dataloaders...")
    if os.path.exists(os.path.join(args.dataset_dir, "shards.json")):
        raise NotImplementedError(
            "packed shard directories need the native fastloader, which is "
            "not ported; point DATASET_DIR at per-sample .npz files")
    dataset = PolyphemusDataset(args.dataset_dir, mc.n_bars)
    n = len(dataset)
    order = np.random.default_rng(args.seed).permutation(n)
    tr_len = int(args.tr_split * n)
    vl_len = int(args.vl_split * n) if args.eval else 0
    tr_set = _Subset(dataset, order[:tr_len])
    vl_set = _Subset(dataset, order[tr_len:tr_len + vl_len])

    model_name = args.model_name or str(uuid.uuid1())
    model_dir = os.path.join(args.output_dir, model_name)
    os.makedirs(args.output_dir, exist_ok=True)
    os.makedirs(model_dir, exist_ok=args.resume)
    save_config(model_dir, cfg)

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        model = VAE(mc)
    eval_every = args.eval_every
    train_loader = BatchLoader(tr_set, cfg.batch_size, shuffle=True,
                               seed=args.seed, num_workers=args.num_workers)
    if args.eval and eval_every is None:
        eval_every = len(train_loader)
    trainer = Trainer(model_dir, model, cfg, device=device,
                      print_every=args.print_every,
                      save_every=args.save_every, eval_every=eval_every)
    train_loader.device_put_fn = trainer.to_device
    valid_loader = (BatchLoader(vl_set, cfg.batch_size, shuffle=False,
                                num_workers=args.num_workers,
                                device_put_fn=trainer.to_device)
                    if args.eval else None)
    print(f"Device: {device}")
    if args.resume and ckpt.latest_exists(model_dir):
        print("Resuming from checkpoint...")
        trainer.resume()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"Total Trainable Parameters: {n_params}")

    print("Starting training...")
    trainer.fit(lambda: iter(train_loader), args.max_epochs,
                valid_iter_fn=(lambda: iter(valid_loader))
                if valid_loader is not None else None,
                early_exit=args.early_exit, seed=args.seed)
    return trainer


if __name__ == "__main__":
    main()
