"""Reconstruction CLI, a port of `polyphemus_tpu.cli.reconstruct`: encode
preprocessed samples, decode them back, save the original and the
reconstruction as MIDI side by side.

    python -m polyphemus_tpu_torch.cli.reconstruct MODEL_DIR SAMPLE... \
        OUT_DIR [--sample_z] [--predict_structure] [--seed N] [--device cuda]

It runs on the CUDA device unless `--device cpu` is given. With
--sample_z the noise comes from torch.Generator(seed), which draws other
numbers than the JAX CLI's jax.random.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .. import generate as G
from ..config import GenerationConfig
from ..data.dataset import load_sample


def main(argv=None):
    p = argparse.ArgumentParser(description="Reconstructs samples through "
                                            "the VAE.")
    p.add_argument("model_dir", type=str)
    p.add_argument("samples", nargs="+", type=str,
                   help="Preprocessed .npz sample files.")
    p.add_argument("out_dir", type=str)
    p.add_argument("--sample_z", action="store_true", default=False,
                   help="Sample z ~ N(mu, sigma) instead of using mu.")
    p.add_argument("--predict_structure", action="store_true", default=False,
                   help="Let the decoder predict structure instead of "
                        "teacher-forcing the original.")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA device).")
    args = p.parse_args(argv)
    device = G.resolve_device(args.device)

    model, cfg = G.load_model(args.model_dir, device)
    mc = cfg.model
    gen_cfg = GenerationConfig()

    toks_np, masks_np = (np.stack(a) for a in zip(
        *(load_sample(s, mc.n_bars) for s in args.samples)))
    toks = torch.as_tensor(toks_np, dtype=torch.int64, device=device)
    masks = torch.as_tensor(masks_np, dtype=torch.bool, device=device)
    with torch.no_grad(), G.exact_fp32():
        mu, log_var = model.encode(toks, masks)
        z = mu
        if args.sample_z:
            g = torch.Generator(device=device).manual_seed(args.seed)
            z = mu + torch.exp(0.5 * log_var) * torch.randn(
                mu.shape, generator=g, device=device)

    if args.predict_structure:
        used_mask, tokens = G.make_generator(model, device=device)(z)
    else:
        used_mask, tokens = G.make_generator(model, conditioned=True,
                                             device=device)(z, masks)
    tokens, used_mask = tokens.cpu().numpy(), used_mask.cpu().numpy()
    for i, path in enumerate(args.samples):
        out = os.path.join(args.out_dir, str(i))
        orig = G.song_from_tokens(toks_np[i][..., 1:, :], masks_np[i],
                                  mc.resolution, gen_cfg)
        rec = G.song_from_tokens(tokens[i], used_mask[i], mc.resolution,
                                 gen_cfg)
        G.save_song(orig, out, "original")
        G.save_song(rec, out, "reconstructed")
        print(f"{path} -> {out}/original.mid, {out}/reconstructed.mid")


if __name__ == "__main__":
    main()
