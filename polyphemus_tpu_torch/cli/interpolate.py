"""Latent interpolation CLI, a port of `polyphemus_tpu.cli.interpolate`:
decode a path between two latents (or two encoded samples) into a series of
MIDI sequences.

    python -m polyphemus_tpu_torch.cli.interpolate MODEL_DIR OUT_DIR \
        [--steps 8] [--seed_a 0 --seed_b 1 | --sample_a X.npz --sample_b Y.npz]
        [--slerp] [--device cuda]

It runs on the CUDA device unless `--device cpu` is given. A seed endpoint
is drawn by torch.Generator(seed), which draws other numbers than the JAX
CLI's jax.random; a sample endpoint is the encoder's mu, as there.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import generate as G
from ..config import GenerationConfig
from ..data.dataset import load_sample


def _slerp(a, b, t):
    an = a / np.linalg.norm(a)
    bn = b / np.linalg.norm(b)
    omega = np.arccos(np.clip(np.dot(an, bn), -1.0, 1.0))
    if omega < 1e-6:
        return (1 - t) * a + t * b
    return (np.sin((1 - t) * omega) * a + np.sin(t * omega) * b) \
        / np.sin(omega)


def main(argv=None):
    p = argparse.ArgumentParser(description="Interpolates in latent space.")
    p.add_argument("model_dir", type=str)
    p.add_argument("out_dir", type=str)
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--seed_a", type=int, default=0)
    p.add_argument("--seed_b", type=int, default=1)
    p.add_argument("--sample_a", type=str, default=None)
    p.add_argument("--sample_b", type=str, default=None)
    p.add_argument("--slerp", action="store_true", default=False)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA device).")
    args = p.parse_args(argv)
    device = G.resolve_device(args.device)

    model, cfg = G.load_model(args.model_dir, device)
    mc = cfg.model

    def endpoint(sample, seed):
        if sample is not None:
            toks, mask = load_sample(sample, mc.n_bars)
            with torch.no_grad(), G.exact_fp32():
                mu, _ = model.encode(
                    torch.as_tensor(toks[None], dtype=torch.int64,
                                    device=device),
                    torch.as_tensor(mask[None], device=device))
            return mu[0].cpu().numpy()
        return G.generate_z(seed, 1, mc.d, device)[0].cpu().numpy()

    za = endpoint(args.sample_a, args.seed_a)
    zb = endpoint(args.sample_b, args.seed_b)
    ts = np.linspace(0.0, 1.0, args.steps)
    if args.slerp:
        zs = np.stack([_slerp(za, zb, t) for t in ts])
    else:
        zs = np.stack([(1 - t) * za + t * zb for t in ts])

    mask, tokens = G.make_generator(model, device=device)(
        zs.astype(np.float32))
    tokens, mask = tokens.cpu().numpy(), mask.cpu().numpy()
    gen_cfg = GenerationConfig()
    for i in range(args.steps):
        song = G.song_from_tokens(tokens[i], mask[i], mc.resolution, gen_cfg)
        G.save_song(song, args.out_dir, f"step_{i:02d}")
    print(f"Wrote {args.steps} interpolation steps to {args.out_dir}")


if __name__ == "__main__":
    main()
