"""Generation CLI, flag-compatible with `polyphemus_tpu.cli.generate` (and
so with the reference's generate.py).

    python -m polyphemus_tpu_torch.cli.generate MODEL_DIR OUTPUT_DIR \
        [--n 5] [--n_loops 1] [--no_audio] [--s_file structure.json] \
        [--seed N] [--z_file z.npy] [--gen_config cfg.yaml] [--bf16] \
        [--s_temp 0] [--c_temp 0] [--plot_struct] [--plot_proll] \
        [--device cuda]

MODEL_DIR is a model directory of the JAX package (`checkpoint.msgpack`),
of the reference (`checkpoint` + `configuration`) or of the port
(`checkpoint.pt`). It runs on the CUDA device unless `--device cpu` is
given. Writes OUTPUT_DIR/<i>/generated.mid (+ extended.mid with
--n_loops > 1, + .wav unless --no_audio), rendered by the native renderer
(`midi.fast_render`), and with --plot_struct / --plot_proll
structure.svg / pianoroll.png (these need matplotlib).
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .. import constants
from .. import generate as G
from ..config import GenerationConfig
from ..midi.fast_render import render_midi_bytes


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Generates MIDI music with a trained model.")
    p.add_argument("model_dir", type=str)
    p.add_argument("output_dir", type=str)
    p.add_argument("--n", type=int, default=5,
                   help="Number of sequences to generate (default 5).")
    p.add_argument("--n_loops", type=int, default=1)
    p.add_argument("--no_audio", action="store_true", default=False)
    p.add_argument("--s_file", type=str,
                   help="JSON file with a binary structure tensor.")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--z_file", type=str, default=None,
                   help="Load latent z from a .npy file (n, d) instead of "
                        "sampling it (torch.Generator(seed) draws other "
                        "numbers than the JAX CLI's jax.random).")
    p.add_argument("--gen_config", type=str, default=None,
                   help="YAML/JSON with MIDI_PROGRAMS / SOUNDFONT_PATH.")
    p.add_argument("--plot_struct", action="store_true", default=False,
                   help="Plot each structure tensor (structure.svg).")
    p.add_argument("--plot_proll", action="store_true", default=False,
                   help="Plot each pianoroll (pianoroll.png).")
    p.add_argument("--no_pallas", action="store_true", default=False,
                   help="Accepted for the JAX CLI's command lines; changes "
                        "nothing (on the card the CUDA kernels always run).")
    p.add_argument("--bf16", action="store_true", default=False,
                   help="bfloat16 decode, as the JAX CLI's --bf16.")
    p.add_argument("--s_temp", type=float, default=0.0,
                   help="Structure sampling temperature (0 = reference "
                        "hard threshold).")
    p.add_argument("--c_temp", type=float, default=0.0,
                   help="Content sampling temperature (0 = reference "
                        "argmax).")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA device).")
    args = p.parse_args(argv)
    device = G.resolve_device(args.device)

    gen_cfg = GenerationConfig.load(args.gen_config)
    print(f"Loading the model from {args.model_dir}...")
    model, cfg = G.load_model(args.model_dir, device)
    mc = cfg.model

    s_batch = None
    if args.s_file is not None:
        s = G.load_structure_file(args.s_file, mc.n_bars, mc.n_tracks,
                                  mc.n_timesteps)
        s_batch = np.broadcast_to(s, (args.n,) + s.shape).copy()

    if args.z_file is not None:
        print(f"Loading z from {args.z_file}...")
        z = np.load(args.z_file).astype(np.float32)
        if z.shape != (args.n, mc.d):
            raise ValueError(f"z file shape {z.shape} != ({args.n}, {mc.d})")
    else:
        print("Generating z...")
        z = G.generate_z(args.seed, args.n, mc.d, device)

    print("Generating music with the model...")
    gen = G.make_generator(model, conditioned=s_batch is not None,
                           bf16=args.bf16, structure_temp=args.s_temp,
                           content_temp=args.c_temp, sample_seed=args.seed,
                           device=device)
    inputs = (z,) if s_batch is None else (z, s_batch)
    gen(*inputs)  # the first call builds the kernels: not timed
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.time()
    mask, tokens = gen(*inputs)
    mask_np, tokens_np = mask.cpu().numpy(), tokens.cpu().numpy()
    dt = time.time() - t0
    print(f"Inference time: {dt:.3f} s ({args.n / max(dt, 1e-9):.1f} seq/s)")

    programs = [0 if name == "Drums" else gen_cfg.midi_programs.get(name, 0)
                for name in constants.TRACKS[:mc.n_tracks]]

    print(f"Saving MIDI files in {args.output_dir}...")
    for i in range(args.n):
        out_dir = os.path.join(args.output_dir, str(i))
        os.makedirs(out_dir, exist_ok=True)
        for name, loops in (("generated", 1),) + (
                (("extended", args.n_loops),) if args.n_loops > 1 else ()):
            midi_path = os.path.join(out_dir, name + ".mid")
            with open(midi_path, "wb") as f:
                f.write(render_midi_bytes(tokens_np[i], mask_np[i],
                                          mc.resolution, programs=programs,
                                          n_loops=loops))
            if not args.no_audio:
                G.synthesize_audio(midi_path, gen_cfg.soundfont_path)
        if args.plot_struct or args.plot_proll:
            from .. import plotting

            if args.plot_struct:
                plotting.plot_structure(mask_np[i], out_dir)
            if args.plot_proll:
                plotting.plot_pianoroll(G.song_from_tokens(
                    tokens_np[i], mask_np[i], mc.resolution, gen_cfg),
                    out_dir)
    print("Finished saving MIDI files.")


if __name__ == "__main__":
    main()
