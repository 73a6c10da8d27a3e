"""Convert a model directory into a port model directory.

    python -m polyphemus_tpu_torch.cli.convert MODEL_DIR OUT_DIR

Counterpart of `polyphemus_tpu.cli.convert`. MODEL_DIR is a reference
(PyTorch) model directory (`checkpoint` + `configuration`) or a JAX one
(`checkpoint.msgpack` + `config.json`); OUT_DIR gets `checkpoint.pt` (the
port's state dict) and `config.json`. OUT_DIR loads with
`generate.load_model`, and the training CLI's `--resume` starts from its
weights with fresh optimizer state.
"""
from __future__ import annotations

import argparse

from ..convert import load_model_dir, save_checkpoint


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Converts a reference (PyTorch) or JAX Polyphemus model "
                    "directory to the port's checkpoint format.")
    p.add_argument("model_dir", type=str)
    p.add_argument("out_dir", type=str)
    args = p.parse_args(argv)

    model, cfg = load_model_dir(args.model_dir, "cpu")
    save_checkpoint(args.out_dir, model, cfg)
    print(f"Converted {args.model_dir} -> {args.out_dir}")


if __name__ == "__main__":
    main()
