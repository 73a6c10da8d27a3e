"""Training stats plots from a model directory, flag-compatible with
`polyphemus_tpu.cli.stats`: reads the meta file `checkpoint.json` that the
trainer writes beside `checkpoint.pt`. Needs matplotlib.

    python -m polyphemus_tpu_torch.cli.stats MODEL_DIR [--out DIR]
        [--losses tot pitch dur ...] [--accuracies note pitch ...] [--val]
"""
from __future__ import annotations

import argparse
import os

from .. import plotting


def main(argv=None):
    p = argparse.ArgumentParser(description="Plots training statistics.")
    p.add_argument("model_dir", type=str)
    p.add_argument("--out", type=str, default=None,
                   help="Output directory (default: model_dir).")
    p.add_argument("--losses", nargs="*",
                   default=["tot", "reconstruction", "pitch", "dur",
                            "structure", "kld"])
    p.add_argument("--accuracies", nargs="*",
                   default=["note", "pitch", "dur", "s_acc", "s_f1"])
    p.add_argument("--val", action="store_true", default=False)
    args = p.parse_args(argv)

    out = args.out or args.model_dir
    os.makedirs(out, exist_ok=True)
    plotting.plot_losses(args.model_dir, args.losses, plot_val=args.val,
                         save_path=os.path.join(out, "losses.png"))
    plotting.plot_accuracies(args.model_dir, args.accuracies,
                             plot_val=args.val,
                             save_path=os.path.join(out, "accuracies.png"))
    print(f"Wrote {out}/losses.png and {out}/accuracies.png")


if __name__ == "__main__":
    main()
