"""Preprocessing CLI, with the flags of `polyphemus_tpu.cli.preprocess`.

    python -m polyphemus_tpu_torch.cli.preprocess MIDI_DIR OUT_DIR \
        [--n_bars 2] [--resolution 8] [--n_files N] [--n_workers 1]
        [--ref_parity]

Walks MIDI_DIR recursively and writes one reference-format `.npz` per kept
window into OUT_DIR (numpy only; no device is used).
"""
from __future__ import annotations

import argparse

from ..data.preprocess import preprocess_midi_dataset


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Preprocesses a MIDI dataset (hierarchical directories "
                    "supported, like Lakh MIDI / MetaMIDI).")
    p.add_argument("midi_dataset_dir", type=str)
    p.add_argument("preprocessed_dir", type=str)
    p.add_argument("--n_bars", type=int, default=2)
    p.add_argument("--resolution", type=int, default=8)
    p.add_argument("--n_files", type=int, default=None)
    p.add_argument("--n_workers", type=int, default=1)
    p.add_argument("--ref_parity", action="store_true",
                   help="reproduce the reference's cross-track silence-"
                        "filter bug for sample-for-sample comparability")
    args = p.parse_args(argv)

    preprocess_midi_dataset(args.midi_dataset_dir, args.preprocessed_dir,
                            args.n_bars, args.resolution, args.n_files,
                            n_workers=args.n_workers,
                            ref_parity=args.ref_parity)


if __name__ == "__main__":
    main()
