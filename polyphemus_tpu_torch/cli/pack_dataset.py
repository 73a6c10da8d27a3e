"""Pack a per-sample .npz dataset directory into large shards, with the
flags of `polyphemus_tpu.cli.pack_dataset`.

    python -m polyphemus_tpu_torch.cli.pack_dataset SAMPLE_DIR OUT_DIR \
        --n_bars 2 [--shard_size 4096]

`cli.train` reads OUT_DIR (its `shards.json`) through the native gather.
"""
from __future__ import annotations

import argparse

from ..data.sharded import pack_dataset


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Packs per-sample npz files into sharded npz files for "
                    "fast training input.")
    p.add_argument("sample_dir", type=str)
    p.add_argument("out_dir", type=str)
    p.add_argument("--n_bars", type=int, default=2)
    p.add_argument("--shard_size", type=int, default=4096)
    args = p.parse_args(argv)
    n = pack_dataset(args.sample_dir, args.out_dir, args.n_bars,
                     args.shard_size)
    print(f"Packed {n} samples into {args.out_dir}")


if __name__ == "__main__":
    main()
