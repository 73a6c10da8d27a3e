"""Download pretrained Polyphemus models from Hugging Face, as
`polyphemus_tpu.cli.download_models` does. The published LMD2/LMD16
checkpoints are reference (PyTorch) directories: `generate.load_model`
reads them as they are, and `python -m polyphemus_tpu_torch.cli.convert`
turns them into port directories.

    python -m polyphemus_tpu_torch.cli.download_models MODELS_DIR
"""
from __future__ import annotations

import argparse

REPO_ID = "EmanueleCosenza/polyphemus"


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Downloads pretrained Polyphemus models from HF.")
    p.add_argument("models_dir", type=str)
    args = p.parse_args(argv)
    try:
        from huggingface_hub import snapshot_download
    except ImportError:
        raise SystemExit("huggingface_hub is not installed in this "
                         "environment; download the checkpoints on a "
                         "network-connected machine and copy them here.")
    path = snapshot_download(repo_id=REPO_ID, local_dir=args.models_dir)
    print(f"Models successfully downloaded in {path}")


if __name__ == "__main__":
    main()
