"""Plots: structure heatmap, pianoroll, training curves.

Counterpart of `polyphemus_tpu/plotting.py`, drawing the same figures. The
pianoroll is drawn from the port's `midi.song.Song`; the training curves
read the meta file `<name>.json` that the trainer writes beside each
checkpoint. matplotlib is imported inside each function, with the Agg
backend: the package imports without it.
"""
from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np

from . import constants
from .midi.song import Song


def plot_structure(mask: np.ndarray, save_dir: Optional[str] = None,
                   name: str = "structure"):
    """Binary activation heatmap, written as `<save_dir>/<name>.svg`.

    mask: (n_bars, n_tracks, n_timesteps).
    """
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    n_bars, n_tracks, n_ts = mask.shape
    resolution = n_ts // 4
    flat = mask.transpose(1, 0, 2).reshape(n_tracks, -1)

    plt.figure(figsize=(3 * n_bars, 3))
    plt.pcolormesh(flat, edgecolors="k", linewidth=1)
    ax = plt.gca()
    plt.xticks(range(0, flat.shape[1], resolution),
               range(1, 4 * n_bars + 1))
    plt.yticks(range(n_tracks), constants.TRACKS)
    ax.invert_yaxis()
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        plt.savefig(os.path.join(save_dir, name + ".svg"), format="svg")
    plt.close()


def plot_pianoroll(song: Song, save_dir: Optional[str] = None,
                   name: str = "pianoroll"):
    """Per-track pianoroll of a Song, written as `<save_dir>/<name>.png`."""
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    n = max(len(song.tracks), 1)
    fig, axs = plt.subplots(n, sharex=True, figsize=(20, 10))
    if n == 1:
        axs = [axs]
    end = max(song.end_time(), 1)
    for ax, track in zip(axs, song.tracks):
        for note in track.notes:
            ax.broken_barh([(note.time, note.duration)],
                           (note.pitch - 0.4, 0.8))
        ax.set_ylabel(track.name)
        ax.set_xlim(0, end)
        ax.set_ylim(0, 128)
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        plt.savefig(os.path.join(save_dir, name + ".png"), dpi=150)
    plt.close(fig)


def _load_meta(model_dir: str, name: str = "checkpoint") -> dict:
    with open(os.path.join(model_dir, name + ".json")) as f:
        return json.load(f)


def plot_losses(model_dir: str, losses: Sequence[str],
                plot_val: bool = False, save_path: Optional[str] = None):
    """Loss curves (training, and validation with `plot_val`) from the
    meta file `<model_dir>/checkpoint.json`."""
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    meta = _load_meta(model_dir)
    plt.figure()
    for key in losses:
        hist = meta["tr_losses"].get(key, [])
        plt.plot(range(1, len(hist) + 1), hist, label=f"{key} (TR)")
        if plot_val and key in meta.get("val_losses", {}):
            v = meta["val_losses"][key]
            plt.plot(np.linspace(1, len(hist), num=len(v)), v, ".",
                     label=f"{key} (VL)")
    plt.grid(); plt.legend(); plt.xlim(0)
    if save_path:
        plt.savefig(save_path, dpi=150)
    plt.close()


def plot_accuracies(model_dir: str, accuracies: Sequence[str],
                    plot_val: bool = False, save_path: Optional[str] = None):
    """Accuracy curves from the same meta file."""
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    meta = _load_meta(model_dir)
    plt.figure()
    for key in accuracies:
        hist = meta["tr_accuracies"].get(key, [])
        plt.plot(range(1, len(hist) + 1), hist, label=f"{key} (TR)")
        if plot_val and key in meta.get("val_accuracies", {}):
            v = meta["val_accuracies"][key]
            plt.plot(np.linspace(1, len(hist), num=len(v)), v, ".",
                     label=f"{key} (VL)")
    plt.grid(); plt.legend(); plt.xlim(0); plt.ylim(0, 1)
    if save_path:
        plt.savefig(save_path, dpi=150)
    plt.close()
