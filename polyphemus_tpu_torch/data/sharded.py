"""Sharded dataset format: many samples per .npz file.

A copy of `polyphemus_tpu/data/sharded.py` (numpy only). The reference
stores one sample per .npz and pays a file open and parse per sample per
epoch; a shard holds N samples as two stacked arrays instead:

    tokens: (N, n_bars, T, S, MAX_SIMU_TOKENS, 2) int16
    mask:   (N, n_bars, T, S) bool

`pack_dataset` converts a per-sample directory (through `PolyphemusDataset`,
so a packed mask carries the empty-bar fix-up) and writes the index
`shards.json`; `ShardedDataset` serves samples with an LRU of loaded shards
and is a drop-in for PolyphemusDataset in BatchLoader, whose worker threads
share it: a lock guards the LRU (the JAX package's has none, and a thread
could read a shard that another had just evicted). Training reads a packed
directory through `fastloader.FastShardedBatcher`.
"""
from __future__ import annotations

import json
import os
import threading
from typing import List, Tuple

import numpy as np

from .dataset import PolyphemusDataset

INDEX_NAME = "shards.json"


def pack_dataset(sample_dir: str, out_dir: str, n_bars: int,
                 shard_size: int = 4096) -> int:
    """Per-sample npz directory -> sharded directory. Returns sample count."""
    ds = PolyphemusDataset(sample_dir, n_bars)
    os.makedirs(out_dir, exist_ok=True)
    index = {"n_bars": n_bars, "shard_size": shard_size, "shards": []}
    total = 0
    buf_t: List[np.ndarray] = []
    buf_m: List[np.ndarray] = []

    def flush():
        nonlocal total
        if not buf_t:
            return
        name = f"shard_{len(index['shards']):05d}.npz"
        np.savez(os.path.join(out_dir, name),
                 tokens=np.stack(buf_t).astype(np.int16),
                 mask=np.stack(buf_m))
        index["shards"].append({"file": name, "n": len(buf_t)})
        total += len(buf_t)
        buf_t.clear()
        buf_m.clear()

    for i in range(len(ds)):
        toks, mask = ds[i]
        buf_t.append(np.asarray(toks, np.int16))
        buf_m.append(np.asarray(mask, bool))
        if len(buf_t) >= shard_size:
            flush()
    flush()
    with open(os.path.join(out_dir, INDEX_NAME), "w") as f:
        json.dump(index, f)
    return total


class ShardedDataset:
    """Random access over a packed shard directory (BatchLoader-compatible)."""

    def __init__(self, directory: str, n_bars: int | None = None,
                 cache_shards: int = 2):
        self.dir = directory
        with open(os.path.join(directory, INDEX_NAME)) as f:
            self.index = json.load(f)
        if n_bars is not None and self.index["n_bars"] != n_bars:
            raise ValueError(
                f"shard n_bars={self.index['n_bars']} != requested {n_bars}")
        self.offsets = []
        off = 0
        for sh in self.index["shards"]:
            self.offsets.append(off)
            off += sh["n"]
        self.total = off
        self._cache: dict = {}
        self._cache_order: List[int] = []
        self._lock = threading.Lock()
        self.cache_shards = cache_shards

    def __len__(self):
        return self.total

    def _shard(self, si: int) -> Tuple[np.ndarray, np.ndarray]:
        with self._lock:
            if si not in self._cache:
                path = os.path.join(self.dir,
                                    self.index["shards"][si]["file"])
                with np.load(path) as z:
                    self._cache[si] = (z["tokens"], z["mask"])
                self._cache_order.append(si)
                if len(self._cache_order) > self.cache_shards:
                    evict = self._cache_order.pop(0)
                    self._cache.pop(evict, None)
            return self._cache[si]

    def __getitem__(self, idx: int):
        if idx < 0 or idx >= self.total:
            raise IndexError(idx)
        si = int(np.searchsorted(self.offsets, idx, side="right") - 1)
        toks, mask = self._shard(si)
        j = idx - self.offsets[si]
        return toks[j], mask[j]
