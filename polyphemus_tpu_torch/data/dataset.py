"""Dataset and host data loading.

Counterpart of `polyphemus_tpu/data/dataset.py` (numpy only). Reads the
reference's per-sample `.npz` format (c_tensor int16 (n_tracks,
n_bars*S, 16, 2), s_tensor bool (n_tracks, n_bars*S)) and returns dense
fixed-shape arrays:
    tokens (n_bars, T, S, 16, 2) int16, mask (n_bars, T, S) bool.

There is no per-sample graph building and no one-hot expansion in the
loader: adjacency comes from the mask on the device, embeddings take the
token ids. __getitem__ is np.load + reshape, so a thread pool saturates it;
batches are assembled as single numpy arrays and, with `device_put_fn`
(`Trainer.to_device`: pinned memory, then an asynchronous copy to the card),
prefetched onto the device by the loader thread. A dataset that has
`gather_batch` (a packed shard directory read by
`fastloader.FastShardedBatcher`, `shards.json`) gives whole batches instead:
its native gather releases the GIL, so it runs beside the step in the
loader thread.
"""
from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Sequence

import numpy as np

from .. import constants


def _fixup_empty_bars(mask: np.ndarray) -> np.ndarray:
    """Host-side ensure_nonempty_bars: cell [0, 0] of an empty bar."""
    empty = ~mask.any(axis=(-1, -2))
    if empty.any():
        mask = mask.copy()
        mask[empty, 0, 0] = True
    return mask


def load_sample(path: str, n_bars: int):
    """One reference-format .npz -> (tokens, mask)."""
    data = np.load(path)
    c = np.asarray(data["c_tensor"], np.int16)
    s = np.asarray(data["s_tensor"], bool)
    t = c.shape[0]
    c = c.reshape(t, n_bars, -1, c.shape[2], c.shape[3]).transpose(1, 0, 2, 3, 4)
    s = s.reshape(t, n_bars, -1).transpose(1, 0, 2)
    return c, _fixup_empty_bars(s)


def write_sample(path: str, tokens: np.ndarray, mask: np.ndarray) -> None:
    """The inverse of `load_sample`: (tokens (n_bars, T, S, 16, 2), mask
    (n_bars, T, S)) -> one reference-format .npz."""
    n_bars, t, s = mask.shape
    c = np.asarray(tokens, np.int16).transpose(1, 0, 2, 3, 4).reshape(
        t, n_bars * s, tokens.shape[-2], tokens.shape[-1])
    np.savez(path, c_tensor=c,
             s_tensor=np.asarray(mask, bool).transpose(1, 0, 2).reshape(
                 t, n_bars * s))


class PolyphemusDataset:
    """Directory of per-sample .npz files."""

    def __init__(self, directory: str, n_bars: int = 2):
        self.dir = directory
        self.files = sorted(
            e.name for e in os.scandir(directory) if e.is_file())
        self.n_bars = n_bars

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx: int):
        return load_sample(os.path.join(self.dir, self.files[idx]),
                           self.n_bars)


def shard_rows(batch: int, microbatches: int, pid: int,
               pcount: int) -> np.ndarray:
    """The rows of a global batch of `batch` that process `pid` of
    `pcount` takes: its slice of each of the `microbatches` microbatches,
    global rows [i*mb + pid*mb/pcount, i*mb + (pid+1)*mb/pcount) for
    microbatch i of mb = batch / microbatches rows. Local microbatch i of
    every process together is then global microbatch i; with one
    microbatch this is the contiguous slice the JAX package takes."""
    mb, rest = divmod(batch, microbatches)
    if rest or mb % pcount:
        raise ValueError(
            f"a batch of {batch} in {microbatches} microbatches does not "
            f"split evenly over {pcount} processes")
    per = mb // pcount
    return np.concatenate([np.arange(i * mb + pid * per,
                                     i * mb + (pid + 1) * per)
                           for i in range(microbatches)])


class BatchLoader:
    """Shuffling batch iterator with threaded loading and device prefetch:
    share-nothing worker threads (np.load releases the GIL) fill a bounded
    queue of ready batches.

    `shard=(pid, pcount)` makes it one of `pcount` data-parallel
    processes: every process builds the same global batch order (the same
    `seed`) and loads only its rows of each global batch (`shard_rows`,
    over the `microbatches` the train step splits a batch into). The batch
    size must be divisible by `pcount` (and each microbatch, too). Every
    process yields the same number of batches: without `drop_last`, a last
    batch that does not split evenly raises."""

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = True,
                 seed: int = 0, num_workers: int = 8, drop_last: bool = True,
                 prefetch: int = 2, device_put_fn=None,
                 shard: tuple = (0, 1), microbatches: int = 1):
        self.ds = dataset
        self.bs = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.workers = num_workers
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.device_put_fn = device_put_fn
        self.shard = tuple(shard)
        self.microbatches = microbatches
        shard_rows(batch_size, microbatches, *self.shard)  # refuse early

    def __len__(self):
        n = len(self.ds)
        return n // self.bs if self.drop_last else -(-n // self.bs)

    def _load_batch(self, idxs: Sequence[int], pool: ThreadPoolExecutor):
        if hasattr(self.ds, "gather_batch"):
            # batch-level path (the native gather over packed shards)
            toks, mask = self.ds.gather_batch(np.asarray(idxs))
        else:
            samples = list(pool.map(self.ds.__getitem__, idxs))
            toks = np.stack([s[0] for s in samples]).astype(np.int32)
            mask = np.stack([s[1] for s in samples])
        if self.device_put_fn is not None:
            return self.device_put_fn(toks, mask)
        return toks, mask

    def __iter__(self) -> Iterator:
        order = np.arange(len(self.ds))
        if self.shuffle:
            self.rng.shuffle(order)
        batches = [order[i * self.bs:(i + 1) * self.bs]
                   for i in range(len(self))]
        if self.shard[1] > 1:
            batches = [b[shard_rows(len(b), self.microbatches, *self.shard)]
                       for b in batches]

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()

        def put(item) -> bool:
            # q.put with a stop check: if the consumer abandons iteration
            # (early break / GC), the producer must not block on a full
            # queue forever — it exits at the next timeout instead.
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(self.workers) as pool:
                    for idxs in batches:
                        if stop.is_set():
                            return
                        if not put(self._load_batch(idxs, pool)):
                            return
                put(sentinel)
            except BaseException as e:  # propagate to the consumer
                put(e)

        th = threading.Thread(target=producer, daemon=True)
        th.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()


def synthetic_batch(rng: np.random.Generator, batch_size: int, n_bars: int,
                    n_tracks: int = constants.N_TRACKS, n_timesteps: int = 32,
                    density: float = 0.15):
    """Random (tokens, mask) batch for smoke tests and benchmarks."""
    mask = rng.random((batch_size, n_bars, n_tracks, n_timesteps)) < density
    mask = _fixup_empty_bars(mask.reshape(-1, n_tracks, n_timesteps)).reshape(
        mask.shape)
    shape = (batch_size, n_bars, n_tracks, n_timesteps,
             constants.MAX_SIMU_TOKENS)
    pitch = rng.integers(0, constants.N_PITCH_TOKENS, shape)
    dur = rng.integers(0, constants.N_DUR_TOKENS, shape)
    pitch[..., 0] = constants.PitchToken.SOS
    dur[..., 0] = constants.DurationToken.SOS
    return (np.stack([pitch, dur], axis=-1).astype(np.int32), mask)
