"""Training checkpoints with resume.

Counterpart of `polyphemus_tpu/train/checkpoint.py`, keeping its two-name
scheme: a rolling `checkpoint` and `best_model` on validation improvement.
Each name is two files:

  <name>.pt    {"model": state dict, "optimizer": optimizer state, "step":
               completed updates, "meta": counters and histories}
  <name>.json  the meta alone (the JAX package's meta file, which its
               `plotting` and `cli/stats.py` read)

`checkpoint.pt` is also what `convert.load_checkpoint` and
`generate.load_model` read, so a training directory serves as it is. Both
files are written atomically (beside, then renamed). `AsyncSaver` writes
them on a worker thread from a snapshot taken on the caller's. A run with
tensor parallelism saves the one-process layout (`Trainer.save` gathers the
shards) and cuts it into the rank's shards on load.
"""
from __future__ import annotations

import json
import os
import queue
import threading
from typing import Optional

import numpy as np
import torch

from ..parallel import mesh as pmesh


def path(model_dir: str, name: str) -> str:
    return os.path.join(model_dir, name + ".pt")


def snapshot(model, optimizer, step: int,
             stream: Optional[torch.cuda.Stream] = None,
             state: Optional[dict] = None) -> dict:
    """{"model", "optimizer", "step"} with every tensor a fresh host copy,
    of the model's and optimizer's state dicts or of `state` ({"model",
    "optimizer"}: the whole state of a sharded model).

    Without a stream, every tensor is copied to the host before this
    returns. With one, every CUDA tensor is first cloned on the current
    stream (so later in-place updates cannot reach the copy); only then
    does `stream` wait for the current stream, which orders it after every
    clone, and copy the clones with `non_blocking=True` into pinned host
    memory. The host copies are complete once an event that the caller
    records on `stream` after this call has passed."""
    def fresh(t):
        t = t.detach()
        if stream is None or not t.is_cuda:
            return t.to("cpu", copy=True)
        return t.clone()

    def host(t):
        if not t.is_cuda:
            return t
        t.record_stream(stream)
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        out.copy_(t, non_blocking=True)
        return out

    if state is None:
        state = {"model": model.state_dict(),
                 "optimizer": optimizer.state_dict()}
    snap = _map(state, fresh)
    if stream is not None:
        stream.wait_stream(torch.cuda.current_stream(stream.device))
        with torch.cuda.stream(stream):
            snap = _map(snap, host)
    return dict(snap, step=int(step))


def _map(x, fn):
    """`x` with fn applied to every tensor of its dicts, lists and
    tuples."""
    if torch.is_tensor(x):
        return fn(x)
    if isinstance(x, dict):
        return {k: _map(v, fn) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_map(v, fn) for v in x)
    return x


def write_checkpoint(model_dir: str, name: str, snap: dict,
                     meta: dict) -> None:
    """Atomically write `<name>.pt` (the host snapshot and meta) and
    `<name>.json` (the meta)."""
    os.makedirs(model_dir, exist_ok=True)
    target = path(model_dir, name)
    tmp = target + ".tmp"
    torch.save(dict(snap, meta=meta), tmp)
    os.replace(tmp, target)
    meta_path = os.path.join(model_dir, name + ".json")
    meta_tmp = meta_path + ".tmp"
    with open(meta_tmp, "w") as f:
        json.dump(_jsonable(meta), f)
    os.replace(meta_tmp, meta_path)


class AsyncSaver:
    """Background checkpoint writer.

    `submit` takes the snapshot on the caller's thread (device copies on a
    side stream, then an event) and queues it; one worker thread waits for
    the event and writes, in the order submitted, while training goes on.
    At most `max_pending` snapshots are in flight (each holds a copy of the
    model and optimizer state). A worker error is re-raised on the next
    `submit()` or `wait()`."""

    def __init__(self, max_pending: int = 2):
        self._q: queue.Queue = queue.Queue()
        self._pending = threading.Semaphore(max_pending)
        self._exc: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        self._stream: Optional[torch.cuda.Stream] = None

    def submit(self, model, optimizer, step: int, model_dir: str, name: str,
               meta: dict, state: Optional[dict] = None) -> None:
        self._pending.acquire()  # bound the snapshots in flight
        try:
            self._raise_pending()
            device = next(model.parameters()).device
            if device.type == "cuda" and self._stream is None:
                self._stream = torch.cuda.Stream(device)
            stream = self._stream if device.type == "cuda" else None
            with torch.no_grad():
                snap = snapshot(model, optimizer, step, stream, state)
            event = None
            if stream is not None:
                event = torch.cuda.Event()
                event.record(stream)
        except BaseException:
            self._pending.release()
            raise
        if self._thread is None:
            self._thread = threading.Thread(target=self._worker, daemon=True,
                                            name="checkpoint-saver")
            self._thread.start()
        self._q.put((snap, event, model_dir, name, meta))

    def wait(self) -> None:
        """Block until every submitted save is on disk, then re-raise any
        worker error."""
        self._q.join()
        self._raise_pending()

    def _worker(self) -> None:
        while True:
            snap, event, model_dir, name, meta = self._q.get()
            try:
                if event is not None:
                    event.synchronize()
                write_checkpoint(model_dir, name, snap, meta)
            except Exception as e:  # noqa: BLE001 - re-raised on wait
                self._exc = e
            finally:
                del snap
                self._pending.release()
                self._q.task_done()

    def _raise_pending(self) -> None:
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise RuntimeError("async checkpoint save failed") from exc


def load_checkpoint(model_dir: str, name: str, model, optimizer) -> tuple:
    """Load `<name>.pt` into model and optimizer; returns (step, meta). A
    params-only `<name>.pt` (a bare state dict, as `cli.convert` writes it
    through `convert.save_checkpoint`) loads the weights alone: the
    optimizer stays fresh, at step 0 and an empty meta. Under tensor
    parallelism each rank loads its shards of the one-process layout."""
    obj = torch.load(path(model_dir, name), map_location="cpu",
                     weights_only=True)
    if "optimizer" not in obj:
        model.load_state_dict(pmesh.shard_state_dict(obj))
        return 0, {}
    model.load_state_dict(pmesh.shard_state_dict(obj["model"]))
    optimizer.load_state_dict(pmesh.shard_optimizer_state(
        model, obj["optimizer"]))
    return int(obj["step"]), dict(obj["meta"])


def latest_exists(model_dir: str, name: str = "checkpoint") -> bool:
    return os.path.exists(path(model_dir, name))


def _jsonable(x):
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, np.ndarray):
        return x.tolist()
    if torch.is_tensor(x):
        return x.tolist()
    return x
