"""Generation server.

Counterpart of `polyphemus_tpu/serve.py`: load a model directory once, keep
one generator per batch *tier* (1 / 8 / 64 / batch_cap by default) so a
small request does not pay for a full batch — each request routes to the
smallest tier >= n, pads to it, and slices the outputs. MIDI renders on the
host; HTTP is the standard library.

    python -m polyphemus_tpu_torch.cli.serve MODEL_DIR --port 8000

API:
  GET  /healthz (alias: /health)
      -> {"status": "ok", "model": ..., "n_bars": N, "batch_cap": B,
          "tiers": [...]}
  POST /generate   {"n": 4, "seed": 123,
                    "structure": [[...]] optional conditioning tensor,
                    "structure_temp": 0.0, "content_temp": 0.0,
                    "format": "midi" | "tokens"}
      -> {"midi_b64": [...]} (one standard MIDI file per sequence)
         or {"tokens": [...], "mask": [...]}.

Device work is serialized by a lock. Concurrent compatible requests (same
temperatures and conditioning) are coalesced: while the device runs one
call, queued requests merge into a single padded tier call. Outputs come
back as uint8. z is drawn on the host from numpy's PCG64 (`host_z`), so a
seed gives the same z in both packages. Generators are cached per (tier,
temps, conditioned) in a bounded LRU, with temperatures quantized to 2
decimals.
"""
from __future__ import annotations

import base64
import json
import threading
from collections import OrderedDict, deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence

import numpy as np

from . import generate as G

_MAX_CACHED_GENERATORS = 24


class _Work:
    """One pending /generate request inside the coalescer."""
    __slots__ = ("key", "z", "s", "event", "out", "err")

    def __init__(self, key, z, s):
        self.key = key          # (s_temp_q, c_temp_q, conditioned)
        self.z = z              # (n, d) rows for this request
        self.s = s              # (n, ...) structure rows or None
        self.event = threading.Event()
        self.out = None         # (mask[n], tokens[n])
        self.err = None


def host_z(seed: int, n: int, d: int) -> np.ndarray:
    """z ~ N(0, I) drawn on the host (numpy PCG64, deterministic per seed;
    the same numbers as `polyphemus_tpu.serve.host_z`)."""
    return np.random.default_rng(seed).standard_normal(
        (n, d)).astype(np.float32)


def _quantize_temp(t) -> float:
    """2-decimal temperatures bound the generator cache; a positive
    temperature never quantizes to 0 (that would turn sampling into
    argmax)."""
    t = float(t)
    if t < 0:
        raise ValueError("temperatures must be >= 0")
    q = round(t, 2)
    if t > 0 and q == 0.0:
        q = 0.01
    return q


class GenerationService:
    """Model + generator cache, independent of the HTTP layer."""

    def __init__(self, model_dir: str, batch_cap: int = 256,
                 tiers: Optional[Sequence[int]] = None,
                 coalesce: bool = True, device=None):
        self.model_dir = model_dir
        self.batch_cap = batch_cap
        if tiers is None:
            tiers = [t for t in (1, 8, 64) if t < batch_cap] + [batch_cap]
        self.tiers = sorted(set(int(t) for t in tiers))
        if self.tiers[0] < 1:
            raise ValueError("tiers must be >= 1")
        if self.tiers[-1] != batch_cap:
            raise ValueError("largest tier must equal batch_cap")
        self.device = G.resolve_device(device)
        self.model, self.cfg = G.load_model(model_dir, self.device)
        self.mc = self.cfg.model
        self._gens: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self.coalesce = bool(coalesce)
        # device_calls counts tier calls; coalesced_requests counts the
        # requests that shared one
        self.stats = {"device_calls": 0, "requests": 0,
                      "coalesced_requests": 0}
        self._pending: deque = deque()
        self._pending_cv = threading.Condition()
        self._dispatcher: Optional[threading.Thread] = None
        if self.coalesce:
            self._dispatcher = threading.Thread(
                target=self._dispatch_loop, daemon=True,
                name="poly-serve-dispatch")
            self._dispatcher.start()

    def tier_for(self, n: int) -> int:
        for t in self.tiers:
            if n <= t:
                return t
        raise ValueError(f"n must be in [1, {self.batch_cap}]")

    def _generator_locked(self, s_temp: float, c_temp: float,
                          conditioned: bool):
        """Caller must hold self._lock. Generators do not depend on the
        tier (PyTorch runs eagerly), only on temperatures and conditioning."""
        key = (_quantize_temp(s_temp), _quantize_temp(c_temp),
               bool(conditioned))
        gen = self._gens.get(key)
        if gen is None:
            gen = G.make_generator(
                self.model, conditioned=conditioned, structure_temp=key[0],
                content_temp=key[1],
                sample_seed=int(key[0] * 1e3 + key[1]) & 0x7FFFFFFF,
                device=self.device)
            self._gens[key] = gen
            while len(self._gens) > _MAX_CACHED_GENERATORS:
                self._gens.popitem(last=False)
        else:
            self._gens.move_to_end(key)
        return gen

    def warmup(self, all_tiers: bool = True):
        """One call per tier: builds the kernels and warms the allocator."""
        with self._lock:
            gen = self._generator_locked(0.0, 0.0, False)
            for tier in (self.tiers if all_tiers else self.tiers[-1:]):
                gen(np.zeros((tier, self.mc.d), np.float32))
            if self.device.type == "cuda":
                import torch

                torch.cuda.synchronize(self.device)

    def generate(self, n: int, seed: int = 0, structure=None,
                 structure_temp: float = 0.0, content_temp: float = 0.0):
        """Returns (mask, tokens) numpy arrays for n sequences."""
        if not 1 <= n <= self.batch_cap:
            raise ValueError(f"n must be in [1, {self.batch_cap}]")
        z = host_z(seed, n, self.mc.d)
        cond = structure is not None
        s_rows = None
        if cond:
            s = G.load_structure_array(
                np.asarray(structure, dtype=bool), self.mc.n_bars,
                self.mc.n_tracks, self.mc.n_timesteps)
            s_rows = np.broadcast_to(s, (n,) + s.shape)
        key = (_quantize_temp(structure_temp), _quantize_temp(content_temp),
               cond)
        if not self.coalesce:
            return self._run_batch(key, z, s_rows, [n])[0]
        work = _Work(key, z, s_rows)
        with self._pending_cv:
            self._pending.append(work)
            self._pending_cv.notify()
        work.event.wait()
        if work.err is not None:
            raise work.err
        return work.out

    def _run_batch(self, key, z_rows, s_rows, sizes):
        """Pad z_rows to the smallest tier, run one device call, split the
        outputs back into per-request (mask, tokens) chunks of `sizes`. The
        device-to-host copy happens inside the lock: while it runs, pending
        requests accumulate into the next, larger call."""
        n_total = z_rows.shape[0]
        tier = self.tier_for(n_total)
        z_pad = np.zeros((tier,) + z_rows.shape[1:], z_rows.dtype)
        z_pad[:n_total] = z_rows
        with self._lock:
            gen = self._generator_locked(key[0], key[1], key[2])
            if key[2]:  # conditioned: pad structure rows with the last one
                s_pad = np.concatenate(
                    [s_rows] + [s_rows[-1:]] * (tier - n_total), axis=0)
                out = gen(z_pad, s_pad)
            else:
                out = gen(z_pad)
            mask, tokens = out[0].cpu().numpy(), out[1].cpu().numpy()
            self.stats["device_calls"] += 1
            self.stats["requests"] += len(sizes)
            if len(sizes) > 1:
                self.stats["coalesced_requests"] += len(sizes)
        res, off = [], 0
        for sz in sizes:
            res.append((mask[off:off + sz], tokens[off:off + sz]))
            off += sz
        return res

    def _dispatch_loop(self):
        """Continuous micro-batching: drain the longest compatible FIFO
        prefix of pending requests into one tier call."""
        while True:
            with self._pending_cv:
                while not self._pending:
                    self._pending_cv.wait()
                batch = [self._pending.popleft()]
                rows = batch[0].z.shape[0]
                while (self._pending
                       and self._pending[0].key == batch[0].key
                       and rows + self._pending[0].z.shape[0]
                       <= self.batch_cap):
                    w = self._pending.popleft()
                    batch.append(w)
                    rows += w.z.shape[0]
            try:
                z = np.concatenate([w.z for w in batch], axis=0)
                s = (np.concatenate([w.s for w in batch], axis=0)
                     if batch[0].key[2] else None)
                outs = self._run_batch(batch[0].key, z, s,
                                       [w.z.shape[0] for w in batch])
                for w, o in zip(batch, outs):
                    w.out = o
            except BaseException as e:  # propagate to every waiter
                for w in batch:
                    w.err = e
            finally:
                for w in batch:
                    w.event.set()

    def render_midi(self, mask: np.ndarray, tokens: np.ndarray) -> bytes:
        """One sequence's (mask, tokens) -> standard MIDI file bytes."""
        from .midi.writer import midi_bytes

        return midi_bytes(G.song_from_tokens(tokens, mask, self.mc.resolution))


def make_handler(svc: GenerationService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/healthz", "/health"):
                self._send(200, {
                    "status": "ok", "model": svc.model_dir,
                    "n_bars": svc.mc.n_bars, "d": svc.mc.d,
                    "batch_cap": svc.batch_cap, "tiers": svc.tiers,
                    "coalesce": svc.coalesce, "device": str(svc.device),
                    "stats": dict(svc.stats),
                })
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/generate":
                self._send(404, {"error": "unknown path"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                n = int(req.get("n", 1))
                mask, tokens = svc.generate(
                    n, seed=int(req.get("seed", 0)),
                    structure=req.get("structure"),
                    structure_temp=float(req.get("structure_temp", 0.0)),
                    content_temp=float(req.get("content_temp", 0.0)))
                if req.get("format", "midi") == "tokens":
                    self._send(200, {"mask": mask.tolist(),
                                     "tokens": tokens.tolist()})
                    return
                mids = [base64.b64encode(
                    svc.render_midi(mask[i], tokens[i])).decode()
                    for i in range(n)]
                self._send(200, {"midi_b64": mids})
            except ValueError as e:
                self._send(400, {"error": str(e)})
            except Exception as e:  # pragma: no cover - defensive
                self._send(500, {"error": repr(e)})

    return Handler


def serve(model_dir: str, host: str = "127.0.0.1", port: int = 8000,
          batch_cap: int = 256, warmup: bool = True,
          tiers: Optional[Sequence[int]] = None, coalesce: bool = True,
          device=None):
    """Build the service and its HTTP server; returns (server, service).
    The caller runs `server.serve_forever()`."""
    svc = GenerationService(model_dir, batch_cap=batch_cap, tiers=tiers,
                            coalesce=coalesce, device=device)
    if warmup:
        svc.warmup()
    httpd = ThreadingHTTPServer((host, port), make_handler(svc))
    return httpd, svc
