"""Native token-tensor -> .mid rendering (ctypes wrapper of
`native/midirender.cpp`).

Counterpart of `polyphemus_tpu/midi/fast_render.py`: the same bytes as
`generate.song_from_tokens` + `midi.writer.midi_bytes` (and
`midi.song.loop_song` for n_loops > 1), rendered in C++. Unlike the JAX
wrapper it never returns None: the library is built at first use or the
call raises, and an output larger than the buffer is rendered again into a
larger one. `renders` counts the native renders.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np

from .. import constants
from ..native import load_midirender

FIRST_CAPACITY = 4 * 1024 * 1024  # bytes of the first output buffer
renders = 0  # native renders


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def render_midi_bytes(tokens: np.ndarray, mask: np.ndarray, resolution: int,
                      programs: Optional[Sequence[int]] = None,
                      n_loops: int = 1, tempo: float = 120.0,
                      track_names: Optional[Sequence[str]] = None) -> bytes:
    """One sample's standard MIDI file: tokens (nb, T, S, n_slots, 2) ids of
    any integer dtype, mask (nb, T, S) bool, both on the host. `programs`
    and `track_names` (one per track) default to the default programs and
    the track names; the drum track (track 0) always takes program 0."""
    global renders
    mask = np.asarray(mask)
    tokens = np.asarray(tokens)
    if (mask.ndim != 3 or tokens.ndim != 5 or tokens.shape[:3] != mask.shape
            or tokens.shape[-1] != 2):
        raise ValueError(f"tokens {tokens.shape} and mask {mask.shape} are "
                         f"not (nb, T, S, n_slots, 2) and (nb, T, S)")
    nb, t, s = mask.shape
    n_slots = tokens.shape[-2]
    if programs is None:
        programs = [constants.DEFAULT_MIDI_PROGRAMS[n] for n in
                    constants.TRACKS[:t]]
    if track_names is None:
        track_names = list(constants.TRACKS[:t])
    if len(programs) != t or len(track_names) != t:
        raise ValueError(f"{len(programs)} programs and {len(track_names)} "
                         f"track names for {t} tracks")
    names = [n.encode("latin-1", "replace")[:127] for n in track_names]
    name_lens = np.asarray([len(n) for n in names], np.int32)
    names_buf = np.frombuffer(b"".join(names) or b"\0", np.uint8).copy()
    toks = np.ascontiguousarray(tokens, np.int32)
    m = np.ascontiguousarray(mask, np.uint8)
    progs = np.ascontiguousarray(programs, np.int32)
    tempo_usec = int(round(60_000_000 / tempo))

    lib = load_midirender()
    cap = FIRST_CAPACITY
    while True:
        out = np.empty(cap, np.uint8)
        n = lib.poly_render_midi(
            _ptr(toks, ctypes.c_int32), _ptr(m, ctypes.c_uint8), nb, t, s,
            n_slots, _ptr(progs, ctypes.c_int32),
            _ptr(names_buf, ctypes.c_uint8), _ptr(name_lens, ctypes.c_int32),
            resolution, max(n_loops, 1), tempo_usec,
            _ptr(out, ctypes.c_uint8), cap)
        if n >= 0:
            break
        cap *= 4  # the file did not fit: render it again into more room
    renders += 1
    return out[:n].tobytes()
