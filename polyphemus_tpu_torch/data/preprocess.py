"""Offline MIDI -> tensor preprocessing.

A copy of `polyphemus_tpu/data/preprocess.py` (numpy only), on the port's
MIDI parser. The pipeline of the reference's preprocess.py (pypianoroll and
muspy based), on a dependency-free parser:

  1. parse + quantize to `resolution` steps/quarter; keep only 4/4 songs;
  2. bucket tracks by MIDI program: drums / bass (32-39) / guitar (0-31) /
     strings (>39), require all four families present;
  3. strings tracks merge via pianoroll max-blend; every track round-trips
     through a pianoroll (so overlapping same-pitch notes merge exactly as
     muspy.from_pypianoroll does);
  4. per (drums x bass x guitar) combination, pack per-timestep token lists
     (SOS + up to 14 (pitch, dur) pairs + EOS, PAD elsewhere) and boolean
     onset activations;
  5. slide a bar-stride window, drop windows with >= 1 bar of consecutive
     per-track silence or a fully silent bar, randomly transpose non-drums
     by -5..+6 semitones, and save one .npz per window (STORED members, the
     sample format the trainer reads).

Known deviation (fixed by default, reproducible): the reference's
consecutive-silence filter has a cross-track false positive (np.diff across
the track-major flattened silent-bar list), so it drops some windows kept
here. Pass ref_parity=True (CLI: --ref_parity) for sample-for-sample
comparability.

`preprocess_midi_dataset` runs its files in a `multiprocessing.Pool` whose
workers are spawned, not forked as in the JAX package: its caller may hold
threads and a CUDA context (a trainer's process), which a forked child
would inherit. The workers run numpy and the MIDI parser only.
"""
from __future__ import annotations

import io
import itertools
import multiprocessing
import os
import struct
import time
import zlib
from struct import error as struct_error
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .. import constants
from ..midi.parser import MidiParseError, quantize_song, read_midi
from ..midi.song import Note, Song, Track


# --------------------------------------------------------------- pianoroll glue
def notes_to_pianoroll(notes: Sequence[Note], length: int) -> np.ndarray:
    roll = np.zeros((length, 128), np.uint8)
    for n in notes:
        if n.pitch < 0 or n.pitch > 127:
            continue
        start = max(n.time, 0)
        end = min(n.time + max(n.duration, 1), length)
        if end > start:
            roll[start:end, n.pitch] = np.maximum(
                roll[start:end, n.pitch], max(n.velocity, 1))
    return roll


def _roll_events(roll: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pianoroll -> (times, pitches, durations) arrays, sorted by
    (time, pitch) — the vectorized core of pianoroll_to_notes (one diff +
    two nonzero over the whole roll instead of a Python loop per pitch)."""
    padded = np.zeros((roll.shape[0] + 2, roll.shape[1]), bool)
    padded[1:-1] = roll > 0
    diff = np.diff(padded.astype(np.int8), axis=0)
    st_t, st_p = np.nonzero(diff == 1)
    en_t, en_p = np.nonzero(diff == -1)
    # within one pitch the k-th start pairs with the k-th end, so sorting
    # both sides by (pitch, time) aligns every start with its end
    so = np.lexsort((st_t, st_p))
    eo = np.lexsort((en_t, en_p))
    st_t, st_p = st_t[so], st_p[so]
    dur = en_t[eo] - st_t
    order = np.lexsort((st_p, st_t))  # the reference's (time, pitch) sort
    return st_t[order], st_p[order], dur[order]


def pianoroll_to_notes(roll: np.ndarray) -> List[Note]:
    """Consecutive active steps of one pitch -> one note (muspy
    from_pypianoroll semantics), sorted by (time, pitch)."""
    times, pitches, durs = _roll_events(roll)
    return [Note(int(t), int(p), int(d), 64)
            for t, p, d in zip(times, pitches, durs)]


# ------------------------------------------------------------------ tokenization
def pack_track(notes: Sequence[Note], length: int):
    """Notes -> (content (length, 16, 2) int16, activations (length,) bool)
    (the reference's preprocess.py packing)."""
    msim = constants.MAX_SIMU_TOKENS
    content = np.zeros((length, msim, 2), np.int16)
    content[:, :, 0] = constants.PitchToken.PAD
    content[:, 0, 0] = constants.PitchToken.SOS
    content[:, :, 1] = constants.DurationToken.PAD
    content[:, 0, 1] = constants.DurationToken.SOS

    counter = np.ones(length, np.int16)
    for n in notes:
        t = n.time
        if t < 0 or t >= length or counter[t] >= msim - 1:
            continue
        pitch = min(max(n.pitch, 0), constants.MAX_PITCH_TOKEN)
        dur = min(max(n.duration, 1), constants.MAX_DUR_TOKEN + 1)
        content[t, counter[t], 0] = pitch
        content[t, counter[t], 1] = dur - 1
        counter[t] += 1

    t_range = np.arange(length)
    content[t_range, counter, 0] = constants.PitchToken.EOS
    content[t_range, counter, 1] = constants.DurationToken.EOS
    activations = (counter - 1).astype(bool)
    return content, activations


def _pack_track_events(times: np.ndarray, pitches: np.ndarray,
                       durs: np.ndarray, length: int):
    """Vectorized pack_track for event arrays already sorted by
    (time, pitch) — exactly the order pianoroll_to_notes yields, so this is
    behavior-identical to pack_track(pianoroll_to_notes(roll), length)
    (the tests hold the two against each other)."""
    msim = constants.MAX_SIMU_TOKENS
    content = np.empty((length, msim, 2), np.int16)
    content[:, :, 0] = constants.PitchToken.PAD
    content[:, 0, 0] = constants.PitchToken.SOS
    content[:, :, 1] = constants.DurationToken.PAD
    content[:, 0, 1] = constants.DurationToken.SOS

    ok = (times >= 0) & (times < length)
    times, pitches, durs = times[ok], pitches[ok], durs[ok]
    # slot rank within each timestep; (time, pitch)-sorted input means
    # rank order matches pack_track's insertion order
    rank = np.arange(times.size) - np.searchsorted(times, times, side="left")
    keep = rank < msim - 2  # pack_track caps at 14 notes per step
    t_k, r_k = times[keep], rank[keep]
    content[t_k, 1 + r_k, 0] = np.clip(pitches[keep], 0,
                                       constants.MAX_PITCH_TOKEN)
    content[t_k, 1 + r_k, 1] = np.clip(durs[keep], 1,
                                       constants.MAX_DUR_TOKEN + 1) - 1

    counter = 1 + np.bincount(t_k, minlength=length)
    t_range = np.arange(length)
    content[t_range, counter, 0] = constants.PitchToken.EOS
    content[t_range, counter, 1] = constants.DurationToken.EOS
    return content, counter > 1


def _keep_window(s_tensor: np.ndarray, n_bars: int,
                 *, ref_parity: bool = False) -> bool:
    """Silence filters (the reference's preprocess.py).

    The reference's consecutive-silence check runs np.diff over the bar
    indices of ALL silent (track, bar) cells flattened track-major, so a
    silent bar in track t followed by the *next* bar silent in track t+1
    also drops the window — a cross-track false positive. Default here:
    per-track consecutive silence only (the clear intent). ref_parity=True
    reproduces the reference filter exactly, for sample-for-sample dataset
    comparability.
    """
    if n_bars > 1:
        bars = s_tensor.reshape(s_tensor.shape[0], n_bars, -1)
        bars_acts = np.any(bars, axis=2)
        if ref_parity:
            # literal reference semantics: diff across the flattened list
            if 1 in np.diff(np.where(~bars_acts)[1]):
                return False
        else:
            # >= 2 consecutive silent bars within one track
            silent = ~bars_acts
            if (silent[:, :-1] & silent[:, 1:]).any():
                return False
        # a completely silent bar
        if (~bars_acts.any(axis=0)).any():
            return False
        return True
    return bool(np.any(s_tensor))


def transpose_non_drums(c_tensor: np.ndarray,
                        rng: np.random.Generator) -> None:
    """Random -5..+6 semitone shift of non-drum pitches, in place
    (as the reference's preprocess.py)."""
    shift = int(rng.integers(-5, 7))
    pitches = c_tensor[1:, :, :, 0]
    cond = ((pitches != constants.PitchToken.PAD)
            & (pitches != constants.PitchToken.SOS)
            & (pitches != constants.PitchToken.EOS))
    shifted = np.clip(pitches + shift, 0, constants.MAX_PITCH_TOKEN)
    c_tensor[1:, :, :, 0] = np.where(cond, shifted, pitches)


# ------------------------------------------------------------------ fast npz
_NPY_HEADER_CACHE: dict = {}


def _npy_header(arr: np.ndarray) -> bytes:
    key = (arr.dtype.str, arr.shape)
    hdr = _NPY_HEADER_CACHE.get(key)
    if hdr is None:
        buf = io.BytesIO()
        # write_array_header_1_0 emits the \x93NUMPY magic itself
        np.lib.format.write_array_header_1_0(buf, {
            "descr": np.lib.format.dtype_to_descr(arr.dtype),
            "fortran_order": False, "shape": arr.shape})
        hdr = _NPY_HEADER_CACHE[key] = buf.getvalue()
    return hdr


def save_npz_uncompressed(path: str, **arrays: np.ndarray) -> str:
    """np.load-compatible uncompressed .npz in one write() call.

    np.savez routes every member through zipfile's buffered CRC wrapper and
    re-formats the npy header per call, once per sample file in the
    reference's one-sample-per-file format. Here the whole archive (STORED
    members, cached npy headers, zlib.crc32, fixed zip times, so the bytes
    depend on the arrays alone) is assembled in memory and written once.
    Appends .npz like np.savez. Returns the final path."""
    if not path.endswith(".npz"):
        path += ".npz"
    blob = bytearray()
    central = bytearray()
    for name, arr in arrays.items():
        fname = (name + ".npy").encode()
        data = _npy_header(arr) + np.ascontiguousarray(arr).tobytes()
        crc = zlib.crc32(data) & 0xFFFFFFFF
        offset = len(blob)
        # local file header: v2.0, no flags, STORED, 1980-01-01 00:00
        blob += struct.pack("<IHHHHHIII HH".replace(" ", ""),
                            0x04034B50, 20, 0, 0, 0, 0x21, crc,
                            len(data), len(data), len(fname), 0)
        blob += fname + data
        central += struct.pack("<IHHHHHHIIIHHHHHII",
                               0x02014B50, 20, 20, 0, 0, 0, 0x21, crc,
                               len(data), len(data), len(fname),
                               0, 0, 0, 0, 0, offset)
        central += fname
    n = len(arrays)
    eocd = struct.pack("<IHHHHIIH", 0x06054B50, 0, 0, n, n,
                       len(central), len(blob), 0)
    with open(path, "wb") as f:
        f.write(bytes(blob) + bytes(central) + eocd)
    return path


# ------------------------------------------------------------------ file pipeline
def preprocess_midi_file(filepath: str, dest_dir: str, n_bars: int,
                         resolution: int,
                         seed: Optional[int] = None,
                         ref_parity: bool = False) -> int:
    """One MIDI file -> .npz samples in dest_dir. Returns samples written.

    ref_parity reproduces the reference's cross-track silence-filter bug
    (see _keep_window) for sample-for-sample dataset comparability.
    """
    filename = os.path.basename(filepath)
    try:
        raw, tpq, time_sigs = read_midi(filepath)
    except (MidiParseError, OSError, IndexError, struct_error):
        print(f"Song skipped (invalid format): {filename}")
        return 0

    for num, den in time_sigs:
        if num != 4 or den != 4:
            print(f"Song skipped ({num}/{den} time signature): {filename}")
            return 0

    song = quantize_song(raw, tpq, resolution)

    drums, basses, guitars, strings = [], [], [], []
    for track in song.tracks:
        if not track.notes:
            continue
        if track.is_drum:
            drums.append(track)
        elif 0 <= track.program <= 31:
            guitars.append(track)
        elif 32 <= track.program <= 39:
            basses.append(track)
        else:
            strings.append(track)
    if not (drums and basses and guitars and strings):
        print(f"Song skipped (missing drum/bass/guitar/strings): {filename}")
        return 0

    bar_steps = 4 * resolution
    rng = np.random.default_rng(seed)
    saved = 0

    def roll_len(tracks):
        return max((n.time + n.duration for t in tracks for n in t.notes),
                   default=0) + 1

    # strings merge once (max-blend, as the reference's preprocess.py)
    for combo in itertools.product(drums, basses, guitars):
        tracks = list(combo) + [strings]
        length = max(roll_len([t]) if not isinstance(t, list)
                     else roll_len(t) for t in tracks)
        if length % bar_steps:
            length += bar_steps - (length % bar_steps)
        if length < n_bars * bar_steps:
            continue

        contents, structures = [], []
        for t in tracks:
            if isinstance(t, list):  # strings family: max-blend
                roll = np.zeros((length, 128), np.uint8)
                for st in t:
                    roll = np.maximum(roll,
                                      notes_to_pianoroll(st.notes, length))
            else:
                roll = notes_to_pianoroll(t.notes, length)
            times, pitches, durs = _roll_events(roll)
            content, acts = _pack_track_events(times, pitches, durs, length)
            contents.append(content)
            structures.append(acts)

        c_all = np.stack(contents)      # (4, length, 16, 2)
        s_all = np.stack(structures)    # (4, length)

        window = n_bars * bar_steps
        for start in range(0, length - window + 1, bar_steps):
            c = np.copy(c_all[:, start:start + window])
            s = np.copy(s_all[:, start:start + window])
            if not _keep_window(s, n_bars, ref_parity=ref_parity):
                continue
            transpose_non_drums(c, rng)
            out = os.path.join(dest_dir, f"{filename}{saved}")
            save_npz_uncompressed(out, c_tensor=c, s_tensor=s)
            saved += 1
    return saved


def preprocess_midi_dataset(midi_dataset_dir: str, preprocessed_dir: str,
                            n_bars: int, resolution: int,
                            n_files: Optional[int] = None,
                            n_workers: int = 1,
                            ref_parity: bool = False) -> None:
    """Recursive parallel sweep (as the reference's preprocess.py)."""
    print("Starting preprocessing")
    start = time.time()
    os.makedirs(preprocessed_dir, exist_ok=True)

    jobs = []
    for dirpath, _, files in os.walk(midi_dataset_dir):
        if n_files is not None and len(jobs) >= n_files:
            break
        for f in files:
            jobs.append((os.path.join(dirpath, f), preprocessed_dir,
                         n_bars, resolution, None, ref_parity))
            if n_files is not None and len(jobs) >= n_files:
                break

    if n_workers > 1:
        with multiprocessing.get_context("spawn").Pool(n_workers) as pool:
            results = pool.starmap(preprocess_midi_file, jobs)
    else:
        results = [preprocess_midi_file(*j) for j in jobs]

    elapsed = time.time() - start
    print(f"Preprocessed {len(jobs)} files -> {sum(results)} samples "
          f"in {elapsed:.1f}s ({len(jobs) / max(elapsed, 1e-9):.1f} files/s)")
