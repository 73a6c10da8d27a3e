"""Minimal built-in software synthesizer: Song -> WAV.

A copy of `polyphemus_tpu/midi/synth.py`. The reference renders audio via
muspy -> fluidsynth + a GM soundfont (its utils.py). When fluidsynth
or a soundfont is unavailable, this pure-numpy additive synth provides a
serviceable preview: band-limited-ish oscillators with ADSR envelopes,
simple per-family timbres and a noise-based drum voice.
"""
from __future__ import annotations

import struct
import wave

import numpy as np

from .song import Song


def _adsr(n, sr, attack=0.005, decay=0.08, sustain=0.6, release=0.05):
    a = int(attack * sr)
    d = int(decay * sr)
    r = int(release * sr)
    s = max(n - a - d - r, 0)
    env = np.concatenate([
        np.linspace(0.0, 1.0, max(a, 1), endpoint=False),
        np.linspace(1.0, sustain, max(d, 1), endpoint=False),
        np.full(s, sustain),
        np.linspace(sustain, 0.0, max(r, 1)),
    ])
    if len(env) < n:
        env = np.pad(env, (0, n - len(env)))
    return env[:n]


def _tone(freq, n, sr, program: int):
    t = np.arange(n) / sr
    ph = 2 * np.pi * freq * t
    if program <= 31:      # piano/guitar-ish: decaying partials
        w = (np.sin(ph) + 0.4 * np.sin(2 * ph) + 0.15 * np.sin(3 * ph))
        w *= np.exp(-2.5 * t)
    elif program <= 39:    # bass: dark, strong fundamental
        w = np.sin(ph) + 0.3 * np.sin(2 * ph)
        w *= np.exp(-1.5 * t)
    else:                  # strings/synth: sustained, slightly detuned pair
        w = np.sin(ph) + 0.5 * np.sin(ph * 1.003) + 0.2 * np.sin(2 * ph)
    return w


def _drum(pitch, n, sr):
    rng = np.random.default_rng(pitch)
    t = np.arange(n) / sr
    if pitch in (35, 36):        # kick: swept sine
        f = 120 * np.exp(-18 * t) + 45
        return np.sin(2 * np.pi * np.cumsum(f) / sr) * np.exp(-8 * t)
    if pitch in (38, 40):        # snare: tone + noise
        return (0.5 * np.sin(2 * np.pi * 190 * t)
                + 0.8 * rng.standard_normal(n)) * np.exp(-18 * t)
    if pitch in (42, 44, 46):    # hats: bright noise
        return rng.standard_normal(n) * np.exp(-(60 if pitch == 42 else 18)
                                               * t) * 0.5
    return rng.standard_normal(n) * np.exp(-25 * t) * 0.4


def synthesize(song: Song, sample_rate: int = 22050,
               bpm: float | None = None) -> np.ndarray:
    """Render a Song to a float32 mono waveform in [-1, 1]."""
    bpm = bpm or song.tempo or 120.0
    sec_per_step = 60.0 / bpm / song.resolution
    total_steps = song.end_time() + song.resolution
    out = np.zeros(int(total_steps * sec_per_step * sample_rate)
                   + sample_rate // 2, np.float32)

    for track in song.tracks:
        gain = 0.18 if not track.is_drum else 0.25
        for note in track.notes:
            start = int(note.time * sec_per_step * sample_rate)
            dur_s = max(note.duration, 1) * sec_per_step
            n = max(int((dur_s + 0.06) * sample_rate), 32)
            if track.is_drum:
                w = _drum(note.pitch, n, sample_rate)
            else:
                freq = 440.0 * 2 ** ((note.pitch - 69) / 12)
                w = _tone(freq, n, sample_rate, track.program) \
                    * _adsr(n, sample_rate)
            v = note.velocity / 127.0
            end = min(start + n, len(out))
            if end > start:
                out[start:end] += (gain * v * w[: end - start]).astype(
                    np.float32)

    peak = np.abs(out).max()
    if peak > 1.0:
        out /= peak * 1.05
    return out


def write_wav(path: str, samples: np.ndarray,
              sample_rate: int = 22050) -> None:
    pcm = np.clip(samples, -1.0, 1.0)
    pcm16 = (pcm * 32767).astype("<i2")
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm16.tobytes())


def song_to_wav(song: Song, path: str, sample_rate: int = 22050) -> None:
    write_wav(path, synthesize(song, sample_rate), sample_rate)
