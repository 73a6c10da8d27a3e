"""Lightweight symbolic-music containers.

The reference leans on muspy.Music/Track/Note; these are
the minimal equivalents used across generation output, MIDI I/O and
preprocessing. Times/durations are in timesteps of `Song.resolution` ticks
per quarter note.
"""
from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass
class Note:
    time: int       # onset, in timesteps
    pitch: int      # MIDI pitch 0..127
    duration: int   # in timesteps, >= 1
    velocity: int = 64


@dataclasses.dataclass
class Track:
    name: str = ""
    program: int = 0
    is_drum: bool = False
    notes: List[Note] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Song:
    resolution: int = 8            # timesteps per quarter note
    tempo: float = 120.0           # BPM
    tracks: List[Track] = dataclasses.field(default_factory=list)

    def end_time(self) -> int:
        return max((n.time + n.duration for t in self.tracks
                    for n in t.notes), default=0)


def loop_song(song: Song, n_loops: int, n_bars: int, resolution: int) -> Song:
    """Repeat a song n_loops times by time-shifting note copies
    (reference utils.py:144-160)."""
    shift_unit = n_bars * 4 * resolution
    out = Song(resolution=song.resolution, tempo=song.tempo,
               tracks=[Track(t.name, t.program, t.is_drum,
                             [dataclasses.replace(n) for n in t.notes])
                       for t in song.tracks])
    for i in range(1, n_loops):
        for src, dst in zip(song.tracks, out.tracks):
            for n in src.notes:
                dst.notes.append(dataclasses.replace(
                    n, time=n.time + i * shift_unit))
    return out
