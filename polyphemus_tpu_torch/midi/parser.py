"""Standard MIDI File parser, dependency-free.

A copy of `polyphemus_tpu/midi/parser.py`, which replaces the reference's
pypianoroll.read/muspy.read pair (its preprocess.py): extracts
per-(track, channel) note lists, per-channel programs, tempo and time
signatures — everything the
preprocessing pipeline needs. Notes are returned in ticks; `quantize_song`
resamples to `resolution` timesteps per quarter note like
pproll.read(resolution=...).
"""
from __future__ import annotations

import struct
from typing import Dict, List, Tuple

from .song import Note, Song, Track


class MidiParseError(ValueError):
    pass


def _read_vlq(data: bytes, pos: int) -> Tuple[int, int]:
    value = 0
    while True:
        b = data[pos]
        pos += 1
        value = (value << 7) | (b & 0x7F)
        if not b & 0x80:
            return value, pos


def read_midi(path: str) -> Tuple[Song, int, List[Tuple[int, int]]]:
    """Parse a .mid file.

    Returns (song_in_ticks, ticks_per_quarter, time_signatures) where
    time_signatures is [(numerator, denominator), ...] and song.tracks hold
    Note times/durations in raw ticks (Song.resolution set to tpq).
    """
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"MThd":
        raise MidiParseError("missing MThd header")
    hlen = struct.unpack(">I", data[4:8])[0]
    fmt, ntrks, division = struct.unpack(">HHH", data[8:14])
    if division & 0x8000:
        raise MidiParseError("SMPTE time division not supported")
    tpq = division
    pos = 8 + hlen

    tempos: List[Tuple[int, float]] = []
    time_sigs: List[Tuple[int, int]] = []
    # (chunk, channel) -> list[Note in ticks]
    chan_notes: Dict[Tuple[int, int], List[Note]] = {}
    chan_program: Dict[Tuple[int, int], int] = {}

    for trk in range(ntrks):
        if pos + 8 > len(data):
            break
        if data[pos:pos + 4] != b"MTrk":
            # skip unknown chunk
            clen = struct.unpack(">I", data[pos + 4:pos + 8])[0]
            pos += 8 + clen
            continue
        clen = struct.unpack(">I", data[pos + 4:pos + 8])[0]
        end = pos + 8 + clen
        p = pos + 8
        tick = 0
        status = 0
        # (channel, pitch) -> (start_tick, velocity)
        active: Dict[Tuple[int, int], Tuple[int, int]] = {}

        while p < end:
            delta, p = _read_vlq(data, p)
            tick += delta
            b = data[p]
            if b & 0x80:
                status = b
                p += 1
            if status == 0xFF:  # meta
                mtype = data[p]
                p += 1
                mlen, p = _read_vlq(data, p)
                payload = data[p:p + mlen]
                p += mlen
                if mtype == 0x51 and mlen == 3:
                    usec = int.from_bytes(payload, "big")
                    tempos.append((tick, 60_000_000 / max(usec, 1)))
                elif mtype == 0x58 and mlen >= 2:
                    time_sigs.append((payload[0], 1 << payload[1]))
                elif mtype == 0x2F:
                    break
                continue
            if status in (0xF0, 0xF7):  # sysex
                mlen, p = _read_vlq(data, p)
                p += mlen
                continue
            kind = status & 0xF0
            ch = status & 0x0F
            if kind in (0x80, 0x90, 0xA0, 0xB0, 0xE0):
                d1, d2 = data[p], data[p + 1]
                p += 2
            elif kind in (0xC0, 0xD0):
                d1, d2 = data[p], 0
                p += 1
            else:
                raise MidiParseError(f"bad status byte {status:#x}")

            key = (trk, ch)
            if kind == 0xC0:
                chan_program.setdefault(key, d1)
            elif kind == 0x90 and d2 > 0:
                if (ch, d1) not in active:
                    active[(ch, d1)] = (tick, d2)
            elif kind == 0x80 or (kind == 0x90 and d2 == 0):
                started = active.pop((ch, d1), None)
                if started is not None:
                    start, vel = started
                    dur = max(tick - start, 1)
                    chan_notes.setdefault(key, []).append(
                        Note(start, d1, dur, vel))
        # close dangling notes at end of track
        for (ch, pitch), (start, vel) in active.items():
            chan_notes.setdefault((trk, ch), []).append(
                Note(start, pitch, max(tick - start, 1), vel))
        pos = end

    song = Song(resolution=tpq,
                tempo=tempos[0][1] if tempos else 120.0, tracks=[])
    for key in sorted(chan_notes):
        trk, ch = key
        notes = sorted(chan_notes[key], key=lambda n: (n.time, n.pitch))
        song.tracks.append(Track(
            name=f"track{trk}ch{ch}",
            program=chan_program.get(key, 0),
            is_drum=(ch == 9),
            notes=notes,
        ))
    return song, tpq, time_sigs


def quantize_song(song: Song, tpq: int, resolution: int) -> Song:
    """Resample note times/durations from ticks to `resolution` steps per
    quarter (the reference's pproll.read(resolution=...) grid)."""
    out = Song(resolution=resolution, tempo=song.tempo, tracks=[])
    for t in song.tracks:
        notes = []
        for n in t.notes:
            start = int(round(n.time * resolution / tpq))
            end = int(round((n.time + n.duration) * resolution / tpq))
            notes.append(Note(start, n.pitch, max(end - start, 1),
                              n.velocity))
        out.tracks.append(Track(t.name, t.program, t.is_drum, notes))
    return out
