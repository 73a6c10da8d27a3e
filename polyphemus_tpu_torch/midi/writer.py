"""Standard MIDI File writer (format 1), dependency-free.

Replaces muspy.write_midi (reference utils.py:164-165). Track 0 carries
tempo + 4/4 time signature; each Song track becomes one MTrk with a program
change and note on/off events. Drum tracks use channel 9; melodic tracks take
the remaining channels in order.
"""
from __future__ import annotations

import struct
from typing import List

from .song import Song


def _vlq(value: int) -> bytes:
    """MIDI variable-length quantity."""
    if value < 0:
        raise ValueError("negative delta time")
    out = [value & 0x7F]
    value >>= 7
    while value:
        out.append(0x80 | (value & 0x7F))
        value >>= 7
    return bytes(reversed(out))


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return tag + struct.pack(">I", len(payload)) + payload


def _meta_track(song: Song) -> bytes:
    ev = b""
    tempo_usec = int(round(60_000_000 / song.tempo))
    ev += _vlq(0) + bytes([0xFF, 0x51, 0x03]) + tempo_usec.to_bytes(3, "big")
    ev += _vlq(0) + bytes([0xFF, 0x58, 0x04, 4, 2, 24, 8])  # 4/4
    ev += _vlq(0) + bytes([0xFF, 0x2F, 0x00])
    return _chunk(b"MTrk", ev)


def midi_bytes(song: Song) -> bytes:
    """Serialize a Song to SMF bytes (in-memory variant of write_midi,
    used by the generation server)."""
    chunks: List[bytes] = [_meta_track(song)]

    next_melodic_ch = 0
    for track in song.tracks:
        if track.is_drum:
            ch = 9
        else:
            if next_melodic_ch == 9:
                next_melodic_ch += 1
            ch = next_melodic_ch
            next_melodic_ch += 1
        ch &= 0x0F

        ev = b""
        if track.name:
            name = track.name.encode("latin-1", "replace")[:127]
            ev += _vlq(0) + bytes([0xFF, 0x03, len(name)]) + name
        program = max(0, min(int(track.program), 127))
        ev += _vlq(0) + bytes([0xC0 | ch, program])

        # (tick, off_first_sort_key, status, pitch, velocity)
        events = []
        for n in track.notes:
            pitch = max(0, min(int(n.pitch), 127))
            vel = max(1, min(int(n.velocity), 127))
            start = max(0, int(n.time))
            end = start + max(1, int(n.duration))
            events.append((start, 1, 0x90 | ch, pitch, vel))
            events.append((end, 0, 0x80 | ch, pitch, 0))
        events.sort()

        now = 0
        for tick, _, status, pitch, vel in events:
            ev += _vlq(tick - now) + bytes([status, pitch, vel])
            now = tick
        ev += _vlq(0) + bytes([0xFF, 0x2F, 0x00])
        chunks.append(_chunk(b"MTrk", ev))

    header = _chunk(
        b"MThd", struct.pack(">HHH", 1, len(chunks), song.resolution))
    return header + b"".join(chunks)


def write_midi(path: str, song: Song) -> None:
    with open(path, "wb") as f:
        f.write(midi_bytes(song))
