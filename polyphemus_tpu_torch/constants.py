"""Domain constants for the Polyphemus music representation.

A copy of `polyphemus_tpu/constants.py`: track list, pitch/duration token
vocabularies, simultaneous-token capacity and edge-relation indexing. They
define the data format, not the architecture, so both packages must agree.
"""
from __future__ import annotations

import enum

# --- Tracks ------------------------------------------------------------------
N_TRACKS = 4
TRACKS = ("Drums", "Bass", "Guitar", "Strings")
DRUMS_TRACK = 0  # row index of the drum track; `is_drum = (track == 0)`

DEFAULT_MIDI_PROGRAMS = {
    "Drums": -1,
    "Bass": 34,
    "Guitar": 1,
    "Strings": 83,
}
DEFAULT_SOUNDFONT_PATH = "/usr/share/soundfonts/FluidR3_GM.sf2"

# --- Pitch tokens -------------------------------------------------------------
# 0..127 are MIDI pitches (60 = middle C), then SOS/EOS/PAD specials.


class PitchToken(enum.IntEnum):
    SOS = 128
    EOS = 129
    PAD = 130


N_PITCH_TOKENS = 131
MAX_PITCH_TOKEN = 127

# --- Duration tokens -----------------------------------------------------------
# 0..95 encode durations of 1..96 timesteps, then SOS/EOS/PAD specials.


class DurationToken(enum.IntEnum):
    SOS = 96
    EOS = 97
    PAD = 98


N_DUR_TOKENS = 99
MAX_DUR_TOKEN = 95

# Width of a one-hot (pitch, duration) token pair.
D_TOKEN_PAIR = N_PITCH_TOKENS + N_DUR_TOKENS  # 230

# Max simultaneous (pitch, duration) tokens per lattice cell: 14 + SOS + EOS.
MAX_SIMU_TOKENS = 16

# --- Edge relations -------------------------------------------------------------
# Relation ids over the bar lattice (see ops/lattice.py):
#   0..N_TRACKS-1 : TRACK edges, one relation per track row
#   N_TRACKS      : ONSET edges (same timestep, across tracks)
#   N_TRACKS + 1  : NEXT edges (consecutive active timesteps, across tracks)
EDGE_TRACK_BASE = 0
EDGE_ONSET = N_TRACKS
EDGE_NEXT = N_TRACKS + 1
N_EDGE_TYPES = N_TRACKS + 2  # 6

# Default temporal geometry (training.json resolution=8 -> 32 steps/bar)
DEFAULT_RESOLUTION = 8
BEATS_PER_BAR = 4


def timesteps_per_bar(resolution: int = DEFAULT_RESOLUTION) -> int:
    return BEATS_PER_BAR * resolution
