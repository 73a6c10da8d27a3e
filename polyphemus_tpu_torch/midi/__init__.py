from .song import Note, Track, Song  # noqa: F401
from .writer import midi_bytes, write_midi  # noqa: F401
