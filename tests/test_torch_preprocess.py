"""The port's MIDI preprocessing against the JAX package's, on the same
seeded inputs: the pianoroll round trip, `pack_track` and its vectorized
form, the silence filter `_keep_window` in both modes (hypothesis),
`transpose_non_drums`, `preprocess_midi_file` at a fixed seed (the .npz
files byte-equal) and its refusals, and `cli.preprocess` over a nested
directory with `--n_files` and `--n_workers 2`.

The CLI draws its transpositions from unseeded generators, as JAX's does,
so the two CLIs' samples are compared through an untransposed run of the
same files: the same file names, structure tensors and drums, and each
sample's other tracks that run shifted by one of -5..+6 semitones under
the clip at MAX_PITCH_TOKEN. Songs come from `chip_smoke.band_song`."""
import os
import subprocess
import sys

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
from polyphemus_tpu.cli import preprocess as jax_cli
from polyphemus_tpu.data import preprocess as jpre
from polyphemus_tpu_torch import constants
from polyphemus_tpu_torch.data import preprocess as ppre
from polyphemus_tpu_torch.midi import Note, write_midi

from . import torch_port_case  # noqa: F401  (one torch thread a worker)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def random_notes(rng, n, length):
    return [Note(int(rng.integers(-2, length + 2)), int(rng.integers(-1, 130)),
                 int(rng.integers(0, 120)), int(rng.integers(0, 128)))
            for _ in range(n)]


def as_tuples(notes):
    return [(n.time, n.pitch, n.duration, n.velocity) for n in notes]


@pytest.mark.parametrize("seed", range(4))
def test_pianoroll_round_trip_and_tokens_match_jax(seed):
    rng = np.random.default_rng(seed)
    length = 64
    notes = random_notes(rng, 80, length)
    roll = ppre.notes_to_pianoroll(notes, length)
    np.testing.assert_array_equal(roll, jpre.notes_to_pianoroll(notes,
                                                                length))
    back = ppre.pianoroll_to_notes(roll)
    assert as_tuples(back) == as_tuples(jpre.pianoroll_to_notes(roll))
    for a, b in zip(ppre._roll_events(roll), jpre._roll_events(roll)):
        np.testing.assert_array_equal(a, b)
    # pack_track on raw notes (out-of-range times and pitches, clamps, the
    # 14-note cap) and its vectorized form on the round-tripped notes
    for got, want in ((ppre.pack_track(notes, length),
                       jpre.pack_track(notes, length)),
                      (ppre._pack_track_events(*ppre._roll_events(roll),
                                               length),
                       ppre.pack_track(back, length))):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[0].dtype == np.int16 and got[1].dtype == bool


def test_pack_track_tokens():
    content, acts = ppre.pack_track(
        [Note(0, 60, 4), Note(0, 64, 4), Note(3, 70, 200)], 8)
    assert content.shape == (8, 16, 2)
    assert content[0, 0, 0] == constants.PitchToken.SOS
    assert list(content[0, 1:4, 0]) == [60, 64, constants.PitchToken.EOS]
    assert content[3, 1, 1] == constants.MAX_DUR_TOKEN
    assert list(acts) == [True, False, False, True] + [False] * 4


@settings(max_examples=300, deadline=None)
@given(n_bars=st.integers(1, 4), steps=st.sampled_from([2, 4, 8]),
       density=st.sampled_from([0.0, 0.1, 0.3, 0.7]),
       seed=st.integers(0, 2 ** 31 - 1), ref_parity=st.booleans())
def test_keep_window_matches_jax(n_bars, steps, density, seed, ref_parity):
    s = np.random.default_rng(seed).random((4, n_bars * steps)) < density
    assert ppre._keep_window(s, n_bars, ref_parity=ref_parity) == \
        jpre._keep_window(s, n_bars, ref_parity=ref_parity)


def test_keep_window_modes_differ_on_the_cross_track_case():
    # track 0 silent in bar 0, track 1 silent in bar 1: the reference's
    # flattened diff drops it, the per-track rule keeps it
    s = np.ones((4, 3 * 4), bool)
    s[0, 0:4] = False
    s[1, 4:8] = False
    for ref_parity, keep in ((False, True), (True, False)):
        assert ppre._keep_window(s, 3, ref_parity=ref_parity) is keep
        assert jpre._keep_window(s, 3, ref_parity=ref_parity) is keep


def test_transpose_non_drums_matches_jax():
    rng = np.random.default_rng(0)
    c = rng.integers(0, constants.N_PITCH_TOKENS, (4, 64, 16, 2)).astype(
        np.int16)
    c[..., 0, 0] = constants.PitchToken.SOS
    got, want = c.copy(), c.copy()
    ppre.transpose_non_drums(got, np.random.default_rng(7))
    jpre.transpose_non_drums(want, np.random.default_rng(7))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], c[0])  # drums untouched
    assert not np.array_equal(got, c)


def write_songs(directory, n, seed, bars=(4, 10), prefix="song"):
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        paths.append(os.path.join(directory, f"{prefix}{i}.mid"))
        write_midi(paths[-1], chip_smoke.band_song(
            rng, int(rng.integers(bars[0], bars[1] + 1))))
    return paths


def files_of(directory):
    out = {}
    for name in sorted(os.listdir(directory)):
        with open(os.path.join(directory, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("ref_parity", [False, True])
def test_preprocess_midi_file_writes_jax_bytes(tmp_path, ref_parity):
    paths = write_songs(tmp_path / "midi", 4, seed=1)
    for k, path in enumerate(paths):
        for pkg, mod in (("port", ppre), ("jax", jpre)):
            out = tmp_path / pkg
            out.mkdir(exist_ok=True)
            mod.preprocess_midi_file(path, str(out), 2, 8, seed=k,
                                     ref_parity=ref_parity)
    got, want = files_of(tmp_path / "port"), files_of(tmp_path / "jax")
    assert len(got) > 20 and list(got) == list(want)
    for name in got:
        assert got[name] == want[name], name
    # STORED members that np.load reads as the reference's sample format
    with np.load(tmp_path / "port" / next(iter(got))) as z:
        assert z["c_tensor"].shape == (4, 64, 16, 2)
        assert z["c_tensor"].dtype == np.int16
        assert z["s_tensor"].shape == (4, 64) and z["s_tensor"].dtype == bool


def test_preprocess_refuses_what_jax_refuses(tmp_path):
    rng = np.random.default_rng(2)
    song = chip_smoke.band_song(rng, 4)
    three = tmp_path / "three_four.mid"
    write_midi(str(three), song)
    raw = bytearray(three.read_bytes())
    idx = raw.find(bytes([0xFF, 0x58, 0x04, 4, 2]))
    assert idx > 0
    raw[idx + 3] = 3
    three.write_bytes(bytes(raw))
    no_strings = tmp_path / "no_strings.mid"
    song.tracks = [t for t in song.tracks if not t.name.startswith("strings")]
    write_midi(str(no_strings), song)
    broken = tmp_path / "broken.mid"
    broken.write_bytes(b"MThd\x00\x00")
    for path in (three, no_strings, broken):
        for mod in (ppre, jpre):
            out = tmp_path / "out"
            out.mkdir(exist_ok=True)
            assert mod.preprocess_midi_file(str(path), str(out), 2, 8) == 0
            assert not os.listdir(out)


class Shift:
    """A generator stand-in whose draw is a fixed shift."""

    def __init__(self, shift):
        self.shift = shift

    def integers(self, lo, hi):
        return self.shift


def test_cli_over_a_nested_directory_matches_jax(tmp_path, monkeypatch):
    midi = tmp_path / "midi"
    for i, sub in enumerate(("", "a", os.path.join("a", "b"))):
        write_songs(midi / sub, 3, seed=10 + i, prefix=f"level{i}_")
    (midi / "a" / "notes.txt").write_text("not a MIDI file")
    args = ["--n_bars", "2", "--resolution", "8", "--n_files", "7"]
    port_out, jax_out = tmp_path / "port", tmp_path / "jax"
    proc = subprocess.run(
        [sys.executable, "-m", "polyphemus_tpu_torch.cli.preprocess",
         str(midi), str(port_out), *args, "--n_workers", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "Preprocessed 7 files" in proc.stdout
    jax_cli.main([str(midi), str(jax_out), *args])
    # the same files, untransposed
    monkeypatch.setattr(ppre, "transpose_non_drums", lambda c, rng: None)
    base_out = tmp_path / "base"
    ppre.preprocess_midi_dataset(str(midi), str(base_out), 2, 8, n_files=7)
    names = sorted(os.listdir(base_out))
    assert len(names) > 20
    assert sorted(os.listdir(port_out)) == names
    assert sorted(os.listdir(jax_out)) == names
    for name in names:
        with np.load(base_out / name) as z:
            base_c, base_s = z["c_tensor"], z["s_tensor"]
        shifted = []
        for shift in range(-5, 7):
            c = base_c.copy()
            jpre.transpose_non_drums(c, Shift(shift))
            shifted.append(c)
        for out in (port_out, jax_out):
            with np.load(out / name) as z:
                np.testing.assert_array_equal(z["s_tensor"], base_s)
                np.testing.assert_array_equal(z["c_tensor"][0], base_c[0])
                assert any(np.array_equal(z["c_tensor"], c)
                           for c in shifted), (out, name)
