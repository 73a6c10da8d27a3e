"""The port's native MIDI renderer (`midi/fast_render.py`,
`native/midirender.cpp`) against the JAX package's native renderer and the
port's Python writer, byte for byte, on `tests/test_fast_render.py`'s
random samples: default and non-default programs and track names, one and
four loops, an output larger than the first buffer; a failed build raises;
`GenerationService.render_midi` renders natively."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from polyphemus_tpu.midi.fast_render import render_midi_bytes as jax_render
from polyphemus_tpu_torch import generate as G
from polyphemus_tpu_torch.config import GenerationConfig
from polyphemus_tpu_torch.midi import fast_render, midi_bytes
from polyphemus_tpu_torch.midi.song import loop_song
from polyphemus_tpu_torch.serve import GenerationService

from .test_fast_render import random_sample
from .test_torch_checkpoints import write_jax_dir
from .torch_port_case import small_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROGRAMS = {"Drums": 5, "Bass": 33, "Guitar": 27, "Strings": 49}
NAMES = ["Kit", "", "Gitarre \xe9", "S" * 140]


def python_bytes(tokens, mask, n_loops, programs=None, names=None):
    """The port's Python path: song_from_tokens (+ loop_song), midi_bytes."""
    cfg = GenerationConfig(midi_programs=programs) if programs else None
    song = G.song_from_tokens(tokens, mask, 8, cfg)
    if names is not None:
        for track, name in zip(song.tracks, names):
            track.name = name
    if n_loops > 1:
        song = loop_song(song, n_loops, mask.shape[0], 8)
    return midi_bytes(song)


@pytest.mark.parametrize("seed,n_loops", [(0, 1), (1, 1), (2, 4), (0, 4)])
@pytest.mark.parametrize("custom", [False, True], ids=["default", "custom"])
def test_bytes_equal_jax_and_the_python_writer(seed, n_loops, custom):
    tokens, mask = random_sample(np.random.default_rng(seed))
    kw = {}
    if custom:
        kw = {"programs": [0] + [PROGRAMS[n] for n in ("Bass", "Guitar",
                                                       "Strings")],
              "track_names": NAMES}
    got = fast_render.render_midi_bytes(tokens, mask, 8, n_loops=n_loops,
                                        **kw)
    assert isinstance(got, bytes) and got[:4] == b"MThd"
    assert got == jax_render(tokens, mask, 8, n_loops=n_loops, **kw)
    assert got == python_bytes(tokens, mask, n_loops,
                               PROGRAMS if custom else None,
                               NAMES if custom else None)


def test_uint8_ids_render_as_int32_ids():
    """The generator's ids are uint8; the cast happens on the host."""
    tokens, mask = random_sample(np.random.default_rng(5))
    assert fast_render.render_midi_bytes(tokens.astype(np.uint8), mask, 8) \
        == fast_render.render_midi_bytes(tokens, mask, 8)


def test_output_larger_than_the_first_buffer_renders_natively(monkeypatch):
    tokens, mask = random_sample(np.random.default_rng(3), nb=16,
                                 density=0.5)
    want = python_bytes(tokens, mask, 4)
    monkeypatch.setattr(fast_render, "FIRST_CAPACITY", 1024)
    before = fast_render.renders
    got = fast_render.render_midi_bytes(tokens, mask, 8, n_loops=4)
    assert len(want) > 16 * 1024 and got == want
    assert fast_render.renders == before + 1


def test_render_checks_its_shapes():
    tokens, mask = random_sample(np.random.default_rng(0))
    with pytest.raises(ValueError, match="not"):
        fast_render.render_midi_bytes(tokens[:1], mask, 8)
    with pytest.raises(ValueError, match="programs"):
        fast_render.render_midi_bytes(tokens, mask, 8, programs=[0, 1])


def test_failed_build_raises():
    code = textwrap.dedent("""
        import numpy as np
        from polyphemus_tpu_torch import native
        from polyphemus_tpu_torch.midi import fast_render
        native.CXX = "/nonexistent/no-such-g++"
        mask = np.ones((2, 4, 32), bool)
        tokens = np.zeros((2, 4, 32, 15, 2), np.int32)
        try:
            fast_render.render_midi_bytes(tokens, mask, 8)
        except RuntimeError as e:
            assert "no-such-g++" in str(e), e
            assert fast_render.renders == 0
            print("raised")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "raised", out.stderr


def test_service_renders_natively(tmp_path, monkeypatch):
    write_jax_dir(tmp_path, small_cfg(n_layers=1), seed=2)
    svc = GenerationService(str(tmp_path), batch_cap=4, coalesce=False,
                            device="cpu")
    mask, tokens = svc.generate(3, seed=4)
    assert tokens.dtype == np.uint8
    want = [python_bytes(tokens[i], mask[i], 1) for i in range(3)]

    def refuse(song):
        raise AssertionError("the service rendered through the Python "
                             "writer")

    monkeypatch.setattr("polyphemus_tpu_torch.midi.writer.midi_bytes", refuse)
    before = fast_render.renders
    got = [svc.render_midi(mask[i], tokens[i]) for i in range(3)]
    assert got == want and fast_render.renders == before + 3
