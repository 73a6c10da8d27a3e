"""The port's inference CLIs against the JAX package's, on the CPU, from one
JAX-format model directory (`checkpoint.msgpack` + `config.json`): the
same z file or samples give byte-equal MIDI files in fp32.

Seed-drawn latents (`generate` without --z_file, `interpolate --seed_*`,
`reconstruct --sample_z`) differ by design: torch.Generator and jax.random
draw different numbers from one seed. Those paths are checked for running
and writing files.
"""
import json
import os

import numpy as np
import pytest

from polyphemus_tpu.cli.generate import main as jax_generate
from polyphemus_tpu.cli.interpolate import main as jax_interpolate
from polyphemus_tpu.cli.reconstruct import main as jax_reconstruct
from polyphemus_tpu.data.preprocess import pack_track
from polyphemus_tpu.midi import Note
from polyphemus_tpu_torch.cli.generate import main as generate
from polyphemus_tpu_torch.cli.interpolate import main as interpolate
from polyphemus_tpu_torch.cli.reconstruct import main as reconstruct
from polyphemus_tpu_torch.midi import read_midi

from .test_torch_checkpoints import write_jax_dir
from .torch_port_case import random_z, small_cfg

CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_model")
    write_jax_dir(path, small_cfg(n_layers=2), seed=6)
    return str(path)


def files(root):
    out = {}
    for base, _, names in os.walk(root):
        for name in names:
            path = os.path.join(base, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def assert_same_files(a, b, n_files):
    fa, fb = files(a), files(b)
    assert sorted(fa) == sorted(fb) and len(fa) == n_files, (sorted(fa),
                                                             sorted(fb))
    for name in fa:
        assert fa[name] == fb[name], name
    notes = [len(read_midi(os.path.join(a, n))[0].tracks[t].notes)
             for n in fa for t in range(4)]
    assert sum(notes) > 0, "no notes were generated"


def write_sample(path, shift):
    notes = [Note(0 + shift, 60, 4), Note(8 + shift, 64 + shift, 4),
             Note(33, 40 + shift, 8), Note(50 - shift, 72, 2)]
    content, acts = pack_track(notes, 2 * 32)
    np.savez(path, c_tensor=np.stack([content] * 4),
             s_tensor=np.stack([acts] * 4))
    return str(path)


def test_generate_from_z_file_matches_jax(tmp_path, model_dir):
    z = tmp_path / "z.npy"
    np.save(z, random_z(3, 32, seed=11))
    args = ["--n", "3", "--no_audio", "--z_file", str(z), "--n_loops", "2"]
    jax_generate([model_dir, str(tmp_path / "jax"), *args])
    generate([model_dir, str(tmp_path / "port"), *args, *CPU])
    assert_same_files(tmp_path / "jax", tmp_path / "port", 6)


def test_generate_with_structure_file_matches_jax(tmp_path, model_dir):
    z = tmp_path / "z.npy"
    np.save(z, random_z(2, 32, seed=12))
    s = np.zeros((1, 4, 32), int)   # one bar, tiled over the model's two
    s[0, :, ::3] = 1
    s[0, 2, 5] = 1
    (tmp_path / "s.json").write_text(json.dumps(s.tolist()))
    args = ["--n", "2", "--no_audio", "--z_file", str(z), "--s_file",
            str(tmp_path / "s.json")]
    jax_generate([model_dir, str(tmp_path / "jax"), *args])
    generate([model_dir, str(tmp_path / "port"), *args, *CPU])
    assert_same_files(tmp_path / "jax", tmp_path / "port", 2)


def test_generate_bf16_and_audio(tmp_path, model_dir):
    generate([model_dir, str(tmp_path / "bf16"), "--n", "2", "--bf16",
              "--no_audio", "--seed", "4", "--no_pallas", *CPU])
    for i in range(2):
        _, tpq, _ = read_midi(str(tmp_path / "bf16" / str(i)
                                  / "generated.mid"))
        assert tpq == 8
    # without --no_audio a .wav is written beside each .mid
    generate([model_dir, str(tmp_path / "wav"), "--n", "1", "--seed", "4",
              *CPU])
    wav = tmp_path / "wav" / "0" / "generated.wav"
    assert wav.exists() and wav.read_bytes()[:4] == b"RIFF"


def test_generate_refuses_plots(tmp_path, model_dir, monkeypatch):
    """--plot_struct and --plot_proll write the JAX CLI's files: the same
    structure.svg (with a fixed SVG hash salt and date) and a pianoroll.png
    that reads back equal, beside byte-equal MIDI files."""
    import matplotlib
    import matplotlib.image

    z = tmp_path / "z.npy"
    np.save(z, random_z(2, 32, seed=13))
    args = ["--n", "2", "--no_audio", "--z_file", str(z), "--plot_struct",
            "--plot_proll"]
    monkeypatch.setenv("SOURCE_DATE_EPOCH", "0")
    with matplotlib.rc_context({"svg.hashsalt": "polyphemus"}):
        jax_generate([model_dir, str(tmp_path / "jax"), *args])
        generate([model_dir, str(tmp_path / "port"), *args, *CPU])
    fj, fp = files(tmp_path / "jax"), files(tmp_path / "port")
    assert sorted(fj) == sorted(fp) == [
        f"{i}/{n}" for i in range(2) for n in ("generated.mid",
                                               "pianoroll.png",
                                               "structure.svg")]
    for name in fj:
        if name.endswith(".png"):
            a = matplotlib.image.imread(tmp_path / "jax" / name)
            b = matplotlib.image.imread(tmp_path / "port" / name)
            np.testing.assert_array_equal(a, b)
        else:
            assert fj[name] == fp[name], name


def test_reconstruct_matches_jax(tmp_path, model_dir):
    samples = [write_sample(tmp_path / f"s{i}.npz", i) for i in range(2)]
    jax_reconstruct([model_dir, *samples, str(tmp_path / "jax")])
    reconstruct([model_dir, *samples, str(tmp_path / "port"), *CPU])
    assert_same_files(tmp_path / "jax", tmp_path / "port", 4)
    reconstruct([model_dir, samples[0], str(tmp_path / "z"), "--sample_z",
                 "--predict_structure", *CPU])
    assert (tmp_path / "z" / "0" / "reconstructed.mid").exists()


@pytest.mark.parametrize("slerp", [False, True], ids=["lerp", "slerp"])
def test_interpolate_samples_matches_jax(tmp_path, model_dir, slerp):
    a = write_sample(tmp_path / "a.npz", 0)
    b = write_sample(tmp_path / "b.npz", 3)
    args = ["--steps", "3", "--sample_a", a, "--sample_b", b] + (
        ["--slerp"] if slerp else [])
    jax_interpolate([model_dir, str(tmp_path / "jax"), *args])
    interpolate([model_dir, str(tmp_path / "port"), *args, *CPU])
    assert_same_files(tmp_path / "jax", tmp_path / "port", 3)


def test_interpolate_seeds_writes_steps(tmp_path, model_dir):
    interpolate([model_dir, str(tmp_path / "o"), "--steps", "2", "--seed_a",
                 "1", "--seed_b", "2", *CPU])
    assert sorted(os.listdir(tmp_path / "o")) == ["step_00.mid",
                                                  "step_01.mid"]
