"""The port stands alone: importing every module of polyphemus_tpu_torch
loads nothing of jax, flax, optax, msgpack or polyphemus_tpu (its data
plane, native gather and native MIDI renderer included), neither
matplotlib nor huggingface_hub, and builds no native library; its entry
points (generation, serving, training, the generate/reconstruct/interpolate
CLIs) refuse to run without a card unless asked for the CPU. The kernels
themselves are held against their plain versions on the card by
tests/test_torch_cuda.py."""
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from .torch_port_case import build, small_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_package_imports_no_jax():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import polyphemus_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                       pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "flax", "optax", "msgpack")
               or m == "polyphemus_tpu" or m.startswith("polyphemus_tpu.")]
        assert not bad, bad
        assert len(names) >= 54, names
        # plotting imports matplotlib, and download_models huggingface_hub,
        # when called: the card's machine has neither
        assert "matplotlib" not in sys.modules
        assert "huggingface_hub" not in sys.modules
        # the native gather and renderer build at first use, not at import
        from polyphemus_tpu_torch import native
        assert not native._libs, native._libs
        print(len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_chip_smoke_imports_no_jax():
    code = ("import sys; sys.argv = ['x']; import chip_smoke; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'polyphemus_tpu')]; assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_entry_points_need_a_card_or_an_explicit_cpu(tmp_path):
    from polyphemus_tpu_torch.generate import generate_z, make_generator
    from polyphemus_tpu_torch.serve import GenerationService

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    _, _, model = build(small_cfg(n_layers=1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_generator(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GenerationService(str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate_z(0, 2, 32)
    fn = make_generator(model, device="cpu")
    mask, tokens = fn(torch.zeros(1, 32))
    assert mask.device.type == "cpu" and tokens.dtype == torch.uint8


def test_train_cli_needs_a_card_or_an_explicit_cpu(tmp_path):
    from polyphemus_tpu_torch.cli import train as train_cli

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    argv = [str(tmp_path), str(tmp_path / "out"),
            os.path.join(ROOT, "examples", "training_lmd2.json")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(argv)
    assert not (tmp_path / "out").exists()


def test_gcl_training_kernels_refuse_unsupported_devices():
    from polyphemus_tpu_torch.ops.kernels import gcl, gcl_bwd

    x = torch.zeros(1, 128, 128, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        gcl.gcl_fwd(x, x, x, x, x)
    with pytest.raises(ValueError, match="unsupported device"):
        gcl_bwd.gcl_bwd_data(x, x, x, x, x)
    with pytest.raises(ValueError, match="unsupported device"):
        gcl_bwd.gcl_bwd_weight(x, x, x, x)


def test_generate_z_is_seeded():
    from polyphemus_tpu_torch.generate import generate_z

    z = generate_z(3, 4, 16, device="cpu")
    assert z.shape == (4, 16) and z.dtype == torch.float32
    torch.testing.assert_close(generate_z(3, 4, 16, device="cpu"), z)
    assert not torch.equal(generate_z(4, 4, 16, device="cpu"), z)


@pytest.mark.parametrize("cli", ["generate", "reconstruct", "interpolate"])
def test_inference_clis_need_a_card_or_an_explicit_cpu(tmp_path, cli):
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    main = importlib.import_module(f"polyphemus_tpu_torch.cli.{cli}").main
    argv = {"generate": [str(tmp_path), str(tmp_path / "out")],
            "reconstruct": [str(tmp_path), "x.npz", str(tmp_path / "out")],
            "interpolate": [str(tmp_path), str(tmp_path / "out")]}[cli]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(argv)
    assert not (tmp_path / "out").exists()


def test_kernels_refuse_unsupported_devices():
    from polyphemus_tpu_torch.ops.kernels import chord_tail, gcl

    x = torch.zeros(1, 128, 128, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        gcl.gcl_eval(x, x, x, x, x, x, x)
    with pytest.raises(ValueError, match="unsupported device"):
        chord_tail.chord_tail_tokens(x, x, x, x, x, x, x, x, x, n_slots=15)
