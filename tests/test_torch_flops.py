"""The port's FLOP accounting (`flops.py`) against the JAX package's: the
same floats at the flagship, deep, wide and 16-bar configs of
tests/test_flops.py; MFU by its formula against the card's peaks; and the
trainer's stats line, which carries the MFU on a card in the peak table and
not on the CPU."""
import dataclasses
import re
import time

import pytest
import torch

from polyphemus_tpu import flops as jflops
from polyphemus_tpu.config import ModelConfig
from polyphemus_tpu_torch import flops

from .test_torch_trainer_surface import batches, tiny_trainer
from .torch_port_case import port_cfg

H100 = "NVIDIA H100 80GB HBM3"
CONFIGS = {
    "flagship": ModelConfig(d=512, gnn_n_layers=8, n_bars=2, resolution=8),
    "deep": ModelConfig(d=512, gnn_n_layers=16, n_bars=2, resolution=8),
    "wide": ModelConfig(d=1024, gnn_n_layers=8, n_bars=2, resolution=8),
    "lmd16": ModelConfig(d=512, gnn_n_layers=8, n_bars=16, resolution=8),
}
FUNCTIONS = ["gcn_flops", "encoder_flops", "decoder_flops",
             "generation_flops_per_seq", "train_fwd_flops_per_seq",
             "train_step_flops_per_seq"]


@pytest.mark.parametrize("fn", FUNCTIONS)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_flops_equal_jax(name, fn):
    cfg = CONFIGS[name]
    got = getattr(flops, fn)(port_cfg(cfg))
    assert isinstance(got, float) and got > 0
    assert got == getattr(jflops, fn)(cfg)


def test_mfu_and_the_h100_peaks():
    cfg = port_cfg(CONFIGS["flagship"])
    g = flops.generation_flops_per_seq(cfg)
    assert 6e9 < g < 11e9
    assert flops.peak_flops(H100, torch.float32) == 66.9e12
    assert flops.peak_flops(H100, torch.bfloat16) == 989.4e12
    peak = flops.peak_flops(H100, torch.float32)
    assert flops.mfu(5000.0, g, peak) == 100.0 * 5000.0 * g / peak
    assert flops.mfu(5000.0, g, peak) == jflops.mfu(5000.0, g, peak=peak)
    assert not hasattr(flops, "V5E_PEAK_FLOPS")


def test_peak_flops_raises_for_an_unknown_card():
    with pytest.raises(KeyError, match="NVIDIA A100-SXM4-80GB"):
        flops.peak_flops("NVIDIA A100-SXM4-80GB", torch.float32)
    with pytest.raises(KeyError, match="float16"):
        flops.peak_flops(H100, torch.float16)


def test_peak_flops_reads_the_name_of_a_cuda_device(monkeypatch):
    seen = []
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev=None: seen.append(dev) or H100)
    dev = torch.device("cuda", 0)
    assert flops.peak_flops(dev, torch.bfloat16) == 989.4e12
    assert seen == [dev]


def test_trainer_prints_mfu_on_a_card_in_the_table(tmp_path, capsys,
                                                   monkeypatch):
    tr = tiny_trainer(tmp_path)
    data = batches(2)
    tr.fit(lambda: iter(data), 1, seed=1)
    out = capsys.readouterr().out
    assert re.search(r" \d+ seq/s losses=", out) and "MFU" not in out
    seq_s = tr.seq_per_sec()
    assert tr.mfu(seq_s) is None  # the CPU

    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: H100)
    tr.device = torch.device("cuda")  # as the card reports itself
    step_flops = flops.train_step_flops_per_seq(tr.cfg.model)
    for bf16, dtype in ((False, torch.float32), (True, torch.bfloat16)):
        tr.cfg = dataclasses.replace(tr.cfg, bf16=bf16)
        want = 100.0 * seq_s * step_flops / flops.PEAK_FLOPS[H100][dtype]
        assert tr.mfu(seq_s) == pytest.approx(want, rel=1e-12)
        tr._print_stats(0, 1, time.time())
        line = capsys.readouterr().out
        assert f" {seq_s:.0f} seq/s ({want:.1f}% MFU) losses=" in line

    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev=None: "NVIDIA A100-SXM4-80GB")
    assert tr.mfu(seq_s) is None
    tr._print_stats(0, 1, time.time())
    assert "MFU" not in capsys.readouterr().out
