"""The port's CUDA kernels on the card: each against its plain PyTorch
version, the generator on the card against the same generator on the CPU,
and one train step on the card against the same step on the CPU. Every test
skips without a CUDA device (a CUDA kernel has no CPU mode).

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from polyphemus_tpu_torch.config import ModelConfig  # noqa: E402
from polyphemus_tpu_torch.generate import make_generator  # noqa: E402
from polyphemus_tpu_torch.models import VAE  # noqa: E402
from polyphemus_tpu_torch.ops.kernels import (  # noqa: E402
    chord_tail, gcl, gcl_bwd)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("k_layers", [1, 2, 3])
@pytest.mark.parametrize("d", [128, 512])
def test_gcl_eval_kernel_matches_plain(cuda, d, k_layers, bf16):
    chip_smoke.check_gcl(6, d, k_layers, cuda, timing=False, bf16=bf16)


@pytest.mark.parametrize("d", [128, 256, 512])
def test_chord_tail_kernel_matches_plain(cuda, d):
    chip_smoke.check_chord(6, d, cuda, timing=False)


def test_kernels_reject_what_they_do_not_take(cuda):
    x = torch.zeros(2, 128, 96, device=cuda)  # d not a multiple of 128
    with pytest.raises(ValueError, match="d % 128"):
        gcl.gcl_eval(x, torch.zeros(2, 14, 128, dtype=torch.int32,
                                    device=cuda), *([x] * 5))


@pytest.mark.parametrize("nbar", [3, 40])
@pytest.mark.parametrize("d", [128, 512])
def test_gcl_training_kernels_match_plain(cuda, d, nbar):
    chip_smoke.check_gcl_train(nbar, d, cuda, timing=False)


def test_training_kernels_reject_what_they_do_not_take(cuda):
    x = torch.zeros(2, 128, 96, device=cuda)  # d not a multiple of 128
    aux = torch.zeros(2, 14, 128, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="d % 128"):
        gcl.gcl_fwd(x, aux, x, x, x)
    y = torch.zeros(2, 128, 128, device=cuda)
    with pytest.raises(ValueError, match="g must be"):
        gcl_bwd.gcl_bwd_weight(y, y[:1], aux, y[0, :32])


def test_train_step_on_the_card_matches_the_cpu(cuda):
    mc = ModelConfig(d=128, gnn_n_layers=2, n_bars=2, resolution=8,
                     batch_norm=True)
    before = chip_smoke.train_kernel_counts()
    chip_smoke.compare_train_step(mc, 8, cuda, seed=3)
    after = chip_smoke.train_kernel_counts()
    # one microbatch through 2 GNN stacks of 2 layers, all in fp32
    assert {k: after[k] - before[k] for k in after} == {
        "gcl_fwd": 4, "gcl_bwd_data": 4, "gcl_bwd_weight": 4,
        "gcl_fwd_bf16": 0, "gcl_bwd_fused": 0}


@pytest.mark.parametrize("nbar", [3, 40])
@pytest.mark.parametrize("d", [128, 512])
def test_bf16_training_kernels_match_plain(cuda, d, nbar):
    chip_smoke.check_gcl_train_bf16(nbar, d, cuda, timing=False)


@pytest.mark.parametrize("nbar", [1, 3, 40])
@pytest.mark.parametrize("d", [128, 512])
def test_fused_backward_fp32_matches_plain(cuda, d, nbar):
    chip_smoke.check_fused_fp32(nbar, d, cuda, timing=False)


def test_fused_backward_rejects_what_it_does_not_take(cuda):
    x = torch.zeros(2, 128, 128, device=cuda, dtype=torch.bfloat16)
    aux = torch.zeros(2, 14, 128, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="wbig must be"):
        gcl_bwd.gcl_bwd_fused(x, x, aux, x[0, :32], x[0].float())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        gcl_bwd.gcl_bwd_fused(x.half(), x.half(), aux, x[0, :32].half(),
                              x[0].half())


def test_bf16_train_step_on_the_card_matches_the_cpu(cuda):
    mc = ModelConfig(d=128, gnn_n_layers=2, n_bars=2, resolution=8,
                     batch_norm=True)
    before = chip_smoke.train_kernel_counts()
    eval_before = gcl.eval_bf16_launches
    chip_smoke.compare_train_step(mc, chip_smoke.BF16_CMP_BATCH, cuda,
                                  seed=3, bf16=True)
    after = chip_smoke.train_kernel_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "gcl_fwd": 0, "gcl_bwd_data": 0, "gcl_bwd_weight": 0,
        "gcl_fwd_bf16": 4, "gcl_bwd_fused": 4}
    # the eval step before it: 2 GNN stacks of 2 layers, chain 1
    assert gcl.eval_bf16_launches - eval_before == 4


def _top2_gap(logits):
    v = logits.topk(2, dim=-1).values
    return v[..., 0] - v[..., 1]


def test_generator_on_the_card_matches_the_cpu(cuda, tmp_path):
    cfg = ModelConfig(d=128, gnn_n_layers=3, n_bars=2, resolution=8,
                      batch_norm=True)
    chip_smoke.make_model_dir(str(tmp_path), cfg, seed=1)
    from polyphemus_tpu_torch.generate import load_model

    z = np.random.default_rng(0).standard_normal((4, cfg.d)).astype(
        np.float32)
    cpu_model, _ = load_model(str(tmp_path), "cpu")
    m_c, t_c, s_c, c_c = make_generator(cpu_model, return_logits=True,
                                        device="cpu")(z)
    model, _ = load_model(str(tmp_path), cuda)
    before = (gcl.launches, chord_tail.launches)
    m_g, _ = make_generator(model, device=cuda)(z)
    _, t_g = make_generator(model, conditioned=True, device=cuda)(z, m_c)
    # 3 layers in groups of 2 -> 2 launches per call; one tail per call
    assert gcl.launches - before[0] == 4
    assert chord_tail.launches - before[1] == 2
    clear = s_c.abs() > 1e-3
    assert torch.equal(m_g.cpu()[clear], m_c[clear])
    tie = torch.stack([_top2_gap(c_c[..., :131]), _top2_gap(c_c[..., 131:])],
                      dim=-1) < 1e-4
    assert tie[m_c].float().mean() < 1e-3
    assert torch.equal(t_g.cpu()[~tie], t_c[~tie])
