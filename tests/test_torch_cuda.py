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
    chord_tail, counts, gcl, gcl_bwd)

pytestmark = pytest.mark.cuda


def train_counts():
    """The training kernels' launches at bars of 4 x 32 cells, by name."""
    return {k: counts.total(k) for k in chip_smoke.TRAIN_KERNELS}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


# fp32 and bf16 at one bar, a few, and 40 (no whole wave of 132 SMs); d =
# 128 makes one output tile the row, d = 384 three (fp32: a 256-column pass
# and a 128-column one)
GCL_EVAL_CASES = [(nbar, d, k, bf16) for bf16 in (False, True)
                  for nbar in (1, 3, 40) for d in (128, 256, 384, 512)
                  for k in (1, 2, 3)]


@pytest.mark.parametrize("nbar,d,k_layers,bf16", GCL_EVAL_CASES)
def test_gcl_eval_kernel_matches_plain(cuda, nbar, d, k_layers, bf16):
    chip_smoke.check_gcl(nbar, d, k_layers, cuda, timing=False, bf16=bf16)


def test_gcl_eval_fp32_leaves_a_bar_without_active_cells_as_it_was(cuda):
    """Bar 1 of 3 has no active cell and a state that is not 0: every layer
    passes it through (the mask zeroes the update), so the output there is
    x exactly; the other bars agree with the plain version."""
    mask, args = chip_smoke.kernel_inputs(3, 384, 2, cuda, 5)
    mask = mask.clone()
    mask[1] = False
    g = torch.Generator().manual_seed(7)
    args[0] = args[0].clone()
    args[0][1] = torch.randn(128, 384, generator=g).to(cuda)
    args[1] = gcl.build_kernel_aux(mask).reshape(3, gcl.N_AUX, 128)
    before = counts.total("gcl_eval")
    out = gcl.gcl_eval(*args)
    ref = gcl.gcl_eval_plain(*args)
    torch.cuda.synchronize()
    assert counts.total("gcl_eval") == before + 1
    assert torch.equal(out[1], args[0][1])
    torch.testing.assert_close(out, ref, rtol=chip_smoke.TOL,
                               atol=chip_smoke.TOL)


# fp32 and bf16 at every width the kernels take (d = 640-1024 in half-bar
# tiles, 1152-1536 in track tiles; 640, 896 and 1152-1408 on padded weights)
# and at one bar, six, and 133 (no whole number of 132-CTA waves). Seven
# bars, not six, at d = 384 (and in bf16 at d = 1152) and 134, not 133, at
# d = 1152: those inputs have an inactive-cell class whose top-2 gap is below
# TIE, shared by 0.5-2 % of the ids, more than check_chord lets the tie rule
# cover
CHORD_TAIL_CASES = [(nbar, d, bf16) for bf16 in (False, True)
                    for d in range(128, 1537, 128)
                    for nbar in (1, 7 if d == 384 or (bf16 and d == 1152)
                                 else 6, 134 if d == 1152 else 133)]


@pytest.mark.parametrize("nbar,d,bf16", CHORD_TAIL_CASES)
def test_chord_tail_kernel_matches_plain(cuda, nbar, d, bf16):
    before = (counts.total("chord_tail"), counts.total("chord_tail_bf16"))
    chip_smoke.check_chord(nbar, d, cuda, timing=False, bf16=bf16)
    # check_chord restores the counts; count one launch here
    x = torch.zeros(1, 4, 32, d, device=cuda,
                    dtype=torch.bfloat16 if bf16 else torch.float32)
    args = chip_smoke.chord_inputs(1, d, cuda, 0)[1][1:]
    chord_tail.chord_tail_tokens(x, *(a.to(x.dtype) for a in args),
                                 n_slots=15)
    assert (counts.total("chord_tail"), counts.total("chord_tail_bf16")) == (
        before[0] + (not bf16), before[1] + bf16)


def equal_maxima_inputs(d, cols, device, dtype):
    """chord_inputs at 3 bars in dtype with x all zero, so every cell's h is
    b_slot, and in each unembed column cols[1] (cols[3]) a copy of column
    cols[0] (cols[2]), both with the largest bias: two equal maxima in every
    cell (drum rows and melodic rows) and slot."""
    _, args = chip_smoke.chord_inputs(3, d, device, 4)
    args = [a.to(dtype) for a in args]
    args[0].zero_()
    p0, p1, d0, d1 = cols
    for k, b, lo, hi in ((3, 4, p0, p1), (5, 6, p0, p1), (7, 8, d0, d1)):
        args[k][:, hi] = args[k][:, lo]
        args[b][lo] = args[b][hi] = args[b].max() + 10.0
    return args


# (pitch, pitch, duration, duration) columns made equal: across the lanes of
# a row, and inside one thread's columns; in a bar tile and a track tile
@pytest.mark.parametrize("d", [512, 1152])
@pytest.mark.parametrize("cols", [(17, 130, 2, 97), (0, 1, 96, 98)])
def test_chord_tail_fp32_takes_the_first_of_equal_maxima(cuda, cols, d):
    """Two equal maxima in every cell and slot: the kernel returns the
    lower index, as `torch.argmax`."""
    args = equal_maxima_inputs(d, cols, cuda, torch.float32)
    before = counts.total("chord_tail")
    out = chord_tail.chord_tail_tokens(*args, n_slots=15)
    torch.cuda.synchronize()
    assert counts.total("chord_tail") == before + 1
    assert (out[..., 0] == cols[0]).all() and (out[..., 1] == cols[2]).all()


# the same in bf16: in a bar tile, a half-bar tile (padded weights) and a
# track tile; both columns of an 8-column tile, and two tiles apart
@pytest.mark.parametrize("d", [512, 640, 1152])
@pytest.mark.parametrize("cols", [(17, 130, 2, 97), (0, 1, 96, 98)])
def test_chord_tail_bf16_takes_the_first_of_equal_maxima(cuda, cols, d):
    """Two equal maxima in every cell and slot, in the drum row and in the
    melodic rows: the bf16 kernel returns the lower index."""
    args = equal_maxima_inputs(d, cols, cuda, torch.bfloat16)
    before = counts.total("chord_tail_bf16")
    out = chord_tail.chord_tail_tokens(*args, n_slots=15)
    torch.cuda.synchronize()
    assert counts.total("chord_tail_bf16") == before + 1
    for rows in (out[:, 0], out[:, 1:]):  # the drum row, the melodic rows
        assert (rows[..., 0] == cols[0]).all()
        assert (rows[..., 1] == cols[2]).all()


@pytest.mark.parametrize("d", [1664, 2048])
def test_chord_tail_fp32_refuses_a_width_it_does_not_take(cuda, d):
    _, args = chip_smoke.chord_inputs(1, d, cuda, 0)
    with pytest.raises(ValueError, match=f"d={d}"):
        chord_tail.chord_tail_tokens(*args, n_slots=15)


@pytest.mark.parametrize("d,vp,vd", [(1664, 131, 99), (2048, 131, 99),
                                     (512, 145, 99), (512, 131, 113)])
def test_chord_tail_bf16_refuses_what_it_does_not_take(cuda, d, vp, vd):
    """A width above 1536, more than 144 pitch or 112 duration tokens: a
    ValueError that names the value, before any launch."""
    _, args = chip_smoke.chord_inputs(1, d, cuda, 0)
    args = [a.bfloat16() for a in args]
    for k, b, v in ((3, 4, vp), (5, 6, vp), (7, 8, vd)):
        args[k] = torch.cat([args[k]] * 2, dim=1)[:, :v].contiguous()
        args[b] = torch.cat([args[b]] * 2)[:v].contiguous()
    before = counts.total("chord_tail_bf16")
    name = f"d={d}" if d > 1536 else f"vp={vp}" if vp > 144 else f"vd={vd}"
    with pytest.raises(ValueError, match=name):
        chord_tail.chord_tail_tokens(*args, n_slots=15)
    assert counts.total("chord_tail_bf16") == before


def test_chord_tail_rejects_what_it_does_not_take(cuda):
    mask, args = chip_smoke.chord_inputs(2, 128, cuda, 0)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        chord_tail.chord_tail_tokens(args[0].half(), *args[1:], n_slots=15)
    with pytest.raises(ValueError, match="chord_kernel must be"):
        chord_tail.chord_tail_tokens(args[0].bfloat16(), *args[1:],
                                     n_slots=15)


def test_kernels_reject_what_they_do_not_take(cuda):
    x = torch.zeros(2, 128, 96, device=cuda)  # d not a multiple of 128
    with pytest.raises(ValueError, match="d % 128"):
        gcl.gcl_eval(x, torch.zeros(2, 14, 128, dtype=torch.int32,
                                    device=cuda), *([x] * 5))


# bar grids of 4 x S cells (resolution S / 4): the grid GCL kernels at S !=
# 32, the S = 32 kernels beside them; one bar, a few and 133 (past a whole
# wave at any bars per CTA); d = 384 takes a 256-column pass and a
# 128-column one (fp32). The chord tail's near-tie cap needs cells: its
# smallest case has 6 bars (one bar is `bar_masks`' empty edge case, a
# single active cell)
GRID_STEPS = (12, 16, 24, 48, 32)
GRID_GCL_CASES = [(1, 128, 1), (5, 384, 2), (133, 512, 2), (7, 256, 3)]
GRID_CHORD_CASES = [(6, 128), (5, 512), (133, 512), (3, 1152)]


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("nbar,d,k_layers", GRID_GCL_CASES)
@pytest.mark.parametrize("s", GRID_STEPS)
def test_grid_gcl_eval_kernel_matches_plain(cuda, s, nbar, d, k_layers, bf16):
    before = dict(counts.launches)
    chip_smoke.check_gcl(nbar, d, k_layers, cuda, timing=False, bf16=bf16,
                         s=s)
    assert counts.launches == before  # comparisons do not count
    mask, args = chip_smoke.kernel_inputs(nbar, d, k_layers, cuda, 1, s)
    if bf16:
        args = [a if a.dtype == torch.int32 else a.bfloat16() for a in args]
    gcl.gcl_eval(*args)
    name = "gcl_eval_bf16" if bf16 else "gcl_eval"
    assert counts.since(before) == {(name, s, k_layers): 1}


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("nbar,d", GRID_CHORD_CASES)
@pytest.mark.parametrize("s", GRID_STEPS)
def test_grid_chord_tail_kernel_matches_plain(cuda, s, nbar, d, bf16):
    before = dict(counts.launches)
    chip_smoke.check_chord(nbar, d, cuda, timing=False, bf16=bf16, s=s,
                           active_ties=True)
    assert counts.launches == before  # comparisons do not count


@pytest.mark.parametrize("resolution", [3, 4, 12])
def test_grid_generator_on_the_card_matches_the_cpu(cuda, tmp_path,
                                                    resolution):
    """A 3-layer model at resolution 3, 4 or 12 on the card against the
    CPU (phase 3's rules, `compare_with_cpu`), through the grid kernels:
    2 `gcl_eval` launches (3 layers at chain 2: one of K = 2, one of K = 1)
    and one `chord_tail` a call at the model's grid, none of the 4 x 32
    kernels."""
    cfg = ModelConfig(d=128, gnn_n_layers=3, n_bars=2, resolution=resolution,
                      batch_norm=True)
    chip_smoke.make_model_dir(str(tmp_path), cfg, seed=resolution)
    from polyphemus_tpu_torch.generate import load_model
    from polyphemus_tpu_torch.serve import host_z

    model, _ = load_model(str(tmp_path), cuda)
    before = dict(counts.launches)
    m, t = make_generator(model, device=cuda)(host_z(8, 8, cfg.d))
    s = cfg.n_timesteps
    assert counts.since(before) == {("gcl_eval", s, 2): 1,
                                    ("gcl_eval", s, 1): 1,
                                    ("chord_tail", s, 1): 1}
    assert m.shape == (8, 2, 4, s)
    chip_smoke.compare_with_cpu(str(tmp_path), (m.cpu().numpy(),
                                                t.cpu().numpy()), cuda)
    res = chip_smoke.compare_bf16_with_cpu(str(tmp_path), cuda, n=4)
    assert res["conditioned"]["active_cells"] > 0


def test_grid_kernels_refuse_what_they_do_not_take(cuda):
    """With 3 tracks the eval kernels and the chord tail raise; past
    resolution 12 (S = 52), which generation and training take in both
    dtypes and both forms, the bf16 fused backward (bf16 training runs the
    split backward there) raises before any kernel runs, naming its
    roadmap item; the split backward refuses bf16 up to 48 steps (bf16
    training runs the fused backward there); the fp32 fused backward (on
    no training path) refuses every grid but 4 x 32 cells."""
    s, t = 16, 3
    mask, args = chip_smoke.kernel_inputs(2, 128, 1, cuda, 0, s)
    x = args[0].reshape(2, 4, s, 128)[:, :t].reshape(2, t * s, 128)
    aux = args[1].reshape(2, 14, 4, s)[:, :, :t].reshape(2, 14, t * s)
    with pytest.raises(ValueError, match="4 tracks"):
        gcl.gcl_eval(x.contiguous(), aux.contiguous(), *args[2:])
    mask, args = chip_smoke.chord_inputs(2, 128, cuda, 0, s)
    with pytest.raises(ValueError, match="4 x S cells"):
        chord_tail.chord_tail_tokens(args[0][:, :t].contiguous(), *args[1:],
                                     n_slots=15)
    mask, args = chip_smoke.kernel_inputs(2, 256, 1, cuda, 0, 52)
    x, aux, gates, w, b = args[:5]
    before = dict(counts.launches)
    xb, gb, wb, bb = (v.bfloat16() for v in (x, gates, w[0], b[0]))
    with pytest.raises(ValueError, match="up to 48 .*the bf16 fused backward "
                                         "at S > 48 .*split backward"):
        gcl_bwd.gcl_bwd_fused(xb.detach(), xb.detach(), aux, gb, wb)
    _, (x, up, aux, gates, wbig, _) = chip_smoke.train_kernel_inputs(
        2, 128, cuda, 0, 16)
    with pytest.raises(ValueError, match="fp32 fused backward.*resolution 8"):
        gcl_bwd.gcl_bwd_fused(x, up, aux, gates, wbig)
    xb, ub, gb, wb = (v.bfloat16() for v in (x, up, gates, wbig))
    with pytest.raises(ValueError, match="bfloat16 at bars of more than 48"):
        gcl_bwd.gcl_bwd_data(xb, ub, aux, gb, wb)
    with pytest.raises(ValueError, match="bfloat16 at bars of more than 48"):
        gcl_bwd.gcl_bwd_weight(xb, ub, aux, gb)
    assert counts.launches == before


# bars of more than 48 steps (resolutions 13, 16, 24, 48): the long-bar GCL
# kernels (one launch a layer) and the chord tails; one bar, a few and 133
# (past a wave: 133 x ceil(S / 32) CTAs); d = 384 takes a 256-column pass
# and a 128-column one (fp32)
LONG_STEPS = (52, 64, 96, 192)
LONG_GCL_CASES = [(1, 128, 1), (3, 384, 2), (133, 512, 2)]
LONG_CHORD_CASES = [(6, 128), (133, 512)]


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("nbar,d,k_layers", LONG_GCL_CASES)
@pytest.mark.parametrize("s", LONG_STEPS)
def test_long_gcl_eval_kernel_matches_plain(cuda, s, nbar, d, k_layers,
                                            bf16):
    before = dict(counts.launches)
    chip_smoke.check_gcl(nbar, d, k_layers, cuda, timing=False, bf16=bf16,
                         s=s)
    assert counts.launches == before  # comparisons do not count
    mask, args = chip_smoke.kernel_inputs(nbar, d, k_layers, cuda, 1, s)
    if bf16:
        args = [a if a.dtype == torch.int32 else a.bfloat16() for a in args]
    gcl.gcl_eval(*args)
    name = "gcl_eval_bf16" if bf16 else "gcl_eval"
    assert counts.since(before) == {(name, s, 1): k_layers}


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("nbar,d", LONG_CHORD_CASES)
@pytest.mark.parametrize("s", LONG_STEPS)
def test_long_chord_tail_kernel_matches_plain(cuda, s, nbar, d, bf16):
    before = dict(counts.launches)
    chip_smoke.check_chord(nbar, d, cuda, timing=False, bf16=bf16, s=s,
                           active_ties=True)
    assert counts.launches == before


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_eval_gcl_keeps_its_route_up_to_48_steps(cuda, bf16):
    """K = 2 at S = 12, 32 and 48 is one launch of K = 2 (the grid kernels,
    and at S = 32 the first ones); at S = 52 two launches of K = 1 (the
    long-bar kernel)."""
    name = "gcl_eval_bf16" if bf16 else "gcl_eval"
    for s in (12, 32, 48, 52):
        _, args = chip_smoke.kernel_inputs(3, 256, 2, cuda, 2, s)
        if bf16:
            args = [a if a.dtype == torch.int32 else a.bfloat16()
                    for a in args]
        before = dict(counts.launches)
        gcl.gcl_eval(*args)
        want = {(name, s, 2): 1} if s <= 48 else {(name, s, 1): 2}
        assert counts.since(before) == want, s


def test_long_gcl_kernels_are_tensor_core_and_ffma_kernels(cuda):
    """The bf16 long-bar kernel holds tensor-core instructions; the fp32 one
    FFMA and none (`cuobjdump -sass`)."""
    from polyphemus_tpu_torch.ops.kernels import _build

    for name, sym in chip_smoke.LONG_FORMS.items():
        _build.launcher(name)  # built at first use
        hmma = chip_smoke.sass_instructions(name, sym)
        ffma = chip_smoke.sass_instructions(name, sym, r"\bFFMA\b")
        if name.endswith("_bf16"):
            assert hmma > 0, (name, hmma)
        else:
            assert hmma == 0 and ffma > 0, (name, hmma, ffma)


# the long-bar column forms (tensor parallelism above 48 steps a bar): d =
# 512 in shards of n = 256 and 128 (the fp32 eval and forward kernels'
# 256-column passes, and their single 128-column pass)
@pytest.mark.parametrize("n", [256, 128])
@pytest.mark.parametrize("s", [52, 96])
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_long_column_forms_match_plain(cuda, bf16, s, n):
    """Every shard of `gcl_fwd`, `gcl_eval` (K = 1), `gcl_bwd_data` and
    `gcl_bwd_weight` over bars of 4 x s cells against its plain version,
    the partial dx and dgate summed over the shards against the square
    plain version (`chip_smoke.check_gcl_columns`); the forward, eval and
    weight shards bit for bit the square launch's columns; each wrapper
    counts its launches in the column form; no comparison launch counts."""
    before = dict(gcl.col_launches), dict(counts.launches)
    res = chip_smoke.check_gcl_columns(40, 512, n, cuda, bf16=bf16,
                                       timing=False, s=s)
    suffix = "_bf16" if bf16 else ""
    assert set(res["kernels"]) == {f"{k}{suffix}" for k in (
        "gcl_fwd", "gcl_eval", "gcl_bwd_data", "gcl_bwd_weight")}
    for name, r in res["kernels"].items():
        assert r.get("equal_to_square", True), name
    assert (dict(gcl.col_launches), counts.launches) == before
    _, (x, up, aux, gates, wbig, bias) = chip_smoke.train_kernel_inputs(
        2, 512, cuda, 1, s)
    dt = torch.bfloat16 if bf16 else torch.float32
    x, up, gates, wbig, bias = (v.to(dt) for v in (x, up, gates, wbig,
                                                   bias))
    wc, bc, gc = (v[..., :n].contiguous() for v in (wbig, bias, up))
    gcl.gcl_fwd(x, aux, gates, wc, bc)
    gcl.gcl_eval(x, aux, gates, wc[None], bc[None], bc[None], bc[None],
                 col0=512 - n)
    gcl_bwd.gcl_bwd_data(x, gc, aux, gates, wc)
    gcl_bwd.gcl_bwd_weight(x, gc, aux, gates)
    torch.cuda.synchronize()
    names = [f"{k}{suffix}" for k in ("gcl_fwd", "gcl_eval", "gcl_bwd_data",
                                      "gcl_bwd_weight")]
    assert counts.since(before[1]) == {(k, s, 1): 1 for k in names}
    assert {k: v - before[0][k] for k, v in gcl.col_launches.items()
            if v != before[0][k]} == dict.fromkeys(names, 1)


FIRST_BACKWARD = """
import sys
sys.path.insert(0, {root!r})
import torch
import chip_smoke
from polyphemus_tpu_torch.ops.kernels import gcl_bwd
dev = torch.device("cuda")
s, d, n = {s}, 512, {n}
mask, (x, up, aux, gates, wbig, _) = chip_smoke.train_kernel_inputs(
    2, d, dev, 0, s)
x.requires_grad_()
rel = (torch.randn(6, d, n, device=dev) * d ** -0.5).requires_grad_()
out = gcl_bwd.gcl_fused(x, gates, rel, wbig[-d:, :n].contiguous(),
                        torch.zeros(n, device=dev), aux, mask)
out.backward(up[..., :n].contiguous())
torch.cuda.synchronize()
assert torch.isfinite(x.grad).all() and torch.isfinite(rel.grad).all()
"""


@pytest.mark.parametrize("s,n", [(32, 512), (96, 256)])
def test_a_layer_backward_runs_as_the_autograd_threads_first_op(cuda, s, n):
    """In a fresh process whose first backward is one GCL layer's (the
    autograd engine's thread has made no CUDA call, so no context is
    current there), the data backward's TMA tensor maps encode: the
    launchers make the device's context current first (once failed with
    CUDA_ERROR_INVALID_CONTEXT); square at S = 32, the column form at S =
    96."""
    import subprocess

    code = FIRST_BACKWARD.format(root=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), s=s, n=n)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]


@pytest.mark.parametrize("resolution", [13, 24])
def test_long_generator_on_the_card_matches_the_cpu(cuda, tmp_path,
                                                    resolution):
    """A 3-layer model at resolution 13 or 24 on the card against the CPU
    (phase 3's rules, `compare_with_cpu`; bf16 by phase 4b's): 3 `gcl_eval`
    launches of one layer (3 layers at chain 2, a chain run one layer a
    launch) and one `chord_tail` a call at the model's grid."""
    cfg = ModelConfig(d=128, gnn_n_layers=3, n_bars=2, resolution=resolution,
                      batch_norm=True)
    chip_smoke.make_model_dir(str(tmp_path), cfg, seed=resolution)
    from polyphemus_tpu_torch.generate import load_model
    from polyphemus_tpu_torch.serve import host_z

    model, _ = load_model(str(tmp_path), cuda)
    before = dict(counts.launches)
    m, t = make_generator(model, device=cuda)(host_z(8, 8, cfg.d))
    s = cfg.n_timesteps
    assert counts.since(before) == {("gcl_eval", s, 1): 3,
                                    ("chord_tail", s, 1): 1}
    assert m.shape == (8, 2, 4, s)
    chip_smoke.compare_with_cpu(str(tmp_path), (m.cpu().numpy(),
                                                t.cpu().numpy()), cuda)
    res = chip_smoke.compare_bf16_with_cpu(str(tmp_path), cuda, n=4)
    assert res["conditioned"]["active_cells"] > 0


# the fp32 training kernels at bars of more than 48 steps (resolutions 13,
# 16, 24, 48): one bar, a few, 40 and past a wave; d = 384 takes a
# 256-column pass and a 128-column one in the forward
LONG_TRAIN_CASES = [(1, 128), (3, 384), (40, 512), (133, 512)]


@pytest.mark.parametrize("nbar,d", LONG_TRAIN_CASES)
@pytest.mark.parametrize("s", LONG_STEPS)
def test_long_training_kernels_match_plain(cuda, s, nbar, d):
    """`gcl_fwd`, `gcl_bwd_data` and `gcl_bwd_weight` in fp32 (phase 2b's
    rules) against their plain versions over bars of 4 x s cells; no
    comparison launch counts."""
    before = dict(counts.launches)
    chip_smoke.check_gcl_train(nbar, d, cuda, timing=False, s=s)
    assert counts.launches == before


def test_long_training_kernels_launch_their_long_forms(cuda):
    """One launch of each fp32 training wrapper over bars of 4 x 96 cells
    counts one launch of that kernel at S = 96, and no other; the three
    long-bar forms are FFMA kernels without tensor-core instructions."""
    from polyphemus_tpu_torch.ops.kernels import _build

    _, (x, up, aux, gates, wbig, bias) = chip_smoke.train_kernel_inputs(
        3, 256, cuda, 1, 96)
    before = dict(counts.launches)
    gcl.gcl_fwd(x, aux, gates, wbig, bias)
    gcl_bwd.gcl_bwd_data(x, up, aux, gates, wbig)
    gcl_bwd.gcl_bwd_weight(x, up, aux, gates)
    torch.cuda.synchronize()
    assert counts.since(before) == {
        (k, 96, 1): 1 for k in ("gcl_fwd", "gcl_bwd_data", "gcl_bwd_weight")}
    for name, sym in chip_smoke.LONG_TRAIN_FORMS.items():
        _build.launcher(name)
        hmma = chip_smoke.sass_instructions(name, sym)
        ffma = chip_smoke.sass_instructions(name, sym, r"\bFFMA\b")
        assert hmma == 0 and ffma > 0, (name, hmma, ffma)


def test_long_data_and_weight_backward_repeat_bitwise(cuda):
    """At S = 96 the fp32 data backward gives dx, dgate and dbias bit for
    bit in two launches (per-bar partials summed in bar order, no atomics),
    and the weight backward dWbig (sums in registers, fixed orders)."""
    _, (x, up, aux, gates, wbig, _) = chip_smoke.train_kernel_inputs(
        128, 512, cuda, 3, 96)
    first = gcl_bwd.gcl_bwd_data(x, up, aux, gates, wbig)
    second = gcl_bwd.gcl_bwd_data(x, up, aux, gates, wbig)
    dw = [gcl_bwd.gcl_bwd_weight(x, up, aux, gates) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    assert torch.equal(dw[0], dw[1])


def test_long_training_kernels_give_zeros_for_a_bar_without_active_cells(
        cuda):
    """At S = 52 (a bar of two tiles, the second of 20 columns), bar 1 of 3
    has no active cell while its x and upstream g are not 0: the forward
    and dx are exactly 0 there; dWbig equals that of the other two bars bit
    for bit and dgate, dbias theirs within phase 2b's tolerances; every
    output agrees with the plain version."""
    mask, (x, up, aux, gates, wbig, bias) = chip_smoke.train_kernel_inputs(
        3, 384, cuda, 5, 52)
    mask = mask.clone()
    mask[1] = False
    aux = gcl.build_kernel_aux(mask).reshape(3, gcl.N_AUX, 208).to(cuda)
    x = x.clone()
    x[1] = torch.randn(208, 384, generator=torch.Generator().manual_seed(7)
                       ).to(cuda)
    assert (x[1] != 0).any() and (up[1] != 0).any()
    keep = torch.tensor([0, 2], device=cuda)

    def kept(*vs):
        return [v[keep].contiguous() for v in vs]

    out = gcl.gcl_fwd(x, aux, gates, wbig, bias)
    assert (out[1] == 0).all()
    chip_smoke.held_to("gcl_fwd", out,
                       gcl.gcl_fwd_plain(x, aux, gates, wbig, bias),
                       summed=False)
    got = check_data_backward(x, up, aux, gates, wbig)
    ref = gcl_bwd.gcl_bwd_data(*kept(x, up, aux), gates, wbig)
    dw = gcl_bwd.gcl_bwd_weight(x, up, aux, gates)
    dw_ref = gcl_bwd.gcl_bwd_weight(*kept(x, up, aux), gates)
    torch.cuda.synchronize()
    assert (got[0][1] == 0).all()
    chip_smoke.held_to("gcl_bwd_data dgate", got[1], ref[1], summed=True)
    chip_smoke.held_to("gcl_bwd_data dbias", got[2], ref[2], summed=True)
    assert torch.equal(dw, dw_ref)
    chip_smoke.held_to("gcl_bwd_weight", dw,
                       gcl_bwd.gcl_bwd_weight_plain(x, up, aux, gates),
                       summed=True)


@pytest.mark.parametrize("resolution", [13, 24])
def test_long_train_step_on_the_card_matches_the_cpu(cuda, resolution):
    """A d = 128, 2-layer fp32 model at resolution 13 or 24 (S = 52, 96) on
    the card against the CPU (losses by phase 5's rule, grads held to an
    fp64 step's on the card by phase 7's), through the long-bar training
    kernels only."""
    mc = ModelConfig(d=128, gnn_n_layers=2, n_bars=2, resolution=resolution,
                     batch_norm=True)
    s = mc.n_timesteps
    before = dict(counts.launches)
    chip_smoke.compare_train_step(mc, 8, cuda, seed=resolution,
                                  witness=True)
    # one microbatch through 2 GNN stacks of 2 layers; the eval steps before
    # the card's two train steps (kernels, plain training GCL) run the eval
    # GCL, one layer a launch
    assert counts.since(before) == {
        ("gcl_fwd", s, 1): 4, ("gcl_bwd_data", s, 1): 4,
        ("gcl_bwd_weight", s, 1): 4, ("gcl_eval", s, 1): 8}


# the training kernels at bar grids of 4 x S cells (S = 12: tracks of 12
# rows, 16-row padded tracks in bf16; 16; 48: 16-column tiles of the fp32
# data backward, two passes of the bf16 dH product); one bar, a few, 40,
# and past a wave (fp32 133, bf16 265); d = 384 takes a 256-column pass and
# a 128-column one in the forward, d = 1024 64 column tiles of the fp32
# data backward at S = 48
GRID_TRAIN_STEPS = (12, 16, 48)
GRID_TRAIN_CASES = [(1, 128), (3, 384), (40, 512), (133, 512), (5, 1024)]


@pytest.mark.parametrize("nbar,d", GRID_TRAIN_CASES)
@pytest.mark.parametrize("s", GRID_TRAIN_STEPS)
def test_grid_training_kernels_match_plain(cuda, s, nbar, d):
    """`gcl_fwd`, `gcl_bwd_data` and `gcl_bwd_weight` (phase 2b's rules),
    the bf16 `gcl_fwd` and `gcl_bwd_fused` (phase 2c's) against their plain
    versions over bars of 4 x s cells; no comparison launch counts."""
    before = dict(counts.launches)
    chip_smoke.check_gcl_train(nbar, d, cuda, timing=False, s=s)
    chip_smoke.check_gcl_train_bf16(2 * nbar, d, cuda, timing=False, s=s)
    assert counts.launches == before


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_grid_training_column_forms_match_plain(cuda, bf16):
    """The column forms at n = d / 2 over bars of 4 x 16 cells: every shard
    against its plain version, the partial dx and dgate summed over the
    shards against the square plain version; the forward and weight shards
    bit for bit the square launch's columns."""
    res = chip_smoke.check_gcl_columns(64, 512, 256, cuda, bf16=bf16,
                                       timing=False, s=16)
    for name, r in res["kernels"].items():
        assert r.get("equal_to_square", True), name


def test_grid_training_kernels_launch_their_grid_forms(cuda):
    """One launch of each training wrapper over bars of 4 x 16 cells counts
    one launch of that kernel at S = 16, and no other."""
    _, (x, up, aux, gates, wbig, bias) = chip_smoke.train_kernel_inputs(
        3, 256, cuda, 1, 16)
    b16 = [v.bfloat16() for v in (x, up, gates, wbig, bias)]
    before = dict(counts.launches)
    gcl.gcl_fwd(x, aux, gates, wbig, bias)
    gcl_bwd.gcl_bwd_data(x, up, aux, gates, wbig)
    gcl_bwd.gcl_bwd_weight(x, up, aux, gates)
    gcl.gcl_fwd(b16[0], aux, b16[2], b16[3], b16[4])
    gcl_bwd.gcl_bwd_fused(b16[0], b16[1], aux, b16[2], b16[3])
    torch.cuda.synchronize()
    assert counts.since(before) == {
        (k, 16, 1): 1 for k in ("gcl_fwd", "gcl_bwd_data", "gcl_bwd_weight",
                                "gcl_fwd_bf16", "gcl_bwd_fused")}


def test_grid_data_backward_and_fused_dw_repeat_bitwise(cuda):
    """At S = 48 the fp32 data backward gives dx, dgate and dbias bit for
    bit in two launches (gathers, fixed orders), and the bf16 fused
    backward dW and dbias."""
    _, (x, up, aux, gates, wbig, _) = chip_smoke.train_kernel_inputs(
        128, 512, cuda, 3, 48)
    first = gcl_bwd.gcl_bwd_data(x, up, aux, gates, wbig)
    second = gcl_bwd.gcl_bwd_data(x, up, aux, gates, wbig)
    args = [v.bfloat16() for v in (x, up)] + [aux] + [
        v.bfloat16() for v in (gates, wbig)]
    fused = [gcl_bwd.gcl_bwd_fused(*args) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    assert torch.equal(fused[0][2], fused[1][2])
    assert torch.equal(fused[0][3], fused[1][3])


def test_grid_training_kernels_give_zeros_for_a_bar_without_active_cells(
        cuda):
    """At S = 12, bar 1 of 3 has no active cell while its x and upstream g
    are not 0: the forward and dx are exactly 0 there in both dtypes; the
    fp32 dWbig equals that of the other two bars bit for bit and dgate,
    dbias theirs within phase 2b's tolerances; the bf16 dW and dbias equal
    theirs bit for bit; every output agrees with the plain version."""
    mask, (x, up, aux, gates, wbig, bias) = chip_smoke.train_kernel_inputs(
        3, 384, cuda, 5, 12)
    mask = mask.clone()
    mask[1] = False
    aux = gcl.build_kernel_aux(mask).reshape(3, gcl.N_AUX, 48).to(cuda)
    x = x.clone()
    x[1] = torch.randn(48, 384, generator=torch.Generator().manual_seed(7)
                       ).to(cuda)
    assert (x[1] != 0).any() and (up[1] != 0).any()
    keep = torch.tensor([0, 2], device=cuda)

    def kept(*vs):
        return [v[keep].contiguous() for v in vs]

    for dt in (torch.float32, torch.bfloat16):
        xx, gg, uu, ww, bb = (v.to(dt) for v in (x, gates, up, wbig, bias))
        out = gcl.gcl_fwd(xx, aux, gg, ww, bb)
        assert (out[1] == 0).all()
        held = (chip_smoke.held_rel if dt == torch.bfloat16 else
                lambda n, a, b: chip_smoke.held_to(n, a, b, summed=False))
        held("gcl_fwd", out, gcl.gcl_fwd_plain(xx, aux, gg, ww, bb))
    got = check_data_backward(x, up, aux, gates, wbig)
    ref = gcl_bwd.gcl_bwd_data(*kept(x, up, aux), gates, wbig)
    dw = gcl_bwd.gcl_bwd_weight(x, up, aux, gates)
    dw_ref = gcl_bwd.gcl_bwd_weight(*kept(x, up, aux), gates)
    torch.cuda.synchronize()
    assert (got[0][1] == 0).all()
    chip_smoke.held_to("gcl_bwd_data dgate", got[1], ref[1], summed=True)
    chip_smoke.held_to("gcl_bwd_data dbias", got[2], ref[2], summed=True)
    assert torch.equal(dw, dw_ref)
    chip_smoke.held_to("gcl_bwd_weight", dw,
                       gcl_bwd.gcl_bwd_weight_plain(x, up, aux, gates),
                       summed=True)
    xb, ub, gb, wb = (v.bfloat16() for v in (x, up, gates, wbig))
    f = gcl_bwd.gcl_bwd_fused(xb, ub, aux, gb, wb)
    f_ref = gcl_bwd.gcl_bwd_fused(*kept(xb, ub, aux), gb, wb)
    torch.cuda.synchronize()
    assert (f[0][1] == 0).all()
    assert torch.equal(f[2], f_ref[2]) and torch.equal(f[3], f_ref[3])
    plain = gcl_bwd.gcl_bwd_fused_plain(xb, ub, aux, gb, wb)
    for name, a, b in zip(("dx", "dgate", "dbias", "dwbig"), f, plain):
        chip_smoke.held_rel(f"gcl_bwd_fused bf16 {name}", a, b)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_grid_train_step_on_the_card_matches_the_cpu(cuda, bf16):
    """A d = 128, 2-layer model at resolution 3 (S = 12: tracks padded to
    16 rows in the bf16 kernels) on the card against the CPU by phase 5's
    and 6's rules, through the grid training kernels only."""
    mc = ModelConfig(d=128, gnn_n_layers=2, n_bars=2, resolution=3,
                     batch_norm=True)
    before = dict(counts.launches)
    chip_smoke.compare_train_step(mc, chip_smoke.BF16_CMP_BATCH if bf16
                                  else 8, cuda, seed=3, bf16=bf16)
    got = counts.since(before)
    # one microbatch through 2 GNN stacks of 2 layers; the eval step before
    # it runs the eval GCL, one layer a launch
    want = ({("gcl_fwd_bf16", 12, 1): 4, ("gcl_bwd_fused", 12, 1): 4,
             ("gcl_eval_bf16", 12, 1): 4} if bf16 else
            {("gcl_fwd", 12, 1): 4, ("gcl_bwd_data", 12, 1): 4,
             ("gcl_bwd_weight", 12, 1): 4, ("gcl_eval", 12, 1): 4})
    assert got == want


# one bar, a few, 40, and one past a whole wave (fp32: one CTA on each of
# 132 SMs; bf16: two); d = 384 takes a 256-column pass and a 128-column one
@pytest.mark.parametrize("nbar", [1, 3, 40, 133])
@pytest.mark.parametrize("d", [128, 384, 512])
def test_gcl_training_kernels_match_plain(cuda, d, nbar):
    chip_smoke.check_gcl_train(nbar, d, cuda, timing=False)


def test_weight_backward_repeats_dw_bitwise(cuda):
    """Each CTA of the fp32 weight backward sums every bar in order in its
    registers and adds its two halves' sums in a fixed order: two launches
    on the same inputs give dWbig bit for bit."""
    _, (x, up, aux, gates, _, _) = chip_smoke.train_kernel_inputs(
        128, 512, cuda, 3)
    before = counts.total("gcl_bwd_weight")
    first = gcl_bwd.gcl_bwd_weight(x, up, aux, gates)
    second = gcl_bwd.gcl_bwd_weight(x, up, aux, gates)
    torch.cuda.synchronize()
    assert counts.total("gcl_bwd_weight") == before + 2
    assert torch.equal(first, second)


def test_weight_backward_leaves_dw_as_without_a_bar_without_active_cells(
        cuda):
    """Bar 1 of 3 has no active cell while its x and upstream g are not 0:
    every A tile row of that bar is 0 (m is folded into them), so its
    products add exact zeros and dWbig equals, bit for bit, that of the
    same inputs without the bar; both agree with the plain version."""
    mask, (x, up, aux, gates, _, _) = chip_smoke.train_kernel_inputs(
        3, 384, cuda, 5)
    mask = mask.clone()
    mask[1] = False
    aux = gcl.build_kernel_aux(mask).reshape(3, gcl.N_AUX, 128).to(cuda)
    x = x.clone()
    x[1] = torch.randn(128, 384, generator=torch.Generator().manual_seed(7)
                       ).to(cuda)
    assert (x[1] != 0).any() and (up[1] != 0).any()
    keep = torch.tensor([0, 2], device=cuda)
    got = gcl_bwd.gcl_bwd_weight(x, up, aux, gates)
    ref = gcl_bwd.gcl_bwd_weight(x[keep].contiguous(), up[keep].contiguous(),
                                 aux[keep].contiguous(), gates)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    chip_smoke.held_to("gcl_bwd_weight", got,
                       gcl_bwd.gcl_bwd_weight_plain(x, up, aux, gates),
                       summed=True)


def check_data_backward(x, up, aux, gates, wbig):
    """`gcl_bwd_data` against its plain version at the tolerances of
    chip_smoke's phase 2b; returns the kernel's (dx, dgate, dbias)."""
    s = gates.shape[0]  # the launch is counted at its bar grid
    before = counts.total("gcl_bwd_data", s)
    got = gcl_bwd.gcl_bwd_data(x, up, aux, gates, wbig)
    want = gcl_bwd.gcl_bwd_data_plain(x, up, aux, gates, wbig)
    torch.cuda.synchronize()
    assert counts.total("gcl_bwd_data", s) == before + 1
    for name, a, b, summed in zip(("dx", "dgate", "dbias"), got, want,
                                  (False, True, True)):
        chip_smoke.held_to(f"gcl_bwd_data {name}", a, b, summed=summed)
    return got


# the data backward at the widest widths: 32 and 48 column tiles, so 4 and
# 2 bar chunks; one bar, a few, 40 and 133 (more bars than chunks)
@pytest.mark.parametrize("nbar", [1, 3, 40, 133])
@pytest.mark.parametrize("d", [1024, 1536])
def test_data_backward_matches_plain_at_wide_widths(cuda, d, nbar):
    _, (x, up, aux, gates, wbig, _) = chip_smoke.train_kernel_inputs(
        nbar, d, cuda, 11)
    check_data_backward(x, up, aux, gates, wbig)


def test_data_backward_repeats_bitwise(cuda):
    """The data backward sums dx in a fixed order (its scatters run as
    gathers), each CTA's dgate and dbias in bar order and the CTAs' rows
    in a fixed order: two launches give all three bit for bit."""
    _, (x, up, aux, gates, wbig, _) = chip_smoke.train_kernel_inputs(
        128, 512, cuda, 3)
    first = gcl_bwd.gcl_bwd_data(x, up, aux, gates, wbig)
    second = gcl_bwd.gcl_bwd_data(x, up, aux, gates, wbig)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_data_backward_gives_zeros_for_a_bar_without_active_cells(cuda):
    """Bar 1 of 3 has no active cell while its x and upstream g are not 0:
    its dx rows are exactly 0, and dgate and dbias are those of the same
    inputs without that bar, within the tolerances of chip_smoke's phase
    2b (the CTAs take the bars in other runs, so the sums add in another
    order); every output agrees with the plain version."""
    mask, (x, up, aux, gates, wbig, _) = chip_smoke.train_kernel_inputs(
        3, 384, cuda, 5)
    mask = mask.clone()
    mask[1] = False
    aux = gcl.build_kernel_aux(mask).reshape(3, gcl.N_AUX, 128).to(cuda)
    x = x.clone()
    x[1] = torch.randn(128, 384, generator=torch.Generator().manual_seed(7)
                       ).to(cuda)
    assert (x[1] != 0).any() and (up[1] != 0).any()
    got = check_data_backward(x, up, aux, gates, wbig)
    keep = torch.tensor([0, 2], device=cuda)
    ref = gcl_bwd.gcl_bwd_data(x[keep].contiguous(), up[keep].contiguous(),
                               aux[keep].contiguous(), gates, wbig)
    torch.cuda.synchronize()
    assert (got[0][1] == 0).all()
    chip_smoke.held_to("gcl_bwd_data dx", got[0][keep], ref[0], summed=False)
    chip_smoke.held_to("gcl_bwd_data dgate", got[1], ref[1], summed=True)
    chip_smoke.held_to("gcl_bwd_data dbias", got[2], ref[2], summed=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gcl_fwd_gives_zeros_for_a_bar_without_active_cells(cuda, dtype):
    """Bar 1 of 3 has no active cell and a state that is not 0: the
    training forward is (gcl(x) + bias) * m, exactly 0 there; the other
    bars agree with the plain version."""
    mask, (x, _, aux, gates, wbig, bias) = chip_smoke.train_kernel_inputs(
        3, 384, cuda, 5)
    mask = mask.clone()
    mask[1] = False
    aux = gcl.build_kernel_aux(mask).reshape(3, gcl.N_AUX, 128).to(cuda)
    x = x.clone()
    x[1] = torch.randn(128, 384, generator=torch.Generator().manual_seed(7)
                       ).to(cuda)
    x, gates, wbig, bias = (v.to(dtype) for v in (x, gates, wbig, bias))
    name = "gcl_fwd" if dtype == torch.float32 else "gcl_fwd_bf16"
    before = counts.total(name)
    out = gcl.gcl_fwd(x, aux, gates, wbig, bias)
    torch.cuda.synchronize()
    assert counts.total(name) == before + 1
    assert out.dtype == dtype
    assert (out[1] == 0).all()
    ref = gcl.gcl_fwd_plain(x, aux, gates, wbig, bias)
    keep = torch.tensor([0, 2], device=cuda)
    if dtype == torch.float32:
        chip_smoke.held_to("gcl_fwd", out[keep], ref[keep], summed=False)
    else:
        chip_smoke.held_rel("gcl_fwd bf16", out[keep], ref[keep])


def test_training_kernels_reject_what_they_do_not_take(cuda):
    x = torch.zeros(2, 128, 96, device=cuda)  # d not a multiple of 128
    aux = torch.zeros(2, 14, 128, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="d % 128"):
        gcl.gcl_fwd(x, aux, x, x, x)
    y = torch.zeros(2, 128, 128, device=cuda)
    with pytest.raises(ValueError, match="g must be"):
        gcl_bwd.gcl_bwd_weight(y, y[:1], aux, y[0, :32])


# the column forms of tensor parallelism: d = 512 in shards of n = 256 and
# 128 columns, 64 bars (a rank's fp32 microbatch at D = 2)
@pytest.mark.parametrize("n", [256, 128])
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_gcl_column_forms_match_plain(cuda, bf16, n):
    """Every shard of `gcl_fwd`, `gcl_eval` (K = 1) and the backward
    against its plain version, the partial dx and dgate summed over the
    shards against the square plain version (`chip_smoke.
    check_gcl_columns`); the forward, eval and weight shards are bit for
    bit the square launch's columns (the column tiles' arithmetic does not
    depend on n); no comparison launch counts."""
    before = dict(gcl.col_launches)
    res = chip_smoke.check_gcl_columns(64, 512, n, cuda, bf16=bf16,
                                       timing=False)
    for name, r in res["kernels"].items():
        assert r.get("equal_to_square", True), name
    assert gcl.col_launches == before


def test_column_forms_reject_what_they_do_not_take(cuda):
    """An output width that is not a multiple of 128, and a column shard
    of the fp32 fused backward (on no path; square only): a ValueError
    before any launch."""
    _, (x, up, aux, gates, wbig, bias) = chip_smoke.train_kernel_inputs(
        2, 512, cuda, 0)
    before = dict(gcl.col_launches), dict(counts.launches)
    with pytest.raises(ValueError, match="output width n"):
        gcl.gcl_fwd(x, aux, gates, wbig[:, :64].contiguous(),
                    bias[:64].contiguous())
    with pytest.raises(ValueError, match="square weights only"):
        gcl_bwd.gcl_bwd_fused(x, up[..., :256].contiguous(), aux, gates,
                              wbig[:, :256].contiguous())
    assert (dict(gcl.col_launches), counts.launches) == before


def test_train_step_on_the_card_matches_the_cpu(cuda):
    mc = ModelConfig(d=128, gnn_n_layers=2, n_bars=2, resolution=8,
                     batch_norm=True)
    before = train_counts()
    chip_smoke.compare_train_step(mc, 8, cuda, seed=3)
    after = train_counts()
    # one microbatch through 2 GNN stacks of 2 layers, all in fp32
    assert {k: after[k] - before[k] for k in after} == {
        "gcl_fwd": 4, "gcl_bwd_data": 4, "gcl_bwd_weight": 4,
        "gcl_fwd_bf16": 0, "gcl_bwd_fused": 0}


# d = 1024: 32 stages of the fused backward's dH product a bar, and 4 bar
# chunks of 32 column tiles
@pytest.mark.parametrize("nbar", [1, 3, 40, 265])
@pytest.mark.parametrize("d", [128, 384, 512, 1024])
def test_bf16_training_kernels_match_plain(cuda, d, nbar):
    chip_smoke.check_gcl_train_bf16(nbar, d, cuda, timing=False)


# the bf16 fused backward alone: one bar at the narrowest width (8 CTAs of
# the dW kernel), a few, a whole wave of dW CTAs at d = 512 at 8, 40 and 256
# bars (the training microbatch), past a wave of the dH kernel at d = 1024,
# and the widest width (1152 dW CTAs)
FUSED_BF16_CASES = [(1, 128), (3, 384), (8, 512), (40, 512), (256, 512),
                    (265, 1024), (8, 1536)]


def bf16_train_inputs(nbar, d, device, seed):
    _, args = chip_smoke.train_kernel_inputs(nbar, d, device, seed)
    return [v if v.dtype == torch.int32 else v.to(torch.bfloat16)
            for v in args[:5]]


@pytest.mark.parametrize("nbar,d", FUSED_BF16_CASES)
def test_fused_backward_bf16_matches_plain(cuda, nbar, d):
    """dx, dgate, dbias and dW each within 2e-2 x max |plain|."""
    args = bf16_train_inputs(nbar, d, cuda, 13)
    before = counts.total("gcl_bwd_fused")
    chip_smoke.check_fused_bf16(*args)
    assert counts.total("gcl_bwd_fused") == before + 1


def test_fused_backward_bf16_repeats_dw_and_dbias_bitwise(cuda):
    """dW sums every bar in order in each dW CTA's registers, dbias the dH
    kernel's chunks in a fixed order: two launches on the same inputs give
    both bit for bit."""
    args = bf16_train_inputs(256, 512, cuda, 3)
    first = gcl_bwd.gcl_bwd_fused(*args)
    second = gcl_bwd.gcl_bwd_fused(*args)
    torch.cuda.synchronize()
    assert torch.equal(first[2], second[2])
    assert torch.equal(first[3], second[3])


def test_fused_backward_bf16_gives_zeros_for_a_bar_without_active_cells(cuda):
    """Bar 1 of 3 has no active cell while its x and upstream g are not 0:
    its dx rows are exactly 0, and dW and dbias equal those of the same
    inputs without that bar (dW: the bar's products are exact zeros, added
    in bar order; dbias: one bar per chunk either way, so the chunks' sums
    add the same values in the same order). dgate and the other bars' dx
    sum by shared-memory atomics, in an order that changes from launch to
    launch: they are held to the plain version's tolerances."""
    mask, (x, up, aux, gates, wbig, _) = chip_smoke.train_kernel_inputs(
        3, 384, cuda, 5)
    mask = mask.clone()
    mask[1] = False
    aux = gcl.build_kernel_aux(mask).reshape(3, gcl.N_AUX, 128).to(cuda)
    x = x.clone()
    x[1] = torch.randn(128, 384, generator=torch.Generator().manual_seed(7)
                       ).to(cuda)
    x, up, gates, wbig = (v.to(torch.bfloat16) for v in (x, up, gates, wbig))
    assert (x[1] != 0).any() and (up[1] != 0).any()
    before = counts.total("gcl_bwd_fused")
    got = gcl_bwd.gcl_bwd_fused(x, up, aux, gates, wbig)
    keep = torch.tensor([0, 2], device=cuda)
    ref = gcl_bwd.gcl_bwd_fused(x[keep].contiguous(), up[keep].contiguous(),
                                aux[keep].contiguous(), gates, wbig)
    torch.cuda.synchronize()
    assert counts.total("gcl_bwd_fused") == before + 2
    assert got[0].dtype == torch.bfloat16
    assert (got[0][1] == 0).all()
    assert torch.equal(got[2], ref[2]) and torch.equal(got[3], ref[3])
    chip_smoke.held_to("gcl_bwd_fused bf16 dgate", got[1], ref[1],
                       summed=True)
    chip_smoke.held_rel("gcl_bwd_fused bf16 dx", got[0][keep], ref[0])
    plain = gcl_bwd.gcl_bwd_fused_plain(x, up, aux, gates, wbig)
    for name, a, b in zip(("dx", "dgate", "dbias", "dwbig"), got, plain):
        chip_smoke.held_rel(f"gcl_bwd_fused bf16 {name}", a, b)


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
    before = train_counts()
    eval_before = counts.total("gcl_eval_bf16")
    chip_smoke.compare_train_step(mc, chip_smoke.BF16_CMP_BATCH, cuda,
                                  seed=3, bf16=True)
    after = train_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "gcl_fwd": 0, "gcl_bwd_data": 0, "gcl_bwd_weight": 0,
        "gcl_fwd_bf16": 4, "gcl_bwd_fused": 4}
    # the eval step before it: 2 GNN stacks of 2 layers, chain 1
    assert counts.total("gcl_eval_bf16") - eval_before == 4


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
    before = (counts.total("gcl_eval"), counts.total("chord_tail"))
    m_g, _ = make_generator(model, device=cuda)(z)
    _, t_g = make_generator(model, conditioned=True, device=cuda)(z, m_c)
    # 3 layers in groups of 2 -> 2 launches per call; one tail per call
    assert counts.total("gcl_eval") - before[0] == 4
    assert counts.total("chord_tail") - before[1] == 2
    clear = s_c.abs() > 1e-3
    assert torch.equal(m_g.cpu()[clear], m_c[clear])
    tie = torch.stack([_top2_gap(c_c[..., :131]), _top2_gap(c_c[..., 131:])],
                      dim=-1) < 1e-4
    assert tie[m_c].float().mean() < 1e-3
    assert torch.equal(t_g.cpu()[~tie], t_c[~tie])


def test_bf16_generator_on_the_card_matches_the_cpu(cuda, tmp_path):
    cfg = ModelConfig(d=128, gnn_n_layers=3, n_bars=2, resolution=8,
                      batch_norm=True)
    chip_smoke.make_model_dir(str(tmp_path), cfg, seed=1)
    before = dict(counts.launches)
    res = chip_smoke.compare_bf16_with_cpu(str(tmp_path), cuda, n=4)
    # 2 card calls of 3 layers in groups of 2 -> 2 bf16 launches each (K =
    # 2 and K = 1), and one bf16 tail each; no fp32 launch
    assert counts.since(before) == {("gcl_eval_bf16", 32, 2): 2,
                                    ("gcl_eval_bf16", 32, 1): 2,
                                    ("chord_tail_bf16", 32, 1): 2}
    assert res["conditioned"]["active_cells"] > 0


def test_bf16_generator_launches_at_the_flagship_depth(cuda, tmp_path):
    """8 GNN layers at chain 2: 4 bf16 eval GCL launches and one bf16 chord
    tail per call, nothing in fp32."""
    cfg = ModelConfig(d=128, gnn_n_layers=8, n_bars=2, resolution=8,
                      batch_norm=True)
    chip_smoke.make_model_dir(str(tmp_path), cfg, seed=2)
    from polyphemus_tpu_torch.generate import load_model

    model, _ = load_model(str(tmp_path), cuda)
    gen = make_generator(model, bf16=True, device=cuda)
    z = torch.randn(8, cfg.d, device=cuda)
    before = dict(counts.launches)
    for _ in range(3):
        mask, tokens = gen(z)
    torch.cuda.synchronize()
    assert counts.since(before) == {("gcl_eval_bf16", 32, 2): 12,
                                    ("chord_tail_bf16", 32, 1): 3}
    assert mask.shape == (8, 2, 4, 32) and tokens.dtype == torch.uint8


@pytest.mark.parametrize("mode", ["edge", "aggregate"])
def test_dropout_gcl_on_the_card_matches_the_cpu(cuda, mode):
    chip_smoke.check_dropout_gcl(16, 512, mode, cuda)


@pytest.mark.parametrize("mode", ["edge", "aggregate"])
def test_dropout_training_launches_no_training_kernel(cuda, mode):
    """A train step with message dropout runs the lattice GCL (no launch of
    a training GCL kernel); an eval step still launches `gcl_eval`."""
    from polyphemus_tpu_torch.config import TrainConfig
    from polyphemus_tpu_torch.data import synthetic_batch
    from polyphemus_tpu_torch.train import trainer as tr

    mc = ModelConfig(d=128, gnn_n_layers=2, n_bars=2, resolution=8,
                     batch_norm=True, message_dropout=0.1,
                     message_dropout_mode=mode)
    cfg = TrainConfig(batch_size=8, model=mc)
    torch.manual_seed(0)
    model = VAE(mc).to(cuda)
    model.set_dropout_generator(torch.Generator(device=cuda).manual_seed(1))
    toks, mask = (torch.from_numpy(a).to(cuda) for a in synthetic_batch(
        np.random.default_rng(0), 8, 2))
    before = train_counts()
    eval_before = counts.total("gcl_eval", k=1)
    losses, _ = tr.make_train_step(model, cfg, tr.make_optimizer(model, cfg))(
        toks, mask)
    assert train_counts() == before
    assert all(torch.isfinite(v) for v in losses.values())
    tr.eval_step(model, cfg, toks, mask, 1)
    # 2 GNN stacks of 2 layers, chain 1
    assert counts.total("gcl_eval", k=1) - eval_before == 4


def test_training_kernels_match_plain_at_lmd16_microbatch(cuda):
    """LMD16's microbatch (16 sequences x 16 bars = 256 bars): the data
    backward's CTAs walk twice the bars they walk at 128."""
    chip_smoke.check_gcl_train(256, 512, cuda, timing=False)


def test_async_saver_saves_the_weights_at_submit_on_the_card(cuda, tmp_path):
    """A d = 512 model and its Adam state on the card: the weights and
    moments changed on the card right after `submit` are not in the saved
    file, which holds the values at submit bitwise."""
    from polyphemus_tpu_torch.config import TrainConfig
    from polyphemus_tpu_torch.train import checkpoint as ckpt
    from polyphemus_tpu_torch.train import trainer as tr

    mc = ModelConfig(d=512, gnn_n_layers=2, n_bars=2, resolution=8)
    torch.manual_seed(0)
    model = VAE(mc).to(cuda)
    opt = tr.make_optimizer(model, TrainConfig(batch_size=8, model=mc))
    g = torch.Generator(device=cuda).manual_seed(1)
    for p in model.parameters():
        p.grad = torch.randn(p.shape, generator=g, device=cuda)
    opt.step()
    want = {k: v.cpu() for k, v in model.state_dict().items()}
    want_opt = {k: (v["exp_avg"].cpu(), v["exp_avg_sq"].cpu())
                for k, v in opt.state_dict()["state"].items()}
    saver = ckpt.AsyncSaver()
    for rep in range(3):
        saver.submit(model, opt, rep, str(tmp_path), f"c{rep}", {})
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(-3.0).add_(1.0)
            for st in opt.state.values():
                st["exp_avg"].mul_(-3.0).add_(1.0)
                st["exp_avg_sq"].mul_(-3.0).add_(1.0)
        saver.wait()
        got = torch.load(ckpt.path(str(tmp_path), f"c{rep}"),
                         weights_only=True)
        for k, v in want.items():
            assert torch.equal(got["model"][k], v), (rep, k)
        for k, (m, v) in want_opt.items():
            st = got["optimizer"]["state"][k]
            assert torch.equal(st["exp_avg"], m), (rep, k)
            assert torch.equal(st["exp_avg_sq"], v), (rep, k)
        want = {k: v.cpu() for k, v in model.state_dict().items()}
        want_opt = {k: (v["exp_avg"].cpu(), v["exp_avg_sq"].cpu())
                    for k, v in opt.state_dict()["state"].items()}


def test_service_renders_natively_on_the_card(cuda, tmp_path):
    """`GenerationService.render_midi` on ids generated on the card: the
    native renderer's bytes, equal to the Python writer's, one native render
    a sequence."""
    from polyphemus_tpu_torch.midi import fast_render
    from polyphemus_tpu_torch.serve import GenerationService

    cfg = ModelConfig(d=128, gnn_n_layers=2, n_bars=2, resolution=8,
                      batch_norm=True)
    chip_smoke.make_model_dir(str(tmp_path), cfg, seed=3)
    svc = GenerationService(str(tmp_path), batch_cap=8, tiers=[8],
                            coalesce=False, device=cuda)
    mask, tokens = svc.generate(4, seed=5)
    assert tokens.dtype == np.uint8 and mask.any()
    before = fast_render.renders
    got = [svc.render_midi(mask[i], tokens[i]) for i in range(4)]
    assert fast_render.renders == before + 4
    for i in range(4):
        assert got[i] == chip_smoke.python_midi(tokens[i], mask[i], 8), i


def test_trainer_prints_mfu_on_the_card(cuda, tmp_path, capsys):
    """On a card in `flops.PEAK_FLOPS` the stats line carries the MFU of
    the step's seq/s against the fp32 peak."""
    from polyphemus_tpu_torch import flops
    from polyphemus_tpu_torch.config import TrainConfig
    from polyphemus_tpu_torch.data import synthetic_batch
    from polyphemus_tpu_torch.train.trainer import Trainer

    mc = ModelConfig(d=128, gnn_n_layers=2, n_bars=2, resolution=8)
    cfg = TrainConfig(batch_size=8, model=mc)
    torch.manual_seed(0)
    trainer = Trainer(str(tmp_path), VAE(mc), cfg, device=cuda)
    rng = np.random.default_rng(0)
    data = [tuple(torch.from_numpy(a).to(cuda)
                  for a in synthetic_batch(rng, 8, 2)) for _ in range(3)]
    trainer.fit(lambda: iter(data), 1, seed=1)
    out = capsys.readouterr().out
    seq_s = trainer.seq_per_sec()
    want = flops.mfu(seq_s, flops.train_step_flops_per_seq(mc),
                     flops.peak_flops(torch.cuda.get_device_name(0),
                                      torch.float32))
    assert 0 < trainer.mfu(seq_s) == want <= 100
    assert "% MFU) losses=" in out, out


def test_one_rank_nccl_train_step_is_the_plain_step(cuda, monkeypatch):
    """A process group of one rank on NCCL (the environment `torchrun`
    gives it): the batch-norm sums, the losses' counts and the grads go
    through NCCL's all-reduce, and the step equals the step without a
    group (d = 128, 2 layers, batch 8 in 2 microbatches)."""
    import copy
    import socket

    from polyphemus_tpu_torch.config import TrainConfig
    from polyphemus_tpu_torch.data import synthetic_batch
    from polyphemus_tpu_torch.parallel import mesh as pmesh
    from polyphemus_tpu_torch.train import trainer as tr

    mc = ModelConfig(d=128, gnn_n_layers=2, n_bars=2, resolution=8,
                     batch_norm=True)
    cfg = TrainConfig(batch_size=8, model=mc, iters_to_accumulate=2)
    torch.manual_seed(0)
    model = VAE(mc).to(cuda)
    rng = np.random.default_rng(1)
    toks, mask = (torch.from_numpy(a).to(cuda)
                  for a in synthetic_batch(rng, 8, mc.n_bars))
    eps = torch.from_numpy(rng.standard_normal((8, mc.d)).astype(
        np.float32)).to(cuda)
    runs = {}
    for name in ("plain", "nccl"):
        m = copy.deepcopy(model)
        if name == "nccl":
            with socket.socket() as s:
                s.bind(("localhost", 0))
                port = s.getsockname()[1]
            for k, v in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                         "MASTER_ADDR": "localhost",
                         "MASTER_PORT": str(port)}.items():
                monkeypatch.setenv(k, v)
            assert pmesh.maybe_initialize_distributed() is not None
            assert torch.distributed.get_backend() == "nccl"
        try:
            before = train_counts()
            step = tr.make_train_step(m, cfg, tr.make_optimizer(m, cfg))
            losses, accs = step(toks, mask, eps=eps)
            after = train_counts()
        finally:
            pmesh.destroy()
        assert after["gcl_fwd"] - before["gcl_fwd"] == 8
        runs[name] = (losses, accs, {n: p.grad for n, p in
                                     m.named_parameters()})
    (lp, ap, gp), (ln, an, gn) = runs["plain"], runs["nccl"]
    for k in lp:
        torch.testing.assert_close(ln[k], lp[k], rtol=1e-6, atol=0)
    for k in ap:
        torch.testing.assert_close(an[k], ap[k], rtol=1e-6, atol=0)
    for n, g in gp.items():
        torch.testing.assert_close(gn[n], g, rtol=1e-6, atol=1e-6 * float(
            g.abs().max()), msg=n)


# the bf16 training kernels at bars of more than 48 steps (bf16 training's
# route there: the long bf16 eval kernel's training form and the split
# backward's bf16 forms), at the fp32 cases' shapes
@pytest.mark.parametrize("nbar,d", LONG_TRAIN_CASES)
@pytest.mark.parametrize("s", LONG_STEPS)
def test_long_bf16_training_kernels_match_plain(cuda, s, nbar, d):
    """`gcl_fwd`, `gcl_bwd_data` and `gcl_bwd_weight` on bf16 inputs
    (phase 2c's rule) against their plain versions over bars of 4 x s
    cells; no comparison launch counts."""
    before = dict(counts.launches)
    chip_smoke.check_gcl_train_long_bf16(nbar, d, cuda, timing=False, s=s)
    assert counts.launches == before


def test_long_bf16_training_kernels_launch_their_long_forms(cuda):
    """One launch of each training wrapper on bf16 inputs over bars of 4 x
    96 cells counts one launch of its bf16 kernel at S = 96, and no other
    (no fused backward); the training forward's long form holds
    tensor-core instructions, the two backward forms FFMA and none."""
    from polyphemus_tpu_torch.ops.kernels import _build

    _, args = chip_smoke.train_kernel_inputs(3, 256, cuda, 1, 96)
    x, up, aux, gates, wbig, bias = [
        v if v.dtype == torch.int32 else v.bfloat16() for v in args]
    before = dict(counts.launches)
    out = gcl.gcl_fwd(x, aux, gates, wbig, bias)
    dx, dg, db = gcl_bwd.gcl_bwd_data(x, up, aux, gates, wbig)
    dw = gcl_bwd.gcl_bwd_weight(x, up, aux, gates)
    torch.cuda.synchronize()
    assert out.dtype == dx.dtype == torch.bfloat16
    assert dg.dtype == db.dtype == dw.dtype == torch.float32
    assert counts.since(before) == {
        (k, 96, 1): 1 for k in ("gcl_fwd_bf16", "gcl_bwd_data_bf16",
                                "gcl_bwd_weight_bf16")}
    for name, sym in chip_smoke.LONG_BF16_TRAIN_FORMS.items():
        _build.launcher(name)
        hmma = chip_smoke.sass_instructions(name, sym)
        ffma = chip_smoke.sass_instructions(name, sym, r"\bFFMA\b")
        if name == "gcl_fwd_long_bf16":
            assert hmma > 0, (name, hmma)
        else:
            assert hmma == 0 and ffma > 0, (name, hmma, ffma)


def test_long_bf16_data_and_weight_backward_repeat_bitwise(cuda):
    """At S = 96 the bf16 data backward gives dx, dgate and dbias bit for
    bit in two launches, and the weight backward dWbig."""
    _, args = chip_smoke.train_kernel_inputs(128, 512, cuda, 3, 96)
    x, up, aux, gates, wbig, _ = [
        v if v.dtype == torch.int32 else v.bfloat16() for v in args]
    first = gcl_bwd.gcl_bwd_data(x, up, aux, gates, wbig)
    second = gcl_bwd.gcl_bwd_data(x, up, aux, gates, wbig)
    dw = [gcl_bwd.gcl_bwd_weight(x, up, aux, gates) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    assert torch.equal(dw[0], dw[1])


def test_long_bf16_training_kernels_give_zeros_for_a_bar_without_active_cells(
        cuda):
    """At S = 52, bf16, bar 1 of 3 has no active cell while its x and
    upstream g are not 0: the forward and dx are exactly 0 there; dWbig,
    dgate and dbias equal those of the other two bars bit for bit (the
    empty bar adds zeros)."""
    mask, args = chip_smoke.train_kernel_inputs(3, 384, cuda, 5, 52)
    x, up, aux, gates, wbig, bias = [
        v if v.dtype == torch.int32 else v.bfloat16() for v in args]
    mask = mask.clone()
    mask[1] = False
    aux = gcl.build_kernel_aux(mask).reshape(3, gcl.N_AUX, 208).to(cuda)
    x = x.clone()
    x[1] = torch.randn(208, 384, generator=torch.Generator().manual_seed(7)
                       ).to(cuda).bfloat16()
    assert (x[1] != 0).any() and (up[1] != 0).any()
    keep = torch.tensor([0, 2], device=cuda)

    def kept(*vs):
        return [v[keep].contiguous() for v in vs]

    out = gcl.gcl_fwd(x, aux, gates, wbig, bias)
    got = gcl_bwd.gcl_bwd_data(x, up, aux, gates, wbig)
    ref = gcl_bwd.gcl_bwd_data(*kept(x, up, aux), gates, wbig)
    dw = gcl_bwd.gcl_bwd_weight(x, up, aux, gates)
    dw_ref = gcl_bwd.gcl_bwd_weight(*kept(x, up, aux), gates)
    torch.cuda.synchronize()
    assert (out[1] == 0).all() and (got[0][1] == 0).all()
    assert torch.equal(got[0][keep], ref[0])
    assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
    assert torch.equal(dw, dw_ref)


@pytest.mark.parametrize("resolution", [13, 24])
def test_long_bf16_train_step_on_the_card_matches_the_cpu(cuda, resolution):
    """A d = 128, 2-layer model at resolution 13 or 24 (S = 52, 96) under
    the bf16 policy on the card against the CPU at batch 32 (phase 6's
    rule), through the bf16 long-bar training kernels and no fused
    backward."""
    mc = ModelConfig(d=128, gnn_n_layers=2, n_bars=2, resolution=resolution,
                     batch_norm=True)
    s = mc.n_timesteps
    before = dict(counts.launches)
    chip_smoke.compare_train_step(mc, 32, cuda, seed=resolution, bf16=True)
    # one microbatch through 2 GNN stacks of 2 layers; the eval steps before
    # the card's two train steps run the bf16 eval GCL, a layer a launch
    assert counts.since(before) == {
        ("gcl_fwd_bf16", s, 1): 4, ("gcl_bwd_data_bf16", s, 1): 4,
        ("gcl_bwd_weight_bf16", s, 1): 4, ("gcl_eval_bf16", s, 1): 4}
