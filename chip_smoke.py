#!/usr/bin/env python3
"""Smoke run of polyphemus_tpu_torch on one CUDA card.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit), the torch and CUDA
   versions, and builds the CUDA kernels from the sources in the checkout.
2. Holds each kernel against its plain PyTorch version on the card, at the
   flagship shapes (batch 256 = 512 bars, d = 512) on realistic and edge-case
   masks: `gcl_eval` at K = 1 and K = 2 (rtol = atol = 2e-4) and
   `chord_tail` (ids equal except where the plain top-2 logit gap is below
   1e-4). Times each (CUDA events, warm) beside its bound: the larger of
   bytes over 3.35 TB/s and the fp32 flops these masks need (active cells;
   `dense_bound_ms` counts every cell) over 67 TFLOP/s.
2b. Holds the training GCL kernels (`gcl_fwd`, `gcl_bwd_data`,
   `gcl_bwd_weight`) against their plain versions at 8 bars and at the
   flagship training microbatch (64 sequences = 128 bars, d = 512): the
   forward and dx at rtol = atol = 2e-4, the sums over bars (dgate, dbias,
   dWbig) at max abs err <= 1e-4 x max |plain|; times each the same way.
2c. The bf16 training kernels, `gcl_fwd` in bf16 and the fused single-pass
   backward `gcl_bwd_fused` in bf16, against their bf16 plain versions at 8
   and 256 bars (the bf16 config's microbatch of 128 sequences): every
   output within 2e-2 x max |plain|; their bound counts the bf16 tensor
   cores (989 TFLOP/s). `gcl_bwd_fused` in fp32 at 128 bars against its
   fp32 plain version at the tolerances of 2b, and timed (`fused_ms`)
   beside `gcl_bwd_data` + `gcl_bwd_weight` on the same inputs (`split_ms`).
   `gcl_eval` in bf16 (the bf16 eval step's GCN) at 8 bars (K = 1, 3) and
   at 512 bars (K = 1, the eval batch of 256), within 2e-2 x max |plain|.
3. Seeds a random-init flagship model (d = 512, 8 GNN layers, 2 bars,
   batch-norm on), saves it as a port model directory and serves it over
   HTTP on localhost with tiers [1, 8, 64, 256]: n = 1, 8 and 256, one
   structure-conditioned request and a burst of 8 concurrent n = 1 requests
   that must coalesce. Checks shapes, dtypes, vocabularies, non-empty bars,
   MIDI headers, that both kernels launched (4 `gcl_eval` launches and 1
   `chord_tail` launch per device call), and that the n = 8 result equals
   the same request on the CPU by the threshold and tie rules.
4. Batch-256 throughput by bench.py's protocol (20 calls, median of 3).
5. Trains the flagship config (`examples/training_lmd2.json`: batch 256 in
   4 microbatches of 64, fp32) through `cli.train.main()` for 4 optimizer
   steps on 512 synthetic reference-format `.npz` samples: every loss and
   metric in metrics.jsonl finite, exactly 64 launches of each training
   GCL kernel per step (16 layers x 4 microbatches); then serves the
   trained directory (one n = 8 request over HTTP). One step at full width
   on the card and on the CPU from the same weights and eps: at batch 2 the
   losses within 2e-4 relative (grads reported); at batch 8 the losses and
   each grad within 1e-3 x its max |cpu| (a grad that is rounding noise,
   under 1e-5 of the largest, within 1e-5 of the largest).
   Seconds per optimizer step at batch 256 (median of 3 passes of 5 steps)
   and seq/s, and one profiled step (device time by kernel).
6. Trains the bf16 flagship config (`examples/training_lmd2_bf16.json`:
   batch 256 in 2 microbatches of 128, the bf16 compute policy) the same
   way on 1024 samples (512 train, 256 validation) with an eval step after
   each epoch: records finite, exactly 32 launches each of the bf16
   `gcl_fwd` and of `gcl_bwd_fused` per step, 16 of the bf16 `gcl_eval`
   per evaluation and none of the fp32 training kernels, master params and
   batch-norm buffers fp32 after it. One bf16 eval and train step at batch
   8 and at batch 32 on the card against the CPU, from weights whose
   `bn_linear_merge` input is centred (`centre_merge_input`): every loss
   within 3e-2 relative and, at batch 32, every grad whose true value is
   not 0 at cosine >= 0.85 with the CPU's. Seconds per step and seq/s as
   in 5, and one profiled step.
7. Prints the `kernels` JSON line, the card line, and last
   {"ok": true, "device": {...}}.

Any failure exits non-zero before the last line. Without a CUDA device, or
without the package beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
TOL = 2e-4            # gcl_eval vs plain: rtol = atol
TIE = 1e-4            # chord_tail: ids may differ below this top-2 gap
SUM_TOL = 1e-4        # dgate, dbias, dWbig: max abs err / max |plain|
BF16_REL = 2e-2       # bf16 kernels: max abs err / max |plain|, per output
FP32_TFLOPS = 67.0    # H100 SXM, fp32 on CUDA cores (NVIDIA data sheet)
BF16_TFLOPS = 989.0   # H100 SXM, dense bf16 on the tensor cores
HBM_TBPS = 3.35       # H100 SXM device memory
SEED = 0


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def bound_ms(flops: float, nbytes: float, tflops: float = FP32_TFLOPS):
    t_ops = flops / (tflops * 1e12) * 1e3
    t_mem = nbytes / (HBM_TBPS * 1e12) * 1e3
    return max(t_ops, t_mem), ("operations" if t_ops >= t_mem else "bytes")


def time_ms(fn, reps: int = 5) -> float:
    """Mean device time of fn() over reps warm runs (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ------------------------------------------------------------------ inputs
def bar_masks(nbar: int, t: int, s: int, seed: int) -> np.ndarray:
    """Realistic densities plus the lattice's edge cases: empty (fixed to
    cell [0, 0]), a single node off track 0, full bars, one full column."""
    rng = np.random.default_rng(seed)
    dens = rng.choice([0.05, 0.3, 0.5, 0.9], size=nbar)
    mask = rng.random((nbar, t, s)) < dens[:, None, None]
    edge = [np.zeros((t, s), bool) for _ in range(4)]
    edge[0][0, 0] = True                 # empty bar after the fix
    edge[1][min(2, t - 1), s // 2 + 1] = True   # single node, track 2
    edge[2][:] = True                    # full bar
    edge[3][:, s // 3] = True            # one full column
    for i, e in enumerate(edge[:nbar]):
        mask[i] = e
    empty = ~mask.any(axis=(1, 2))
    mask[empty, 0, 0] = True
    return mask


def kernel_inputs(nbar, d, k_layers, device, seed):
    """Seeded random x, aux, gates and K layers of packed weights."""
    import torch

    from polyphemus_tpu_torch.ops.kernels import gcl

    g = torch.Generator().manual_seed(seed)
    mask = torch.from_numpy(bar_masks(nbar, 4, 32, seed))
    x = torch.randn(nbar, 4, 32, d, generator=g) * mask[..., None]
    aux = gcl.build_kernel_aux(mask).reshape(nbar, gcl.N_AUX, 128)
    gates = torch.randn(32, d, generator=g) * 0.3
    wb = [gcl.pack_weights(torch.randn(6, d, d, generator=g) * d ** -0.5,
                           torch.randn(d, d, generator=g) * d ** -0.5, 4)
          for _ in range(k_layers)]
    lay = [torch.stack(wb)] + [
        torch.randn(k_layers, d, generator=g) * sc + off
        for sc, off in ((0.1, 0.0), (0.1, 1.0), (0.1, 0.0))]
    return mask.to(device), [v.contiguous().to(device) for v in
                             [x.reshape(nbar, 128, d), aux, gates] + lay]


# ----------------------------------------------------------- phase 2: kernels
def check_gcl(nbar, d, k_layers, device, timing=True, bf16=False):
    """`gcl_eval` against its plain version, in fp32 at rtol = atol = TOL or
    in bf16 (`bf16`: every float input cast) within BF16_REL of max |plain|;
    with timing, ms per launch and the bound (bf16: on the bf16 tensor
    cores, `cuda_core_bound_ms` on the fp32 CUDA cores it runs on)."""
    import torch

    from polyphemus_tpu_torch.ops.kernels import gcl

    mask, args = kernel_inputs(nbar, d, k_layers, device, SEED + k_layers)
    if bf16:
        args = [a if a.dtype == torch.int32 else a.to(torch.bfloat16)
                for a in args]
    before = (gcl.launches, gcl.eval_bf16_launches)
    out = gcl.gcl_eval(*args)
    ref = gcl.gcl_eval_plain(*args)
    torch.cuda.synchronize()
    if bf16:
        check(out.dtype == torch.bfloat16,
              f"gcl_eval bf16 returned {out.dtype}")
        res = {"max_abs_err": held_rel(f"gcl_eval bf16 K={k_layers} "
                                       f"nbar={nbar}", out, ref)}
    else:
        err = (out - ref).abs()
        bad = err > TOL + TOL * ref.abs()
        check(torch.isfinite(out).all().item(), "gcl_eval output not finite")
        check(not bad.any().item(),
              f"gcl_eval K={k_layers} nbar={nbar}: {int(bad.sum())} values "
              f"off, max abs err {err.max().item():.3e}")
        res = {"max_abs_err": err.max().item(),
               "max_rel_err": (err / ref.abs().clamp(min=1e-3)).max().item()}
    if timing:
        res["ms"] = time_ms(lambda: gcl.gcl_eval(*args))
        res["plain_ms"] = time_ms(lambda: gcl.gcl_eval_plain(*args), reps=2)
        # an inactive cell's row of A is zero and its output is its input:
        # only active rows need the (5d x d) product
        flops = 2.0 * int(mask.sum()) * 5 * d * d * k_layers
        nbytes = sum(a.numel() * a.element_size() for a in args) \
            + out.numel() * out.element_size()
        peak = BF16_TFLOPS if bf16 else FP32_TFLOPS
        res["bound_ms"], res["bound_by"] = bound_ms(flops, nbytes, peak)
        res["dense_bound_ms"] = bound_ms(
            flops * mask.numel() / int(mask.sum()), nbytes, peak)[0]
        if bf16:
            res["cuda_core_bound_ms"] = bound_ms(flops, nbytes)[0]
    gcl.launches, gcl.eval_bf16_launches = before  # comparisons do not count
    return res


# ----------------------------------------- phase 2b: training GCL kernels
def train_kernel_inputs(nbar, d, device, seed):
    """Seeded x (masked), upstream g, aux, gates, packed weights and bias of
    one training GCL layer."""
    import torch

    from polyphemus_tpu_torch.ops.kernels import gcl

    g = torch.Generator().manual_seed(seed)
    mask = torch.from_numpy(bar_masks(nbar, 4, 32, seed))
    x = torch.randn(nbar, 128, d, generator=g) * mask.reshape(nbar, 128, 1)
    up = torch.randn(nbar, 128, d, generator=g)
    aux = gcl.build_kernel_aux(mask).reshape(nbar, gcl.N_AUX, 128)
    gates = torch.randn(32, d, generator=g) * 0.3
    wbig = gcl.pack_weights(torch.randn(6, d, d, generator=g) * d ** -0.5,
                            torch.randn(d, d, generator=g) * d ** -0.5, 4)
    bias = torch.randn(d, generator=g) * 0.1
    return mask, [v.contiguous().to(device)
                  for v in (x, up, aux, gates, wbig, bias)]


def held_to(name, out, ref, *, summed: bool) -> float:
    """Max abs error of out against ref; fails unless every element is
    within rtol = atol = TOL or, for a sum over many rows (`summed`), the max
    error is within SUM_TOL of max |ref|."""
    import torch

    check(torch.isfinite(out).all().item(), f"{name} output not finite")
    err = (out - ref).abs()
    if summed:
        ok = err.max().item() <= SUM_TOL * ref.abs().max().item()
    else:
        ok = not (err > TOL + TOL * ref.abs()).any().item()
    check(ok, f"{name}: max abs err {err.max().item():.3e}, max |ref| "
              f"{ref.abs().max().item():.3e}")
    return err.max().item()


def check_gcl_train(nbar, d, device, timing=True):
    """`gcl_fwd`, `gcl_bwd_data` and `gcl_bwd_weight` against their plain
    versions; with timing, ms per launch and the bounds. Each kernel's
    useful work is 2 * active cells * 5d * d flops (an inactive cell's
    output row, upstream row and dW contribution are zero); `dense_bound_ms`
    counts every cell and `cost_estimate_bound_ms` the JAX kernel's
    CostEstimate, 2 * nbar * 128 * 8d * d."""
    import torch

    from polyphemus_tpu_torch.ops.kernels import gcl, gcl_bwd

    mask, (x, up, aux, gates, wbig, bias) = train_kernel_inputs(
        nbar, d, device, SEED + 11)
    before = train_kernel_counts()
    runs = {
        "gcl_fwd": (lambda: gcl.gcl_fwd(x, aux, gates, wbig, bias),
                    lambda: gcl.gcl_fwd_plain(x, aux, gates, wbig, bias)),
        "gcl_bwd_data": (
            lambda: gcl_bwd.gcl_bwd_data(x, up, aux, gates, wbig),
            lambda: gcl_bwd.gcl_bwd_data_plain(x, up, aux, gates, wbig)),
        "gcl_bwd_weight": (
            lambda: gcl_bwd.gcl_bwd_weight(x, up, aux, gates),
            lambda: gcl_bwd.gcl_bwd_weight_plain(x, up, aux, gates)),
    }
    res = {}
    out, ref = runs["gcl_fwd"][0](), runs["gcl_fwd"][1]()
    torch.cuda.synchronize()
    res["gcl_fwd"] = {"max_abs_err": held_to("gcl_fwd", out, ref,
                                             summed=False)}
    (dx, dg, db), (rdx, rdg, rdb) = (runs["gcl_bwd_data"][0](),
                                     runs["gcl_bwd_data"][1]())
    torch.cuda.synchronize()
    res["gcl_bwd_data"] = {
        "max_abs_err": held_to("gcl_bwd_data dx", dx, rdx, summed=False),
        "dgate_max_abs_err": held_to("gcl_bwd_data dgate", dg, rdg,
                                     summed=True),
        "dbias_max_abs_err": held_to("gcl_bwd_data dbias", db, rdb,
                                     summed=True)}
    dw, rdw = runs["gcl_bwd_weight"][0](), runs["gcl_bwd_weight"][1]()
    torch.cuda.synchronize()
    res["gcl_bwd_weight"] = {"max_abs_err": held_to(
        "gcl_bwd_weight", dw, rdw, summed=True),
        "max_abs_ref": rdw.abs().max().item()}
    if timing:
        active = int(mask.sum())
        flops = 2.0 * active * 5 * d * d
        dense = 2.0 * nbar * 128 * 5 * d * d
        cost_est = 2.0 * nbar * 128 * 8 * d * d
        state = x.numel() * 4
        small = aux.numel() * 4 + gates.numel() * 4
        nbytes = {"gcl_fwd": 2 * state + small + wbig.numel() * 4 + d * 4,
                  "gcl_bwd_data": 3 * state + small + wbig.numel() * 4
                  + 33 * d * 4,
                  "gcl_bwd_weight": 2 * state + small + wbig.numel() * 4}
        for name, (kern, plain) in runs.items():
            r = res[name]
            r["ms"] = time_ms(kern)
            r["plain_ms"] = time_ms(plain, reps=2)
            r["bound_ms"], r["bound_by"] = bound_ms(flops, nbytes[name])
            r["dense_bound_ms"] = bound_ms(dense, nbytes[name])[0]
            r["cost_estimate_bound_ms"] = bound_ms(cost_est, nbytes[name])[0]
    set_train_kernel_counts(before)  # comparison launches do not count
    return res


# ------------------------------- phase 2c: bf16 training and fused backward
def held_rel(name, out, ref) -> float:
    """Max abs error of out against ref, both read in fp32; fails unless it
    is within BF16_REL of max |ref|."""
    import torch

    out, ref = out.float(), ref.float()
    check(torch.isfinite(out).all().item(), f"{name} output not finite")
    err = (out - ref).abs().max().item()
    scale = ref.abs().max().item()
    check(err <= BF16_REL * scale,
          f"{name}: max abs err {err:.3e}, max |ref| {scale:.3e}")
    return err


def fused_bwd_work(mask, d, nbar):
    """(data, dense, CostEstimate) flops of one fused backward: per active
    cell 2 * 5d * d for the dH product and as many for the dW product."""
    active = int(mask.sum())
    return (20.0 * active * d * d, 20.0 * nbar * 128 * d * d,
            4.0 * nbar * 128 * 8 * d * d)


def check_gcl_train_bf16(nbar, d, device, timing=True):
    """The bf16 `gcl_fwd` and `gcl_bwd_fused` against their bf16 plain
    versions on the card; with timing, ms per launch and the bounds
    (`bound_ms`: the bf16 tensor cores; `cuda_core_bound_ms`: fp32 FMAs on
    the CUDA cores, what these kernels run on; "dense" and "CE" variants as
    in 2b)."""
    import torch

    from polyphemus_tpu_torch.ops.kernels import gcl, gcl_bwd

    mask, args = train_kernel_inputs(nbar, d, device, SEED + 13)
    x, up, aux, gates, wbig, bias = [
        v if v.dtype == torch.int32 else v.to(torch.bfloat16) for v in args]
    before = train_kernel_counts()
    runs = {
        "gcl_fwd_bf16": (lambda: gcl.gcl_fwd(x, aux, gates, wbig, bias),
                         lambda: gcl.gcl_fwd_plain(x, aux, gates, wbig, bias)),
        "gcl_bwd_fused": (
            lambda: gcl_bwd.gcl_bwd_fused(x, up, aux, gates, wbig),
            lambda: gcl_bwd.gcl_bwd_fused_plain(x, up, aux, gates, wbig)),
    }
    out, ref = runs["gcl_fwd_bf16"][0](), runs["gcl_fwd_bf16"][1]()
    torch.cuda.synchronize()
    check(out.dtype == torch.bfloat16, f"gcl_fwd bf16 returned {out.dtype}")
    res = {"gcl_fwd_bf16": {"max_abs_err": held_rel("gcl_fwd bf16", out,
                                                    ref)}}
    got, want = runs["gcl_bwd_fused"][0](), runs["gcl_bwd_fused"][1]()
    torch.cuda.synchronize()
    check(got[0].dtype == torch.bfloat16, "gcl_bwd_fused bf16 dx dtype")
    errs = {n: held_rel(f"gcl_bwd_fused bf16 {n}", a, b) for n, a, b in
            zip(("dx", "dgate", "dbias", "dwbig"), got, want)}
    res["gcl_bwd_fused"] = dict(
        {"max_abs_err": max(errs.values())},
        **{f"{n}_max_abs_err": e for n, e in errs.items()})
    if timing:
        active = int(mask.sum())
        state = x.numel() * 2
        small = aux.numel() * 4 + gates.numel() * 2
        work = {"gcl_fwd_bf16": (2.0 * active * 5 * d * d,
                                 2.0 * nbar * 128 * 5 * d * d,
                                 2.0 * nbar * 128 * 8 * d * d),
                "gcl_bwd_fused": fused_bwd_work(mask, d, nbar)}
        nbytes = {"gcl_fwd_bf16": 2 * state + small + wbig.numel() * 2 + d * 2,
                  "gcl_bwd_fused": 3 * state + small + wbig.numel() * 2
                  + wbig.numel() * 4 + 33 * d * 4}
        for name, (kern, plain) in runs.items():
            r = res[name]
            data, dense, cost_est = work[name]
            r["ms"] = time_ms(kern)
            r["plain_ms"] = time_ms(plain, reps=2)
            r["bound_ms"], r["bound_by"] = bound_ms(data, nbytes[name],
                                                    BF16_TFLOPS)
            r["cuda_core_bound_ms"] = bound_ms(data, nbytes[name])[0]
            r["dense_bound_ms"] = bound_ms(dense, nbytes[name], BF16_TFLOPS)[0]
            r["dense_cuda_core_bound_ms"] = bound_ms(dense, nbytes[name])[0]
            r["cost_estimate_bound_ms"] = bound_ms(cost_est, nbytes[name],
                                                   BF16_TFLOPS)[0]
            r["cost_estimate_cuda_core_bound_ms"] = bound_ms(
                cost_est, nbytes[name])[0]
    set_train_kernel_counts(before)  # comparison launches do not count
    return res


def check_fused_fp32(nbar, d, device, timing=True):
    """`gcl_bwd_fused` in fp32 against its fp32 plain version (dx at rtol =
    atol = TOL, the sums at SUM_TOL); with timing, `fused_ms` beside
    `split_ms`, `gcl_bwd_data` + `gcl_bwd_weight` on the same inputs."""
    import torch

    from polyphemus_tpu_torch.ops.kernels import gcl_bwd

    mask, (x, up, aux, gates, wbig, _) = train_kernel_inputs(
        nbar, d, device, SEED + 11)
    before = train_kernel_counts()
    got = gcl_bwd.gcl_bwd_fused(x, up, aux, gates, wbig)
    want = gcl_bwd.gcl_bwd_fused_plain(x, up, aux, gates, wbig)
    torch.cuda.synchronize()
    res = {"max_abs_err": held_to("gcl_bwd_fused fp32 dx", got[0], want[0],
                                  summed=False)}
    for n, a, b in zip(("dgate", "dbias", "dwbig"), got[1:], want[1:]):
        res[f"{n}_max_abs_err"] = held_to(f"gcl_bwd_fused fp32 {n}", a, b,
                                          summed=True)
    if timing:
        def split():
            gcl_bwd.gcl_bwd_data(x, up, aux, gates, wbig)
            gcl_bwd.gcl_bwd_weight(x, up, aux, gates)

        res["fused_ms"] = time_ms(
            lambda: gcl_bwd.gcl_bwd_fused(x, up, aux, gates, wbig))
        res["split_ms"] = time_ms(split)
        res["plain_ms"] = time_ms(
            lambda: gcl_bwd.gcl_bwd_fused_plain(x, up, aux, gates, wbig),
            reps=2)
        nbytes = 3 * x.numel() * 4 + aux.numel() * 4 + gates.numel() * 4 \
            + 2 * wbig.numel() * 4 + 33 * d * 4
        data, dense, cost_est = fused_bwd_work(mask, d, nbar)
        res["bound_ms"], res["bound_by"] = bound_ms(data, nbytes)
        res["dense_bound_ms"] = bound_ms(dense, nbytes)[0]
        res["cost_estimate_bound_ms"] = bound_ms(cost_est, nbytes)[0]
    set_train_kernel_counts(before)  # comparison launches do not count
    return res


def chord_inputs(nbar, d, device, seed):
    import torch

    g = torch.Generator().manual_seed(seed)
    h = d // 2
    mask = torch.from_numpy(bar_masks(nbar, 4, 32, seed))
    x = (torch.randn(nbar, 4, 32, d, generator=g) * mask[..., None])
    p = [torch.randn(d, 15 * d, generator=g) * d ** -0.5,
         torch.randn(15 * d, generator=g) * 0.1,
         torch.randn(h, 131, generator=g) * h ** -0.5,
         torch.randn(131, generator=g) * 0.1,
         torch.randn(h, 131, generator=g) * h ** -0.5,
         torch.randn(131, generator=g) * 0.1,
         torch.randn(h, 99, generator=g) * h ** -0.5,
         torch.randn(99, generator=g) * 0.1]
    return mask.to(device), [v.contiguous().to(device) for v in [x] + p]


def chord_gaps(x, ck, cb, pkd, pbd, pkn, pbn, dk, db):
    """Top-2 logit gaps (..., T, S, 15, 2) of the plain chord tail."""
    import torch

    d = x.shape[-1]
    h = d // 2
    gaps = []
    for s in range(15):
        sh = x @ ck[:, s * d:(s + 1) * d] + cb[s * d:(s + 1) * d]
        pitch = torch.cat([sh[..., :1, :, :h] @ pkd + pbd,
                           sh[..., 1:, :, :h] @ pkn + pbn], dim=-3)
        dur = sh[..., h:] @ dk + db
        g2 = [v.topk(2, dim=-1).values for v in (pitch, dur)]
        gaps.append(torch.stack([v[..., 0] - v[..., 1] for v in g2], -1))
    return torch.stack(gaps, dim=-2)


def check_chord(nbar, d, device, timing=True):
    import torch

    from polyphemus_tpu_torch.ops.kernels import chord_tail

    mask, args = chord_inputs(nbar, d, device, SEED + 7)
    before = chord_tail.launches
    out = chord_tail.chord_tail_tokens(*args, n_slots=15)
    ref = chord_tail.chord_tail_plain(*args, n_slots=15)
    gaps = chord_gaps(*args)
    torch.cuda.synchronize()
    check(out.shape == ref.shape and out.dtype == torch.int32,
          f"chord_tail output {out.dtype} {tuple(out.shape)}")
    tie = gaps < TIE
    diff = out != ref
    check(not (diff & ~tie).any().item(),
          f"chord_tail nbar={nbar}: {int((diff & ~tie).sum())} ids differ "
          f"outside near-ties")
    check(tie.float().mean().item() < 1e-3, "too many chord-tail near-ties")
    res = {"max_abs_err": (out - ref)[~tie].abs().max().item(),
           "tie_mismatches": int((diff & tie).sum()),
           "near_ties": int(tie.sum())}
    if timing:
        res["ms"] = time_ms(lambda: chord_tail.chord_tail_tokens(
            *args, n_slots=15))
        res["plain_ms"] = time_ms(lambda: chord_tail.chord_tail_plain(
            *args, n_slots=15), reps=2)
        h = d // 2
        # an inactive cell has x = 0, so its ids depend only on whether it
        # is a drum cell: one distinct row per such class, then each active
        # cell
        inactive = ~mask
        rows = int(mask.sum()) + int(inactive[:, 0].any()) \
            + int(inactive[:, 1:].any())
        per_row = 15 * (2.0 * d * d + 2.0 * h * (131 + 99))
        nbytes = sum(a.numel() * a.element_size() for a in args) \
            + out.numel() * 4
        res["bound_ms"], res["bound_by"] = bound_ms(rows * per_row, nbytes)
        res["dense_bound_ms"] = bound_ms(mask.numel() * per_row, nbytes)[0]
    chord_tail.launches = before
    return res


# --------------------------------------------------------- phase 3: service
def make_model_dir(path, cfg_model, seed):
    """A seeded random-init model saved as a port model directory."""
    import torch

    from polyphemus_tpu_torch.config import TrainConfig
    from polyphemus_tpu_torch.convert import save_checkpoint
    from polyphemus_tpu_torch.models import VAE

    torch.manual_seed(seed)
    model = VAE(cfg_model)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):  # zero biases tie every empty cell
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=g))
            elif name.endswith("running_var"):
                buf.copy_(1.0 + 0.1 * torch.rand(buf.shape, generator=g))
    save_checkpoint(path, model, TrainConfig(model=cfg_model))


def post(url, payload):
    req = urllib.request.Request(
        url + "/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        check(r.status == 200, f"/generate returned {r.status}")
        return json.loads(r.read())


def check_tokens(mask, toks, n, mc):
    mask, toks = np.asarray(mask, bool), np.asarray(toks)
    check(mask.shape == (n, mc.n_bars, 4, mc.n_timesteps),
          f"mask shape {mask.shape}")
    check(toks.shape == mask.shape + (15, 2), f"tokens shape {toks.shape}")
    check(toks[..., 0].max() < 131 and toks[..., 1].max() < 99 and
          toks.min() >= 0, "token ids outside the vocabularies")
    check(mask.any(axis=(-1, -2)).all(), "an empty bar was generated")


def serve_phase(model_dir, mc, device, tiers, big_n, structure):
    """Drive the HTTP service; returns (stats, launches, n=8 (mask, tokens))."""
    import base64

    from polyphemus_tpu_torch.ops.kernels import chord_tail, gcl
    from polyphemus_tpu_torch.serve import serve

    httpd, svc = serve(model_dir, port=0, batch_cap=tiers[-1], tiers=tiers,
                       device=device)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            check(json.loads(r.read())["status"] == "ok", "healthz")
        calls0 = svc.stats["device_calls"]
        gcl.launches = chord_tail.launches = 0
        # ---- the main path ----
        one = post(url, {"n": 1, "seed": 1})
        eight = post(url, {"n": 8, "seed": 8, "format": "tokens"})
        big = post(url, {"n": big_n, "seed": 256})
        cond = post(url, {"n": 2, "seed": 3, "structure": structure,
                          "format": "tokens"})
        # burst of 8 concurrent n=1 requests, released together
        burst = [None] * 8
        with svc._lock:
            ths = [threading.Thread(target=lambda i=i: burst.__setitem__(
                i, post(url, {"n": 1, "seed": 100 + i}))) for i in range(8)]
            for t_ in ths:
                t_.start()
            deadline = time.time() + 120
            while len(svc._pending) < 7 and time.time() < deadline:
                time.sleep(0.01)
        for t_ in ths:
            t_.join(600)
        launches = {"gcl_eval": gcl.launches, "chord_tail": chord_tail.launches}
        calls = svc.stats["device_calls"] - calls0
    finally:
        httpd.shutdown()
        httpd.server_close()
    for body, n in ((one, 1), (big, big_n)):
        mids = [base64.b64decode(m) for m in body["midi_b64"]]
        check(len(mids) == n and all(m[:4] == b"MThd" for m in mids),
              "MIDI responses")
    for b in burst:
        check(b is not None and base64.b64decode(b["midi_b64"][0])[:4]
              == b"MThd", "burst response")
    check_tokens(eight["mask"], eight["tokens"], 8, mc)
    check_tokens(cond["mask"], cond["tokens"], 2, mc)
    want = np.asarray(structure, bool)
    want = np.tile(want, (-(-mc.n_bars // want.shape[0]), 1, 1))[:mc.n_bars]
    check((np.asarray(cond["mask"], bool) == want[None]).all(),
          "conditioned mask differs from the requested structure")
    stats = dict(svc.stats)
    check(stats["coalesced_requests"] >= 2, f"burst did not coalesce: {stats}")
    return stats, calls, launches, (np.asarray(eight["mask"], bool),
                                    np.asarray(eight["tokens"]))


def compare_with_cpu(model_dir, n8, device):
    """The n = 8 served result against the same request on the CPU: masks
    equal where |s_logit| > 1e-3; ids equal outside top-2 gaps < 1e-4
    (compared on the CPU's mask when a threshold flipped)."""
    import torch

    from polyphemus_tpu_torch.generate import load_model, make_generator
    from polyphemus_tpu_torch.serve import host_z

    model, cfg = load_model(model_dir, "cpu")
    z = host_z(8, 8, cfg.model.d)
    m_c, t_c, s_c, c_c = make_generator(model, return_logits=True,
                                        device="cpu")(z)
    m_g, t_g = n8
    clear = s_c.abs().numpy() > 1e-3
    flips = int((m_g != m_c.numpy()).sum())
    check((m_g == m_c.numpy())[clear].all(), "n=8 mask differs from the CPU")
    if flips:
        gmodel, _ = load_model(model_dir, device)
        _, t_g = make_generator(gmodel, conditioned=True, device=device)(
            z, m_c.numpy())
        t_g = t_g.cpu().numpy()
    c = c_c.numpy().astype(np.float64)
    gaps = np.stack([np.diff(np.sort(c[..., :131], -1)[..., -2:], axis=-1)[..., 0],
                     np.diff(np.sort(c[..., 131:], -1)[..., -2:], axis=-1)[..., 0]],
                    -1)
    tie = gaps < TIE
    diff = t_g != t_c.numpy()
    check(not (diff & ~tie).any(),
          f"n=8 tokens differ from the CPU at {int((diff & ~tie).sum())} ids")
    return {"mask_flips": flips, "id_mismatches_at_ties": int((diff & tie).sum()),
            "near_ties": int(tie.sum())}


# -------------------------------------------------------- phase 5: training
LOSS_KEYS = ("tot", "pitch", "dur", "structure", "reconstruction", "kld",
             "beta*kld")
METRIC_KEYS = ("note", "pitch", "pitch_drums", "pitch_non_drums", "dur",
               "s_acc", "s_precision", "s_recall", "s_f1")
TRAIN_LOSS_RTOL = 2e-4   # card vs CPU step: each loss, relative
BF16_LOSS_RTOL = 3e-2    # the same under the bf16 policy
TRAIN_GRAD_TOL = 1e-3    # card vs CPU step: max abs err / max |cpu| per grad
# a grad below this share of the model's largest |grad| is rounding noise (a
# bias that feeds batch-norm with batch statistics has a true gradient of 0):
# it is held to an abs err of GRAD_NOISE x the largest |grad| instead
GRAD_NOISE = 1e-5
BF16_GRAD_FLOOR = 1e-3  # bf16: a grad is held if its max is this share of
#                         the largest |grad|
BF16_GRAD_COS = 0.85    # bf16: least cosine of a held grad with the CPU's
BF16_CMP_BATCH = 32     # the bf16 card-vs-CPU step whose grads are held
RESOLVED = 2.0 ** -5    # bf16 resolves a batch variance >= this x mean^2


def train_kernel_counts():
    from polyphemus_tpu_torch.ops.kernels import gcl, gcl_bwd

    return {"gcl_fwd": gcl.fwd_launches,
            "gcl_bwd_data": gcl_bwd.data_launches,
            "gcl_bwd_weight": gcl_bwd.weight_launches,
            "gcl_fwd_bf16": gcl.fwd_bf16_launches,
            "gcl_bwd_fused": gcl_bwd.fused_launches}


def set_train_kernel_counts(counts):
    """Set the training kernels' launch counters to `counts`, a dict as
    `train_kernel_counts` returns it."""
    from polyphemus_tpu_torch.ops.kernels import gcl, gcl_bwd

    gcl.fwd_launches = counts["gcl_fwd"]
    gcl_bwd.data_launches = counts["gcl_bwd_data"]
    gcl_bwd.weight_launches = counts["gcl_bwd_weight"]
    gcl.fwd_bf16_launches = counts["gcl_fwd_bf16"]
    gcl_bwd.fused_launches = counts["gcl_bwd_fused"]


def check_launches(counts, per_step, steps):
    """Exactly per_step[k] launches of kernel k per optimizer step, and none
    of the training kernels per_step does not name."""
    for name, n in counts.items():
        want = per_step.get(name, 0) * steps
        check(n == want, f"expected {per_step.get(name, 0)} {name} launches "
                         f"per optimizer step, got {n} in {steps} steps")


def write_dataset(path, n, n_bars, seed):
    """n reference-format .npz samples of synthetic music (density 0.15)."""
    from polyphemus_tpu_torch.data import synthetic_batch, write_sample

    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    toks, mask = synthetic_batch(np.random.default_rng(seed), n, n_bars)
    for i in range(n):
        write_sample(os.path.join(path, f"s{i:04d}.npz"), toks[i], mask[i])


def train_phase(device, config_path, data_dir, out_dir, epochs,
                splits=("--tr_split", "1.0")):
    """Train through the CLI's `main()` (`splits`: its data-split and eval
    arguments); returns (trainer, model dir, the main path's launch counts
    of the training kernels and of the bf16 eval kernel, metrics.jsonl
    records)."""
    from polyphemus_tpu_torch.cli import train as train_cli
    from polyphemus_tpu_torch.ops.kernels import gcl

    shutil.rmtree(out_dir, ignore_errors=True)
    set_train_kernel_counts(dict.fromkeys(train_kernel_counts(), 0))
    gcl.eval_bf16_launches = 0
    # ---- the main path ----
    trainer = train_cli.main([
        data_dir, out_dir, config_path, "--model_name", "lmd2",
        *splits, "--max_epochs", str(epochs), "--save_every",
        "0", "--num_workers", "8", "--seed", str(SEED),
        "--device", str(device)])
    counts = dict(train_kernel_counts(),
                  gcl_eval_bf16=gcl.eval_bf16_launches)
    model_dir = os.path.join(out_dir, "lmd2")
    with open(os.path.join(model_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return trainer, model_dir, counts, recs


def check_records(recs, steps, evals=0):
    """`steps` training records and `evals` validation records (prefix
    `val_`), each with every loss and metric, all finite."""
    val = [r for r in recs if "val_loss/tot" in r]
    check(len(recs) - len(val) == steps and len(val) == evals,
          f"{len(recs) - len(val)} training and {len(val)} validation "
          f"metrics.jsonl records for {steps} steps and {evals} evaluations")
    for r in recs:
        pre = "val_" if r in val else ""
        vals = [r.get(f"{pre}loss/{k}") for k in LOSS_KEYS] + [
            r.get(f"{pre}acc/{k}") for k in METRIC_KEYS]
        check(all(v is not None and np.isfinite(v) for v in vals),
              f"a loss or metric is missing or not finite: {r}")


def serve_trained(model_dir, mc, device):
    """The trained directory behind the HTTP service: one n = 8 request."""
    from polyphemus_tpu_torch.serve import serve

    httpd, _ = serve(model_dir, port=0, batch_cap=8, tiers=[8],
                     device=device)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        out = post(f"http://127.0.0.1:{httpd.server_address[1]}",
                   {"n": 8, "seed": 5, "format": "tokens"})
    finally:
        httpd.shutdown()
        httpd.server_close()
    check_tokens(out["mask"], out["tokens"], 8, mc)


def cosine(a, b) -> float:
    """Cosine of the angle between two tensors read as flat fp64 vectors
    (0 when either is all zero)."""
    a, b = a.double().flatten(), b.double().flatten()
    den = (a.norm() * b.norm()).item()
    return (a @ b).item() / den if den > 0 else 0.0


def centre_merge_input(model, mc, toks, mask, eps):
    """Shift `linear_merge`'s bias by minus the batch mean of its output
    (an fp32 forward of a copy of `model` on this batch).

    The shift leaves a training step's function unchanged, since
    `bn_linear_merge` subtracts the batch mean again; what it changes is
    bf16's rounding. Its E[x^2] - mean^2 errs by up to ~2^-8 mean^2, and
    at the seeded random init 16-20 of the flagship's 512 merge features
    have a batch variance below 2^-7 mean^2 at every batch from 32 to 256:
    their variance rounds to a few bits or to 0, the feature is scaled by
    up to 1 / sqrt(eps), and mu, log_var, the KLD and every grad follow
    each device's rounding (the JAX package computes the statistics the
    same way). Centred, the features' means are rounding-sized and bf16
    resolves every variance."""
    import copy

    import torch

    from polyphemus_tpu_torch.config import TrainConfig
    from polyphemus_tpu_torch.train import trainer as tr

    probe = copy.deepcopy(model).train()
    seen = {}
    handle = probe.encoder.bn_linear_merge.register_forward_hook(
        lambda mod, args, _: seen.update(x=args[0].detach()))
    with torch.no_grad():
        tr.forward_loss(probe, TrainConfig(batch_size=len(toks), model=mc),
                        toks, mask, 0.0, eps=eps)
        handle.remove()
        x = seen["x"]
        model.encoder.linear_merge.bias -= x.reshape(-1, x.shape[-1]).mean(0)


def shift_free_grads(model, mc, toks, mask, eps):
    """The parameters whose true grad on this batch is 0: their fp32 grad
    (one fp32 step of `model` on the CPU) is under GRAD_NOISE x the largest.
    They are the biases that feed a norm with batch statistics, which
    removes any shift; under the bf16 policy their grads are rounding
    noise."""
    from polyphemus_tpu_torch.config import TrainConfig
    from polyphemus_tpu_torch.train import trainer as tr

    cfg = TrainConfig(batch_size=len(toks), model=mc)
    step = tr.make_train_step(model, cfg, tr.make_optimizer(model, cfg))
    step(toks, mask, eps=eps)
    top = {n: p.grad.abs().max().item() for n, p in model.named_parameters()}
    scale = max(top.values())
    return {n for n, v in top.items() if v < GRAD_NOISE * scale}


def compare_train_step(mc, batch, device, seed, check_grads=True,
                       bf16=False):
    """One eval step, then one train step, from the same weights, batch and
    eps on the card and on the CPU. The eval losses (running statistics)
    are held as the train losses are.

    fp32: losses within TRAIN_LOSS_RTOL and, with check_grads, each grad
    within TRAIN_GRAD_TOL of its max |cpu| (rounding-noise grads:
    GRAD_NOISE). At batch 2 the grads are reported, not held: the two
    batch-norms over 2 samples (`bn_linear_merge`, the decoder head's) make
    the grads behind them hang on fp32 rounding, so that the card's kernels
    and the card's plain versions differ there as much as either differs
    from the CPU.

    bf16 policy: every loss within BF16_LOSS_RTOL and, with check_grads,
    each grad whose max is at least BF16_GRAD_FLOOR of the largest and
    whose true value is not 0 (`shift_free_grads`) points the CPU's way:
    cosine >= BF16_GRAD_COS (bf16 grads behind a batch-norm differ in
    their elements by tens of percent of their max between two summation
    orders; the JAX package's bf16 and fp32 grads do too). First
    `centre_merge_input` reconditions the weights; the step fails unless
    bf16 then resolves the batch variance of every `bn_linear_merge`
    feature on both devices (var >= RESOLVED x mean^2 over the batch, in
    fp32 from its input).
    """
    import copy

    import torch

    from polyphemus_tpu_torch.config import TrainConfig
    from polyphemus_tpu_torch.data import synthetic_batch
    from polyphemus_tpu_torch.models import VAE
    from polyphemus_tpu_torch.train import trainer as tr

    cfg = TrainConfig(batch_size=batch, model=mc, iters_to_accumulate=1,
                      bf16=bf16)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        cpu_model = VAE(mc)
    rng = np.random.default_rng(seed)
    toks, mask = (torch.from_numpy(a) for a in synthetic_batch(rng, batch,
                                                               mc.n_bars))
    eps = torch.from_numpy(rng.standard_normal((batch, mc.d)).astype(
        np.float32))
    if bf16:
        centre_merge_input(cpu_model, mc, toks, mask, eps)
        shift_free = shift_free_grads(copy.deepcopy(cpu_model), mc, toks,
                                      mask, eps)
    card_model = copy.deepcopy(cpu_model).to(device)
    out, unresolved = {}, {}

    def merge_bn_hook(name):
        def hook(mod, args, _):
            x = args[0].detach().float()
            var, mean = x.var(0, unbiased=False), x.mean(0)
            unresolved[name] = int((var < RESOLVED * mean.square()).sum())
        return hook

    evals = {}
    for name, model, dev in (("cpu", cpu_model, torch.device("cpu")),
                             ("card", card_model, device)):
        lo, _ = tr.eval_step(model, cfg, toks.to(dev), mask.to(dev), 0,
                             eps=eps.to(dev))
        evals[name] = {k: float(v) for k, v in lo.items()}
        handle = model.encoder.bn_linear_merge.register_forward_hook(
            merge_bn_hook(name))
        step = tr.make_train_step(model, cfg, tr.make_optimizer(model, cfg))
        losses, _ = step(toks.to(dev), mask.to(dev), eps=eps.to(dev))
        handle.remove()
        out[name] = ({k: float(v) for k, v in losses.items()},
                     {n: p.grad.detach().cpu()
                      for n, p in model.named_parameters()})
    (l_cpu, g_cpu), (l_card, g_card) = out["cpu"], out["card"]
    check(not bf16 or max(unresolved.values()) == 0,
          f"bf16 step at batch {batch}: bf16 does not resolve the batch "
          f"variance of {unresolved} bn_linear_merge features")
    rel = {k: abs(l_card[k] - l_cpu[k]) / max(abs(l_cpu[k]), 1e-12)
           for k in LOSS_KEYS if l_cpu[k] != 0.0}
    loss_err = max(rel.values())
    check(loss_err <= (BF16_LOSS_RTOL if bf16 else TRAIN_LOSS_RTOL) and all(
        (l_card[k] == 0.0) == (l_cpu[k] == 0.0) for k in LOSS_KEYS),
        f"card losses {l_card} vs cpu {l_cpu}")
    eval_rel = {k: abs(evals["card"][k] - evals["cpu"][k])
                / max(abs(evals["cpu"][k]), 1e-12)
                for k in LOSS_KEYS if evals["cpu"][k] != 0.0}
    check(max(eval_rel.values()) <= (BF16_LOSS_RTOL if bf16
                                     else TRAIN_LOSS_RTOL),
          f"card eval losses {evals['card']} vs cpu {evals['cpu']}")
    scale = max(g.abs().max().item() for g in g_cpu.values())
    rows = {}
    for n, g in g_cpu.items():
        err = (g_card[n] - g).abs().max().item()
        ref = g.abs().max().item()
        cos = cosine(g_card[n], g)
        if bf16:
            noise = n in shift_free or ref < BF16_GRAD_FLOOR * scale
            score = 0.0 if noise else (1.0 - cos) / (1.0 - BF16_GRAD_COS)
        else:
            noise = ref <= GRAD_NOISE * scale
            score = (err / (GRAD_NOISE * scale) if noise
                     else err / (TRAIN_GRAD_TOL * ref))
        rows[n] = (score, err, ref, cos, noise)
    worst = sorted(rows, key=lambda n: -rows[n][0])[:4]
    check(not check_grads or rows[worst[0]][0] <= 1.0,
          f"grads off: {[(n, rows[n]) for n in worst]} (largest |grad| "
          f"{scale:.3e})")
    held = [n for n in rows if not rows[n][4]]
    return {"batch": batch, "bf16": bf16, "grads_held": check_grads,
            "max_loss_rel_err": loss_err, "loss_rel_err": rel,
            "eval_max_loss_rel_err": max(eval_rel.values()),
            "losses_cpu": l_cpu, "losses_card": l_card,
            "merge_bn_features_unresolved_in_bf16": unresolved,
            "n_grads": len(rows), "n_grads_held": len(held),
            "n_grads_shift_free": len(shift_free) if bf16 else None,
            "largest_grad": scale,
            "min_grad_cosine": min(rows[n][3] for n in held),
            "max_grad_err_over_max": max(rows[n][1] / rows[n][2]
                                         for n in held),
            "worst_grads": [{"name": n, "score": rows[n][0],
                             "max_abs_err": rows[n][1],
                             "max_abs_cpu": rows[n][2],
                             "cosine": rows[n][3]} for n in worst]}


def time_train_steps(trainer, batch, device, passes=3, steps=5):
    """Seconds per optimizer step (host clock around steps that end in a
    sync): median of `passes` passes of `steps` steps, after one warm step,
    on device-resident synthetic batches."""
    import torch

    from polyphemus_tpu_torch.data import synthetic_batch

    rng = np.random.default_rng(SEED + 3)
    toks, mask = (torch.from_numpy(a).to(device) for a in synthetic_batch(
        rng, batch, trainer.cfg.model.n_bars))
    gen = torch.Generator(device=device).manual_seed(SEED)
    trainer.train_step(toks, mask, generator=gen)
    torch.cuda.synchronize()
    times = []
    for _ in range(passes):
        t0 = time.perf_counter()
        for _ in range(steps):
            losses, _ = trainer.train_step(toks, mask, generator=gen)
        float(losses["tot"])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / steps)
    s = statistics.median(times)
    return {"metric": "lmd2_train_step", "step_s": s, "seq_s": batch / s,
            "batch": batch, "accumulate": trainer.cfg.iters_to_accumulate,
            "passes_step_s": times}


def profile_train_step(trainer, batch, device, path):
    """Device time by kernel over one optimizer step (torch.profiler),
    written to `path`; returns the step's wall time, the summed kernel time
    (device busy; the idle share is the rest) and the top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from polyphemus_tpu_torch.data import synthetic_batch

    toks, mask = (torch.from_numpy(a).to(device) for a in synthetic_batch(
        np.random.default_rng(SEED + 4), batch, trainer.cfg.model.n_bars))
    gen = torch.Generator(device=device).manual_seed(SEED)
    trainer.train_step(toks, mask, generator=gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(toks, mask, generator=gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    with open(path, "w") as f:
        f.write(f"step wall {wall_ms:.3f} ms, kernels {busy:.3f} ms\n")
        for key, ms, count in rows:
            f.write(f"{ms:12.3f} ms {count:6d}x  {key}\n")
    return {"step_wall_ms": wall_ms, "kernel_ms": busy,
            "idle_share": 1.0 - busy / wall_ms,
            "top": [{"name": k[:80], "ms": ms, "calls": c}
                    for k, ms, c in rows[:12]]}


# ----------------------------------------------------------- phase 4: bench
def bench(model_dir, device, batch=256, rounds=20):
    import torch

    from polyphemus_tpu_torch.generate import load_model, make_generator

    model, cfg = load_model(model_dir, device)
    gen = make_generator(model, device=device)
    g = torch.Generator(device=device).manual_seed(100)
    zs = [torch.randn(batch, cfg.model.d, generator=g, device=device)
          for _ in range(rounds)]
    gen(zs[0])
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        for z in zs:
            out = gen(z)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    del out
    dt = statistics.median(times)
    return {"metric": "lmd2_batched_generation", "value": rounds * batch / dt,
            "unit": "seq/s", "batch": batch, "call_ms": dt / rounds * 1e3,
            "passes_s": times}


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on the card")
    sys.path.insert(0, ROOT)
    try:
        import polyphemus_tpu_torch
        from polyphemus_tpu_torch.config import ModelConfig
        from polyphemus_tpu_torch.generate import load_structure_file
        from polyphemus_tpu_torch.ops.kernels import _build
    except ImportError as e:
        fail(f"polyphemus_tpu_torch is not importable beside this script: {e}")
    pkg_dir = os.path.dirname(os.path.abspath(polyphemus_tpu_torch.__file__))
    check(pkg_dir == os.path.join(ROOT, "polyphemus_tpu_torch"),
          f"polyphemus_tpu_torch was imported from {pkg_dir}, not from the "
          f"checkout beside this script")

    # ---- 1. the card, the toolchain, the build ----
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"device {torch.cuda.get_device_name(0)}")
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(logs)}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  {name}: {line.strip()}")
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 2. kernels against their plain versions ----
    small = {"gcl_eval_k1": check_gcl(8, 512, 1, device, timing=False),
             "gcl_eval_k3": check_gcl(8, 512, 3, device, timing=False),
             "chord_tail": check_chord(8, 512, device, timing=False)}
    print("small-shape check:", json.dumps(small))
    gcl1 = check_gcl(512, 512, 1, device)
    gcl2 = check_gcl(512, 512, 2, device)
    chord = check_chord(512, 512, device)
    print("flagship kernel check (512 bars, d=512):", json.dumps(
        {"gcl_eval_k1": gcl1, "gcl_eval_k2": gcl2, "chord_tail": chord}))

    # ---- 2b. training kernels against their plain versions ----
    print("small-shape training kernel check (8 bars, d=512):",
          json.dumps(check_gcl_train(8, 512, device, timing=False)))
    train_k = check_gcl_train(128, 512, device)
    print("flagship training kernel check (128 bars, d=512):",
          json.dumps(train_k))

    # ---- 2c. bf16 training kernels and the fused backward ----
    print("small-shape bf16 training kernel check (8 bars, d=512):",
          json.dumps(check_gcl_train_bf16(8, 512, device, timing=False)))
    bf16_k = check_gcl_train_bf16(256, 512, device)
    print(f"bf16 flagship training kernel check (256 bars, d=512, {card}):",
          json.dumps(bf16_k))
    print("small-shape bf16 eval GCL check (8 bars, d=512, K=1, 3):",
          json.dumps({f"gcl_eval_bf16_k{k}": check_gcl(
              8, 512, k, device, timing=False, bf16=True) for k in (1, 3)}))
    # the bf16 eval step's shape: batch 256 x 2 bars, one layer per launch
    eval16_k = check_gcl(512, 512, 1, device, bf16=True)
    print(f"bf16 eval GCL check (512 bars, d=512, K=1, {card}):",
          json.dumps(eval16_k))
    fused32 = check_fused_fp32(128, 512, device)
    print(f"fused vs split backward, fp32 (128 bars, d=512, {card}):",
          json.dumps(fused32))

    # ---- 3. the service on the card ----
    mc = ModelConfig(d=512, gnn_n_layers=8, n_bars=2, resolution=8,
                     dropout=0.0, batch_norm=True)
    model_dir = os.path.join(ROOT, "build", "chip_smoke_model")
    make_model_dir(model_dir, mc, SEED)
    structure = load_structure_file(
        os.path.join(ROOT, "examples", "structure.json"), mc.n_bars,
        mc.n_tracks, mc.n_timesteps).tolist()
    stats, calls, launches, n8 = serve_phase(
        model_dir, mc, device, [1, 8, 64, 256], 256, structure)
    print(f"service: {calls} device calls, stats {stats}, launches {launches}")
    check(launches["gcl_eval"] == 4 * calls,
          f"expected 4 gcl_eval launches per call, got {launches} / {calls}")
    check(launches["chord_tail"] == calls,
          f"expected 1 chord_tail launch per call, got {launches} / {calls}")
    cpu_cmp = compare_with_cpu(model_dir, n8, device)
    print("n=8 against the CPU:", json.dumps(cpu_cmp))

    # ---- 4. throughput at batch 256 ----
    res = bench(model_dir, device)
    res.update({"card": card, "gcl_eval_launches_per_call": 4,
                "kernel_ms_per_call": 4 * gcl2["ms"] + chord["ms"]})
    print("bench:", json.dumps(res))

    # ---- 5. training on the card ----
    config_path = os.path.join(ROOT, "examples", "training_lmd2.json")
    data_dir = os.path.join(ROOT, "build", "chip_smoke_data")
    write_dataset(data_dir, 512, mc.n_bars, SEED)
    epochs = 2  # 2 steps per epoch at batch 256 over 512 samples
    trainer, trained_dir, train_launches, recs = train_phase(
        device, config_path, data_dir, os.path.join(ROOT, "build",
                                                    "chip_smoke_train"),
        epochs)
    steps = trainer.step
    print(f"training: {steps} steps, launches {train_launches}, last "
          f"record {json.dumps(recs[-1])}")
    check(steps == 2 * epochs, f"{steps} optimizer steps")
    check_records(recs, steps)
    check_launches(train_launches, {"gcl_fwd": 64, "gcl_bwd_data": 64,
                                    "gcl_bwd_weight": 64}, steps)
    serve_trained(trained_dir, mc, device)
    for batch, held in ((2, False), (8, True)):
        step_cmp = compare_train_step(mc, batch, device, SEED + 5,
                                      check_grads=held)
        print(f"train step, card vs CPU (d=512, 8 layers, batch {batch}):",
              json.dumps(step_cmp))
    train_bench = time_train_steps(trainer, trainer.cfg.batch_size, device)
    train_bench["card"] = card
    print("train bench:", json.dumps(train_bench))
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    prof = profile_train_step(trainer, trainer.cfg.batch_size, device,
                              os.path.join(ROOT, "chiprun_out",
                                           "train_step_profile.txt"))
    print("train step profile:", json.dumps(prof))
    del trainer

    # ---- 6. bf16 training on the card, with an eval step per epoch ----
    # 1024 samples: 512 train (2 steps per epoch), 256 validation (one
    # eval batch after each epoch's last step)
    data16 = os.path.join(ROOT, "build", "chip_smoke_data_bf16")
    write_dataset(data16, 1024, mc.n_bars, SEED)
    trainer, _, bf16_launches, recs = train_phase(
        device, os.path.join(ROOT, "examples", "training_lmd2_bf16.json"),
        data16, os.path.join(ROOT, "build", "chip_smoke_train_bf16"),
        epochs, splits=("--tr_split", "0.5", "--vl_split", "0.25", "--eval"))
    steps = trainer.step
    evals = len(trainer.val_losses["tot"])
    print(f"bf16 training: {steps} steps, {evals} evaluations, launches "
          f"{bf16_launches}, last records {json.dumps(recs[-2:])}")
    check(trainer.cfg.bf16 and trainer.cfg.iters_to_accumulate == 2,
          "the bf16 config did not load as batch 256 / accumulate 2, bf16")
    check(steps == 2 * epochs and evals == epochs,
          f"{steps} bf16 optimizer steps, {evals} evaluations")
    check_records(recs, steps, evals)
    check_launches({k: v for k, v in bf16_launches.items()
                    if k != "gcl_eval_bf16"},
                   {"gcl_fwd_bf16": 32, "gcl_bwd_fused": 32}, steps)
    # one eval batch per evaluation: 2 GNN stacks of 8 layers, chain 1
    check(bf16_launches["gcl_eval_bf16"] == 16 * evals,
          f"expected 16 bf16 gcl_eval launches per evaluation, got "
          f"{bf16_launches['gcl_eval_bf16']} in {evals}")
    model = trainer.model
    check(all(p.dtype == torch.float32 for p in model.parameters()) and all(
        b.dtype == torch.float32 for b in model.buffers()
        if b.is_floating_point()),
        "master params or batch-norm buffers are not fp32 after bf16 steps")
    for batch, held in ((8, False), (BF16_CMP_BATCH, True)):
        step_cmp = compare_train_step(mc, batch, device, SEED + 5,
                                      check_grads=held, bf16=True)
        print(f"bf16 train step, card vs CPU (d=512, 8 layers, batch "
              f"{batch}):", json.dumps(step_cmp))
    bench16 = time_train_steps(trainer, trainer.cfg.batch_size, device)
    bench16["card"] = card
    print("bf16 train bench:", json.dumps(bench16))
    prof16 = profile_train_step(trainer, trainer.cfg.batch_size, device,
                                os.path.join(ROOT, "chiprun_out",
                                             "train_step_profile_bf16.txt"))
    prof16["card"] = card
    print("bf16 train step profile:", json.dumps(prof16))

    # ---- 7. results ----
    launches = dict(launches, **train_launches)
    launches.update({k: bf16_launches[k]
                     for k in ("gcl_fwd_bf16", "gcl_bwd_fused",
                               "gcl_eval_bf16")})

    def entry(name, src, replaces, r):
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": None}

    kernels = [
        entry("gcl_eval", "polyphemus_tpu_torch/csrc/gcl_eval.cu",
              "polyphemus_tpu/ops/kernels/gcl_pallas.py:440", gcl2),
        entry("chord_tail", "polyphemus_tpu_torch/csrc/chord_tail.cu",
              "polyphemus_tpu/ops/kernels/chord_tail.py:101", chord),
        entry("gcl_fwd", "polyphemus_tpu_torch/csrc/gcl_eval.cu",
              "polyphemus_tpu/ops/kernels/gcl_pallas.py:347",
              train_k["gcl_fwd"]),
        entry("gcl_bwd_data", "polyphemus_tpu_torch/csrc/gcl_bwd_data.cu",
              "polyphemus_tpu/ops/kernels/gcl_pallas_bwd.py:528",
              train_k["gcl_bwd_data"]),
        entry("gcl_bwd_weight",
              "polyphemus_tpu_torch/csrc/gcl_bwd_weight.cu",
              "polyphemus_tpu/ops/kernels/gcl_pallas_bwd.py:564",
              train_k["gcl_bwd_weight"]),
        entry("gcl_fwd_bf16", "polyphemus_tpu_torch/csrc/gcl_eval.cu",
              "polyphemus_tpu/ops/kernels/gcl_pallas.py:347",
              bf16_k["gcl_fwd_bf16"]),
        entry("gcl_bwd_fused", "polyphemus_tpu_torch/csrc/gcl_bwd_fused.cu",
              "polyphemus_tpu/ops/kernels/gcl_pallas_bwd.py:453",
              bf16_k["gcl_bwd_fused"]),
        entry("gcl_eval_bf16", "polyphemus_tpu_torch/csrc/gcl_eval.cu",
              "polyphemus_tpu/ops/kernels/gcl_pallas.py:347", eval16_k)]
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
