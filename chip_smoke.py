#!/usr/bin/env python3
"""Smoke run of polyphemus_tpu_torch on one CUDA card.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit), the torch and CUDA
   versions, and builds the CUDA kernels from the sources in the checkout
   (ptxas' registers and spills printed). Counts the tensor-core
   instructions (HMMA/HGMMA) in the SASS of both forms of the bf16 GCL
   kernel (`csrc/gcl_eval_bf16_tc.cu`: the eval form and the training
   forward), of both kernels of the bf16 fused GCL backward
   (`csrc/gcl_bwd_fused_bf16_tc.cu`: the dH kernel and the dW kernel)
   and of the bf16 chord-tail kernel (`csrc/chord_tail_bf16_tc.cu`, its
   d = 512 form, and its MIX form for S % 16 != 0; `cuobjdump -sass`) and
   fails if any has none; counts those
   of both forms of the fp32 GCL kernel (`csrc/gcl_eval_fp32.cu`), of the
   fp32 fused backward (`csrc/gcl_bwd_fused.cu`) and of the fp32 chord-tail
   kernel (`csrc/chord_tail_fp32.cu`, its d = 512 form) and fails if any
   holds one, or no FFMA. Every form of the grid GCL kernels (bars of 4 x
   S cells, S != 32: both forms of `csrc/gcl_eval_grid_fp32.cu` and
   `csrc/gcl_eval_grid_bf16_tc.cu`, the eval layer and the training
   forward; the instantiation of each S of `csrc/gcl_bwd_data_grid.cu`,
   `csrc/gcl_bwd_weight_grid.cu` and both kernels of
   `csrc/gcl_bwd_fused_grid_bf16_tc.cu`) with its registers, spills,
   dynamic shared memory and SASS counts: each bf16 form must hold
   tensor-core instructions, each fp32 form FFMA and none, without
   spills. The same for the fp32 weight and data backward
   kernels (`csrc/gcl_bwd_weight.cu`, `csrc/gcl_bwd_data.cu`), with their
   ptxas registers and spills and their dynamic shared memory printed; it
   fails if ptxas spilled any bytes of either. ptxas' registers, spills,
   stack and static
   shared memory are printed for each kernel function (each template
   instantiation) of each source.
2. Holds each kernel against its plain PyTorch version on the card, at the
   flagship shapes (batch 256 = 512 bars, d = 512) on realistic and edge-case
   masks: `gcl_eval` at K = 1 and K = 2 (rtol = atol = 2e-4) and
   `chord_tail` (ids equal except where the plain top-2 logit gap is below
   1e-4). Times each (CUDA events, warm) beside its bound: the larger of
   bytes over 3.35 TB/s and the fp32 flops these masks need (active cells;
   `dense_bound_ms` counts every cell) over the card's fp32 peak
   (`flops.PEAK_FLOPS`: 66.9 TFLOP/s on an H100 SXM). The fp32
   `gcl_eval` times are printed beside the first fp32 kernel's recorded
   ones (`SIMT_EVAL_FP32_MS`), the fp32 `chord_tail` beside the SIMT
   kernel's (`SIMT_CHORD_FP32_MS`).
2b. Holds the training GCL kernels (`gcl_fwd`, `gcl_bwd_data`,
   `gcl_bwd_weight`) against their plain versions at 8 bars and at the
   flagship training microbatch (64 sequences = 128 bars, d = 512): the
   forward and dx at rtol = atol = 2e-4, the sums over bars (dgate, dbias,
   dWbig) at max abs err <= 1e-4 x max |plain|; times each the same way,
   `gcl_fwd` beside the recorded time of the SIMT kernel it replaced
   (`SIMT_FWD_MS`), `gcl_bwd_weight` beside that of its split-K form
   (`SPLIT_K_WEIGHT_FP32_MS`), `gcl_bwd_data` beside that of its first
   design (`FIRST_DESIGN_DATA_FP32_MS`).
2c. The bf16 training kernels, `gcl_fwd` in bf16 and the fused single-pass
   backward `gcl_bwd_fused` in bf16, against their bf16 plain versions at 8
   and 256 bars (the bf16 config's microbatch of 128 sequences): every
   output within 2e-2 x max |plain|; their bound counts the bf16 tensor
   cores (989.4 TFLOP/s), `cuda_core_bound_ms` the CUDA cores (where the
   fused backward's first form ran); `gcl_fwd` is timed beside the SIMT
   kernel's recorded time, `gcl_bwd_fused` beside the FFMA form's
   (`FFMA_FUSED_BF16_MS`) and the form whose dW product ran FFMA over
   partials in device memory (`TC_DH_FUSED_BF16_MS`), with ptxas'
   registers and spills and the HMMA count of each of its two kernels.
   `gcl_bwd_fused` in fp32 at 128 bars against its
   fp32 plain version at the tolerances of 2b, and timed (`fused_ms`)
   beside `gcl_bwd_data` + `gcl_bwd_weight` on the same inputs (`split_ms`).
   `gcl_eval` in bf16 (the tensor-core kernel; the bf16 eval step's GCN)
   at 8 bars (K = 1, 3) and at 512 bars (K = 1, the eval batch of 256),
   within 2e-2 x max |plain|, timed beside the CUDA-core form's recorded
   time (`CUDA_CORE_EVAL_BF16_MS`).
3. Seeds a random-init flagship model (d = 512, 8 GNN layers, 2 bars,
   batch-norm on), saves it as a port model directory and serves it over
   HTTP on localhost with tiers [1, 8, 64, 256]: n = 1, 8 and 256, one
   structure-conditioned request and a burst of 8 concurrent n = 1 requests
   that must coalesce. Checks shapes, dtypes, vocabularies, non-empty bars,
   MIDI headers, that both kernels launched (4 `gcl_eval` launches and 1
   `chord_tail` launch per device call), and that the n = 8 result equals
   the same request on the CPU by the threshold and tie rules.
2d. The bf16 generation kernels at 512 bars: `chord_tail` in bf16 (ids
   equal outside top-2 gaps < 1e-4 of its fp32 logits; timed beside the
   SIMT kernel's recorded time, `SIMT_CHORD_BF16_MS`, and beside the dense
   bound of the three-part unembed that its tensor-core products take,
   `dense_split_bound_ms`) and `gcl_eval` in bf16 at K = 2 (within 2e-2 x
   max |plain|), timed as in 2c.
4. Batch-256 throughput by bench.py's protocol (20 calls, median of 3).
4b. The same in bf16 (`make_generator(bf16=True)`; its call time over
   fp32's printed): exactly 4 bf16 `gcl_eval` and 1 bf16 `chord_tail`
   launch per call and no fp32 one; an
   n = 8 bf16 request on the card against the CPU, unconditioned and on a
   given structure (masks equal where |s_logit| > 0.03, at most 1 % of
   cells flipped; in the bars whose masks agree the GCN output within
   2e-2 x max |cpu| and ids equal outside top-2 gaps of the fp32 chord-tail
   logits below twice their largest card-vs-CPU difference, a band that may
   cover at most 25 % of the active ids); then the port's
   `generate` CLI on the card (fp32 and --bf16, MIDI that parses, the
   launches of 2 calls) and its `reconstruct` CLI on 2 samples (8 encoder
   and 4 decoder `gcl_eval` launches, 1 `chord_tail`).
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
   Seconds per optimizer step at batch 256 (median of 2 passes of 3 steps)
   and seq/s, and one profiled step (device time by kernel, the idle share,
   and the share of the step that the `gcl_fwd` kernel takes).
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
   in 5.
7. Trains LMD16 (`examples/training_lmd16.json` as shipped: 16 bars, batch
   64 in 4 microbatches of 16 sequences = 256 bars, fp32) through
   `cli.train.main()` with `--profile` on 704 synthetic 16-bar samples
   (11 steps, so the CLI's trace of steps 10-15 is written, cut to step 10
   by the end of training): records finite, exactly 64 launches each of
   `gcl_fwd`, `gcl_bwd_data` and `gcl_bwd_weight` per step and none of the
   bf16 ones, the meta file `checkpoint.json` beside `checkpoint.pt`, a
   trace with device kernels. The three training kernels against their
   plain versions at 256 bars (the tolerances of 2b) and timed; seconds
   per step and seq/s as in 5; one step at batch 8 on
   the card against the CPU: the losses within 2e-4 relative, each grad
   that is not noise at cosine >= 0.9999 with the CPU's (at 16 bars the
   card's plain versions differ from the CPU, and from its kernels, by a
   few % of some grads' max, as its kernels do; the step reports all
   three).
7b. LMD16 generation: a seeded 16-bar model directory at batch 256 (4096
   bars a call) by bench.py's protocol at 5 calls a pass, with 4
   `gcl_eval` launches at K = 2
   and 1 `chord_tail` launch per call; `gcl_eval` at K = 2 (rtol = atol =
   2e-4) and `chord_tail` (ids outside top-2 gaps < 1e-4) against their
   plain versions at 4096 bars, the plain versions run in chunks of 512
   bars (each bar is independent), and timed; n = 8 on the card against the
   CPU by phase 3's rules; the generate CLI (`--n 2 --n_loops 4`) and the
   reconstruct CLI on the trained 16-bar directory: the launches of
   `cli_phase`, MIDI that parses, the looped file 4 copies of the piece
   shifted by 16 bars each.
7c. Message dropout: 2 steps of `examples/training_lmd2.json` with
   `message_dropout` 0.1, in the "edge" and in the "aggregate" mode, with
   an eval step: records finite, no launch of a training GCL kernel (the
   lattice GCL runs in plain PyTorch), 16 fp32 `gcl_eval` launches at K = 1
   per evaluation. The dropout `lattice.gcl_apply` on the card against the
   CPU on the same keep masks, d = 512, 16 bars: the output at rtol = atol
   = 2e-4, each grad within 2e-4 of its max |cpu|.
8. The data plane: writes 96 seeded full-band 4/4 MIDI songs of 12-32
   bars (`band_song`) in nested directories, runs `cli.preprocess` on them
   (4 worker processes) and `cli.pack_dataset` (shards of 128 samples);
   one shuffled epoch of the native batch gather (`data.fastloader`, built
   by g++ from `native/fastloader.cpp`; the phase fails first if g++ is
   missing) equals the plain numpy gather and `ShardedDataset` row by row;
   times the native gather (4 threads), the plain gather and the
   per-sample `BatchLoader` (8 workers) in ms per batch of 256; trains the
   flagship fp32 config (`examples/training_lmd2.json`) through
   `cli.train.main()` for 4 steps on 640 samples from the packed directory
   and again from the per-sample one: records finite, 64 launches of each
   training GCL kernel per step, one native gather per step from the
   packed data and none from the other, the first step's losses the same
   within 1e-6 relative (the same batches); s/step of each CLI run; s/step
   of 3 steps fed by each loader (and, beside the packed one, of 3 steps on
   one batch kept on the card), the kernel time of 2 more under the
   profiler and the idle share it leaves.
9. The remaining surface. MFU (`flops.py`: model FLOPs a sequence over
   the card's peak for the path's compute dtype, `flops.PEAK_FLOPS`) of
   the rates that phases 4, 4b and 7b (generation seq/s) and 5, 6 and 7
   (training seq/s) measured, on one JSON line with the card line; it
   fails if the card is not in the table or a share is not in (0, 100 %].
   The native MIDI renderer (`midi.fast_render`, g++ from
   `native/midirender.cpp` at first use; a failed build fails the phase)
   against the Python writer (`song_from_tokens`, `loop_song`,
   `midi_bytes`), byte for byte: phase 3's n = 8 served sequences and 8
   more served on a given structure of density 0.15, through
   `GenerationService.render_midi`, 7b's n = 8 LMD16 pieces looped 4
   times, with ms a sequence of each on the card's host (median of 3
   passes); the generate CLI (`--n 2 --n_loops 4`) on phase 3's model
   directory: its launches, 4 native renders, its files byte-equal to the
   Python writer's on the (mask, tokens) it generated. `mtp_from_logits`
   on the card on one n = 8 batch's logits, equal to the CPU's. Plotting
   and `cli.stats` need matplotlib, which the card's machine lacks: the CPU
   tests hold them to the JAX package's.
10. Data parallelism (`parallel.mesh`) under `torchrun --standalone`:
   (i) the train CLI with one rank on NCCL (the flagship fp32 config, 5
   steps from phase 8's shards) between two runs of the same CLI without a
   process group: the first step's losses within 1e-6 relative, the
   largest over the steps within 10 x the two runs without a group's (the
   card's backward is not bitwise repeatable, and Adam at the warmup's
   peak LR turns its rounding into steps of lr on grads whose true value
   is 0: two runs part by about 10 x a step), 64 launches of each fp32
   training kernel a step on the rank (read from the rank's output), each
   run's s/step, and s/step of the fp32 `TrainStep` in chip_smoke's own
   process on a batch kept on the card, without a group and in a one-rank
   NCCL group, in turns; (ii) two ranks on the
   one card over gloo (NCCL refuses two ranks on one GPU; gloo's
   all-reduce and broadcast take CUDA tensors), the flagship fp32 config
   at its global batch of 256, 2 steps from seeded weights, batches and
   eps, against one process on the same: every step's losses within 1e-4
   relative; the grads after step 1 held to an fp64 step's on the same
   weights and batch by phase 7's rule (within 0.1 of each max |fp64|, 1
   - cosine <= 1e-5; at this batch fp32 leaves one process's grads up to
   4 % of their max from fp64's on an H100), with the largest distance from one
   process's reported; the kernels' launches
   on each rank, s/step and the seconds of a gradient all-reduce through
   the host; (iii) the same in bf16 (`examples/training_lmd2_bf16.json`,
   2 steps, `bn_linear_merge`'s input centred as in phase 6): losses
   within 3e-2 relative.
10b. Tensor parallelism (`parallel.model_axis` 2): (i) the column forms
   of the GCL kernels (output width n of d = 512: `gcl_fwd`, `gcl_eval` at
   K = 1, `gcl_bwd_data`, `gcl_bwd_weight` in fp32 at 64 and 128 bars,
   `gcl_fwd`, `gcl_eval` and `gcl_bwd_fused` in bf16 at 256 bars; n = 256
   and 128) against their plain versions on every shard (fp32: rtol = atol
   = 2e-4, the sums over bars 1e-4 x max |plain|; bf16: 2e-2), the
   partial dx and dgate summed over the shards against the square plain
   version, each timed beside the square launch and its bound; (ii) two
   gloo ranks at model axis 2 through the `Trainer`, the flagship fp32
   config, 2 steps, against one process as in phase 10 (ii) (losses 1e-4
   relative, the grads after step 1 held to an fp64 step's; the last
   step's collectives timed on the host), after an eval step on the
   first batch (its losses as one process's on the same weights); (iii)
   the same in bf16, 2 steps, losses
   3e-2; (iv) four gloo ranks at D = 2 x M = 2, fp32, 2 steps, against
   (ii)'s one process. On every rank every training-kernel launch is in
   the column form (64 of each fp32 kernel, 32 of each bf16 one a step)
   and the eval step's 16; the ranks' checkpoint is one process's layout
   and serves one n = 8 request over HTTP.
12. Bar grids other than 4 x 32 cells (`resolution` r, S = 4r steps a
   bar): (i) the four generation kernels (`gcl_eval` at K = 2, and at K =
   1, and `chord_tail`, fp32 and bf16; at S != 32 the GCL goes to
   `csrc/gcl_eval_grid_*.cu`) against their plain versions at r = 3, 4, 6
   and 12, 8 and 512 bars, d = 512, by phase 2's tolerances (the chord
   tail's near-tie cap over the ids of active cells, and every inactive
   cell of a track kind given the same ids), each 512-bar launch timed
   beside its bound;
   (ii) seeded model directories at r = 4 and 12 (d = 512, 8 layers, 2
   bars): batch-256 generation in fp32 and bf16 by bench.py's protocol
   at GRID_BENCH_ROUNDS (10) calls a pass, with MFU, each call launching exactly 4 `gcl_eval` and 1 `chord_tail` of
   the model's grid and nothing else, n = 8 on the card against the CPU by
   phase 3's rules and phase 4b's; (iii) at r = 4, an HTTP request
   through `GenerationService` whose native MIDI equals the Python
   writer's, and the generate CLI (`--n 2 --n_loops 4`, its files against
   the Python writer's) and the reconstruct CLI on 2 samples of that grid
   (its encoder: the GCL at K = 1); (iv) the training GCL kernels at r =
   3, 4, 6, 12 (`gcl_fwd` fp32 and bf16, `gcl_bwd_data`, `gcl_bwd_weight`,
   `gcl_bwd_fused` in bf16; at S != 32 `csrc/gcl_eval_grid_*.cu` without
   the epilogue and `csrc/gcl_bwd_*_grid*.cu`) against their plain
   versions at the training microbatches' bars (fp32 128, bf16 256), d =
   512, by phases 2b's and 2c's rules, each timed beside its bound, and
   their column forms at n = 256, S = 16; (v) at r = 4 and 12, LMD2's
   training configs (`examples/training_lmd2.json` and `_bf16.json` with
   that resolution) at batch 256: one step through `cli.train.main()` on
   256 samples of the grid, s/step (1 pass of 3 steps) with MFU, each
   run launching exactly 64 of each fp32 (32
   of each bf16) training kernel of the grid a step and nothing else, and
   the step on the card against the CPU: bf16 at batch 32 by phase 6's
   rule, fp32 at batch 8 with its losses by phase 5's and its grads by
   phase 7's (held to an fp64 step's: at these grids the CPU's fp32 grads
   are further from it than the card's).
13. Bars of more than 48 steps (`resolution` 13 and up; the GCL goes to
   `csrc/gcl_eval_long_*.cu`, one launch a layer): (i) the four generation
   kernels (`gcl_eval` at K = 2 and 1, `chord_tail`, fp32 and bf16) against
   their plain versions at r = 13, 16, 24 and 48 (S = 52, 64, 96, 192; the
   bf16 chord tail's MIX form at 52), 8 and 512 bars, d = 512, by phase
   12 (i)'s rules, the 512-bar calls at r = 24 timed beside their bounds
   (since PR 24 the other resolutions' are held, not timed); (ii)-(iv) a
   seeded model directory at r = 24 (pypianoroll's default grid, 4 x 96
   cells; d = 512, 8 layers, 2 bars) as phase 12 (ii) and (iii) run r = 4:
   batch-256 generation in fp32 and bf16 with MFU, each call launching
   exactly 8 `gcl_eval` of one layer and 1 `chord_tail` of the grid, n = 8
   on the card against the CPU (phases 3's and 4b's rules, but for the
   bf16 flip cap: this random model puts 64 % of its cells in the 0.03
   tie band, so the unconditioned run holds its structure logits within
   2e-2 x max |cpu| of the CPU's instead and compares every bar on the
   CPU's mask, `compare_bf16_with_cpu(flip_cap=False)`), the service, the
   generate and the reconstruct CLIs; (v) one `gcl_fused` layer in the
   column form (n = d / 2) at S = 96 raises before any launch, naming its
   roadmap item; (vi) the three fp32 training kernels (`gcl_fwd`,
   `gcl_bwd_data`, `gcl_bwd_weight`: `csrc/gcl_eval_long_fp32.cu`'s
   training form, `csrc/gcl_bwd_data_long.cu`, `csrc/gcl_bwd_weight_long.cu`)
   against their plain versions at r = 13, 16, 24 and 48, 128 bars, d =
   512, by phase 2b's rules, each timed beside its bounds, and their bf16
   forms (`csrc/gcl_eval_long_bf16_tc.cu`'s training form and the bf16
   instantiations of the two backward sources, bf16 training's split
   backward above 48 steps) at 256 bars by phase 2c's rule, each timed
   beside its bounds; (vii) LMD2's fp32 and bf16 training configs at
   r = 24 as phase 12 (v) runs them: one CLI step, s/step with MFU, exactly
   64 launches of each fp32 long-bar training kernel a step, and 32 of each
   bf16 one (`gcl_fwd_bf16`, `gcl_bwd_data_bf16`, `gcl_bwd_weight_bf16`; no
   `gcl_bwd_fused`), the fp32 step at batch 8 against the CPU with its
   grads held to an fp64 step's, the bf16 step at batch 32 by phase 6's
   rule.
11. Prints the LMD16 kernels line (ms, plain ms and bounds at 256 and 4096
   bars, launches in phases 7 and 7b), the `kernels` JSON line (launches
   of every phase, phases 10's and 10b's on every rank; the column forms
   at n = 256 on a rank's microbatch, `<kernel>_cols`; phase 12's grid
   kernels at S = 16 and 48, `<kernel>_s<S>`, the generation kernels timed
   in 12 (i) and launched in 12 (ii) and (iii), the training kernels timed
   in 12 (iv) and launched in 12 (v); phase 13's generation kernels at S =
   96, the long-bar GCL as `<kernel>_k1_s96`, and its fp32 and bf16
   training kernels at S = 96, timed in 13 (vi) and launched in 13 (vii)),
   the script's seconds, the card line, and last
   {"ok":
   true, "device": {...}}.

Any failure, a child process's too, exits non-zero before the last line.
Without a CUDA device, or without the package beside it, it exits non-zero
and prints no result. `chip_smoke.py rank_child SPEC` is one rank of
phases 10's and 10b's gloo runs, started by the phase itself.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import functools
import json
import os
import re
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
# ms per launch of the bf16 eval GCL at 512 bars, d = 512, K = 1 and 2, when
# it ran fp32 FMAs on the CUDA cores (the retired `gcl_eval.cu` templated on
# bf16; NVIDIA H100 80GB HBM3, 700.00 W): the yardstick of the tensor-core
# kernel
CUDA_CORE_EVAL_BF16_MS = {1: 7.063, 2: 13.976}
# ms per launch of the fp32 eval GCL at 512 bars, d = 512, K = 1 and 2, as
# the SIMT template of the retired `gcl_eval.cu` (128 x 128 tiles, 8-feature
# chunks) ran it before `gcl_eval_fp32.cu` (NVIDIA H100 80GB HBM3, 700.00
# W): the yardstick of the fp32 kernel
SIMT_EVAL_FP32_MS = {1: 6.438, 2: 12.764}
# ms per launch of the fp32 chord tail at 512 bars, d = 512, as the SIMT
# template of `chord_tail.cu` (32-row tiles, the slot the slow grid axis) ran
# it before `chord_tail_fp32.cu` (NVIDIA H100 80GB HBM3, 700.00 W)
SIMT_CHORD_FP32_MS = 19.11
# the same for the bf16 chord tail, as the SIMT template of `chord_tail.cu`
# ran it before `chord_tail_bf16_tc.cu` (NVIDIA H100 80GB HBM3, 700.00 W)
SIMT_CHORD_BF16_MS = 20.306
# ms per launch of the training forward at the training microbatches (fp32
# 128 bars, bf16 256 bars; d = 512), as the SIMT template of the retired
# `gcl_eval.cu` (128 x 128 tiles, 8-feature chunks, fp32 FMAs in both
# dtypes) ran it before the eval kernels took it over (NVIDIA H100 80GB
# HBM3, 700.00 W)
SIMT_FWD_MS = {"gcl_fwd": 2.231, "gcl_fwd_bf16": 3.526}
# ms per launch of the fp32 weight backward at 128 bars, d = 512, in its
# split-K form (64 x 64 tiles of one block over bar chunks, per-chunk
# partials in device memory and a second pass to sum them; NVIDIA H100 80GB
# HBM3, 700.00 W)
SPLIT_K_WEIGHT_FP32_MS = 2.557
# ms per launch of the fp32 data backward at 128 bars, d = 512, in its first
# design (a CTA per bar and 32-column tile, synchronous staging, scatters by
# shared-memory atomics; NVIDIA H100 80GB HBM3, 700.00 W)
FIRST_DESIGN_DATA_FP32_MS = 1.710
# ms per launch of the bf16 fused backward at 256 bars, d = 512, when its dH
# product ran fp32 FMAs on the CUDA cores (the bf16 instantiation of
# `gcl_bwd_fused.cu`; NVIDIA H100 80GB HBM3, 700.00 W)
FFMA_FUSED_BF16_MS = 7.415
# the same when only its dH product ran on the tensor cores and its dW
# product ran fp32 FMAs with per-bar partials in device memory (NVIDIA H100
# 80GB HBM3, 700.00 W)
TC_DH_FUSED_BF16_MS = 5.024
# the kernels of `csrc/gcl_bwd_fused_bf16_tc.cu`, by their symbols
FUSED_BF16_KERNELS = {"dH": "gcl_bwd_fused_bf16_tc_kernel",
                      "dW": "gcl_bwd_dw_bf16_tc_kernel"}
HBM_TBPS = 3.35       # H100 SXM device memory
SEED = 0


START = time.perf_counter()


def phase(name: str) -> None:
    """Print the seconds since the script started as phase `name` begins."""
    print(f"[+{time.perf_counter() - START:.0f} s] phase {name}", flush=True)


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


def peak_tflops(bf16: bool = False) -> float:
    """The card's peak TFLOP/s, fp32 on the CUDA cores or dense bf16 on the
    tensor cores, from `polyphemus_tpu_torch.flops.PEAK_FLOPS` (the one copy
    of these data-sheet figures); fails on a card that is not there."""
    import torch

    from polyphemus_tpu_torch import flops

    try:
        return flops.peak_flops(torch.cuda.get_device_name(0),
                                torch.bfloat16 if bf16 else torch.float32) \
            / 1e12
    except KeyError as e:
        fail(str(e))


def bound_ms(flops: float, nbytes: float, tflops: float = None):
    """(ms, "operations" or "bytes"): the larger of flops at `tflops` (the
    card's fp32 peak by default) and nbytes at the HBM rate."""
    tflops = peak_tflops() if tflops is None else tflops
    t_ops = flops / (tflops * 1e12) * 1e3
    t_mem = nbytes / (HBM_TBPS * 1e12) * 1e3
    return max(t_ops, t_mem), ("operations" if t_ops >= t_mem else "bytes")


def ptxas_usage(log: str) -> dict:
    """{function: {"registers", "spill_bytes", "stack_bytes",
    "static_smem_bytes"}} from the `-Xptxas -v` lines of one nvcc log
    (spills: stores plus loads; dynamic shared memory is not in the log)."""
    usage, func = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:entry function|Function properties for) "
                      r"'?(\w+)", line)
        if m:
            func = m.group(1)
            usage.setdefault(func, {})
            continue
        if func is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            usage[func]["stack_bytes"] = int(m.group(1))
            usage[func]["spill_bytes"] = int(m.group(2)) + int(m.group(3))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage[func]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            usage[func]["static_smem_bytes"] = int(m.group(1))
    return {f: u for f, u in usage.items() if u}


@functools.lru_cache(maxsize=None)
def sass_functions(library: str) -> dict:
    """{function: its SASS text} from `cuobjdump -sass` (beside nvcc) of one
    built library, once."""
    from polyphemus_tpu_torch.ops.kernels import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", library], capture_output=True,
                         text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr[-2000:]}")
    funcs, name = {}, None
    for line in out.stdout.splitlines(keepends=True):
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            funcs[name] = []
        elif name is not None:
            funcs[name].append(line)
    return {f: "".join(lines) for f, lines in funcs.items()}


def sass_instructions(kernel: str, symbol: str,
                      pattern: str = r"\bHG?MMA\b") -> int:
    """Instructions matching `pattern` (default: HMMA and HGMMA, the
    tensor-core products) in the SASS of the functions whose names hold
    `symbol`, in the library that `_build.launcher(kernel)` loads."""
    from polyphemus_tpu_torch.ops.kernels import _build

    texts = [text for f, text in sass_functions(
        str(_build.library(kernel))).items() if symbol in f]
    check(texts, f"no function {symbol} in the SASS of {kernel}")
    return sum(len(re.findall(pattern, text)) for text in texts)


def smem_bytes(kernel: str, *args) -> int:
    """Dynamic shared memory a CTA of the fp32 weight or data backward or of
    a grid GCL kernel (`kernel`) takes, as its library's
    `<kernel>_smem_bytes(*args)` reports it (the grid training kernels'
    take the steps S of a bar, the bf16 fused backward's then 0 for its dH
    kernel or 1 for its dW kernel)."""
    import ctypes

    from polyphemus_tpu_torch.ops.kernels import _build

    lib = ctypes.CDLL(str(_build.library(kernel)))
    return getattr(lib, f"{kernel}_smem_bytes")(*args)


# the grid GCL sources (bars of 4 x S cells, S != 32): (dtype, source,
# kernel name, symbol of each form); the grid training kernels are
# templates on S, each instantiation a form, `ILi<S>E` in its symbol
# the long-bar eval GCL kernels (bars of 4 x S cells, S > 48), by kernel
# name: the symbol of each
LONG_FORMS = {"gcl_eval_long": "gcl_eval_long_fp32_kernelILb1E",
              "gcl_eval_long_bf16": "gcl_eval_long_bf16_tc_kernelILb1E"}
# the fp32 long-bar training kernels, by kernel name: the symbol of each
# (the training form of the long eval kernel; the data backward's product
# kernel, whose gather kernel holds no product; the weight backward)
LONG_TRAIN_FORMS = {"gcl_fwd_long": "gcl_eval_long_fp32_kernelILb0E",
                    "gcl_bwd_data_long": "gcl_bwd_data_long_kernelIf",
                    "gcl_bwd_weight_long": "gcl_bwd_weight_long_kernelIf"}
# the bf16 ones, the same kernels' bf16 instantiations: the training form
# of the long bf16 eval kernel (tensor cores), the split backward (FFMA on
# bf16 operands widened to fp32)
LONG_BF16_TRAIN_FORMS = {
    "gcl_fwd_long_bf16": "gcl_eval_long_bf16_tc_kernelILb0E",
    "gcl_bwd_data_long_bf16": "gcl_bwd_data_long_kernelI13__nv_bfloat16",
    "gcl_bwd_weight_long_bf16": "gcl_bwd_weight_long_kernelI13__nv_bfloat16"}
GRID_FORMS = [
    ("fp32", "gcl_eval_grid_fp32", "gcl_eval_grid",
     {"eval": "gcl_eval_grid_fp32_kernelILb1E",
      "fwd": "gcl_eval_grid_fp32_kernelILb0E"}),
    ("bf16", "gcl_eval_grid_bf16_tc", "gcl_eval_grid_bf16",
     {"eval": "gcl_eval_grid_bf16_tc_kernelILb1E",
      "fwd": "gcl_eval_grid_bf16_tc_kernelILb0E"}),
    ("fp32", "gcl_eval_long_fp32", "gcl_eval_long",
     {"eval": LONG_FORMS["gcl_eval_long"],
      "fwd": LONG_TRAIN_FORMS["gcl_fwd_long"]}),
    ("fp32", "gcl_bwd_data_long", "gcl_bwd_data_long",
     {"data": LONG_TRAIN_FORMS["gcl_bwd_data_long"]}),
    ("fp32", "gcl_bwd_weight_long", "gcl_bwd_weight_long",
     {"weight": LONG_TRAIN_FORMS["gcl_bwd_weight_long"]}),
    ("bf16", "gcl_eval_long_bf16_tc", "gcl_eval_long_bf16",
     {"eval": LONG_FORMS["gcl_eval_long_bf16"],
      "fwd": LONG_BF16_TRAIN_FORMS["gcl_fwd_long_bf16"]}),
    ("bf16_ffma", "gcl_bwd_data_long", "gcl_bwd_data_long_bf16",
     {"data": LONG_BF16_TRAIN_FORMS["gcl_bwd_data_long_bf16"]}),
    ("bf16_ffma", "gcl_bwd_weight_long", "gcl_bwd_weight_long_bf16",
     {"weight": LONG_BF16_TRAIN_FORMS["gcl_bwd_weight_long_bf16"]})]
GRID_TRAIN_SOURCES = [
    ("fp32", "gcl_bwd_data_grid", "gcl_bwd_data_grid",
     {"data": "gcl_bwd_data_grid_kernel"}),
    ("fp32", "gcl_bwd_weight_grid", "gcl_bwd_weight_grid",
     {"weight": "gcl_bwd_weight_grid_kernel"}),
    ("bf16", "gcl_bwd_fused_grid_bf16_tc", "gcl_bwd_fused_grid_bf16",
     {"dH": "gcl_bwd_fused_grid_bf16_tc_kernel",
      "dW": "gcl_bwd_dw_grid_bf16_tc_kernel"})]
GRID_STEPS = (4, 8, 12, 16, 20, 24, 28, 36, 40, 44, 48)


def grid_kernel_forms(usage) -> dict:
    """Phase 1's checks of every form of the grid GCL kernels: the eval
    kernels' eval and training-forward forms, the long-bar eval kernels
    (with their training forms) and training backward kernels (fp32 and
    bf16), and the grid training backward kernels at each S of GRID_STEPS.
    Each form's ptxas registers, spills and dynamic shared memory and its
    SASS counts; fails unless each bf16 tensor-core form holds tensor-core
    instructions and each FFMA form (fp32, and "bf16_ffma": the long bf16
    split backward) FFMA and none, without spills."""
    forms = [(dt, src, kname, part, sym, ())
             for dt, src, kname, syms in GRID_FORMS
             for part, sym in syms.items()]
    forms += [(dt, src, kname, part, f"{sym}ILi{s}E",
               (s,) + ((int(part == "dW"),) if dt == "bf16" else ()))
              for dt, src, kname, syms in GRID_TRAIN_SOURCES
              for part, sym in syms.items() for s in GRID_STEPS]
    out = {}
    for dt, src, kname, part, sym, args in forms:
        funcs = [u for f, u in usage[src].items() if sym in f]
        check(len(funcs) == 1, f"ptxas reported {len(funcs)} {sym}")
        r = dict(funcs[0], dynamic_smem_bytes=smem_bytes(kname, *args),
                 hmma=sass_instructions(kname, sym),
                 ffma=sass_instructions(kname, sym, r"\bFFMA\b"))
        out[sym] = r
        if dt == "bf16":
            check(r["hmma"] > 0, f"the bf16 grid kernel {sym} holds no "
                                 f"tensor-core instruction")
        else:
            check(r["hmma"] == 0 and r["ffma"] > 0 and r["spill_bytes"] == 0,
                  f"the {dt} grid kernel {sym} is not an FFMA kernel "
                  f"without spills: {r}")
    return out


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


def kernel_inputs(nbar, d, k_layers, device, seed, s=32):
    """Seeded random x, aux, gates and K layers of packed weights over bars
    of 4 x s cells."""
    import torch

    from polyphemus_tpu_torch.ops.kernels import gcl

    g = torch.Generator().manual_seed(seed)
    mask = torch.from_numpy(bar_masks(nbar, 4, s, seed))
    x = torch.randn(nbar, 4, s, d, generator=g) * mask[..., None]
    aux = gcl.build_kernel_aux(mask).reshape(nbar, gcl.N_AUX, 4 * s)
    gates = torch.randn(s, d, generator=g) * 0.3
    wb = [gcl.pack_weights(torch.randn(6, d, d, generator=g) * d ** -0.5,
                           torch.randn(d, d, generator=g) * d ** -0.5, 4)
          for _ in range(k_layers)]
    lay = [torch.stack(wb)] + [
        torch.randn(k_layers, d, generator=g) * sc + off
        for sc, off in ((0.1, 0.0), (0.1, 1.0), (0.1, 0.0))]
    return mask.to(device), [v.contiguous().to(device) for v in
                             [x.reshape(nbar, 4 * s, d), aux, gates] + lay]


def by_bars(fn, per_bar, shared, chunk=None, **kw):
    """fn(*per_bar, *shared, **kw) on runs of `chunk` bars of the per-bar
    inputs (leading axis: bars), concatenated; exact, since every bar is
    computed alone. One run when chunk is None."""
    import torch

    n = per_bar[0].shape[0]
    step = chunk or n
    return torch.cat([fn(*(a[i:i + step] for a in per_bar), *shared, **kw)
                      for i in range(0, n, step)])


# ----------------------------------------------------------- phase 2: kernels
def check_gcl(nbar, d, k_layers, device, timing=True, bf16=False,
              chunk=None, s=32):
    """`gcl_eval` against its plain version, in fp32 at rtol = atol = TOL or
    in bf16 (`bf16`: every float input cast) within BF16_REL of max |plain|;
    with timing, ms per launch and the bound (bf16: on the bf16 tensor
    cores, where the bf16 kernel runs; `cuda_core_bound_ms` on the fp32
    CUDA cores). `chunk`: the plain version runs on that many bars at a
    time; s: steps a bar (another resolution's grid for s != 32)."""
    import torch

    from polyphemus_tpu_torch.ops.kernels import counts, gcl

    mask, args = kernel_inputs(nbar, d, k_layers, device, SEED + k_layers,
                               s)
    if bf16:
        args = [a if a.dtype == torch.int32 else a.to(torch.bfloat16)
                for a in args]
    before = dict(counts.launches)
    out = gcl.gcl_eval(*args)

    def plain():
        return by_bars(gcl.gcl_eval_plain, args[:2], args[2:], chunk)

    ref = plain()
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
        res["plain_ms"] = time_ms(plain, reps=2)
        # an inactive cell's row of A is zero and its output is its input:
        # only active rows need the (5d x d) product
        flops = 2.0 * int(mask.sum()) * 5 * d * d * k_layers
        nbytes = sum(a.numel() * a.element_size() for a in args) \
            + out.numel() * out.element_size()
        peak = peak_tflops(bf16)
        res["bound_ms"], res["bound_by"] = bound_ms(flops, nbytes, peak)
        res["dense_bound_ms"] = bound_ms(
            flops * mask.numel() / int(mask.sum()), nbytes, peak)[0]
        if bf16:
            res["cuda_core_bound_ms"] = bound_ms(flops, nbytes)[0]
    counts.restore(before)  # comparisons do not count
    return res


# ----------------------------------------- phase 2b: training GCL kernels
def train_kernel_inputs(nbar, d, device, seed, s=32):
    """Seeded x (masked), upstream g, aux, gates, packed weights and bias of
    one training GCL layer over bars of 4 x s cells."""
    import torch

    from polyphemus_tpu_torch.ops.kernels import gcl

    g = torch.Generator().manual_seed(seed)
    n = 4 * s
    mask = torch.from_numpy(bar_masks(nbar, 4, s, seed))
    x = torch.randn(nbar, n, d, generator=g) * mask.reshape(nbar, n, 1)
    up = torch.randn(nbar, n, d, generator=g)
    aux = gcl.build_kernel_aux(mask).reshape(nbar, gcl.N_AUX, n)
    gates = torch.randn(s, d, generator=g) * 0.3
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


def check_gcl_train(nbar, d, device, timing=True, s=32):
    """`gcl_fwd`, `gcl_bwd_data` and `gcl_bwd_weight` against their plain
    versions over bars of 4 x s cells; with timing, ms per launch and the
    bounds. Each kernel's useful work is 2 * active cells * 5d * d flops (an
    inactive cell's output row, upstream row and dW contribution are zero);
    `dense_bound_ms` counts every cell and `cost_estimate_bound_ms` the JAX
    kernel's CostEstimate, 2 * nbar * 4s * 8d * d."""
    import torch

    from polyphemus_tpu_torch.ops.kernels import counts, gcl, gcl_bwd

    mask, (x, up, aux, gates, wbig, bias) = train_kernel_inputs(
        nbar, d, device, SEED + 11, s)
    before = dict(counts.launches)
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
        dense = 2.0 * mask.numel() * 5 * d * d
        cost_est = 2.0 * mask.numel() * 8 * d * d
        state = x.numel() * 4
        small = aux.numel() * 4 + gates.numel() * 4
        nbytes = {"gcl_fwd": 2 * state + small + wbig.numel() * 4 + d * 4,
                  "gcl_bwd_data": 3 * state + small + wbig.numel() * 4
                  + (s + 1) * d * 4,
                  "gcl_bwd_weight": 2 * state + small + wbig.numel() * 4}
        for name, (kern, plain) in runs.items():
            r = res[name]
            r["ms"] = time_ms(kern)
            r["plain_ms"] = time_ms(plain, reps=2)
            r["bound_ms"], r["bound_by"] = bound_ms(flops, nbytes[name])
            r["dense_bound_ms"] = bound_ms(dense, nbytes[name])[0]
            r["cost_estimate_bound_ms"] = bound_ms(cost_est, nbytes[name])[0]
    counts.restore(before)  # comparison launches do not count
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


def fused_bwd_work(mask, d):
    """(data, dense, CostEstimate) flops of one fused backward: per active
    cell 2 * 5d * d for the dH product and as many for the dW product."""
    active, cells = int(mask.sum()), mask.numel()
    return (20.0 * active * d * d, 20.0 * cells * d * d,
            4.0 * cells * 8 * d * d)


def check_fused_bf16(x, up, aux, gates, wbig) -> dict:
    """`gcl_bwd_fused` on bf16 inputs against its plain version: every
    output (dx, dgate, dbias, dwbig) within BF16_REL of max |plain|;
    returns {output: max abs err}."""
    import torch

    from polyphemus_tpu_torch.ops.kernels import gcl_bwd

    got = gcl_bwd.gcl_bwd_fused(x, up, aux, gates, wbig)
    want = gcl_bwd.gcl_bwd_fused_plain(x, up, aux, gates, wbig)
    torch.cuda.synchronize()
    check(got[0].dtype == torch.bfloat16, "gcl_bwd_fused bf16 dx dtype")
    return {n: held_rel(f"gcl_bwd_fused bf16 {n}", a, b) for n, a, b in
            zip(("dx", "dgate", "dbias", "dwbig"), got, want)}


def check_gcl_train_bf16(nbar, d, device, timing=True, s=32):
    """The bf16 `gcl_fwd` and `gcl_bwd_fused` against their bf16 plain
    versions on the card, over bars of 4 x s cells; with timing, ms per
    launch and the bounds (`bound_ms`: the bf16 tensor cores, where both
    run; `cuda_core_bound_ms`: fp32 FMAs on the CUDA cores, where the fused
    backward's first form ran; "dense" and "CE" variants as in 2b)."""
    import torch

    from polyphemus_tpu_torch.ops.kernels import counts, gcl, gcl_bwd

    mask, args = train_kernel_inputs(nbar, d, device, SEED + 13, s)
    x, up, aux, gates, wbig, bias = [
        v if v.dtype == torch.int32 else v.to(torch.bfloat16) for v in args]
    before = dict(counts.launches)
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
    errs = check_fused_bf16(x, up, aux, gates, wbig)
    res["gcl_bwd_fused"] = dict(
        {"max_abs_err": max(errs.values())},
        **{f"{n}_max_abs_err": e for n, e in errs.items()})
    if timing:
        active = int(mask.sum())
        state = x.numel() * 2
        small = aux.numel() * 4 + gates.numel() * 2
        work = {"gcl_fwd_bf16": (2.0 * active * 5 * d * d,
                                 2.0 * mask.numel() * 5 * d * d,
                                 2.0 * mask.numel() * 8 * d * d),
                "gcl_bwd_fused": fused_bwd_work(mask, d)}
        nbytes = {"gcl_fwd_bf16": 2 * state + small + wbig.numel() * 2 + d * 2,
                  "gcl_bwd_fused": 3 * state + small + wbig.numel() * 2
                  + wbig.numel() * 4 + (s + 1) * d * 4}
        for name, (kern, plain) in runs.items():
            r = res[name]
            data, dense, cost_est = work[name]
            r["ms"] = time_ms(kern)
            r["plain_ms"] = time_ms(plain, reps=2)
            r["bound_ms"], r["bound_by"] = bound_ms(data, nbytes[name],
                                                    peak_tflops(True))
            r["cuda_core_bound_ms"] = bound_ms(data, nbytes[name])[0]
            r["dense_bound_ms"] = bound_ms(dense, nbytes[name],
                                           peak_tflops(True))[0]
            r["dense_cuda_core_bound_ms"] = bound_ms(dense, nbytes[name])[0]
            r["cost_estimate_bound_ms"] = bound_ms(cost_est, nbytes[name],
                                                   peak_tflops(True))[0]
            r["cost_estimate_cuda_core_bound_ms"] = bound_ms(
                cost_est, nbytes[name])[0]
    counts.restore(before)  # comparison launches do not count
    return res


def check_gcl_train_long_bf16(nbar, d, device, timing=True, s=96):
    """The bf16 training kernels above 48 steps a bar (`gcl_fwd` and the
    split backward, `gcl_bwd_data` and `gcl_bwd_weight`, on bf16 inputs:
    `csrc/gcl_eval_long_bf16_tc.cu`'s training form and the bf16 forms of
    `csrc/gcl_bwd_data_long.cu` and `csrc/gcl_bwd_weight_long.cu`) against
    their bf16 plain versions over bars of 4 x s cells, every output within
    BF16_REL of max |plain|; with timing, ms per launch and the bounds
    (`bound_ms`: the bf16 tensor cores' rate, the inputs' type;
    `cuda_core_bound_ms`: fp32 FMAs on the CUDA cores, where the two
    backward kernels multiply bf16 operands widened to fp32; "dense" and
    "CE" variants as in 2b). The data backward's scratch (nbar x 4 planes x
    4s x d floats) is the kernel's own traffic and counts in no bound."""
    import torch

    from polyphemus_tpu_torch.ops.kernels import counts, gcl, gcl_bwd

    check(s > gcl.MAX_STEPS, f"the bf16 split backward takes S > "
                             f"{gcl.MAX_STEPS}, got {s}")
    mask, args = train_kernel_inputs(nbar, d, device, SEED + 19, s)
    x, up, aux, gates, wbig, bias = [
        v if v.dtype == torch.int32 else v.to(torch.bfloat16) for v in args]
    before = dict(counts.launches)
    runs = {
        "gcl_fwd_bf16": (lambda: gcl.gcl_fwd(x, aux, gates, wbig, bias),
                         lambda: gcl.gcl_fwd_plain(x, aux, gates, wbig, bias)),
        "gcl_bwd_data_bf16": (
            lambda: gcl_bwd.gcl_bwd_data(x, up, aux, gates, wbig),
            lambda: gcl_bwd.gcl_bwd_data_plain(x, up, aux, gates, wbig)),
        "gcl_bwd_weight_bf16": (
            lambda: gcl_bwd.gcl_bwd_weight(x, up, aux, gates),
            lambda: gcl_bwd.gcl_bwd_weight_plain(x, up, aux, gates)),
    }
    res = {}
    for name, (kern, plain) in runs.items():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        parts = {"gcl_bwd_data_bf16": ("dx", "dgate", "dbias")}.get(
            name, ("out",))
        check([v.dtype for v in got] == [v.dtype for v in want],
              f"{name} returned {[v.dtype for v in got]}, its plain version "
              f"{[v.dtype for v in want]}")
        errs = {p: held_rel(f"{name} {p}", a, b)
                for p, a, b in zip(parts, got, want)}
        res[name] = dict({"max_abs_err": max(errs.values())},
                         **({f"{p}_max_abs_err": e for p, e in errs.items()}
                            if len(errs) > 1 else {}))
    if timing:
        active = int(mask.sum())
        state = x.numel() * 2
        small = aux.numel() * 4 + gates.numel() * 2
        flops = 2.0 * active * 5 * d * d
        dense = 2.0 * mask.numel() * 5 * d * d
        cost_est = 2.0 * mask.numel() * 8 * d * d
        nbytes = {"gcl_fwd_bf16": 2 * state + small + wbig.numel() * 2
                  + d * 2,
                  "gcl_bwd_data_bf16": 3 * state + small + wbig.numel() * 2
                  + (s + 1) * d * 4,
                  "gcl_bwd_weight_bf16": 2 * state + small
                  + wbig.numel() * 4}
        for name, (kern, plain) in runs.items():
            r = res[name]
            r["ms"] = time_ms(kern)
            r["plain_ms"] = time_ms(plain, reps=2)
            r["bound_ms"], r["bound_by"] = bound_ms(flops, nbytes[name],
                                                    peak_tflops(True))
            r["cuda_core_bound_ms"] = bound_ms(flops, nbytes[name])[0]
            r["dense_bound_ms"] = bound_ms(dense, nbytes[name],
                                           peak_tflops(True))[0]
            r["dense_cuda_core_bound_ms"] = bound_ms(dense, nbytes[name])[0]
            r["cost_estimate_bound_ms"] = bound_ms(cost_est, nbytes[name],
                                                   peak_tflops(True))[0]
        r = res["gcl_bwd_data_bf16"]
        r["scratch_bytes"] = nbar * 4 * 4 * s * d * 4
    counts.restore(before)  # comparison launches do not count
    return res


def check_fused_fp32(nbar, d, device, timing=True):
    """`gcl_bwd_fused` in fp32 against its fp32 plain version (dx at rtol =
    atol = TOL, the sums at SUM_TOL); with timing, `fused_ms` beside
    `split_ms`, `gcl_bwd_data` + `gcl_bwd_weight` on the same inputs."""
    import torch

    from polyphemus_tpu_torch.ops.kernels import counts, gcl_bwd

    mask, (x, up, aux, gates, wbig, _) = train_kernel_inputs(
        nbar, d, device, SEED + 11)
    before = dict(counts.launches)
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
        data, dense, cost_est = fused_bwd_work(mask, d)
        res["bound_ms"], res["bound_by"] = bound_ms(data, nbytes)
        res["dense_bound_ms"] = bound_ms(dense, nbytes)[0]
        res["cost_estimate_bound_ms"] = bound_ms(cost_est, nbytes)[0]
    counts.restore(before)  # comparison launches do not count
    return res


# ------------------------- phase 10b: the column forms (tensor parallelism)
def kernel_counts():
    """Every wrapper's launch counts, the column forms' too."""
    from polyphemus_tpu_torch.ops.kernels import counts, gcl

    return dict(counts.launches), dict(gcl.col_launches)


def set_kernel_counts(saved) -> None:
    from polyphemus_tpu_torch.ops.kernels import counts, gcl

    counts.restore(saved[0])
    gcl.col_launches.update(saved[1])


def check_gcl_columns(nbar, d, n, device, bf16=False, timing=True,
                      s=32) -> dict:
    """The column forms of the GCL kernels that tensor parallelism launches
    (output width n of d, `parallel.mesh`), for every one of the d / n
    column shards of one layer over bars of 4 x s cells: `gcl_fwd`,
    `gcl_eval` at K = 1 and the backward that training runs there: in fp32,
    and in bf16 above 48 steps a bar, `gcl_bwd_data` and `gcl_bwd_weight`;
    in bf16 up to 48 `gcl_bwd_fused`. Each against its plain version on the
    same shard (fp32: rtol = atol = TOL, the sums over bars at SUM_TOL;
    bf16: BF16_REL of max |plain|). The partial dx and dgate summed over the
    shards (in fp32) against the square plain version's, at the same
    tolerances. `equal_to_square` says whether the shards of the forward,
    eval and weight kernels are bit for bit the square launch's columns.
    With timing, shard 0's ms per launch, its plain version's and its bound
    (1 / M of the square launch's work: active cells, and every cell for
    `dense_bound_ms`), beside the square launch's ms and bounds."""
    import torch

    from polyphemus_tpu_torch.ops.kernels import gcl, gcl_bwd

    mask, args = train_kernel_inputs(nbar, d, device, SEED + 19, s)
    g = torch.Generator().manual_seed(SEED + 19)
    ea = (torch.randn(d, generator=g) * 0.1 + 1.0).to(device)
    eb = (torch.randn(d, generator=g) * 0.1).to(device)
    dt = torch.bfloat16 if bf16 else torch.float32
    x, up, aux, gates, wbig, bias = [
        v if v.dtype == torch.int32 else v.to(dt) for v in args]
    ea, eb = ea.to(dt), eb.to(dt)
    saved = kernel_counts()
    suffix = "_bf16" if bf16 else ""
    split = not bf16 or s > gcl.MAX_STEPS  # the data and weight pair
    bwd = f"gcl_bwd_data{suffix}" if split else "gcl_bwd_fused"
    wgt = f"gcl_bwd_weight{suffix}"

    def held(name, a, b, summed):
        return held_rel(name, a, b) if bf16 else held_to(name, a, b,
                                                         summed=summed)

    def shard(r):
        c = slice(r * n, (r + 1) * n)
        return (wbig[:, c].contiguous(), bias[c].contiguous(),
                ea[c].contiguous(), eb[c].contiguous())

    def runs(r):
        wc, bc, eac, ebc = shard(r)
        eval_args = (x, aux, gates, wc[None], bc[None], eac[None], ebc[None])
        out = {f"gcl_fwd{suffix}": (
            lambda: gcl.gcl_fwd(x, aux, gates, wc, bc),
            lambda: gcl.gcl_fwd_plain(x, aux, gates, wc, bc)),
            f"gcl_eval{suffix}": (
            lambda: gcl.gcl_eval(*eval_args, col0=r * n),
            lambda: gcl.gcl_eval_plain(*eval_args, col0=r * n))}
        gc = up[..., r * n:(r + 1) * n].contiguous()
        if split:
            out[bwd] = (lambda: gcl_bwd.gcl_bwd_data(x, gc, aux, gates, wc),
                        lambda: gcl_bwd.gcl_bwd_data_plain(x, gc, aux,
                                                           gates, wc))
            out[wgt] = (
                lambda: gcl_bwd.gcl_bwd_weight(x, gc, aux, gates),
                lambda: gcl_bwd.gcl_bwd_weight_plain(x, gc, aux, gates))
        else:
            out[bwd] = (lambda: gcl_bwd.gcl_bwd_fused(x, gc, aux, gates, wc),
                        lambda: gcl_bwd.gcl_bwd_fused_plain(x, gc, aux,
                                                            gates, wc))
        return out

    square = {f"gcl_fwd{suffix}": gcl.gcl_fwd(x, aux, gates, wbig, bias),
              f"gcl_eval{suffix}": gcl.gcl_eval(
                  x, aux, gates, wbig[None], bias[None], ea[None], eb[None])}
    if split:
        square[wgt] = gcl_bwd.gcl_bwd_weight(x, up, aux, gates)
        square_bwd = gcl_bwd.gcl_bwd_data_plain(x, up, aux, gates, wbig)
    else:
        square_bwd = gcl_bwd.gcl_bwd_fused_plain(x, up, aux, gates, wbig)
    res = {k: {"max_abs_err": 0.0, "equal_to_square": True}
           for k in runs(0)}
    res[bwd].pop("equal_to_square")
    sums = None
    for r in range(d // n):
        for name, (kern, plain) in runs(r).items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            if name == bwd:
                outs = ("dx", "dgate", "dbias", "dwbig")
                errs = [held(f"{name} n={n} shard {r} {o}", a, b,
                             o != "dx") for o, a, b in zip(outs, got, want)]
                part = [v.float() for v in got[:2]]
                sums = (part if sums is None
                        else [a + b for a, b in zip(sums, part)])
                err = max(errs)
            else:
                err = held(f"{name} n={n} shard {r}", got, want, name == wgt)
                res[name]["equal_to_square"] &= torch.equal(
                    got, square[name][..., r * n:(r + 1) * n])
            res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
    for o, a, b in zip(("dx", "dgate"), sums, square_bwd):
        res[bwd][f"{o}_summed_over_shards_max_abs_err"] = held(
            f"{bwd} n={n} {o} summed over the shards", a, b.float(),
            o != "dx")
    if timing:
        active = int(mask.sum())
        esz = x.element_size()
        peak = peak_tflops(bf16)
        state = x.numel() * esz
        small = aux.numel() * 4 + gates.numel() * esz

        def work(name, w, cells=active):
            """(flops, bytes) of one launch at output width w."""
            flops = 2.0 * cells * 5 * d * w
            wbytes = 8 * d * w * esz
            out_b = nbar * 4 * s * w * esz
            if name.startswith("gcl_fwd"):
                return flops, state + out_b + small + wbytes + w * esz
            if name.startswith("gcl_eval"):
                return flops, state + out_b + small + wbytes + 3 * w * esz
            if name.startswith("gcl_bwd_weight"):
                return flops, state + out_b + small + 8 * d * w * 4
            if name.startswith("gcl_bwd_data"):
                return flops, 2 * state + out_b + small + wbytes \
                    + (s * d + w) * 4
            return 2 * flops, 2 * state + out_b + small + wbytes \
                + 8 * d * w * 4 + (s * d + w) * 4

        sq = {f"gcl_fwd{suffix}": lambda: gcl.gcl_fwd(x, aux, gates, wbig,
                                                       bias),
              f"gcl_eval{suffix}": lambda: gcl.gcl_eval(
                  x, aux, gates, wbig[None], bias[None], ea[None], eb[None]),
              wgt: lambda: gcl_bwd.gcl_bwd_weight(x, up, aux, gates),
              f"gcl_bwd_data{suffix}": lambda: gcl_bwd.gcl_bwd_data(
                  x, up, aux, gates, wbig),
              "gcl_bwd_fused": lambda: gcl_bwd.gcl_bwd_fused(
                  x, up, aux, gates, wbig)}
        for name, (kern, plain) in runs(0).items():
            r = res[name]
            r["ms"] = time_ms(kern)
            r["plain_ms"] = time_ms(plain, reps=2)
            r["bound_ms"], r["bound_by"] = bound_ms(*work(name, n), peak)
            r["dense_bound_ms"] = bound_ms(*work(name, n, mask.numel()),
                                           peak)[0]
            r["square_ms"] = time_ms(sq[name])
            r["square_bound_ms"] = bound_ms(*work(name, d), peak)[0]
    set_kernel_counts(saved)  # comparison launches do not count
    return {"nbar": nbar, "d": d, "n": n, "s": s, "bf16": bf16,
            "kernels": res}


def chord_inputs(nbar, d, device, seed, s=32):
    import torch

    g = torch.Generator().manual_seed(seed)
    h = d // 2
    mask = torch.from_numpy(bar_masks(nbar, 4, s, seed))
    x = (torch.randn(nbar, 4, s, d, generator=g) * mask[..., None])
    p = [torch.randn(d, 15 * d, generator=g) * d ** -0.5,
         torch.randn(15 * d, generator=g) * 0.1,
         torch.randn(h, 131, generator=g) * h ** -0.5,
         torch.randn(131, generator=g) * 0.1,
         torch.randn(h, 131, generator=g) * h ** -0.5,
         torch.randn(131, generator=g) * 0.1,
         torch.randn(h, 99, generator=g) * h ** -0.5,
         torch.randn(99, generator=g) * 0.1]
    return mask.to(device), [v.contiguous().to(device) for v in [x] + p]


def chord_logits(x, params):
    """Per slot, the plain chord tail's (pitch, dur) logits for x (..., T,
    S, d) and params (ck, cb, pkd, pbd, pkn, pbn, dk, db), in fp32 (or
    wider) for bf16 operands too: a generator of 15 pairs."""
    import torch

    x = x.float()
    ck, cb, pkd, pbd, pkn, pbn, dk, db = (a.float() for a in params)
    d = x.shape[-1]
    h = d // 2
    for s in range(15):
        sh = x @ ck[:, s * d:(s + 1) * d] + cb[s * d:(s + 1) * d]
        pitch = torch.cat([sh[..., :1, :, :h] @ pkd + pbd,
                           sh[..., 1:, :, :h] @ pkn + pbn], dim=-3)
        yield pitch, sh[..., h:] @ dk + db


def chord_gaps(x, *params):
    """Top-2 logit gaps (..., T, S, 15, 2) of the plain chord tail."""
    import torch

    gaps = []
    for pitch, dur in chord_logits(x, params):
        g2 = [v.topk(2, dim=-1).values for v in (pitch, dur)]
        gaps.append(torch.stack([v[..., 0] - v[..., 1] for v in g2], -1))
    return torch.stack(gaps, dim=-2)


def idle_ids_agree(ids, mask) -> bool:
    """Whether every inactive cell of a track kind has the same ids: x = 0
    there, so every inactive drum cell has the same logits, and every
    inactive melodic one."""
    for trk in (slice(0, 1), slice(1, None)):  # drum, melodic
        idle = ids[..., trk, :, :, :][~mask[..., trk, :]]
        if not (idle == idle[:1]).all().item():
            return False
    return True


def check_chord(nbar, d, device, timing=True, bf16=False, chunk=None, s=32,
                active_ties=False):
    """`chord_tail` against its plain version: ids equal except where the
    plain top-2 logit gap is below TIE (`bf16`: x and every weight and bias
    cast to bf16; the logits are fp32 sums either way, so the rule is the
    same); with timing, ms per launch and the bound (bf16: on the bf16
    tensor cores, `dense_split_bound_ms` with the three-part unembed the
    kernel takes, `cuda_core_bound_ms` on the fp32 CUDA cores). `chunk`: the
    plain version runs on that many bars at a time; s: steps a bar. The
    near-ties may be at most 1e-3 of the ids, or with `active_ties` of the
    active cells' ids (those that generation reads); every inactive cell of
    a track kind must get the same ids (`idle_ids_agree`)."""
    import torch

    from polyphemus_tpu_torch.ops.kernels import chord_tail, counts

    mask, args = chord_inputs(nbar, d, device, SEED + 7, s)
    if bf16:
        args = [a.to(torch.bfloat16) for a in args]
    before = dict(counts.launches)
    out = chord_tail.chord_tail_tokens(*args, n_slots=15)

    def plain():
        return by_bars(chord_tail.chord_tail_plain, args[:1], args[1:], chunk,
                       n_slots=15)

    ref = plain()
    gaps = by_bars(chord_gaps, args[:1], args[1:], chunk)
    torch.cuda.synchronize()
    check(out.shape == ref.shape and out.dtype == torch.int32,
          f"chord_tail output {out.dtype} {tuple(out.shape)}")
    tie = gaps < TIE
    diff = out != ref
    check(not (diff & ~tie).any().item(),
          f"chord_tail nbar={nbar}: {int((diff & ~tie).sum())} ids differ "
          f"outside near-ties")
    share = (tie[mask] if active_ties else tie).float().mean().item()
    check(share < 1e-3, f"too many chord-tail near-ties: {share:.2e}")
    check(idle_ids_agree(out, mask), f"chord_tail nbar={nbar}: inactive "
          f"cells of one track kind got different ids")
    res = {"max_abs_err": (out - ref)[~tie].abs().max().item(),
           "tie_mismatches": int((diff & tie).sum()),
           "near_ties": int(tie.sum())}
    if timing:
        res["ms"] = time_ms(lambda: chord_tail.chord_tail_tokens(
            *args, n_slots=15))
        res["plain_ms"] = time_ms(plain, reps=2)
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
        peak = peak_tflops(bf16)
        res["bound_ms"], res["bound_by"] = bound_ms(rows * per_row, nbytes,
                                                    peak)
        res["dense_bound_ms"] = bound_ms(mask.numel() * per_row, nbytes,
                                         peak)[0]
        if bf16:
            # the kernel's unembeds take h as three bf16 parts: 3 x their
            # products on the tensor cores
            split_row = 15 * (2.0 * d * d + 3 * 2.0 * h * (131 + 99))
            res["dense_split_bound_ms"] = bound_ms(mask.numel() * split_row,
                                                   nbytes, peak)[0]
            res["cuda_core_bound_ms"] = bound_ms(rows * per_row, nbytes)[0]
            res["dense_cuda_core_bound_ms"] = bound_ms(
                mask.numel() * per_row, nbytes)[0]
    counts.restore(before)  # comparisons do not count
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

    from polyphemus_tpu_torch.ops.kernels import counts
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
        counts.reset()
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
        launches = {"gcl_eval": counts.total("gcl_eval"),
                    "gcl_eval_by_k": by_k(),
                    "chord_tail": counts.total("chord_tail")}
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


# ------------------------------------------- phase 4b: bf16 generation, CLIs
S_TIE_BF16 = 0.03     # bf16 masks: equal where |s_logit| > this (the bf16
#                       sigmoid 1 / (1 + exp(-s)) reads 0.5 down to
#                       s = -0.0117; two bf16 ulps beyond that)
BF16_FLIP_SHARE = 1e-2  # bf16: most cells that may flip near the threshold
BF16_TIE_SHARE = 0.25   # bf16: most active ids the tie band may excuse


def compare_bf16_with_cpu(model_dir, device, n=8, seed=9, flip_cap=True):
    """bf16 generation of n sequences on the card against the same on the
    CPU (the kernels against their plain versions inside the whole decode),
    unconditioned and on a given structure (`bar_masks`, realistic
    densities: a random-init model's own masks can be nearly empty).

    Without `flip_cap` (a model whose structure logits crowd the bf16
    threshold: phase 13's random weights at r = 24 put 64 % of the cells
    in the |s_logit| <= S_TIE_BF16 band), the unconditioned run's flip
    share is reported, not capped: instead the structure logits must be
    within BF16_REL x max |cpu| of the CPU's (a flip is a cell where the
    two logits straddle the threshold), and, where cells flipped, the card
    decodes again on the CPU's mask (as phase 3 does in fp32) so that every
    bar is compared by the rules below.

    Unconditioned: masks equal where |s_logit| > S_TIE_BF16, at most
    BF16_FLIP_SHARE of cells flipped. In the bars whose masks agree (a
    flipped cell changes its bar's graph): the GCN output within BF16_REL
    of its max |cpu| (8 layers of bf16 rounding in two summation orders);
    ids equal except where the CPU's top-2 gap of the chord tail's fp32
    logits is below 2 delta + TIE, delta the largest difference between the
    logits of the two GCN outputs (a logit pair can swap only within that;
    TIE covers the kernel's fp32 summation order); that band may excuse at
    most BF16_TIE_SHARE of the active ids."""
    import torch

    from polyphemus_tpu_torch.generate import load_model, make_generator
    from polyphemus_tpu_torch.serve import host_z

    seen = {"cpu": {}, "card": {}}
    models = {}
    for name, dev in (("cpu", "cpu"), ("card", device)):
        model, cfg = load_model(model_dir, dev)
        # the generator's bf16 copy of the model keeps these hooks
        model.decoder.s_decoder.register_forward_hook(
            lambda mod, args, out, k=name: seen[k].update(s=out.float()))
        model.decoder.c_decoder.graph_decoder.register_forward_hook(
            lambda mod, args, out, k=name: seen[k].update(x=out))
        models[name] = model
    mc = cfg.model
    cd = models["cpu"].decoder.c_decoder
    weights = [p.detach().to(torch.bfloat16) for p in (
        cd.chord_decoder.kernel, cd.chord_decoder.bias,
        cd.drums_pitch_emb.kernel, cd.drums_pitch_emb.bias,
        cd.non_drums_pitch_emb.kernel, cd.non_drums_pitch_emb.bias,
        cd.dur_emb.kernel, cd.dur_emb.bias)]
    z = host_z(seed, n, mc.d)
    given = torch.from_numpy(bar_masks(n * mc.n_bars, mc.n_tracks,
                                       mc.n_timesteps, seed)).reshape(
        n, mc.n_bars, mc.n_tracks, mc.n_timesteps)
    res = {"n": n}
    for name, inputs in (("unconditioned", (z,)), ("conditioned", (z, given))):
        cond = len(inputs) == 2
        m_c, t_c = make_generator(models["cpu"], conditioned=cond, bf16=True,
                                  device="cpu")(*inputs)
        m_g, t_g = make_generator(models["card"], conditioned=cond,
                                  bf16=True, device=device)(
            *(v.to(device) if torch.is_tensor(v) else v for v in inputs))
        m_g, t_g = m_g.cpu(), t_g.cpu()
        flips = m_g != m_c
        r = {"mask_flips": int(flips.sum()), "cells": flips.numel(),
             "active_cells": int(m_c.sum())}
        if not cond:
            s_c = seen["cpu"]["s"]
            clear = s_c.abs() > S_TIE_BF16
            check(torch.equal(m_g[clear], m_c[clear]),
                  f"bf16 n={n}: {int((flips & clear).sum())} mask cells "
                  f"differ from the CPU at |s_logit| > {S_TIE_BF16}")
            r["max_abs_s_logit"] = s_c.abs().max().item()
            r["s_logit_max_abs_err"] = (seen["card"]["s"].cpu()
                                        - s_c).abs().max().item()
            if flip_cap:
                check(flips.float().mean().item() <= BF16_FLIP_SHARE,
                      f"bf16 n={n}: {int(flips.sum())} mask cells flipped")
            else:
                r["cells_in_tie_band"] = int((~clear).sum())
                check(r["s_logit_max_abs_err"]
                      <= BF16_REL * r["max_abs_s_logit"],
                      f"bf16 n={n}: structure logits off by "
                      f"{r['s_logit_max_abs_err']:.3e} (max "
                      f"{r['max_abs_s_logit']:.3e})")
                if flips.any():  # every bar compared on the CPU's mask
                    m_g, t_g = make_generator(
                        models["card"], conditioned=True, bf16=True,
                        device=device)(z, m_c.to(device))
                    m_g, t_g = m_g.cpu(), t_g.cpu()
                    flips = m_g != m_c
        same = ~flips.any(dim=-1).any(dim=-1)
        check(same.any().item(), "bf16: every bar has a flipped cell")
        x_c = seen["cpu"]["x"][same].float()
        x_g = seen["card"]["x"].cpu()[same].float()
        state_err = (x_g - x_c).abs().max().item()
        check(state_err <= BF16_REL * x_c.abs().max().item(),
              f"bf16 {name}: GCN output off by {state_err:.3e} (max "
              f"{x_c.abs().max().item():.3e})")
        delta = max((a - b).abs().max().item()
                    for lc, lg in zip(chord_logits(x_c, weights),
                                      chord_logits(x_g, weights))
                    for a, b in zip(lc, lg))
        tie = chord_gaps(x_c, *weights) < 2 * delta + TIE
        diff = t_g[same] != t_c[same]
        check(not (diff & ~tie).any().item(),
              f"bf16 {name} n={n}: {int((diff & ~tie).sum())} ids differ "
              f"from the CPU outside top-2 gaps < {2 * delta + TIE:.3e}")
        active = m_c[same]
        tie_share = tie[active].float().mean().item()
        check(tie_share <= BF16_TIE_SHARE,
              f"bf16 {name}: the tie band excuses {tie_share:.3f} of the "
              f"active ids")
        r.update({"bars_compared": int(same.sum()), "bars": same.numel(),
                  "gcn_max_abs_err": state_err,
                  "gcn_max_abs": x_c.abs().max().item(),
                  "logit_max_abs_err": delta,
                  "id_mismatches": int(diff[active].sum()),
                  "ids": int(diff[active].numel()),
                  "near_tie_share": tie_share})
        res[name] = r
    return res


def cli_phase(model_dir, device, out_dir, samples):
    """The port's generate CLI on the card (fp32, then `--bf16`) and its
    reconstruct CLI on `samples`; each must write MIDI files that parse and
    launch the kernels of its path: per generation call 4 `gcl_eval` (or 4
    bf16) and 1 `chord_tail` (or bf16) launch; the CLI makes 2 calls (one
    warm-up). Reconstruct runs the encoder's GCN (8 layers at K = 1) and a
    conditioned decode."""
    from polyphemus_tpu_torch.cli import generate as gen_cli
    from polyphemus_tpu_torch.midi import read_midi
    from polyphemus_tpu_torch.ops.kernels import counts

    shutil.rmtree(out_dir, ignore_errors=True)
    n = 4
    res = {}
    for name, extra in (("generate", []), ("generate_bf16", ["--bf16"])):
        counts.reset()
        out = os.path.join(out_dir, name)
        gen_cli.main([model_dir, out, "--n", str(n), "--no_audio",
                      "--seed", "2", "--device", str(device), *extra])
        got = tuple(counts.total(k) for k in (
            "gcl_eval", "chord_tail", "gcl_eval_bf16", "chord_tail_bf16"))
        want = (0, 0, 8, 2) if extra else (8, 2, 0, 0)
        check(got == want, f"{name} CLI launches {got}, expected {want}")
        notes = 0
        for i in range(n):
            song, tpq, _ = read_midi(os.path.join(out, str(i),
                                                  "generated.mid"))
            notes += sum(len(t.notes) for t in song.tracks)
        res[name] = {"files": n, "notes": notes, "launches": got}
    res["reconstruct"] = reconstruct_cli(
        model_dir, device, os.path.join(out_dir, "reconstruct"), samples)
    return res


def reconstruct_cli(model_dir, device, out, samples, s=32):
    """The port's reconstruct CLI on `samples` of bars of 4 x s cells: 8
    encoder launches of `gcl_eval` at K = 1, a conditioned decode (4 at K =
    2, 1 `chord_tail`; above 48 steps the decode's 8 layers at K = 1) and
    no other launch, MIDI files that parse."""
    from polyphemus_tpu_torch.cli import reconstruct as rec_cli
    from polyphemus_tpu_torch.midi import read_midi
    from polyphemus_tpu_torch.ops.kernels import counts

    counts.reset()
    rec_cli.main([model_dir, *samples, out, "--device", str(device)])
    launches = named(counts.launches)
    want = named(summed(eval_calls("gcl_eval", s, 1, 8),
                        eval_calls("gcl_eval", s, 2, 4),
                        {("chord_tail", s, 1): 1}))
    check(launches == want, f"reconstruct CLI launches {launches}, "
          f"expected {want}: 8 at K = 1 (encoder), 4 at K = 2 and 1 chord "
          f"tail (decode)")
    got = (counts.total("gcl_eval", s), counts.total("chord_tail", s))
    for i in range(len(samples)):
        for name in ("original", "reconstructed"):
            read_midi(os.path.join(out, str(i), name + ".mid"))
    return {"samples": len(samples), "launches": got,
            "gcl_eval_by_k": by_k(s=s)}


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
# fp32 at 16 bars, batch 8: the card's grads are held to an fp64 step's
# (`witness_fp64_grads`), not to the CPU's. Every fp32 step misses the fp64
# grads by about as much there: the CPU's by 2.5 % of a grad's max at the
# worst element and 1 - cosine 2.0e-6, the card's plain versions' by 2.4 %
# and 2.8e-6, the card's kernels' by 3.2 % and 3.4e-6 (H100, 700 W), all on
# the decoder's GCN weights, so the CPU is no nearer the exact grads than
# the card. Each limit is about 3x the largest of those readings.
WITNESS_GRAD_TOL = 0.1          # max abs err / max |fp64|, per grad
WITNESS_GRAD_COS_GAP = 1e-5     # 1 - cosine with the fp64 grad, per grad


TRAIN_KERNELS = ("gcl_fwd", "gcl_bwd_data", "gcl_bwd_weight", "gcl_fwd_bf16",
                 "gcl_bwd_fused")


def by_k(kernel="gcl_eval", s=32, launches=None) -> dict:
    """The launches of `kernel` over bars of 4 x s cells in `launches` (by
    default every count since the last reset), by chained layers K."""
    from polyphemus_tpu_torch.ops.kernels import counts

    launches = counts.launches if launches is None else launches
    return {k: n for (name, s_, k), n in launches.items()
            if name == kernel and s_ == s}


def grid_name(kernel, s, k) -> str:
    """The name of launches of `kernel` over bars of 4 x s cells at k
    chained layers: the kernel's, `_k1` added for one eval layer a launch
    (as in the `kernels` line), `_s<S>` for another grid than 4 x 32."""
    name = kernel + ("_k1" if kernel.startswith("gcl_eval") and k == 1
                     else "")
    return name if s == 32 else f"{name}_s{s}"


def named(launches) -> dict:
    """Launch counts keyed by (kernel, S, K), by `grid_name`."""
    out = {}
    for key, n in launches.items():
        out[grid_name(*key)] = out.get(grid_name(*key), 0) + n
    return out


def eval_calls(kernel, s, k, n) -> dict:
    """The launch counts of n `gcl_eval` calls of k chained layers over
    bars of 4 x s cells: n launches of K = k, or above 48 steps (the
    long-bar kernels) n k launches of one layer."""
    return {(kernel, s, k): n} if s <= 48 else {(kernel, s, 1): n * k}


def summed(*runs) -> dict:
    """Launch counts added key by key."""
    out = {}
    for run in runs:
        for key, n in run.items():
            out[key] = out.get(key, 0) + n
    return out


def check_launches(counts, per_step, steps):
    """Exactly per_step[k] launches of kernel k per optimizer step, and none
    of the training kernels per_step does not name."""
    for name, n in counts.items():
        want = per_step.get(name, 0) * steps
        check(n == want, f"expected {per_step.get(name, 0)} {name} launches "
                         f"per optimizer step, got {n} in {steps} steps")


def write_dataset(path, n, n_bars, seed, n_timesteps=32):
    """n reference-format .npz samples of synthetic music (density 0.15)."""
    from polyphemus_tpu_torch.data import synthetic_batch, write_sample

    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    toks, mask = synthetic_batch(np.random.default_rng(seed), n, n_bars,
                                 n_timesteps=n_timesteps)
    for i in range(n):
        write_sample(os.path.join(path, f"s{i:04d}.npz"), toks[i], mask[i])


def train_phase(device, config_path, data_dir, out_dir, epochs,
                splits=("--tr_split", "1.0"), extra=(), name="lmd2"):
    """Train through the CLI's `main()` (`splits`: its data-split and eval
    arguments; `extra`: more arguments) into the model directory
    `out_dir/name`; returns (trainer, model dir, the main path's launch
    counts of the training kernels and of the eval kernels, bf16 and fp32
    at K = 1, metrics.jsonl records)."""
    from polyphemus_tpu_torch.cli import train as train_cli
    from polyphemus_tpu_torch.ops.kernels import counts

    shutil.rmtree(out_dir, ignore_errors=True)
    counts.reset()
    # ---- the main path ----
    trainer = train_cli.main([
        data_dir, out_dir, config_path, "--model_name", name,
        *splits, "--max_epochs", str(epochs), "--save_every",
        "0", "--num_workers", "8", "--seed", str(SEED),
        "--device", str(device), *extra])
    launches = dict({k: counts.total(k) for k in TRAIN_KERNELS},
                    gcl_eval_bf16=counts.total("gcl_eval_bf16"),
                    gcl_eval_k1=counts.total("gcl_eval", k=1))
    model_dir = os.path.join(out_dir, name)
    with open(os.path.join(model_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return trainer, model_dir, launches, recs


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


def shift_free_grads(model, mc, toks, mask, eps, device):
    """The parameters whose true grad on this batch is 0: their fp32 grad
    (one fp32 step of `model` on `device`; its launches do not count) is
    under GRAD_NOISE x the largest. They are the biases that feed a norm
    with batch statistics, which removes any shift (their fp32 grads come
    out near 1e-8 of the largest on either device); under the bf16 policy
    their grads are rounding noise. The step runs on the card: on the CPU
    it was a whole fp32 step of LMD2 beside the comparison's own bf16 one,
    about half of a comparison's time at r = 24."""
    from polyphemus_tpu_torch.config import TrainConfig
    from polyphemus_tpu_torch.ops.kernels import counts
    from polyphemus_tpu_torch.train import trainer as tr

    before = dict(counts.launches)
    model = model.to(device)
    cfg = TrainConfig(batch_size=len(toks), model=mc)
    step = tr.make_train_step(model, cfg, tr.make_optimizer(model, cfg))
    step(toks.to(device), mask.to(device), eps=eps.to(device))
    top = {n: p.grad.abs().max().item() for n, p in model.named_parameters()}
    counts.restore(before)
    scale = max(top.values())
    return {n for n, v in top.items() if v < GRAD_NOISE * scale}


@contextlib.contextmanager
def plain_training_gcl():
    """Inside, the training GCL (`gcl_fused`) runs its kernels' plain
    versions on every device (no launch, no count)."""
    from polyphemus_tpu_torch.ops.kernels import gcl, gcl_bwd

    names = ("gcl_fwd", "gcl_bwd_data", "gcl_bwd_weight", "gcl_bwd_fused")
    saved = [getattr(gcl_bwd, n) for n in names]
    for n in names:
        setattr(gcl_bwd, n, getattr(gcl if n == "gcl_fwd" else gcl_bwd,
                                    n + "_plain"))
    try:
        yield
    finally:
        for n, f in zip(names, saved):
            setattr(gcl_bwd, n, f)


def witness_fp64_grads(model, cfg, toks, mask, eps, device):
    """The grads of one train step of an fp64 copy of `model` on `device`,
    through the training GCL's plain versions (no kernel takes fp64) and
    with every step that widens to fp32 widening to fp64: the witness that
    shows which fp32 step, the card's or the CPU's, is nearer the exact
    grads."""
    import copy

    import torch

    from polyphemus_tpu_torch.train import trainer as tr

    m = copy.deepcopy(model).double().to(device)
    step = tr.make_train_step(m, cfg, tr.make_optimizer(m, cfg))
    with plain_training_gcl():
        step(toks.to(device), mask.to(device),
             eps=eps.to(device, torch.float64))
    return {n: p.grad.detach().cpu() for n, p in m.named_parameters()}


def hold_against_witness(grads, g64, check_grads, held_run="card"):
    """Each fp32 run's grads (`grads`: {run: {name: grad}}) against the fp64
    witness's: the largest max abs err over max |fp64| and the least cosine
    over the grads that are not noise (max above GRAD_NOISE x the largest),
    and the largest abs err over GRAD_NOISE x the largest on the others.
    With check_grads, the run `held_run` must keep each grad within
    WITNESS_GRAD_TOL of its max |fp64| and within WITNESS_GRAD_COS_GAP of
    its direction, and each noise grad within GRAD_NOISE x the largest."""
    scale = max(g.abs().max().item() for g in g64.values())
    held = [n for n, g in g64.items()
            if g.abs().max().item() > GRAD_NOISE * scale]
    noise = [n for n in g64 if n not in held]
    report = {}
    for run, g in grads.items():
        err = {n: (g[n].double() - g64[n]).abs().max().item()
               / g64[n].abs().max().item() for n in held}
        worst = sorted(err, key=lambda n: -err[n])[:3]
        report[run] = {
            "max_grad_err_over_max": max(err.values()),
            "min_grad_cosine": min(cosine(g[n], g64[n]) for n in held),
            "noise_max_err_over_noise_tol": max(
                ((g[n].double() - g64[n]).abs().max().item()
                 / (GRAD_NOISE * scale) for n in noise), default=0.0),
            "worst": {n: err[n] for n in worst}}
    card = report[held_run]
    check(not check_grads or (
        card["max_grad_err_over_max"] <= WITNESS_GRAD_TOL
        and 1.0 - card["min_grad_cosine"] <= WITNESS_GRAD_COS_GAP
        and card["noise_max_err_over_noise_tol"] <= 1.0),
        f"{held_run} grads off the fp64 witness's: {card} (limits: "
        f"{WITNESS_GRAD_TOL} of each max, 1 - cosine "
        f"{WITNESS_GRAD_COS_GAP}, GRAD_NOISE on noise grads)")
    return {"vs_fp64": report, "fp64_largest_grad": scale,
            "fp64_grads_held": len(held),
            "witness_grad_tol": WITNESS_GRAD_TOL,
            "witness_grad_cos_gap": WITNESS_GRAD_COS_GAP}


def compare_train_step(mc, batch, device, seed, check_grads=True,
                       bf16=False, witness=False):
    """One eval step, then one train step, from the same weights, batch and
    eps on the card and on the CPU. The eval losses (running statistics)
    are held as the train losses are.

    fp32: losses within TRAIN_LOSS_RTOL and, with check_grads, each grad
    within TRAIN_GRAD_TOL of its max |cpu| (rounding-noise grads:
    GRAD_NOISE). At batch 2 the grads are reported, not held: the two
    batch-norms over 2 samples (`bn_linear_merge`, the decoder head's) make
    the grads behind them hang on fp32 rounding, so that the card's kernels
    and the card's plain versions differ there as much as either differs
    from the CPU. With `witness` (fp32), the same step also runs in fp64
    (`witness_fp64_grads`) and on the card with the training GCL's plain
    versions (`plain_training_gcl`): each fp32 step's distance from the
    fp64 grads is reported, and the card's grads are held to them
    (`hold_against_witness`) instead of to the CPU's.

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
    toks, mask = (torch.from_numpy(a) for a in synthetic_batch(
        rng, batch, mc.n_bars, n_timesteps=mc.n_timesteps))
    eps = torch.from_numpy(rng.standard_normal((batch, mc.d)).astype(
        np.float32))
    if bf16:
        centre_merge_input(cpu_model, mc, toks, mask, eps)
        shift_free = shift_free_grads(copy.deepcopy(cpu_model), mc, toks,
                                      mask, eps, device)
    runs = [("cpu", cpu_model, torch.device("cpu")),
            ("card", copy.deepcopy(cpu_model).to(device), device)]
    if witness:
        runs.append(("card_plain", copy.deepcopy(cpu_model).to(device),
                     device))
        g64 = witness_fp64_grads(cpu_model, cfg, toks, mask, eps, device)
    out, unresolved = {}, {}

    def merge_bn_hook(name):
        def hook(mod, args, _):
            x = args[0].detach().float()
            var, mean = x.var(0, unbiased=False), x.mean(0)
            unresolved[name] = int((var < RESOLVED * mean.square()).sum())
        return hook

    evals = {}
    for name, model, dev in runs:
        lo, _ = tr.eval_step(model, cfg, toks.to(dev), mask.to(dev), 0,
                             eps=eps.to(dev))
        evals[name] = {k: float(v) for k, v in lo.items()}
        handle = model.encoder.bn_linear_merge.register_forward_hook(
            merge_bn_hook(name))
        step = tr.make_train_step(model, cfg, tr.make_optimizer(model, cfg))
        with (plain_training_gcl() if name == "card_plain"
              else contextlib.nullcontext()):
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
            if noise:
                score = err / (GRAD_NOISE * scale)
            elif witness:
                score = 0.0  # held against the fp64 witness below
            else:
                score = err / (TRAIN_GRAD_TOL * ref)
        rows[n] = (score, err, ref, cos, noise)
    worst = sorted(rows, key=lambda n: -rows[n][0])[:4]
    check(not check_grads or rows[worst[0]][0] <= 1.0,
          f"grads off: {[(n, rows[n]) for n in worst]} (largest |grad| "
          f"{scale:.3e})")
    held = [n for n in rows if not rows[n][4]]
    vs_fp64 = {}
    if witness:
        vs_fp64 = hold_against_witness(
            {k: out[k][1] for k in ("cpu", "card", "card_plain")}, g64,
            check_grads)
    return {**vs_fp64, "batch": batch, "bf16": bf16,
            "grads_held": check_grads, "fp64_witness": witness,
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


def time_train_steps(trainer, batch, device, passes=3, steps=3):
    """Seconds per optimizer step (host clock around steps that end in a
    sync): median of `passes` passes of `steps` steps, after one warm step,
    on device-resident synthetic batches."""
    import torch

    from polyphemus_tpu_torch.data import synthetic_batch

    rng = np.random.default_rng(SEED + 3)
    mc = trainer.cfg.model
    toks, mask = (torch.from_numpy(a).to(device) for a in synthetic_batch(
        rng, batch, mc.n_bars, n_timesteps=mc.n_timesteps))
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
    return {"metric": f"lmd{trainer.cfg.model.n_bars}_train_step",
            "step_s": s, "seq_s": batch / s,
            "batch": batch, "accumulate": trainer.cfg.iters_to_accumulate,
            "passes_step_s": times}


def profile_train_step(trainer, batch, device, path):
    """Device time by kernel over one optimizer step (torch.profiler),
    written to `path`; returns the step's wall time, the summed kernel time
    (device busy; the idle share is the rest), the time and share of the
    step of the training forward's kernel (`gcl_fwd`: the GCL kernels'
    form without the epilogue, template flag false) and the top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from polyphemus_tpu_torch.data import synthetic_batch

    mc = trainer.cfg.model
    toks, mask = (torch.from_numpy(a).to(device) for a in synthetic_batch(
        np.random.default_rng(SEED + 4), batch, mc.n_bars,
        n_timesteps=mc.n_timesteps))
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
    fwd_ms = sum(ms for key, ms, _ in rows
                 if re.search(r"gcl_eval_\w+_kernel(<false>|ILb0E)", key))
    with open(path, "w") as f:
        f.write(f"step wall {wall_ms:.3f} ms, kernels {busy:.3f} ms\n")
        for key, ms, count in rows:
            f.write(f"{ms:12.3f} ms {count:6d}x  {key}\n")
    return {"step_wall_ms": wall_ms, "kernel_ms": busy,
            "idle_share": 1.0 - busy / wall_ms, "gcl_fwd_ms": fwd_ms,
            "gcl_fwd_share": fwd_ms / wall_ms,
            "top": [{"name": k[:80], "ms": ms, "calls": c}
                    for k, ms, c in rows[:12]]}


# ------------------------------------------- phases 7-7c: LMD16, dropout
LMD16_CHUNK = 512     # bars a plain version takes at a time at 4096 bars
DROPOUT_P = 0.1       # the reference's message dropout
DROPOUT_TOL = 2e-4    # dropout GCL, card vs CPU: grads, max abs err / max


def check_meta_and_trace(model_dir, profile_dir):
    """The meta file `checkpoint.json` beside `checkpoint.pt` (its histories
    one entry a step), and the `--profile` trace: a Chrome trace that holds
    device kernels (counted by their category in the text; a trace of a
    step runs to hundreds of MB)."""
    meta_path = os.path.join(model_dir, "checkpoint.json")
    check(os.path.exists(meta_path) and os.path.exists(
        os.path.join(model_dir, "checkpoint.pt")),
        f"no checkpoint.json beside checkpoint.pt in {model_dir}")
    with open(meta_path) as f:
        meta = json.load(f)
    check(len(meta["tr_losses"]["tot"]) == meta["tot_batches"],
          f"meta file: {meta['tot_batches']} batches, "
          f"{len(meta['tr_losses']['tot'])} losses")
    trace = os.path.join(profile_dir, "trace.json")
    check(os.path.exists(trace), f"--profile wrote no {trace}")
    with open(trace) as f:
        text = f.read()
    check(text.lstrip().startswith("{") and '"traceEvents"' in text,
          f"{trace} is not a Chrome trace")
    kernels = len(re.findall(r'"cat":\s*"kernel"', text))
    check(kernels > 0, "the --profile trace holds no device kernel")
    return {"meta_keys": sorted(meta), "trace_kernel_events": kernels,
            "trace_bytes": len(text)}


def generate_looped_cli(model_dir, device, out, n_bars, loops=4):
    """The port's generate CLI with `--n 2 --n_loops loops`: 4 `gcl_eval`
    launches at K = 2 and 1 `chord_tail` a call, 2 calls; every file
    parses, and each `extended.mid` holds `loops` copies of its
    `generated.mid`, the k-th shifted by k x n_bars bars."""
    from polyphemus_tpu_torch.cli import generate as gen_cli
    from polyphemus_tpu_torch.midi import read_midi
    from polyphemus_tpu_torch.ops.kernels import counts

    counts.reset()
    gen_cli.main([model_dir, out, "--n", "2", "--n_loops", str(loops),
                  "--no_audio", "--seed", "2", "--device", str(device)])
    got = (by_k(), counts.total("chord_tail"))
    check(got == ({2: 8}, 2), f"looped generate CLI launches {got}")
    notes = 0
    for i in range(2):
        song, tpq, _ = read_midi(os.path.join(out, str(i), "generated.mid"))
        ext, tpq_ext, _ = read_midi(os.path.join(out, str(i),
                                                 "extended.mid"))
        shift = n_bars * 4 * tpq
        check(tpq_ext == tpq and len(ext.tracks) == len(song.tracks),
              "extended.mid has other tracks than generated.mid")
        for a, b in zip(song.tracks, ext.tracks):
            want = sorted((n.time + k * shift, n.pitch, n.duration)
                          for k in range(loops) for n in a.notes)
            check(sorted((n.time, n.pitch, n.duration) for n in b.notes)
                  == want, f"extended.mid track {a.name} is not {loops} "
                           f"copies of generated.mid")
            notes += len(a.notes)
    return {"files": 2, "notes": notes, "loops": loops,
            "gcl_eval_by_k": got[0], "chord_tail": got[1]}


def check_dropout_gcl(nbar, d, mode, device, seed=SEED + 17):
    """`lattice.gcl_apply` with message dropout (p = DROPOUT_P, `mode`) on
    the card against the CPU on the same keep masks (drawn on the CPU) and
    inputs, TF32 off: the output at rtol = atol = TOL, and the grads of x,
    rel_weight, root, bias and gate_table (of the sum of the output times a
    seeded cotangent) each within DROPOUT_TOL of its max |cpu|."""
    import torch

    from polyphemus_tpu_torch.generate import exact_fp32
    from polyphemus_tpu_torch.ops import lattice

    g = torch.Generator().manual_seed(seed)
    mask = torch.from_numpy(bar_masks(nbar, 4, 32, seed))
    x = torch.randn(nbar, 4, 32, d, generator=g) * mask[..., None]
    params = [torch.randn(6, d, d, generator=g) * d ** -0.5,
              torch.randn(d, d, generator=g) * d ** -0.5,
              torch.randn(d, generator=g) * 0.1,
              torch.randn(32, d, generator=g) * 0.3]
    cot = torch.randn(nbar, 4, 32, d, generator=g)
    keep_p = 1.0 - DROPOUT_P
    if mode == "aggregate":
        keep = [lattice.keep_mask((4,) + x.shape, keep_p, g, "cpu")]
    else:
        pair = (nbar, 4, 4, 32, d)
        keep = [lattice.keep_mask(sh, keep_p, g, "cpu")
                for sh in (x.shape, x.shape, pair, pair, x.shape)]
    res = {}
    for name, dev in (("cpu", torch.device("cpu")), ("card", device)):
        leaves = [t.to(dev, copy=True).requires_grad_() for t in [x] + params]
        xx, rw, root, bias, gt = leaves
        m = mask.to(dev)
        k = [t.to(dev) for t in keep]
        with exact_fp32():
            out = lattice.gcl_apply(
                xx, m, lattice.build_neighbors(m), gt, rw, root, bias,
                message_dropout=DROPOUT_P, message_dropout_mode=mode,
                keep=k[0] if mode == "aggregate" else k)
            (out * cot.to(dev)).sum().backward()
        res[name] = [out.detach().cpu()] + [t.grad.cpu() for t in leaves]
    errs = {"out_max_abs_err": held_to(f"dropout gcl_apply ({mode})",
                                       res["card"][0], res["cpu"][0],
                                       summed=False)}
    for n, a, b in zip(("x", "rel_weight", "root", "bias", "gate_table"),
                       res["card"][1:], res["cpu"][1:]):
        err, scale = (a - b).abs().max().item(), b.abs().max().item()
        check(err <= DROPOUT_TOL * scale,
              f"dropout gcl_apply ({mode}) grad {n}: max abs err {err:.3e}, "
              f"max |cpu| {scale:.3e}")
        errs[f"{n}_grad_err_over_max"] = err / scale
    return errs


def lmd16_vs_cpu(model_dir, device, n=8):
    """n = 8 generated on the card from the z that phase 3's request draws,
    held to the CPU by `compare_with_cpu`. Returns its result and the
    pieces, (mask, tokens) on the host."""
    import torch

    from polyphemus_tpu_torch.generate import load_model, make_generator
    from polyphemus_tpu_torch.serve import host_z

    model, cfg = load_model(model_dir, device)
    z = torch.from_numpy(host_z(8, n, cfg.model.d)).to(device)
    mask, tokens = make_generator(model, device=device)(z)
    pieces = (mask.cpu().numpy(), tokens.cpu().numpy())
    return compare_with_cpu(model_dir, pieces, device), pieces


# ----------------------------------------------------------- phase 4: bench
def bench(model_dir, device, batch=256, rounds=20, bf16=False):
    """Batched generation by bench.py's protocol: one warm call, then the
    median of 3 passes of `rounds` calls (`calls` counts them all)."""
    import torch

    from polyphemus_tpu_torch.generate import load_model, make_generator

    model, cfg = load_model(model_dir, device)
    gen = make_generator(model, bf16=bf16, device=device)
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
    return {"metric": f"lmd{cfg.model.n_bars}_batched_generation"
            + ("_bf16" if bf16 else ""),
            "value": rounds * batch / dt, "unit": "seq/s", "batch": batch,
            "call_ms": dt / rounds * 1e3, "passes_s": times,
            "calls": 1 + 3 * rounds}


def lmd16_phases(device, card):
    """Phases 7 and 7b: LMD16 training through the CLI, its kernels at 256
    bars, the card-vs-CPU step; LMD16 generation at 4096 bars a call, its
    kernels, n = 8 against the CPU, the CLIs on the trained directory.
    Returns what the results print."""
    from polyphemus_tpu_torch.config import load_train_config
    from polyphemus_tpu_torch.ops.kernels import counts

    # ---- 7. LMD16 training on the card ----
    lmd16_config = os.path.join(ROOT, "examples", "training_lmd16.json")
    cfg16 = load_train_config(lmd16_config)
    mc16 = cfg16.model
    check((mc16.n_bars, mc16.d, mc16.gnn_n_layers, cfg16.batch_size,
           cfg16.iters_to_accumulate, cfg16.bf16) == (16, 512, 8, 64, 4,
                                                      False),
          f"training_lmd16.json loaded as {cfg16}")
    data_l16 = os.path.join(ROOT, "build", "chip_smoke_data_lmd16")
    # 11 steps of 64: the CLI's trace of steps 10-15 is cut by the end of
    # training to step 10 alone (a 5-step trace takes minutes to write)
    write_dataset(data_l16, 704, mc16.n_bars, SEED)
    prof_dir = os.path.join(ROOT, "build", "chip_smoke_lmd16_profile")
    shutil.rmtree(prof_dir, ignore_errors=True)
    trainer, dir_l16, l16_launches, recs = train_phase(
        device, lmd16_config, data_l16,
        os.path.join(ROOT, "build", "chip_smoke_train_lmd16"), 1,
        extra=("--profile", prof_dir), name="lmd16")
    steps = trainer.step
    print(f"LMD16 training: {steps} steps, launches {l16_launches}, last "
          f"record {json.dumps(recs[-1])}")
    check(steps == 11, f"{steps} LMD16 optimizer steps")
    check_records(recs, steps)
    check_launches(l16_launches, {"gcl_fwd": 64, "gcl_bwd_data": 64,
                                  "gcl_bwd_weight": 64}, steps)
    surface = check_meta_and_trace(dir_l16, prof_dir)
    shutil.copy(os.path.join(prof_dir, "kernels.txt"),
                os.path.join(ROOT, "chiprun_out",
                             "lmd16_cli_profile_kernels.txt"))
    print("LMD16 meta file and --profile trace:", json.dumps(surface))
    # the training kernels at LMD16's microbatch: 16 sequences x 16 bars
    train_l16 = check_gcl_train(256, 512, device)
    print(f"LMD16 training kernel check (256 bars, d=512, {card}):",
          json.dumps(train_l16))
    step_cmp = compare_train_step(mc16, 8, device, SEED + 5, witness=True)
    print("LMD16 train step, card vs CPU (d=512, 8 layers, 16 bars, batch "
          "8):", json.dumps(step_cmp))
    bench_l16 = time_train_steps(trainer, cfg16.batch_size, device,
                                 passes=2)
    bench_l16["card"] = card
    print("LMD16 train bench:", json.dumps(bench_l16))
    del trainer

    # ---- 7b. LMD16 generation at batch 256: 4096 bars a call ----
    model_l16 = os.path.join(ROOT, "build", "chip_smoke_model_lmd16")
    make_model_dir(model_l16, mc16, SEED)
    counts.reset()
    # ---- the main path ----
    gen_l16 = bench(model_l16, device, rounds=5)
    gen_l16_launches = {"gcl_eval_by_k": by_k(),
                        "chord_tail": counts.total("chord_tail")}
    check(gen_l16_launches == {"gcl_eval_by_k": {2: 4 * gen_l16["calls"]},
                               "chord_tail": gen_l16["calls"]},
          f"LMD16 generation: launches {gen_l16_launches} in "
          f"{gen_l16['calls']} calls")
    gcl_l16 = check_gcl(4096, 512, 2, device, chunk=LMD16_CHUNK)
    chord_l16 = check_chord(4096, 512, device, chunk=LMD16_CHUNK)
    print(f"LMD16 generation kernel check (4096 bars, d=512, {card}):",
          json.dumps({"gcl_eval_k2": gcl_l16, "chord_tail": chord_l16}))
    gen_l16.update({"card": card, "launches": gen_l16_launches,
                    "kernel_ms_per_call": 4 * gcl_l16["ms"]
                    + chord_l16["ms"]})
    print("LMD16 bench:", json.dumps(gen_l16))
    cmp_l16, pieces = lmd16_vs_cpu(model_l16, device)
    print("LMD16 n=8 against the CPU:", json.dumps(cmp_l16))
    samples_l16 = os.path.join(ROOT, "build", "chip_smoke_samples_lmd16")
    write_dataset(samples_l16, 2, mc16.n_bars, SEED + 1)
    cli_l16 = os.path.join(ROOT, "build", "chip_smoke_cli_lmd16")
    shutil.rmtree(cli_l16, ignore_errors=True)
    clis_l16 = {
        "generate_n_loops_4": generate_looped_cli(
            dir_l16, device, os.path.join(cli_l16, "generate"),
            mc16.n_bars),
        "reconstruct": reconstruct_cli(
            dir_l16, device, os.path.join(cli_l16, "reconstruct"),
            sorted(os.path.join(samples_l16, f)
                   for f in os.listdir(samples_l16)))}
    print("LMD16 CLIs on the card (the trained directory):",
          json.dumps(clis_l16))
    return {"train_launches": l16_launches, "train_kernels": train_l16,
            "gen_launches": gen_l16_launches, "gcl_eval": gcl_l16,
            "chord_tail": chord_l16, "clis": clis_l16, "bench": gen_l16,
            "train_bench": bench_l16, "pieces": pieces, "mc": mc16}


def dropout_phase(device, card, config_path, data_dir):
    """Phase 7c: 2 steps of the LMD2 config with message dropout in each
    mode, with an eval step, and the dropout GCL card vs CPU. Returns
    {mode: result}."""
    # ---- 7c. message dropout on the card, both modes ----
    with open(config_path) as f:
        raw = json.load(f)
    dropout = {}
    for mode in ("edge", "aggregate"):
        cfg_path = os.path.join(ROOT, "build",
                                f"chip_smoke_dropout_{mode}.json")
        with open(cfg_path, "w") as f:
            json.dump(dict(raw, model=dict(
                raw["model"], message_dropout=DROPOUT_P,
                message_dropout_mode=mode)), f)
        # 1024 samples: 512 train (2 steps), 256 validation (1 eval batch)
        trainer, _, counts, recs = train_phase(
            device, cfg_path, data_dir,
            os.path.join(ROOT, "build", f"chip_smoke_train_{mode}"), 1,
            splits=("--tr_split", "0.5", "--vl_split", "0.25", "--eval"),
            name=mode)
        steps = trainer.step
        evals = len(trainer.val_losses["tot"])
        check(trainer.cfg.model.message_dropout == DROPOUT_P
              and steps == 2 and evals == 1,
              f"dropout ({mode}): {steps} steps, {evals} evaluations")
        check_records(recs, steps, evals)
        # no training GCL kernel: the lattice GCL runs in plain PyTorch
        check_launches({k: v for k, v in counts.items()
                        if k != "gcl_eval_k1"}, {}, steps)
        check(counts["gcl_eval_k1"] == 16 * evals,
              f"dropout ({mode}): {counts['gcl_eval_k1']} gcl_eval launches "
              f"at K = 1 in {evals} evaluations, expected 16 each")
        dropout[mode] = {"steps": steps, "launches": counts,
                         "seq_s": trainer.seq_per_sec(),
                         "losses": [r["loss/tot"] for r in recs
                                    if "loss/tot" in r],
                         "card_vs_cpu": check_dropout_gcl(16, 512, mode,
                                                          device)}
        del trainer
    print(f"message dropout p = {DROPOUT_P} on the card ({card}):",
          json.dumps(dropout))
    return dropout


# ------------------------------------------------- phase 8: the data plane
DATA_SONGS = 96       # seeded full-band 4/4 songs of 12-32 bars
DATA_SHARD = 128      # samples a shard, so that batches cross shards
DATA_TRAIN = 640      # training samples of the CLI runs: 2 steps an epoch
LOADER_REPS = 5       # timed batches of each gather
LOADER_FED_STEPS = 3  # loader-fed steps timed
PROFILED_STEPS = 2    # loader-fed steps profiled for their kernel time
# packed vs per-sample data: the first step's losses, relative (the same
# batch on the same card; a different batch moves them by about 1e-2)
SAME_BATCH_RTOL = 1e-6


def band_song(rng, n_bars, resolution=8):
    """A seeded full-band 4/4 song of `n_bars`: drums, a bass (program
    32-39), one or two guitars (0-31) and one or two strings tracks (40-95)
    with random onsets, chords, pitches and durations; a non-drum track
    leaves a bar silent with probability 0.1."""
    from polyphemus_tpu_torch.midi import Note, Song, Track

    bar = 4 * resolution

    def notes(lo, hi, per_bar, dur, silent_p):
        out = []
        for b in range(n_bars):
            if rng.random() < silent_p:
                continue
            steps = rng.choice(bar, size=int(rng.integers(1, per_bar + 1)),
                               replace=False)
            for t in np.sort(steps):
                for _ in range(int(rng.integers(1, 3))):
                    out.append(Note(int(b * bar + t),
                                    int(rng.integers(lo, hi)),
                                    int(rng.integers(1, dur + 1))))
        return out

    tracks = [Track("drums", 0, True, notes(35, 52, 8, 2, 0.0)),
              Track("bass", int(rng.integers(32, 40)), False,
                    notes(28, 52, 4, 8, 0.1))]
    tracks += [Track(f"guitar{g}", int(rng.integers(0, 32)), False,
                     notes(48, 77, 4, 8, 0.1))
               for g in range(int(rng.integers(1, 3)))]
    tracks += [Track(f"strings{k}", int(rng.integers(40, 96)), False,
                     notes(55, 85, 2, 24, 0.1))
               for k in range(int(rng.integers(1, 3)))]
    return Song(resolution=resolution, tempo=120, tracks=tracks)


def write_songs(midi_dir, n, seed, bars=(12, 32)):
    """`n` band songs of bars[0]..bars[1] bars as .mid files in `midi_dir`
    and one and two directories below it."""
    from polyphemus_tpu_torch.midi import write_midi

    shutil.rmtree(midi_dir, ignore_errors=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        sub = os.path.join(midi_dir, *["sub"] * (i % 3))
        os.makedirs(sub, exist_ok=True)
        write_midi(os.path.join(sub, f"song{i:03d}.mid"),
                   band_song(rng, int(rng.integers(bars[0], bars[1] + 1))))


def check_gather_epoch(fast, packed, batch, seed):
    """One shuffled epoch of the packed directory `packed` in batches of
    `batch` (the last one short): each batch of the native gather (`fast`,
    its `FastShardedBatcher`) equal to the plain gather's and, row by row,
    to `ShardedDataset`'s samples."""
    from polyphemus_tpu_torch.data.fastloader import gather_plain
    from polyphemus_tpu_torch.data.sharded import ShardedDataset

    plain = ShardedDataset(packed, cache_shards=len(fast.offsets))
    order = np.random.default_rng(seed).permutation(len(fast))
    batches = crossing = 0
    for i in range(0, len(order), batch):
        idxs = order[i:i + batch]
        toks, mask = fast.gather_batch(idxs)
        ptoks, pmask = gather_plain(fast.tok_views, fast.mask_views,
                                    fast.offsets, idxs)
        check(toks.dtype == np.int32 and mask.dtype == np.bool_
              and np.array_equal(toks, ptoks) and np.array_equal(mask, pmask),
              f"the native gather differs from the plain one in batch "
              f"{batches}")
        for k, j in enumerate(idxs):
            t, m = plain[int(j)]
            check(np.array_equal(toks[k], t) and np.array_equal(mask[k], m),
                  f"the native gather differs from ShardedDataset at "
                  f"sample {j}")
        batches += 1
        crossing += len(set(np.searchsorted(fast.offsets, idxs,
                                            side="right"))) > 1
    return {"samples": len(fast), "shards": len(fast.offsets),
            "batches": batches, "batches_over_several_shards": crossing}


def time_loaders(fast, samples_dir, n_bars, batch, seed):
    """ms per batch of `batch` samples on the host: the native gather of
    `fast` and the plain gather over its mmapped shards (LOADER_REPS
    random batches after a warm one), and the per-sample `BatchLoader` (8
    worker threads, prefetch 2) over the unpacked directory (one shuffled
    epoch of whole batches, its first included; all warm in the page
    cache)."""
    from polyphemus_tpu_torch.data import BatchLoader, PolyphemusDataset
    from polyphemus_tpu_torch.data.fastloader import gather_plain

    rng = np.random.default_rng(seed)
    batches = [rng.choice(len(fast), batch, replace=False)
               for _ in range(LOADER_REPS)]

    def per_batch_ms(fn):
        fn(batches[0])
        t0 = time.perf_counter()
        for b in batches:
            fn(b)
        return (time.perf_counter() - t0) / LOADER_REPS * 1e3

    native = per_batch_ms(fast.gather_batch)
    plain = per_batch_ms(lambda b: gather_plain(
        fast.tok_views, fast.mask_views, fast.offsets, b))
    loader = BatchLoader(PolyphemusDataset(samples_dir, n_bars), batch,
                         seed=seed, num_workers=8)
    t0 = time.perf_counter()
    n = sum(1 for _ in loader)
    per_sample = (time.perf_counter() - t0) / n * 1e3
    # bytes a batch moves: int16 tokens and the mask read, int32 tokens and
    # the mask written
    tok, msk = fast._tok_elems * batch, fast._mask_bytes * batch
    moved = 2 * tok + 4 * tok + 2 * msk
    return {"batch": batch, "native_ms": native, "plain_ms": plain,
            "per_sample_ms": per_sample, "per_sample_batches": n,
            "bytes_per_batch": moved,
            "native_gb_s": moved / native / 1e6}


def loader_fed_steps(trainer, dataset, batch, seed, resident=False):
    """Optimizer steps of `trainer` fed by the CLI's loader (`BatchLoader`,
    8 workers, pinned copies to the card) over `dataset`, after one warm
    step: seconds per step on the host clock over LOADER_FED_STEPS steps;
    with `resident`, as many steps on one batch kept on the card (no
    loader), the control; then the kernel time per step (device busy) over
    PROFILED_STEPS fed steps under torch.profiler (device activity only)
    and the idle share of the unprofiled fed step that it leaves."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from polyphemus_tpu_torch.data import BatchLoader

    loader = BatchLoader(dataset, batch, seed=seed, num_workers=8,
                         device_put_fn=trainer.to_device)

    def epochs():
        while True:
            yield from loader

    feed = epochs()
    gen = torch.Generator(device=trainer.device).manual_seed(seed)

    def steps_s(next_batch, n=LOADER_FED_STEPS):
        t0 = time.perf_counter()
        for _ in range(n):
            losses, _ = trainer.train_step(*next_batch(), generator=gen)
            float(losses["tot"])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n

    kept = next(feed)
    trainer.train_step(*kept, generator=gen)
    out = {"steps": LOADER_FED_STEPS, "step_s": steps_s(lambda: next(feed))}
    if resident:
        out["resident_step_s"] = steps_s(lambda: kept)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out["profiled_step_s"] = steps_s(lambda: next(feed), PROFILED_STEPS)
    feed.close()  # stops the loader's thread
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / PROFILED_STEPS
    check(busy > 0, "the profiler saw no kernel of the loader-fed steps")
    out.update(kernel_ms_per_step=busy,
               idle_share=1.0 - busy / (out["step_s"] * 1e3))
    return out


def data_plane_phase(device, card, config_path):
    """Phase 8: MIDI files -> `cli.preprocess` (4 worker processes) ->
    `cli.pack_dataset` (shards of DATA_SHARD) -> 4 flagship fp32 steps of
    `cli.train` from the packed directory, then from the per-sample one; the
    native gather over one epoch against the plain gather and
    `ShardedDataset`; the loaders' ms per batch; s/step and idle share from
    each directory. Returns (what the results print, the training kernels'
    launches)."""
    from polyphemus_tpu_torch.cli import pack_dataset as pack_cli
    from polyphemus_tpu_torch.cli import preprocess as pre_cli
    from polyphemus_tpu_torch.config import load_train_config
    from polyphemus_tpu_torch.data import PolyphemusDataset, fastloader

    # ---- 8. the data plane: preprocess, pack, train from shards ----
    check(shutil.which("g++") is not None,
          "g++ is not on PATH: the native batch gather cannot be built")
    cfg = load_train_config(config_path)
    base = os.path.join(ROOT, "build", "chip_smoke_data_plane")
    midi_dir, samples, packed = (os.path.join(base, d) for d in
                                 ("midi", "samples", "packed"))
    shutil.rmtree(base, ignore_errors=True)
    stages, clock = {}, [time.perf_counter()]

    def lap(stage):  # seconds since the last lap, by stage
        stages[stage], clock[0] = time.perf_counter() - clock[0], \
            time.perf_counter()

    write_songs(midi_dir, DATA_SONGS, SEED)
    lap("write_songs")
    pre_cli.main([midi_dir, samples, "--n_bars", str(cfg.model.n_bars),
                  "--resolution", str(cfg.model.resolution),
                  "--n_workers", "4"])
    lap("preprocess")
    pack_cli.main([samples, packed, "--n_bars", str(cfg.model.n_bars),
                   "--shard_size", str(DATA_SHARD)])
    lap("pack")
    n = len(os.listdir(samples))
    check(n >= 3 * cfg.batch_size, f"{DATA_SONGS} songs gave {n} samples, "
                                   f"fewer than {3 * cfg.batch_size}")
    fast = fastloader.FastShardedBatcher(packed)  # 4 threads, as the CLI's
    epoch = check_gather_epoch(fast, packed, cfg.batch_size, SEED)
    check(epoch["samples"] == n and epoch["shards"] == -(-n // DATA_SHARD),
          f"packed {epoch} from {n} samples")
    lap("epoch_check")
    loaders = time_loaders(fast, samples, cfg.model.n_bars, cfg.batch_size,
                           SEED)
    lap("time_loaders")
    # DATA_TRAIN of the n samples: 2 steps an epoch, 2 epochs
    splits = ("--tr_split", repr((DATA_TRAIN + 0.5) / n))
    runs, counts = {}, {}
    for name, data in (("packed", packed), ("per_sample", samples)):
        fastloader.gathers = 0
        # ---- the main path ----
        trainer, _, counts[name], recs = train_phase(
            device, config_path, data,
            os.path.join(ROOT, "build", f"chip_smoke_train_{name}"), 2,
            splits=splits, name=name)
        gathers = fastloader.gathers
        lap(f"cli_train_{name}")
        steps = trainer.step
        check(steps == 4, f"{steps} optimizer steps from the {name} data")
        check_records(recs, steps)
        check_launches(counts[name], {"gcl_fwd": 64, "gcl_bwd_data": 64,
                                      "gcl_bwd_weight": 64}, steps)
        check(gathers == (steps if name == "packed" else 0),
              f"{gathers} native gathers in {steps} steps from the {name} "
              f"data")
        dataset = (fast if name == "packed"
                   else PolyphemusDataset(samples, cfg.model.n_bars))
        runs[name] = {"steps": steps, "native_gathers": gathers,
                      "cli_step_s": statistics.median(trainer._timer.times),
                      "cli_step_intervals_s": trainer._timer.times,
                      "first_losses": {k: recs[0][f"loss/{k}"]
                                       for k in LOSS_KEYS},
                      "losses": [r["loss/tot"] for r in recs],
                      "loader_fed": loader_fed_steps(
                          trainer, dataset, cfg.batch_size, SEED,
                          resident=name == "packed")}
        lap(f"loader_fed_{name}")
        del trainer
    # the same samples in the same order: the same first step
    first = [runs[k]["first_losses"] for k in ("packed", "per_sample")]
    for k in LOSS_KEYS:
        check(abs(first[0][k] - first[1][k]) <= SAME_BATCH_RTOL * abs(
            first[1][k]), f"the first step's {k} loss from the packed data, "
                          f"{first[0][k]}, is not the per-sample data's, "
                          f"{first[1][k]}")
    out = {"songs": DATA_SONGS, "samples": n, "epoch_check": epoch,
           "stages_s": stages, "loaders": loaders, "train": runs,
           "card": card}
    print(f"data plane (d={cfg.model.d}, batch {cfg.batch_size}, {card}):",
          json.dumps(out))
    launches = {k: counts["packed"][k] + counts["per_sample"][k]
                for k in ("gcl_fwd", "gcl_bwd_data", "gcl_bwd_weight")}
    return out, launches


# ---------------------------------------- phase 9: the remaining surface
RENDER_REPS = 3       # timed passes over each set of pieces
LOOPS = 4             # the looped pieces' n_loops, as the CLIs run it


def mfu_shares(rates) -> dict:
    """{path: MFU in percent} from {path: (seq/s, FLOP a sequence, bf16)}
    against the card's peaks (`flops.PEAK_FLOPS`); fails when a share is
    not in (0, 100]."""
    from polyphemus_tpu_torch import flops

    shares = {}
    for name, (seq_s, per_seq, bf16) in rates.items():
        shares[name] = flops.mfu(seq_s, per_seq, peak_tflops(bf16) * 1e12)
        check(0 < shares[name] <= 100,
              f"MFU of {name}: {shares[name]} % of the card's peak")
    return shares


def python_midi(tokens, mask, resolution, n_loops=1, gen_cfg=None) -> bytes:
    """The Python writer's bytes of one piece: `song_from_tokens` (+
    `loop_song`), `midi_bytes`."""
    from polyphemus_tpu_torch.generate import song_from_tokens
    from polyphemus_tpu_torch.midi import midi_bytes
    from polyphemus_tpu_torch.midi.song import loop_song

    song = song_from_tokens(tokens, mask, resolution, gen_cfg)
    if n_loops > 1:
        song = loop_song(song, n_loops, mask.shape[0], resolution)
    return midi_bytes(song)


def render_vs_python(native, python, n) -> dict:
    """native(i) against python(i) for i < n: byte-equal bytes, and each
    one's ms a sequence on the host clock (median of RENDER_REPS passes
    over the n pieces, the two in turns)."""
    from polyphemus_tpu_torch.midi import fast_render

    before = fast_render.renders
    for i in range(n):
        got, want = native(i), python(i)
        check(got == want, f"native MIDI of piece {i} differs from the "
                           f"Python writer's ({len(got)} vs {len(want)} "
                           f"bytes)")
    check(fast_render.renders == before + n,
          f"{fast_render.renders - before} native renders for {n} pieces")
    times = {"native": [], "python": []}
    for _ in range(RENDER_REPS):
        for name, fn in (("native", native), ("python", python)):
            t0 = time.perf_counter()
            for i in range(n):
                fn(i)
            times[name].append((time.perf_counter() - t0) / n * 1e3)
    return {"pieces": n, "bytes": sum(len(native(i)) for i in range(n)),
            "native_ms_per_seq": statistics.median(times["native"]),
            "python_ms_per_seq": statistics.median(times["python"]),
            "passes_ms_per_seq": times}


@contextlib.contextmanager
def captured_generation(seen: list):
    """`generate.make_generator`'s functions append each call's (mask,
    tokens), on the host, to `seen`: what a CLI rendered."""
    from polyphemus_tpu_torch import generate as G

    make = G.make_generator

    def recording(*args, **kw):
        fn = make(*args, **kw)

        def run(*inputs):
            out = fn(*inputs)
            seen.append((out[0].cpu().numpy(), out[1].cpu().numpy()))
            return out
        return run

    G.make_generator = recording
    try:
        yield
    finally:
        G.make_generator = make


def generate_cli_render(model_dir, device, out, mc) -> dict:
    """The generate CLI (`--n 2 --n_loops LOOPS`) on the card: 4 `gcl_eval`
    launches at K = 2 (above 48 steps 8 at K = 1) and 1 `chord_tail` a call
    (2 calls) at the model's grid, 4 native renders, and each `generated.mid` / `extended.mid`
    byte-equal to the Python writer's on the (mask, tokens) that the CLI's
    last call returned."""
    from polyphemus_tpu_torch.cli import generate as gen_cli
    from polyphemus_tpu_torch.config import GenerationConfig
    from polyphemus_tpu_torch.midi import fast_render
    from polyphemus_tpu_torch.ops.kernels import counts

    shutil.rmtree(out, ignore_errors=True)
    seen = []
    renders = fast_render.renders
    s = mc.n_timesteps
    counts.reset()
    # ---- the main path ----
    with captured_generation(seen):
        gen_cli.main([model_dir, out, "--n", "2", "--n_loops", str(LOOPS),
                      "--no_audio", "--seed", "2", "--device", str(device)])
    got = dict(counts.launches)
    want = summed(eval_calls("gcl_eval", s, 2, 8), {("chord_tail", s, 1): 2})
    check(got == want, f"generate CLI launches {named(got)}, expected "
                       f"{named(want)}")
    launches = (counts.total("gcl_eval", s), counts.total("chord_tail", s))
    check(fast_render.renders - renders == 4 and len(seen) == 2,
          f"generate CLI: {fast_render.renders - renders} native renders, "
          f"{len(seen)} generator calls")
    mask, tokens = seen[-1]
    gen_cfg = GenerationConfig()
    for i in range(2):
        for name, loops in (("generated", 1), ("extended", LOOPS)):
            with open(os.path.join(out, str(i), name + ".mid"), "rb") as f:
                got = f.read()
            check(got == python_midi(tokens[i], mask[i], mc.resolution,
                                     loops, gen_cfg),
                  f"the generate CLI's {i}/{name}.mid differs from the "
                  f"Python writer's bytes")
    return {"files": 4, "bytes": int(sum(
        os.path.getsize(os.path.join(out, str(i), n + ".mid"))
        for i in range(2) for n in ("generated", "extended"))),
        "gcl_eval": launches[0], "chord_tail": launches[1]}


def mtp_on_card(model_dir, device) -> dict:
    """`generate.mtp_from_logits` on the card on one n = 8 batch's c_logits
    against the same call on the CPU: equal exactly, in the logits' dtype,
    on their device."""
    import torch

    from polyphemus_tpu_torch.generate import (load_model, make_generator,
                                               mtp_from_logits)
    from polyphemus_tpu_torch.serve import host_z

    model, cfg = load_model(model_dir, device)
    mask, _, _, c_logits = make_generator(model, return_logits=True,
                                          device=device)(
        host_z(8, 8, cfg.model.d))
    got = mtp_from_logits(c_logits, mask)
    want = mtp_from_logits(c_logits.cpu(), mask.cpu())
    check(got.device == c_logits.device and got.dtype == c_logits.dtype,
          f"mtp_from_logits gave {got.dtype} on {got.device}")
    check(torch.equal(got.cpu(), want),
          "mtp_from_logits on the card differs from the CPU's")
    return {"shape": list(got.shape), "dtype": str(got.dtype),
            "inactive_cells": int((~mask).sum())}


def surface_phase(device, card, model_dir, mc, n8, l16, rates) -> dict:
    """Phase 9: the MFU of every path that chip_smoke times (no new timed
    loop), the native MIDI render against the Python writer (phase 3's
    served n = 8 through `GenerationService.render_midi`, 7b's n = 8 LMD16
    pieces looped LOOPS times, the generate CLI's files), and
    `mtp_from_logits` on the card. Plotting and `cli.stats` are not run:
    they need matplotlib, which the card's machine lacks (the CPU tests
    hold them to the JAX package's). Returns the CLI's launches."""
    from polyphemus_tpu_torch.data import synthetic_batch
    from polyphemus_tpu_torch.midi.fast_render import render_midi_bytes
    from polyphemus_tpu_torch.serve import GenerationService

    # ---- 9. the remaining surface ----
    print(json.dumps({"mfu_percent": mfu_shares(rates), "card": card}))

    svc = GenerationService(model_dir, batch_cap=8, tiers=[8],
                            coalesce=False, device=device)
    renders = {}
    # phase 3's random-init pieces are nearly empty (one active cell a bar
    # after `ensure_nonempty_bars`): the render is timed again on 8 pieces
    # served on a given structure at the synthetic data's density (0.15)
    given = synthetic_batch(np.random.default_rng(SEED + 9), 1,
                            mc.n_bars)[1][0]
    for name, (mask, tokens) in (
            ("served_lmd2", n8),
            ("served_lmd2_given_structure", svc.generate(8, seed=8,
                                                         structure=given))):
        renders[name] = dict(render_vs_python(
            lambda i: svc.render_midi(mask[i], tokens[i]),
            lambda i: python_midi(tokens[i], mask[i], mc.resolution),
            len(mask)), active_cells=int(mask.sum()))
    del svc
    mask16, tokens16 = l16["pieces"]
    res16 = l16["mc"].resolution
    renders[f"lmd16_n_loops_{LOOPS}"] = dict(render_vs_python(
        lambda i: render_midi_bytes(tokens16[i], mask16[i], res16,
                                    n_loops=LOOPS),
        lambda i: python_midi(tokens16[i], mask16[i], res16, LOOPS),
        len(mask16)), active_cells=int(mask16.sum()))
    print(f"native MIDI render against the Python writer, ms a sequence on "
          f"the card's host ({card}):", json.dumps(renders))
    cli = generate_cli_render(model_dir, device, os.path.join(
        ROOT, "build", "chip_smoke_cli_render"), mc)
    mtp = mtp_on_card(model_dir, device)
    print("generate CLI files against the Python writer, mtp_from_logits "
          "card vs CPU:", json.dumps({"generate_cli": cli,
                                      "mtp_from_logits": mtp}))
    return cli


# ------------------------------------- phase 10: data parallelism, torchrun
DDP_STEPS = 5            # W = 1 NCCL steps of the train CLI, and of the
#                          non-distributed run it is held to
DDP_LOSS_RTOL = 1e-6     # W = 1 NCCL vs non-distributed: the first step's
DDP_SPREAD = 10.0        # later steps: this x the spread of two runs
#                          without a group (a share of it, not a tolerance)
TWO_RANK_STEPS = {False: 2, True: 2}        # 2 gloo ranks, fp32 and bf16
TWO_RANK_BATCH = 64      # the global batch of the gloo runs at resolution 8
TWO_RANK_LOSS_RTOL = {False: 1e-4, True: BF16_LOSS_RTOL}
CHILD_TIMEOUT = 300      # seconds, one torchrun or CLI process
LAUNCHES_LINE = re.compile(r"^Kernel launches \(rank (\d+)\): (\{.*\})$",
                           re.M)
TWO_RANK_LINE = re.compile(r"^TWO_RANK_RESULT (\{.*\})$", re.M)


def torchrun(nproc, *args) -> list:
    """`torchrun --standalone` (a free port on localhost) of `args`."""
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", str(nproc), *map(str, args)]


def run_child(cmd, what) -> str:
    """Run `cmd` from the checkout; fail unless it exits 0. Returns its
    standard output."""
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=CHILD_TIMEOUT)
    check(out.returncode == 0, f"{what} exited {out.returncode}:\n"
                               f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    return out.stdout


def rank_launches(stdout, nproc) -> list:
    """Each rank's kernel launches, as the train CLI (or a two-rank child)
    prints them at its end."""
    found = {int(r): json.loads(c) for r, c in LAUNCHES_LINE.findall(stdout)}
    check(sorted(found) == list(range(nproc)),
          f"kernel launches of ranks {sorted(found)}, not of {nproc}")
    return [found[r] for r in range(nproc)]


def cli_records(model_dir):
    with open(os.path.join(model_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def nccl_cli_run(card, config_path, data_dir, n_samples) -> tuple:
    """(i) The train CLI under `torchrun --nproc_per_node 1` (NCCL on the
    card) between two runs of it without a process group, DDP_STEPS steps
    each from `data_dir` on the same seed. The first step's losses (the
    same work on the same weights) within DDP_LOSS_RTOL of the first run's;
    the largest relative loss error over the steps within DDP_SPREAD x the
    second run's (or DDP_LOSS_RTOL): the card's backward is not bitwise
    repeatable (the embedding, gather and convolution grads accumulate in
    no fixed order), and Adam, at the peak LR of the warmup, turns that
    rounding into steps of lr on grads whose true value is 0, so that two
    runs without a group part by about 10x a step from the second step on
    (up to 1e-4 at the fifth). 64 launches of each fp32 training kernel a
    step on the rank, and each run's s/step (the mean of the step
    intervals after the first, `seq_s` of its last record). Returns (what
    it prints, the rank's launches)."""
    from polyphemus_tpu_torch.config import load_train_config

    cfg = load_train_config(config_path)
    out_dir = os.path.join(ROOT, "build", "chip_smoke_ddp")
    shutil.rmtree(out_dir, ignore_errors=True)
    args = [data_dir, out_dir, config_path, "--tr_split",
            repr((DDP_STEPS * cfg.batch_size + 0.5) / n_samples),
            "--max_epochs", "1", "--save_every", "0", "--num_workers", "8",
            "--seed", str(SEED)]
    module = ["-m", "polyphemus_tpu_torch.cli.train"]
    process_s, stdout = {}, None
    for name in ("plain", "nccl", "plain_again"):
        t0 = time.perf_counter()
        if name == "nccl":
            # ---- the main path ----
            stdout = run_child(
                torchrun(1, *module, *args, "--model_name", name),
                "the train CLI under torchrun (NCCL)")
        else:
            run_child([sys.executable, *module, *args, "--model_name", name],
                      "the train CLI")
        process_s[name] = time.perf_counter() - t0
    check("Devices: 1 mesh={'data': 1, 'model': 1}" in stdout,
          "the torchrun run did not report one process of data parallelism")
    launches = rank_launches(stdout, 1)[0]
    recs = {name: cli_records(os.path.join(out_dir, name))
            for name in process_s}
    for r in recs.values():
        check_records(r, DDP_STEPS)

    def rel_errs(name):  # each step's largest relative loss error
        return [max(abs(a[f"loss/{k}"] - b[f"loss/{k}"])
                    / max(abs(b[f"loss/{k}"]), 1e-12) for k in LOSS_KEYS)
                for a, b in zip(recs[name], recs["plain"])]

    errs = {name: rel_errs(name) for name in ("nccl", "plain_again")}
    limit = max(DDP_LOSS_RTOL, DDP_SPREAD * max(errs["plain_again"]))
    check(all(e[0] <= DDP_LOSS_RTOL for e in errs.values())
          and max(errs["nccl"]) <= limit,
          f"the losses' relative errors by step from the first run without "
          f"a process group: {errs} (limits: {DDP_LOSS_RTOL} at the first "
          f"step, {limit} over all)")
    check_launches({k: launches[k] for k in TRAIN_KERNELS},
                   {"gcl_fwd": 64, "gcl_bwd_data": 64,
                    "gcl_bwd_weight": 64}, DDP_STEPS)
    step_s = {name: cfg.batch_size / r[-1]["seq_s"]
              for name, r in recs.items()}
    return {"steps": DDP_STEPS, "loss_rel_err_by_step": errs,
            "loss_rel_err_limit": limit,
            "s_per_step": step_s,
            "nccl_over_plain": 2 * step_s["nccl"] / (
                step_s["plain"] + step_s["plain_again"]),
            "process_s": process_s,
            "losses": {name: [x["loss/tot"] for x in r]
                       for name, r in recs.items()},
            "launches_rank0": launches, "card": card}, launches


def nccl_step_overhead(device, card, config_path, steps=2) -> dict:
    """s/step of the flagship fp32 `TrainStep` in this process on one
    batch kept on the card, without a process group and in a one-rank NCCL
    group (the environment set here as `torchrun` sets it, then restored),
    in turns: none, NCCL, NCCL, none; `steps` steps a pass after a warm
    one. What the collectives add to a step, without the loader and the
    host's spread between processes."""
    import socket

    import torch

    from polyphemus_tpu_torch.config import load_train_config
    from polyphemus_tpu_torch.data import synthetic_batch
    from polyphemus_tpu_torch.models import VAE
    from polyphemus_tpu_torch.parallel import mesh as pmesh
    from polyphemus_tpu_torch.train import trainer as tr

    cfg = load_train_config(config_path)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        model = VAE(cfg.model).to(device)
    rng = np.random.default_rng(SEED)
    toks, mask = (torch.from_numpy(a).to(device) for a in synthetic_batch(
        rng, cfg.batch_size, cfg.model.n_bars))
    step = tr.make_train_step(model, cfg, tr.make_optimizer(model, cfg))

    def timed():
        step(toks, mask)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step(toks, mask)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / steps

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    group_env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                 "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}
    saved = {k: os.environ.get(k) for k in group_env}
    passes = {"none": [], "nccl": []}
    try:
        passes["none"].append(timed())
        os.environ.update(group_env)
        check(pmesh.maybe_initialize_distributed() is not None,
              "no one-rank NCCL group came up")
        passes["nccl"] += [timed(), timed()]
        pmesh.destroy()
        passes["none"].append(timed())
    finally:
        pmesh.destroy()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    mean = {k: statistics.mean(v) for k, v in passes.items()}
    return {"steps_a_pass": steps, "s_per_step": passes,
            "nccl_over_none": mean["nccl"] / mean["none"], "card": card}


def two_rank_batches(mc, batch, steps):
    """The global batches and eps of the two-rank phase at mc's grid, from
    SEED."""
    import torch

    from polyphemus_tpu_torch.data import synthetic_batch

    rng = np.random.default_rng(SEED + 10)
    out = []
    for _ in range(steps):
        toks, mask = synthetic_batch(rng, batch, mc.n_bars,
                                     n_timesteps=mc.n_timesteps)
        eps = rng.standard_normal((batch, mc.d)).astype(np.float32)
        out.append(tuple(torch.from_numpy(a) for a in (toks, mask, eps)))
    return out


@contextlib.contextmanager
def timed_collectives():
    """Every `torch.distributed` all-reduce, all-gather and broadcast inside,
    timed on the host clock from the call to its return: {op: {"calls",
    "s", "bytes"}}, bytes of this rank's tensor. On gloo with CUDA tensors
    a call returns once its copies through the host are done, so its
    seconds are the ones the rank spends blocked in it: the card's
    pending work before the copy out, the wait for the other ranks, the
    transfer."""
    import torch.distributed as dist

    stats = {}
    saved = {name: getattr(dist, name)
             for name in ("all_reduce", "all_gather", "broadcast")}

    def wrap(name, fn):
        def timed(*args, **kw):
            t = args[1] if name == "all_gather" else args[0]
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            st = stats.setdefault(name, {"calls": 0, "s": 0.0, "bytes": 0})
            st["calls"] += 1
            st["s"] += time.perf_counter() - t0
            st["bytes"] += t.numel() * t.element_size()
            return out
        return timed

    for name, fn in saved.items():
        setattr(dist, name, wrap(name, fn))
    try:
        yield stats
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def rank_child(spec_path) -> int:
    """One rank of the gloo runs of phases 10 and 10b, under `torchrun
    --nproc_per_node W`: gloo on the one card, then each run of the spec's
    `runs` in turn (one launch of W processes serves them all), its model,
    config (at its model axis M) and global batches stepped through the
    `Trainer` (which lays out the mesh, keeps the rank's shards and makes
    Adam over them) on the rows of the rank's data index
    (`data.shard_rows`). At M > 1 an eval step on the first batch comes
    first. Rank 0 writes the grads after the first step, gathered whole. At
    M = 1 every rank then times one more gradient all-reduce; at M > 1 its
    last step times every collective (`timed_collectives`), and it saves
    the checkpoint (rank 0 writes the one-process layout). Every rank
    prints, a run at a time, its losses, s/step, those times and the run's
    kernel launches (the counts set to 0 before each run)."""
    import dataclasses

    import torch

    sys.path.insert(0, ROOT)
    from polyphemus_tpu_torch.config import ParallelConfig, load_train_config
    from polyphemus_tpu_torch.convert import save_config
    from polyphemus_tpu_torch.data import shard_rows
    from polyphemus_tpu_torch.models import VAE
    from polyphemus_tpu_torch.ops import kernels
    from polyphemus_tpu_torch.ops.kernels import counts, gcl
    from polyphemus_tpu_torch.parallel import mesh as pmesh
    from polyphemus_tpu_torch.train import trainer as tr

    with open(spec_path) as f:
        spec = json.load(f)
    device = pmesh.maybe_initialize_distributed("cuda:0", backend="gloo")
    check(device is not None and pmesh.world() == spec["nproc"],
          f"the rank child did not join a group of {spec['nproc']}")
    try:
        r = pmesh.rank()
        for run_index, run in enumerate(spec["runs"]):
            counts.reset()
            gcl.col_launches.update(dict.fromkeys(gcl.col_launches, 0))
            cfg = load_train_config(run["config"])
            cfg = dataclasses.replace(cfg, parallel=ParallelConfig(
                model_axis=run["model_axis"]))
            model = VAE(cfg.model)
            model.load_state_dict(torch.load(run["state"], weights_only=True))
            # ---- the main path ----
            trainer = tr.Trainer(run["model_dir"], model, cfg, device=device)
            rows = torch.from_numpy(shard_rows(
                cfg.batch_size, cfg.iters_to_accumulate, pmesh.data_index(),
                pmesh.data_size()))
            losses, times = [], []
            batches = [tuple(t[rows].to(device) for t in b) for b in
                       two_rank_batches(cfg.model, cfg.batch_size,
                                        run["steps"])]
            res = {"rank": r, "run": run_index, "mesh": trainer.layout}
            if run["model_axis"] > 1:  # the column-form eval stack
                ev, _ = tr.eval_step(trainer.model, cfg, *batches[0][:2],
                                     trainer.step, eps=batches[0][2])
                res["eval_losses"] = {k: float(v) for k, v in ev.items()}
            coll = {}
            for i, (toks, mask, eps) in enumerate(batches):
                last = i == len(batches) - 1 and run["model_axis"] > 1
                torch.cuda.synchronize()
                with (timed_collectives() if last
                      else contextlib.nullcontext({})) as coll:
                    t0 = time.perf_counter()
                    lo, _ = trainer.train_step(toks, mask, eps=eps)
                    lo = {k: float(v) for k, v in lo.items()}
                    times.append(time.perf_counter() - t0)
                losses.append(lo)
                if i == 0:
                    grads = pmesh.full_state_dict(
                        {n: p.grad.detach() for n, p in
                         trainer.model.named_parameters()})
                    if r == 0:
                        torch.save({n: g.cpu() for n, g in grads.items()},
                                   run["grads"])
            res.update(losses=losses, step_s=times)
            torch.cuda.synchronize()
            if run["model_axis"] == 1:
                t0 = time.perf_counter()
                pmesh.all_reduce_grads(trainer.model.parameters())
                torch.cuda.synchronize()
                res["grad_all_reduce_s"] = time.perf_counter() - t0
            else:
                res["collectives"] = coll
                if r == 0:
                    save_config(run["model_dir"], cfg)
                trainer.save("checkpoint")
            res["launches"] = kernels.launch_counts()
            # one write a line: torchrun's ranks write unbuffered to one pipe
            sys.stdout.write("TWO_RANK_RESULT " + json.dumps(res) + "\n")
            del trainer, model, grads, batches
            torch.cuda.empty_cache()
    finally:
        pmesh.destroy()
    return 0


def ranks_phase(device, card, bf16, nproc=2, model_axis=1, steps=None,
                one=None, resolution=8, batch=None) -> tuple:
    """`nproc` gloo ranks on the one card (NCCL refuses two ranks on one
    GPU) at model axis `model_axis`, the flagship config at its global
    batch of 256 (or `batch`, its accumulation kept) and at `resolution`
    (`grid_config`), `steps` steps (TWO_RANK_STEPS[bf16] by default), against
    one process on the same weights, batches and eps (`one`, a previous
    call's one-process results, when given): every step's losses within
    TWO_RANK_LOSS_RTOL[bf16]. In fp32, without `one`, also the grads after
    step 1 held to an fp64 step's on the same weights and batch by phase
    7's rule (`hold_against_witness`): at this batch fp32 leaves one
    process's grads up to 4 % of their max from the fp64 grads on an H100
    (the encoder's `linear_merge`), so they are no yardstick at 1e-3; the
    largest distance between the ranks' and one process's grads is
    reported. Each rank's training kernels launched as in phases 5 and 6
    (above 48 steps a bar as in phase 13: bf16 through the split backward),
    at the bars' grid, and no other training launch; at M > 1 every launch
    in the column form, also an eval step's 16 eval GCL launches on the
    first batch before the steps, whose losses are one process's within
    the same tolerance; the ranks' checkpoint then loads as one process's
    and serves. The bf16 weights have `bn_linear_merge`'s input centred on the
    first batch (`centre_merge_input`), as phase 6's card-vs-CPU step.
    Returns (what it prints, the ranks' launches summed, the one-process
    results). `ranks_phases` runs several such runs of as many ranks in one
    launch of the ranks."""
    return ranks_phases(device, card, [dict(
        bf16=bf16, nproc=nproc, model_axis=model_axis, steps=steps, one=one,
        resolution=resolution, batch=batch)])[0]


def ranks_phases(device, card, runs) -> list:
    """`ranks_phase` for each of `runs` (its keyword arguments, each with
    the same `nproc`), the ranks launched once for all of them (a launch
    of W processes costs tens of seconds before its first step). Returns
    `ranks_phase`'s result for each run; `process_s` is the launch's."""
    import torch

    nproc = runs[0]["nproc"]
    check(all(r["nproc"] == nproc for r in runs),
          f"one launch of ranks takes runs of one size, got "
          f"{[r['nproc'] for r in runs]}")
    preps = [prepare_ranks(device, **r) for r in runs]
    spec_path = os.path.join(ROOT, "build", f"chip_smoke_ranks_{nproc}.json")
    with open(spec_path, "w") as f:
        json.dump({"nproc": nproc, "runs": [p["spec"] for p in preps]}, f)
    what = (f"{nproc} ranks on gloo ({len(preps)} runs: "
            f"{'; '.join(p['what'] for p in preps)})")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    # ---- the main path ----
    stdout = run_child(torchrun(nproc, os.path.join(ROOT, "chip_smoke.py"),
                                "rank_child", spec_path), what)
    child_s = time.perf_counter() - t0
    found = [json.loads(x) for x in TWO_RANK_LINE.findall(stdout)]
    return [check_ranks(device, card, p, sorted(
        (x for x in found if x["run"] == i), key=lambda x: x["rank"]),
        child_s) for i, p in enumerate(preps)]


def prepare_ranks(device, bf16, nproc=2, model_axis=1, steps=None, one=None,
                  resolution=8, batch=None) -> dict:
    """What one run of `ranks_phase` takes before its ranks start: the
    config at `resolution` and `batch`, the seeded model (its bf16 merge
    input centred), the global batches, the fp64 witness's grads (fp32,
    without `one`), and the run's spec for `rank_child` (the weights saved
    under build/)."""
    import torch

    from polyphemus_tpu_torch.config import load_train_config
    from polyphemus_tpu_torch.models import VAE

    name = "training_lmd2_bf16.json" if bf16 else "training_lmd2.json"
    config_path = (os.path.join(ROOT, "examples", name)
                   if resolution == 8 and batch is None
                   else grid_config(resolution, bf16, batch))
    cfg = load_train_config(config_path)
    steps = steps or TWO_RANK_STEPS[bf16]
    work = os.path.join(ROOT, "build", f"chip_smoke_ranks_{nproc}_"
                                       f"{model_axis}_r{resolution}_"
                                       f"{'bf16' if bf16 else 'fp32'}")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED + 10)
        model = VAE(cfg.model).to(device)
    batches = two_rank_batches(cfg.model, cfg.batch_size, steps)
    g64 = None
    if bf16:
        centre_merge_input(model, cfg.model,
                           *(t.to(device) for t in batches[0]))
    elif one is None:
        g64 = witness_fp64_grads(model, cfg, *batches[0], device)
    spec = {"config": config_path, "steps": steps, "model_axis": model_axis,
            "state": os.path.join(work, "state.pt"),
            "grads": os.path.join(work, "grads.pt"),
            "model_dir": os.path.join(work, "model")}
    torch.save(model.state_dict(), spec["state"])
    what = (f"{nproc} ranks at model axis {model_axis} "
            f"({'bf16' if bf16 else 'fp32'}, resolution {resolution}, batch "
            f"{cfg.batch_size})")
    return {"bf16": bf16, "nproc": nproc, "model_axis": model_axis,
            "steps": steps, "one": one, "resolution": resolution, "cfg": cfg,
            "work": work, "model": model, "batches": batches, "g64": g64,
            "spec": spec, "what": what}


def check_ranks(device, card, p, results, child_s) -> tuple:
    """The checks of `ranks_phase` on one run's results from its ranks
    (`prepare_ranks`' `p`), sorted by rank; `child_s` the launch's
    seconds."""
    import torch

    from polyphemus_tpu_torch.train import trainer as tr

    bf16, nproc, model_axis = p["bf16"], p["nproc"], p["model_axis"]
    steps, one, cfg, what = p["steps"], p["one"], p["cfg"], p["what"]
    model, batches, g64, spec = p["model"], p["batches"], p["g64"], p["spec"]
    check([x["rank"] for x in results] == list(range(nproc)),
          f"{what}: results from ranks {[x['rank'] for x in results]}")
    check(all(x["losses"] == results[0]["losses"] for x in results),
          f"{what}: the ranks report different global losses")
    check(results[0]["mesh"] == {"data": nproc // model_axis,
                                 "model": model_axis},
          f"{what}: mesh {results[0]['mesh']}")
    launches = [x["launches"] for x in results]
    s = 4 * p["resolution"]

    def at_grid(k):  # `kernels.launch_counts`' name at the bars' grid
        return k if s == 32 else f"{k}_s{s}"

    train_k = grid_train_kernels(bf16, s)
    per_step = {at_grid(k): n for k, n in train_k.items()}
    tp = model_axis > 1
    if tp:
        # every training launch in the column form
        col_names = {"gcl_bwd_fused": "gcl_bwd_fused_bf16_cols"}
        per_step.update({col_names.get(k, f"{k}_cols"): n
                         for k, n in train_k.items()})
        ev = "gcl_eval_bf16" if bf16 else "gcl_eval"
    for counts in launches:
        # every training kernel's count, at any grid and in the column form
        check_launches({k: n for k, n in counts.items()
                        if k.startswith(("gcl_fwd", "gcl_bwd"))}, per_step,
                       steps)
        if tp:  # one eval batch: 2 GNN stacks of 8 layers, one a launch
            check(counts.get(at_grid(ev), 0) == counts[f"{ev}_cols"] == 16,
                  f"{what}: eval launches {counts.get(at_grid(ev), 0)}, "
                  f"columns {counts[f'{ev}_cols']}, not 16")

    if one is None:
        # one process on the same weights, batches and eps
        trainer = tr.Trainer(os.path.join(p["work"], "one"), model, cfg,
                             device=device)
        ev_l, _ = tr.eval_step(trainer.model, cfg,
                               *(t.to(device) for t in batches[0][:2]),
                               trainer.step, eps=batches[0][2].to(device))
        one = {"losses": [], "step_s": [],
               "eval_losses": {k: float(v) for k, v in ev_l.items()}}
        for i, batch in enumerate(batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lo, _ = trainer.train_step(*(t.to(device) for t in batch[:2]),
                                       eps=batch[2].to(device))
            one["losses"].append({k: float(v) for k, v in lo.items()})
            one["step_s"].append(time.perf_counter() - t0)
            if i == 0:
                one["grads"] = {n: p.grad.detach().cpu()
                                for n, p in trainer.model.named_parameters()}
        del trainer

    def rel_err(got, want):
        return max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-12)
                   for k in LOSS_KEYS if want[k] != 0.0)

    rel = max(rel_err(a, b) for a, b in zip(results[0]["losses"],
                                            one["losses"]))
    check(rel <= TWO_RANK_LOSS_RTOL[bf16],
          f"{what}: losses {rel:.3e} (relative) from one process's")
    out = {"bf16": bf16, "nproc": nproc, "mesh": results[0]["mesh"],
           "resolution": p["resolution"], "batch": cfg.batch_size,
           "steps": steps, "max_loss_rel_err": rel,
           "losses_ranks": [x["tot"] for x in results[0]["losses"]],
           "losses_one_process": [x["tot"] for x in one["losses"]][:steps],
           "step_s_ranks": results[0]["step_s"],
           "step_s_one_process": one["step_s"][:steps],
           "process_s": child_s, "launches_per_rank": launches,
           "card": card}
    if tp:
        out["eval_loss_rel_err"] = rel_err(results[0]["eval_losses"],
                                           one["eval_losses"])
        check(out["eval_loss_rel_err"] <= TWO_RANK_LOSS_RTOL[bf16],
              f"{what}: eval losses {out['eval_loss_rel_err']:.3e} "
              f"(relative) from one process's")
        out["collectives_last_step"] = [x["collectives"] for x in results]
        out["collective_s"] = [sum(c["s"] for c in x["collectives"].values())
                               for x in results]
        ck = torch.load(os.path.join(spec["model_dir"], "checkpoint.pt"),
                        weights_only=True)
        whole = model.state_dict()
        check(ck["step"] == steps and all(
            tuple(v.shape) == tuple(whole[k].shape)
            for k, v in ck["model"].items()) and set(ck["model"]) == set(
            whole), f"{what}: the checkpoint is not one process's layout")
        serve_trained(spec["model_dir"], cfg.model, device)
    else:
        out["grad_all_reduce_s"] = [x["grad_all_reduce_s"] for x in results]
    if g64 is not None:
        ranks_g = torch.load(spec["grads"], weights_only=True)
        out.update(hold_against_witness(
            {"ranks": ranks_g, "one_process": one["grads"]}, g64, True,
            held_run="ranks"))
        scale = max(g.abs().max().item() for g in one["grads"].values())
        out["ranks_vs_one_max_grad_err_over_max"] = max(
            (ranks_g[n] - g).abs().max().item() / g.abs().max().item()
            for n, g in one["grads"].items()
            if g.abs().max().item() > GRAD_NOISE * scale)
    summed = {k: sum(c.get(k, 0) for c in launches) for k in set(per_step)
              | ({at_grid(ev), f"{ev}_cols"} if tp else set())}
    return out, summed, one


def ddp_phase(card, config_path, data_dir, n_samples) -> dict:
    """Phase 10: (i) the train CLI under torchrun at W = 1 on NCCL against
    the non-distributed CLI; (ii), (iii) two gloo ranks on the card against
    one process, fp32 and bf16 at batch TWO_RANK_BATCH, in one launch of
    the ranks. Returns the phase's launches (every rank of the torchrun
    runs)."""
    import torch

    # ---- 10. data parallelism: torchrun on the card ----
    device = torch.device("cuda")
    nccl, launches = nccl_cli_run(card, config_path, data_dir, n_samples)
    print(f"train CLI, torchrun W = 1 on NCCL against no process group "
          f"({card}):", json.dumps(nccl))
    launches = {k: launches[k] for k in ("gcl_fwd", "gcl_bwd_data",
                                         "gcl_bwd_weight")}
    overhead = nccl_step_overhead(device, card, config_path)
    print(f"fp32 TrainStep in one process, without a group and in a "
          f"one-rank NCCL group, in turns ({card}):", json.dumps(overhead))
    for res, summed, _ in ranks_phases(device, card, [
            dict(bf16=bf16, nproc=2, batch=TWO_RANK_BATCH)
            for bf16 in (False, True)]):
        print(f"two gloo ranks on one card against one process "
              f"({'bf16' if res['bf16'] else 'fp32'}, batch {res['batch']}, "
              f"{card}):", json.dumps(res))
        for k, n in summed.items():
            launches[k] = launches.get(k, 0) + n
    return launches


# column widths, bars and steps a bar of phase 10b's kernel checks: the
# fp32 kernels at the microbatch of a rank at D = 2 and D = 1 (64 and 128
# bars), the bf16 ones at D = 1 (256 bars), at 4 x 32 cells; above 48
# steps a bar (4 x 96 cells, resolution 24) the fp32 kernels at 128 bars and
# the bf16 ones at 256; n = d / 2 and d / 4
TP_KERNEL_CASES = [(False, 64, 32), (False, 128, 32), (True, 256, 32),
                   (False, 128, 96), (True, 256, 96)]
TP_WIDTHS = (256, 128)
# (v): two ranks at model axis 2 at LONG_MODEL's resolution, at a global
# batch of TP_LONG_BATCH[bf16] (the configs' accumulation kept: fp32
# microbatches of 16, bf16 of 16), TP_LONG_STEPS steps in each dtype. fp32
# takes 64: at 32 (microbatches of 8) one process's own fp32 grads miss the
# fp64 witness's cosine rule (1 - cosine 3.8e-5 against 1e-5 on an H100),
# at 64 they keep it (9.4e-6)
TP_LONG_BATCH = {False: 64, True: 32}
TP_LONG_STEPS = 2


def tp_phase(card) -> tuple:
    """Phase 10b, tensor parallelism on the one card: (i) the GCL kernels'
    column forms against their plain versions (`check_gcl_columns`) at
    TP_KERNEL_CASES x TP_WIDTHS, timed beside the square launch; (ii) two
    gloo ranks at model axis 2 (D = 1), fp32, 2 steps, against one process
    and the fp64 witness; (iii) the same in bf16, 2 steps; (v) two gloo
    ranks at model axis 2 at resolution LONG_MODEL (bars of 4 x 96 cells:
    the long-bar kernels' column forms), batch TP_LONG_BATCH[bf16],
    TP_LONG_STEPS steps, in fp32 (against one process and the fp64
    witness) and in bf16 (against one process); (ii), (iii) and (v) in one
    launch of the ranks; (iv) four gloo ranks at D = 2 x M = 2, fp32, 2
    steps, against (ii)'s one process (`ranks_phases`); (ii)-(iv) at batch
    TWO_RANK_BATCH. Returns (the kernel checks, the ranks' launches summed:
    (v)'s column-form launches as `<kernel>_cols_s96`)."""
    import torch

    # ---- 10b. tensor parallelism: column forms, then the mesh ----
    device = torch.device("cuda")
    cols = {}
    for bf16, nbar, s in TP_KERNEL_CASES:
        for n in TP_WIDTHS:
            cols[(bf16, nbar, n, s)] = check_gcl_columns(
                nbar, 512, n, device, bf16=bf16, s=s)
    print(f"GCL column forms against their plain versions (d=512, {card}):",
          json.dumps({f"{'bf16' if b else 'fp32'}_{nbar}_bars_n{n}_s{s}": r
                      for (b, nbar, n, s), r in cols.items()}))
    launches = {}
    s = 4 * LONG_MODEL
    runs = [dict(bf16=bf16, nproc=2, model_axis=2, batch=TWO_RANK_BATCH)
            for bf16 in (False, True)]
    runs += [dict(bf16=bf16, nproc=2, model_axis=2, steps=TP_LONG_STEPS,
                  resolution=LONG_MODEL, batch=TP_LONG_BATCH[bf16])
             for bf16 in (False, True)]
    t0 = time.perf_counter()
    done = ranks_phases(device, card, runs)
    done_s = time.perf_counter() - t0
    one = done[0][2]  # (ii)'s one process, (iv)'s yardstick
    done.append(ranks_phase(device, card, False, nproc=4, model_axis=2,
                            steps=2, one=one, batch=TWO_RANK_BATCH))
    for res, summed, _ in done:
        at = (f" at resolution {res['resolution']}"
              if res["resolution"] != 8 else "")
        print(f"{res['nproc']} gloo ranks at model axis 2{at} on one card "
              f"against one process ({'bf16' if res['bf16'] else 'fp32'}, "
              f"batch {res['batch']}, {card}):", json.dumps(res))
        for k, n in summed.items():
            if res["resolution"] != 8:
                # every launch of these ranks is a column-form launch at
                # S = 96: counted under `<kernel>_cols_s96` alone
                if k.endswith("_cols"):
                    k = f"{k}_s{s}"
                else:
                    continue
            launches[k] = launches.get(k, 0) + n
    print(f"phase 10b (ii), (iii), (v): {done_s:.1f} s in one launch of the "
          f"ranks")
    return cols, launches


# ---------------------------------------- phase 12: bar grids (resolutions)
GRID_CHECKS = (3, 4, 6, 12)   # resolutions whose kernels are held and timed
GRID_MODELS = (4, 12)         # resolutions generated end to end
GRID_KERNELS = ("gcl_eval", "gcl_eval_bf16", "chord_tail", "chord_tail_bf16")
GRID_MODEL = {"d": 512, "gnn_n_layers": 8, "n_bars": 2}  # LMD2's widths
GRID_BENCH_ROUNDS = 10        # calls a timed pass of phases 12 and 13's bench


def grid_kernels(device, card, resolutions=GRID_CHECKS, timed=None) -> dict:
    """Phase 12 (i): the four generation kernels at bars of 4 x 4r cells for
    r in `resolutions` (phase 13 (i): LONG_CHECKS), against their plain
    versions at 8 and 512 bars (batch 256), d = 512, by phase 2's rules
    (the GCL at K = 2, and at K = 1 as the reconstruct encoder runs it), the
    chord tail's near-tie cap over the ids of active cells
    (`active_ties`); the 512-bar launches of the resolutions in `timed`
    (all by default) timed beside their bounds. {r: {kernel: result}}."""
    res = {}
    for r in resolutions:
        s = 4 * r
        for nbar in (8, 512):
            got = {}
            timing = nbar > 8 and (timed is None or r in timed)
            for bf16 in (False, True):
                k = "_bf16" if bf16 else ""
                for layers in (2, 1):
                    got[f"gcl_eval{k}" + ("_k1" if layers == 1 else "")] = \
                        check_gcl(nbar, 512, layers, device,
                                  timing=timing, bf16=bf16, s=s)
                got[f"chord_tail{k}"] = check_chord(
                    nbar, 512, device, timing=timing, bf16=bf16, s=s,
                    active_ties=True)
            print(f"bar grid r={r} (4 x {s} cells), the generation kernels "
                  f"against their plain versions ({nbar} bars, d=512, K=2 "
                  f"and 1, {card}):", json.dumps(got))
        res[r] = got
    return res


def grid_generation(device, card, r, service=False, flip_cap=True) -> tuple:
    """Phase 12 (ii): a seeded model directory at resolution r (d = 512, 8
    layers, 2 bars); batch-256 generation in fp32 and bf16 by bench.py's
    protocol, each call launching 4 `gcl_eval` at K = 2 (above 48 steps 8 at
    K = 1) and 1 `chord_tail` of the 4 x 4r grid and nothing else, with MFU
    (`flops.py`); n = 8 on the
    card against the CPU by phase 3's rules (fp32) and phase 4b's (bf16).
    With `service`, (iii): one HTTP request through `GenerationService`
    whose natively rendered MIDI equals the Python writer's on the same
    request's tokens, the generate CLI (`generate_cli_render`) and the
    reconstruct CLI on 2 samples of the grid (`reconstruct_cli`).
    `flip_cap`: the bf16 comparison's (`compare_bf16_with_cpu`). The
    counts are set to 0 before each of those runs and read after it.
    Returns (results, the launches of all of it by `grid_name`)."""
    import base64

    import torch

    from polyphemus_tpu_torch import flops
    from polyphemus_tpu_torch.config import ModelConfig
    from polyphemus_tpu_torch.generate import load_model, make_generator
    from polyphemus_tpu_torch.midi import fast_render
    from polyphemus_tpu_torch.ops.kernels import counts
    from polyphemus_tpu_torch.serve import host_z, serve

    mc = ModelConfig(resolution=r, dropout=0.0, batch_norm=True,
                     **GRID_MODEL)
    s = mc.n_timesteps
    model_dir = os.path.join(ROOT, "build", f"chip_smoke_model_r{r}")
    make_model_dir(model_dir, mc, SEED + r)
    res = {"resolution": r, "cells_a_bar": 4 * s, "card": card}
    t0 = time.perf_counter()
    launches = {}

    def add(got):
        for key, n in got.items():
            launches[key] = launches.get(key, 0) + n

    for bf16 in (False, True):
        k = "_bf16" if bf16 else ""
        counts.reset()
        # ---- the main path ----
        b = bench(model_dir, device, rounds=GRID_BENCH_ROUNDS, bf16=bf16)
        got = dict(counts.launches)
        want = summed(eval_calls(f"gcl_eval{k}", s, 2, 4 * b["calls"]),
                      {(f"chord_tail{k}", s, 1): b["calls"]})
        check(got == want, f"r={r} {'bf16' if bf16 else 'fp32'} generation "
                           f"launched {named(got)}, expected {named(want)}")
        b["mfu_percent"] = 100.0 * flops.generation_flops_per_seq(mc) \
            * b["value"] / (peak_tflops(bf16) * 1e12)
        b["launches"] = named(got)
        res[f"bench{k}"] = b
        add(got)
    counts.reset()
    gmodel, _ = load_model(model_dir, device)
    m8, t8 = make_generator(gmodel, device=device)(host_z(8, 8, mc.d))
    del gmodel
    res["n8_vs_cpu"] = compare_with_cpu(
        model_dir, (m8.cpu().numpy(), t8.cpu().numpy()), device)
    res["n8_bf16_vs_cpu"] = compare_bf16_with_cpu(model_dir, device,
                                                  flip_cap=flip_cap)
    if service:
        httpd, svc = serve(model_dir, port=0, batch_cap=8, tiers=[8],
                           device=device)
        th = threading.Thread(target=httpd.serve_forever, daemon=True)
        th.start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            renders = fast_render.renders
            midi = post(url, {"n": 2, "seed": 5})
            native = fast_render.renders - renders
            toks = post(url, {"n": 2, "seed": 5, "format": "tokens"})
        finally:
            httpd.shutdown()
            httpd.server_close()
        check_tokens(toks["mask"], toks["tokens"], 2, mc)
        mask = np.asarray(toks["mask"], bool)
        tokens = np.asarray(toks["tokens"])
        got = [base64.b64decode(m) for m in midi["midi_b64"]]
        check(native == 2 and all(
            g == python_midi(tokens[i], mask[i], mc.resolution)
            for i, g in enumerate(got)),
            f"r={r} service: {native} native renders, MIDI against the "
            f"Python writer's bytes")
        res["service"] = {"requests": 2, "native_renders": native,
                          "midi_bytes": sum(map(len, got))}
    add(counts.launches)  # n = 8 and the service
    if service:
        res["generate_cli"] = generate_cli_render(
            model_dir, device, os.path.join(ROOT, "build",
                                            f"chip_smoke_cli_r{r}"), mc)
        add(counts.launches)
        samples_dir = os.path.join(ROOT, "build", f"chip_smoke_samples_r{r}")
        write_dataset(samples_dir, 2, mc.n_bars, SEED + 1, s)
        res["reconstruct_cli"] = reconstruct_cli(
            model_dir, device, os.path.join(ROOT, "build",
                                            f"chip_smoke_reconstruct_r{r}"),
            sorted(os.path.join(samples_dir, f)
                   for f in os.listdir(samples_dir)), s)
        add(counts.launches)
    launches = named(launches)
    if s > 48:  # the long-bar kernels: one layer a launch
        want = ("gcl_eval_k1", "gcl_eval_bf16_k1", "chord_tail",
                "chord_tail_bf16")
    else:
        want = GRID_KERNELS + (("gcl_eval_k1",) if service else ())
    check(set(launches) == {f"{n}_s{s}" for n in want},
          f"r={r}: launches {launches}")
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t0
    print(f"bar grid r={r} (4 x {s} cells) generation on the card, d=512, "
          f"8 layers ({card}):", json.dumps(res))
    return res, launches


# the training kernels of a bar grid, by dtype: per optimizer step of the
# LMD2 configs (16 GCL layers a microbatch, 4 microbatches in fp32, 2 in
# bf16); bf16 above 48 steps a bar runs the split backward
GRID_TRAIN_KERNELS = {False: {"gcl_fwd": 64, "gcl_bwd_data": 64,
                              "gcl_bwd_weight": 64},
                      True: {"gcl_fwd_bf16": 32, "gcl_bwd_fused": 32}}
LONG_BF16_TRAIN_KERNELS = {"gcl_fwd_bf16": 32, "gcl_bwd_data_bf16": 32,
                           "gcl_bwd_weight_bf16": 32}


def grid_train_kernels(bf16, s) -> dict:
    """The training kernels' launches per optimizer step of the LMD2
    configs (bf16 or not) over bars of 4 x s cells."""
    return LONG_BF16_TRAIN_KERNELS if bf16 and s > 48 \
        else GRID_TRAIN_KERNELS[bf16]
GRID_TRAIN_SAMPLES = 256   # one step a CLI epoch at batch 256


def grid_training_kernels(device, card) -> dict:
    """Phase 12 (iv): the training GCL kernels at bars of 4 x 4r cells for r
    in GRID_CHECKS, at the training microbatches' bars (fp32 128, bf16
    256), d = 512, against their plain versions by phases 2b's and 2c's
    rules and timed beside their bounds (`check_gcl_train`,
    `check_gcl_train_bf16`); and the column forms at n = 256 of d = 512, S
    = 16 (`check_gcl_columns`). {r: {kernel: result}, "cols_s16": ...}."""
    res = {}
    for r in GRID_CHECKS:
        s = 4 * r
        res[r] = dict(check_gcl_train(128, 512, device, s=s),
                      **check_gcl_train_bf16(256, 512, device, s=s))
        print(f"bar grid r={r} (4 x {s} cells), the training kernels against "
              f"their plain versions (fp32 128 bars, bf16 256, d=512, "
              f"{card}):", json.dumps(res[r]))
    res["cols_s16"] = {
        "fp32": check_gcl_columns(128, 512, 256, device, s=16),
        "bf16": check_gcl_columns(256, 512, 256, device, bf16=True, s=16)}
    print(f"bar grid r=4, the column forms at n=256 of d=512 ({card}):",
          json.dumps(res["cols_s16"]))
    return res


def grid_config(r, bf16, batch=None) -> str:
    """A copy of `examples/training_lmd2.json` (bf16: `_bf16.json`) at
    resolution r (and global batch `batch`, its accumulation kept), under
    build/; returns its path."""
    name = "training_lmd2_bf16.json" if bf16 else "training_lmd2.json"
    with open(os.path.join(ROOT, "examples", name)) as f:
        raw = json.load(f)
    raw["model"]["resolution"] = r
    if batch is not None:
        raw["batch_size"] = batch
        name = f"b{batch}_{name}"
    path = os.path.join(ROOT, "build", f"chip_smoke_r{r}_{name}")
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


def grid_training(device, card, r, bf16s=(False, True)) -> tuple:
    """Phase 12 (v): LMD2's widths at resolution r (4 x 4r cells a bar), in
    fp32 and bf16 (`bf16s`) at batch 256:
    one optimizer step through
    `cli.train.main()` on GRID_TRAIN_SAMPLES synthetic samples of the grid
    (records finite), then seconds per step (`time_train_steps`: 1 pass of
    3 synchronised steps after a warm one) with MFU (`flops.py`), and
    the step on the card against the CPU: bf16
    at batch BF16_CMP_BATCH by phase 6's rule; fp32 at batch 8 with its
    losses by phase 5's rule and its grads by phase 7's (held to an fp64
    step's on the card, `witness`): at 4 x 16 and 4 x 48 cells, batch 8,
    the CPU's own fp32 grads lie 3.1-3.2 % of a max from the fp64 ones in
    the decoder's GCN, the card's kernels' 1.1-1.5 % (H100, PERF.md §6),
    so phase 5's 1e-3 against the CPU would hold the CPU's rounding. The
    counts are set to 0 before the CLI run and before the timed steps and
    read after each: exactly `grid_train_kernels`' launches a step of the
    grid's kernels and nothing else. Returns (results, launches by
    `grid_name`)."""
    from polyphemus_tpu_torch import flops
    from polyphemus_tpu_torch.ops.kernels import counts

    s = 4 * r
    data_dir = os.path.join(ROOT, "build", f"chip_smoke_data_r{r}")
    write_dataset(data_dir, GRID_TRAIN_SAMPLES, 2, SEED, s)
    res, launches = {"resolution": r, "cells_a_bar": 4 * s, "card": card}, {}
    for bf16 in bf16s:
        k = "bf16" if bf16 else "fp32"
        t0 = time.perf_counter()

        def want(steps):
            return {(name, s, 1): n * steps
                    for name, n in grid_train_kernels(bf16, s).items()}

        # ---- the main path: the CLI's step, then the timed steps ----
        t1 = time.perf_counter()
        trainer, _, _, recs = train_phase(
            device, grid_config(r, bf16), data_dir,
            os.path.join(ROOT, "build", f"chip_smoke_train_r{r}_{k}"), 1)
        got = dict(counts.launches)
        check(trainer.step == 1, f"r={r} {k}: {trainer.step} CLI steps")
        check_records(recs, 1)
        check(got == want(1), f"r={r} {k} CLI step launched {named(got)}, "
                              f"expected {named(want(1))}")
        counts.reset()
        t2 = time.perf_counter()
        bench = time_train_steps(trainer, GRID_TRAIN_SAMPLES, device,
                                 passes=1)
        timed = dict(counts.launches)
        t3 = time.perf_counter()
        steps = 1 + len(bench["passes_step_s"]) * 3  # a warm step, 1 x 3
        check(timed == want(steps),
              f"r={r} {k} timed steps launched {named(timed)}, expected "
              f"{named(want(steps))}")
        mc = trainer.cfg.model
        bench["mfu_percent"] = 100.0 * flops.train_step_flops_per_seq(mc) \
            * bench["seq_s"] / (peak_tflops(bf16) * 1e12)
        bench["launches_per_step"] = named(want(1))
        for run in (got, timed):
            for key, n in named(run).items():
                launches[key] = launches.get(key, 0) + n
        del trainer
        counts.reset()  # the comparison's launches do not count
        bench["vs_cpu"] = compare_train_step(
            mc, BF16_CMP_BATCH if bf16 else 8, device, SEED + 5, bf16=bf16,
            witness=not bf16)
        t4 = time.perf_counter()
        bench["seconds"] = {"cli": t2 - t1, "timed": t3 - t2,
                            "vs_cpu": t4 - t3, "all": t4 - t0}
        res[k] = bench
        print(f"bar grid r={r} (4 x {s} cells) training on the card, d=512, "
              f"8 layers, batch 256 ({card}):", json.dumps(bench))
    return res, launches


def grids_phase(device, card) -> tuple:
    """Phase 12: bar grids other than 4 x 32 cells (`grid_kernels`, then
    `grid_generation` at each of GRID_MODELS, the service and the CLI at
    the first; `grid_training_kernels`, then `grid_training` at each of
    GRID_MODELS). Returns (kernel checks, training
    kernel checks, generation and training results, launches)."""
    # ---- 12. bar grids: resolutions 3, 4, 6, 12 ----
    t0 = time.perf_counter()
    kern = grid_kernels(device, card)
    print(f"phase 12 (i): {time.perf_counter() - t0:.1f} s")
    gens, launches = {}, {}
    for i, r in enumerate(GRID_MODELS):
        gens[r], got = grid_generation(device, card, r, service=i == 0)
        launches.update(got)
    t0 = time.perf_counter()
    train_kern = grid_training_kernels(device, card)
    print(f"phase 12 (iv): {time.perf_counter() - t0:.1f} s")
    trains = {}
    for r in GRID_MODELS:
        trains[r], got = grid_training(device, card, r)
        launches.update(got)
    return kern, train_kern, {"generation": gens, "training": trains}, \
        launches


LONG_CHECKS = (13, 16, 24, 48)   # resolutions above 12 held and timed
LONG_MODEL = 24                  # generated end to end: pypianoroll's grid


def long_training_refused(device, r) -> dict:
    """Phase 13 (v): training at resolution r (S = 4r > 48) in the column
    form, and what it still refuses on the card. One fp32 `gcl_fused` layer
    at n = d / 2 (tensor parallelism) runs forward and backward through the
    long-bar kernels' column forms: one launch each of `gcl_fwd`,
    `gcl_bwd_data` and `gcl_bwd_weight` at S, each counted as a column-form
    launch, and finite outputs of n columns. The bf16 fused backward (on no
    path there: training runs the split backward) raises before any kernel
    launch, with a message that names the limit and its ROADMAP.md item
    (`gcl.FUSED_LONG`). The launches here are checks and do not count.
    {case: what it gave}."""
    import torch

    from polyphemus_tpu_torch.ops.kernels import counts, gcl, gcl_bwd

    d = GRID_MODEL["d"]
    n, s = d // 2, 4 * r
    bar_mask, (x, up, aux, gates, wbig, _) = train_kernel_inputs(
        2, d, device, SEED, s)
    saved = kernel_counts()
    counts.reset()
    cols0 = dict(gcl.col_launches)
    xg = x.detach().clone().requires_grad_()
    rel = (torch.randn(6, d, n, device=device) * d ** -0.5).requires_grad_()
    out = gcl_bwd.gcl_fused(xg, gates, rel, wbig[-d:, :n].contiguous(),
                            torch.zeros(n, device=device), aux, bar_mask)
    out.backward(up[..., :n].contiguous())
    torch.cuda.synchronize()
    names = ("gcl_fwd", "gcl_bwd_data", "gcl_bwd_weight")
    ran = dict(counts.launches)
    cols = {k: v - cols0[k] for k, v in gcl.col_launches.items()
            if v != cols0[k]}
    check(ran == {(k, s, 1): 1 for k in names} and cols == dict.fromkeys(
        names, 1), f"resolution {r} column-form training launched "
                   f"{named(ran)}, columns {cols}")
    check(tuple(out.shape) == (2, 4 * s, n) and all(
        torch.isfinite(v).all().item() for v in (out, xg.grad, rel.grad)),
        f"resolution {r} column-form training: output {tuple(out.shape)} "
        f"or its grads not finite")
    counts.reset()
    xb, ub, gb, wb = (v.bfloat16() for v in (x, up, gates, wbig))
    try:
        gcl_bwd.gcl_bwd_fused(xb, ub, aux, gb, wb)
    except ValueError as e:
        msg = str(e)
    else:
        fail(f"the bf16 fused backward at resolution {r} ran on the card")
    check("up to 48" in msg and gcl.FUSED_LONG in msg and "ROADMAP" in msg,
          f"resolution {r} bf16 fused backward raised: {msg}")
    check(not counts.launches, f"resolution {r} bf16 fused backward "
                               f"launched {named(counts.launches)} first")
    set_kernel_counts(saved)
    return {"fp32_column_form_launches": named(ran),
            "fp32_column_form_cols": cols, "bf16_fused_backward": msg}


def long_training_kernels(device, card) -> dict:
    """Phase 13 (vi): the training kernels at bars of 4 x 4r cells for r in
    LONG_CHECKS, d = 512, against their plain versions: fp32 at the fp32
    training microbatch's 128 bars by phase 2b's rules, timed beside their
    bounds (`check_gcl_train`); bf16 at the bf16 microbatch's 256 bars by
    phase 2c's rule, timed beside their bounds
    (`check_gcl_train_long_bf16`). {r: {kernel: result}}."""
    res = {}
    for r in LONG_CHECKS:
        s = 4 * r
        res[r] = check_gcl_train(128, 512, device, s=s)
        res[r].update(check_gcl_train_long_bf16(256, 512, device, s=s))
        print(f"long bars r={r} (4 x {s} cells), the training kernels "
              f"against their plain versions (fp32 128 bars, bf16 256, "
              f"d=512, {card}):", json.dumps(res[r]))
    return res


def long_phase(device, card) -> tuple:
    """Phase 13: bars of more than 48 steps (resolution 13 and up): the
    generation kernels at LONG_CHECKS against their plain versions and
    timed (`grid_kernels`), LONG_MODEL's generation, service and CLIs
    (`grid_generation`), its column-form training layer and what its
    training refuses (`long_training_refused`), the training kernels at
    LONG_CHECKS
    (`long_training_kernels`) and LONG_MODEL's training in fp32 and bf16
    (`grid_training`). Returns (kernel checks, training kernel checks,
    generation and training results, launches by `grid_name`)."""
    t0 = time.perf_counter()
    kern = grid_kernels(device, card, LONG_CHECKS, timed=(LONG_MODEL,))
    print(f"phase 13 (i): {time.perf_counter() - t0:.1f} s")
    gen, launches = grid_generation(device, card, LONG_MODEL, service=True,
                                    flip_cap=False)
    refused = long_training_refused(device, LONG_MODEL)
    print(f"resolution {LONG_MODEL}: the column-form layer on the card, and "
          f"the bf16 fused backward refused before any launch:",
          json.dumps(refused))
    t0 = time.perf_counter()
    train_kern = long_training_kernels(device, card)
    print(f"phase 13 (vi): {time.perf_counter() - t0:.1f} s")
    train, got = grid_training(device, card, LONG_MODEL,
                               bf16s=(False, True))
    launches.update(got)
    return kern, train_kern, {"generation": gen, "training": train}, \
        launches


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
    phase("1")
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"device {torch.cuda.get_device_name(0)}")
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(logs)}")
    usage = {}
    for name, log in logs.items():
        usage[name] = ptxas_usage(log)
        for func, u in usage[name].items():
            print(f"  {name} {func}: {json.dumps(u)}")
    # every library's SASS at once (cuobjdump processes in parallel), kept
    # for the checks below
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        list(pool.map(sass_functions, sorted(
            {str(_build.library(n)) for n in _build.SIGNATURES})))
    print(f"cuobjdump -sass: {time.perf_counter() - t0:.1f} s")
    # both forms of each GCL kernel: the eval form (template flag 1) and the
    # training forward (0)
    forms = {"gcl_eval": "ILb1E", "gcl_fwd": "ILb0E"}
    for name, flag in forms.items():
        hmma = sass_instructions(f"{name}_bf16",
                                 f"gcl_eval_bf16_tc_kernel{flag}")
        print(f"{name}_bf16 SASS: {hmma} tensor-core instructions "
              f"(HMMA/HGMMA)")
        check(hmma > 0, f"the bf16 GCL kernel's {name} form holds no "
                        f"tensor-core instruction")
    # the bf16 chord tail in its d = 512 form (128-row tiles, H = 256), for
    # S % 16 == 0 and in its MIX form (drum and melodic rows in one warp)
    for mix in (0, 1):
        hmma_tail = sass_instructions(
            "chord_tail_bf16", f"chord_tail_bf16_tc_kernelILi128ELi256ELb{mix}E")
        print(f"chord_tail_bf16{' MIX form' if mix else ''} SASS: "
              f"{hmma_tail} tensor-core instructions (HMMA/HGMMA)")
        check(hmma_tail > 0, "the bf16 chord-tail kernel holds no "
                             "tensor-core instruction")
    # both kernels of the bf16 fused backward: dH (dx, dgate, dbias) and dW
    fused16 = {}
    for part, sym in FUSED_BF16_KERNELS.items():
        funcs = {f: u for f, u in usage["gcl_bwd_fused_bf16_tc"].items()
                 if sym in f}
        check(len(funcs) == 1, f"ptxas reported {sorted(funcs)} for {sym}")
        fused16[part] = dict(next(iter(funcs.values())), hmma=(
            sass_instructions("gcl_bwd_fused_bf16", sym)))
        print(f"gcl_bwd_fused_bf16 {part} kernel: {json.dumps(fused16[part])}")
        check(fused16[part]["hmma"] > 0, f"the bf16 fused backward's {part} "
                                         f"kernel holds no tensor-core "
                                         f"instruction")
    # the fp32 GCL kernel keeps fp32 rounding: FFMA only, no TF32 products
    for name, flag in forms.items():
        sym = f"gcl_eval_fp32_kernel{flag}"
        mma32 = sass_instructions(name, sym)
        ffma32 = sass_instructions(name, sym, r"\bFFMA\b")
        print(f"{name} (fp32) SASS: {ffma32} FFMA, {mma32} tensor-core "
              f"instructions")
        check(mma32 == 0 and ffma32 > 0, f"the fp32 GCL kernel's {name} form "
                                         f"is not an FFMA kernel")
    # the same for the fp32 chord tail, in its d = 512 form (128-row tiles)
    tail_sym = "chord_tail_fp32_kernelILi128ELi4E"
    mma_tail = sass_instructions("chord_tail", tail_sym)
    ffma_tail = sass_instructions("chord_tail", tail_sym, r"\bFFMA\b")
    print(f"chord_tail (fp32) SASS: {ffma_tail} FFMA, {mma_tail} tensor-core "
          f"instructions")
    check(mma_tail == 0 and ffma_tail > 0, "the fp32 chord-tail kernel is "
                                           "not an FFMA kernel")
    fused_sym = "gcl_bwd_fused_kernelIfE"
    mma_fused32 = sass_instructions("gcl_bwd_fused", fused_sym)
    ffma_fused32 = sass_instructions("gcl_bwd_fused", fused_sym, r"\bFFMA\b")
    print(f"gcl_bwd_fused (fp32) SASS: {ffma_fused32} FFMA, {mma_fused32} "
          f"tensor-core instructions")
    check(mma_fused32 == 0 and ffma_fused32 > 0, "the fp32 fused backward is "
                                                 "not an FFMA kernel")
    # the fp32 weight and data backward: FFMA kernels, no spills
    bwd32 = {}
    for name in ("gcl_bwd_weight", "gcl_bwd_data"):
        sym = f"{name}_kernel"
        funcs = [u for f, u in usage[name].items() if sym in f]
        check(len(funcs) == 1, f"ptxas reported {len(funcs)} {sym}")
        bwd32[name] = dict(
            funcs[0], dynamic_smem_bytes=smem_bytes(name),
            ffma=sass_instructions(name, sym, r"\bFFMA\b"),
            hmma=sass_instructions(name, sym))
        print(f"{name} (fp32) kernel: {json.dumps(bwd32[name])}")
        check(bwd32[name]["hmma"] == 0 and bwd32[name]["ffma"] > 0,
              f"the fp32 {name} kernel is not an FFMA kernel")
        check(bwd32[name]["spill_bytes"] == 0,
              f"ptxas spilled registers of the fp32 {name} kernel")
    grid_k = grid_kernel_forms(usage)
    print("grid GCL kernels (bars of 4 x S, S != 32):", json.dumps(grid_k))
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 2. kernels against their plain versions ----
    phase("2")
    small = {"gcl_eval_k1": check_gcl(8, 512, 1, device, timing=False),
             "gcl_eval_k3": check_gcl(8, 512, 3, device, timing=False),
             "chord_tail": check_chord(8, 512, device, timing=False)}
    print("small-shape check:", json.dumps(small))
    gcl1 = check_gcl(512, 512, 1, device)
    gcl2 = check_gcl(512, 512, 2, device)
    for k, r in ((1, gcl1), (2, gcl2)):
        r["simt_kernel_ms"] = SIMT_EVAL_FP32_MS[k]
    chord = check_chord(512, 512, device)
    chord["simt_kernel_ms"] = SIMT_CHORD_FP32_MS
    print(f"flagship kernel check (512 bars, d=512, {card}):", json.dumps(
        {"gcl_eval_k1": gcl1, "gcl_eval_k2": gcl2, "chord_tail": chord}))

    # ---- 2b. training kernels against their plain versions ----
    phase("2b")
    print("small-shape training kernel check (8 bars, d=512):",
          json.dumps(check_gcl_train(8, 512, device, timing=False)))
    train_k = check_gcl_train(128, 512, device)
    train_k["gcl_fwd"]["simt_kernel_ms"] = SIMT_FWD_MS["gcl_fwd"]
    train_k["gcl_bwd_weight"]["split_k_kernel_ms"] = SPLIT_K_WEIGHT_FP32_MS
    train_k["gcl_bwd_weight"]["kernel"] = bwd32["gcl_bwd_weight"]
    train_k["gcl_bwd_data"]["first_design_kernel_ms"] = \
        FIRST_DESIGN_DATA_FP32_MS
    train_k["gcl_bwd_data"]["kernel"] = bwd32["gcl_bwd_data"]
    print("flagship training kernel check (128 bars, d=512):",
          json.dumps(train_k))

    # ---- 2c. bf16 training kernels and the fused backward ----
    phase("2c")
    print("small-shape bf16 training kernel check (8 bars, d=512):",
          json.dumps(check_gcl_train_bf16(8, 512, device, timing=False)))
    bf16_k = check_gcl_train_bf16(256, 512, device)
    bf16_k["gcl_fwd_bf16"]["simt_kernel_ms"] = SIMT_FWD_MS["gcl_fwd_bf16"]
    bf16_k["gcl_bwd_fused"]["ffma_kernel_ms"] = FFMA_FUSED_BF16_MS
    bf16_k["gcl_bwd_fused"]["tc_dh_kernel_ms"] = TC_DH_FUSED_BF16_MS
    bf16_k["gcl_bwd_fused"]["kernels"] = fused16
    print(f"bf16 flagship training kernel check (256 bars, d=512, {card}):",
          json.dumps(bf16_k))
    print("small-shape bf16 eval GCL check (8 bars, d=512, K=1, 3):",
          json.dumps({f"gcl_eval_bf16_k{k}": check_gcl(
              8, 512, k, device, timing=False, bf16=True) for k in (1, 3)}))
    # the bf16 eval step's shape: batch 256 x 2 bars, one layer per launch
    eval16_k = check_gcl(512, 512, 1, device, bf16=True)
    eval16_k["cuda_core_kernel_ms"] = CUDA_CORE_EVAL_BF16_MS[1]
    print(f"bf16 eval GCL check (512 bars, d=512, K=1, {card}):",
          json.dumps(eval16_k))
    fused32 = check_fused_fp32(128, 512, device)
    print(f"fused vs split backward, fp32 (128 bars, d=512, {card}):",
          json.dumps(fused32))

    # ---- 2d. the bf16 generation kernels: chord tail, eval GCL at K = 2 ----
    phase("2d")
    print("small-shape bf16 chord tail check (8 bars, d=512):", json.dumps(
        check_chord(8, 512, device, timing=False, bf16=True)))
    chord16 = check_chord(512, 512, device, bf16=True)
    chord16["simt_kernel_ms"] = SIMT_CHORD_BF16_MS
    gen16_k = check_gcl(512, 512, 2, device, bf16=True)
    gen16_k["cuda_core_kernel_ms"] = CUDA_CORE_EVAL_BF16_MS[2]
    print(f"bf16 generation kernel check (512 bars, d=512, {card}):",
          json.dumps({"chord_tail_bf16": chord16,
                      "gcl_eval_bf16_k2": gen16_k}))

    # ---- 3. the service on the card ----
    phase("3")
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
    check(launches["gcl_eval_by_k"] == {2: 4 * calls},
          f"expected 4 gcl_eval launches at K = 2 per call, got {launches} "
          f"/ {calls}")
    check(launches["chord_tail"] == calls,
          f"expected 1 chord_tail launch per call, got {launches} / {calls}")
    cpu_cmp = compare_with_cpu(model_dir, n8, device)
    print("n=8 against the CPU:", json.dumps(cpu_cmp))

    # ---- 4. throughput at batch 256 ----
    phase("4")
    res = bench(model_dir, device)
    res.update({"card": card, "gcl_eval_launches_per_call": 4,
                "kernel_ms_per_call": 4 * gcl2["ms"] + chord["ms"]})
    print("bench:", json.dumps(res))

    # ---- 4b. bf16 generation at batch 256, then the CLIs on the card ----
    phase("4b")
    from polyphemus_tpu_torch.ops.kernels import counts

    counts.reset()
    # ---- the main path ----
    res16 = bench(model_dir, device, bf16=True)
    gen16_launches = {"gcl_eval_bf16_k2": counts.total("gcl_eval_bf16"),
                      "chord_tail_bf16": counts.total("chord_tail_bf16")}
    want = {("gcl_eval_bf16", 32, 2): 4 * res16["calls"],
            ("chord_tail_bf16", 32, 1): res16["calls"]}
    check(counts.launches == want,
          f"bf16 generation: launches {named(counts.launches)}, expected "
          f"{named(want)} in {res16['calls']} calls")
    res16.update({"card": card, "launches": gen16_launches,
                  "kernel_ms_per_call": 4 * gen16_k["ms"] + chord16["ms"],
                  "call_ms_over_fp32": res16["call_ms"] / res["call_ms"]})
    print("bf16 bench:", json.dumps(res16))
    cmp16 = compare_bf16_with_cpu(model_dir, device)
    print("bf16 n=8 against the CPU:", json.dumps(cmp16))
    samples_dir = os.path.join(ROOT, "build", "chip_smoke_samples")
    write_dataset(samples_dir, 2, mc.n_bars, SEED + 1)
    clis = cli_phase(model_dir, device, os.path.join(ROOT, "build",
                                                     "chip_smoke_cli"),
                     sorted(os.path.join(samples_dir, f)
                            for f in os.listdir(samples_dir)))
    print("CLIs on the card:", json.dumps(clis))

    # ---- 5. training on the card ----
    phase("5")
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
    train_bench = time_train_steps(trainer, trainer.cfg.batch_size, device,
                                   passes=2)
    train_bench["card"] = card
    print("train bench:", json.dumps(train_bench))
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    prof = profile_train_step(trainer, trainer.cfg.batch_size, device,
                              os.path.join(ROOT, "chiprun_out",
                                           "train_step_profile.txt"))
    print("train step profile:", json.dumps(prof))
    del trainer

    # ---- 6. bf16 training on the card, with an eval step per epoch ----
    phase("6")
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
    bench16 = time_train_steps(trainer, trainer.cfg.batch_size, device,
                               passes=2)
    bench16["card"] = card
    print("bf16 train bench:", json.dumps(bench16))
    del trainer

    # ---- 7, 7b. LMD16 training and generation on the card ----
    phase("7, 7b")
    l16 = lmd16_phases(device, card)

    # ---- 7c. message dropout on the card, both modes ----
    phase("7c")
    dropout = dropout_phase(device, card, config_path, data16)

    # ---- 8. the data plane: MIDI -> samples -> shards -> training ----
    phase("8")
    data_out, data_launches = data_plane_phase(device, card, config_path)

    # ---- 9. the remaining surface: MFU, native render, mtp_from_logits ----
    phase("9")
    from polyphemus_tpu_torch import flops

    gen_f, step_f = flops.generation_flops_per_seq, \
        flops.train_step_flops_per_seq
    mc16 = l16["mc"]
    rates = {
        "generation_fp32": (res["value"], gen_f(mc), False),
        "generation_bf16": (res16["value"], gen_f(mc), True),
        "generation_lmd16_fp32": (l16["bench"]["value"], gen_f(mc16), False),
        "training_fp32": (train_bench["seq_s"], step_f(mc), False),
        "training_bf16": (bench16["seq_s"], step_f(mc), True),
        "training_lmd16_fp32": (l16["train_bench"]["seq_s"], step_f(mc16),
                                False)}
    cli_render = surface_phase(device, card, model_dir, mc, n8, l16, rates)

    # ---- 10. data parallelism: torchrun, NCCL at W = 1, 2 gloo ranks ----
    phase("10")
    ddp_launches = ddp_phase(card, config_path, os.path.join(
        ROOT, "build", "chip_smoke_data_plane", "packed"),
        data_out["samples"])

    # ---- 10b. tensor parallelism: column forms, 2 and 4 gloo ranks ----
    phase("10b")
    tp_cols, tp_launches = tp_phase(card)

    # ---- 12. bar grids other than 4 x 32 cells: resolutions 3, 4, 6, 12 ----
    phase("12")
    grid_checks, grid_train_checks, _, grid_launches = grids_phase(device,
                                                                   card)

    # ---- 13. bars of more than 48 steps: resolutions 13, 16, 24, 48 ----
    phase("13")
    long_checks, long_train_checks, _, long_launches = long_phase(device,
                                                                  card)

    # ---- 11. results ----
    phase("11")
    launches = dict(launches, **train_launches, **gen16_launches)
    # K = 1 runs in the reconstruct CLIs' encoders and the dropout runs'
    # eval steps, counted by the wrapper
    launches["gcl_eval_k1"] = (
        clis["reconstruct"]["gcl_eval_by_k"][1]
        + l16["clis"]["reconstruct"]["gcl_eval_by_k"][1]
        + sum(r["launches"]["gcl_eval_k1"] for r in dropout.values()))
    launches.update({k: bf16_launches[k]
                     for k in ("gcl_fwd_bf16", "gcl_bwd_fused",
                               "gcl_eval_bf16")})
    # the LMD16 phases: training (7), generation and its CLIs (7b)
    clis_l16 = l16["clis"]
    lmd16_gen = {"gcl_eval": l16["gen_launches"]["gcl_eval_by_k"][2]
                 + clis_l16["generate_n_loops_4"]["gcl_eval_by_k"][2]
                 + clis_l16["reconstruct"]["gcl_eval_by_k"][2],
                 "chord_tail": l16["gen_launches"]["chord_tail"]
                 + clis_l16["generate_n_loops_4"]["chord_tail"]
                 + clis_l16["reconstruct"]["launches"][1]}
    l16_launches = l16["train_launches"]
    for name, n in dict(lmd16_gen, **{k: l16_launches[k] for k in (
            "gcl_fwd", "gcl_bwd_data", "gcl_bwd_weight")}).items():
        launches[name] += n
    for name, n in data_launches.items():
        launches[name] += n
    for name in ("gcl_eval", "chord_tail"):  # phase 9's generate CLI
        launches[name] += cli_render[name]
    for name, n in ddp_launches.items():  # every rank of phase 10
        launches[name] += n
    for name, n in tp_launches.items():  # every rank of phase 10b
        # its eval steps run one layer a launch
        name = {"gcl_eval": "gcl_eval_k1"}.get(name, name)
        launches[name] = launches.get(name, 0) + n

    def entry(name, src, replaces, r):
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": None}

    kernels = [
        entry("gcl_eval", "polyphemus_tpu_torch/csrc/gcl_eval_fp32.cu",
              "polyphemus_tpu/ops/kernels/gcl_pallas.py:440", gcl2),
        entry("gcl_eval_k1", "polyphemus_tpu_torch/csrc/gcl_eval_fp32.cu",
              "polyphemus_tpu/ops/kernels/gcl_pallas.py:347", gcl1),
        entry("chord_tail", "polyphemus_tpu_torch/csrc/chord_tail_fp32.cu",
              "polyphemus_tpu/ops/kernels/chord_tail.py:101", chord),
        entry("gcl_fwd", "polyphemus_tpu_torch/csrc/gcl_eval_fp32.cu",
              "polyphemus_tpu/ops/kernels/gcl_pallas.py:347",
              train_k["gcl_fwd"]),
        entry("gcl_bwd_data", "polyphemus_tpu_torch/csrc/gcl_bwd_data.cu",
              "polyphemus_tpu/ops/kernels/gcl_pallas_bwd.py:528",
              train_k["gcl_bwd_data"]),
        entry("gcl_bwd_weight",
              "polyphemus_tpu_torch/csrc/gcl_bwd_weight.cu",
              "polyphemus_tpu/ops/kernels/gcl_pallas_bwd.py:564",
              train_k["gcl_bwd_weight"]),
        entry("gcl_fwd_bf16",
              "polyphemus_tpu_torch/csrc/gcl_eval_bf16_tc.cu",
              "polyphemus_tpu/ops/kernels/gcl_pallas.py:347",
              bf16_k["gcl_fwd_bf16"]),
        entry("gcl_bwd_fused",
              "polyphemus_tpu_torch/csrc/gcl_bwd_fused_bf16_tc.cu",
              "polyphemus_tpu/ops/kernels/gcl_pallas_bwd.py:453",
              bf16_k["gcl_bwd_fused"]),
        entry("gcl_eval_bf16",
              "polyphemus_tpu_torch/csrc/gcl_eval_bf16_tc.cu",
              "polyphemus_tpu/ops/kernels/gcl_pallas.py:347", eval16_k),
        entry("gcl_eval_bf16_k2",
              "polyphemus_tpu_torch/csrc/gcl_eval_bf16_tc.cu",
              "polyphemus_tpu/ops/kernels/gcl_pallas.py:440", gen16_k),
        entry("chord_tail_bf16",
              "polyphemus_tpu_torch/csrc/chord_tail_bf16_tc.cu",
              "polyphemus_tpu/ops/kernels/chord_tail.py:101", chord16)]
    # the column forms at n = 256, the main path's at model axis 2, on a
    # rank's microbatch at D = 1 (phase 10b (ii), (iii))
    for name, src, replaces, bf16, nbar in (
            ("gcl_fwd", "gcl_eval_fp32.cu", "gcl_pallas.py:347", False, 128),
            ("gcl_eval", "gcl_eval_fp32.cu", "gcl_pallas.py:347", False,
             128),
            ("gcl_bwd_data", "gcl_bwd_data.cu", "gcl_pallas_bwd.py:528",
             False, 128),
            ("gcl_bwd_weight", "gcl_bwd_weight.cu", "gcl_pallas_bwd.py:564",
             False, 128),
            ("gcl_fwd_bf16", "gcl_eval_bf16_tc.cu", "gcl_pallas.py:347",
             True, 256),
            ("gcl_eval_bf16", "gcl_eval_bf16_tc.cu", "gcl_pallas.py:347",
             True, 256),
            ("gcl_bwd_fused_bf16", "gcl_bwd_fused_bf16_tc.cu",
             "gcl_pallas_bwd.py:453", True, 256)):
        r = tp_cols[(bf16, nbar, 256, 32)]["kernels"][
            "gcl_bwd_fused" if name == "gcl_bwd_fused_bf16" else name]
        kernels.append(entry(f"{name}_cols",
                             f"polyphemus_tpu_torch/csrc/{src}",
                             f"polyphemus_tpu/ops/kernels/{replaces}", r))
    # the long-bar column forms at n = 256 (bars of 4 x 96 cells), held and
    # timed on a rank's microbatch at D = 1 in 10b (i), launched by 10b (v)
    s = 4 * LONG_MODEL
    for name, src, replaces, bf16, nbar in (
            ("gcl_fwd", "gcl_eval_long_fp32.cu", "gcl_pallas.py:347", False,
             128),
            ("gcl_eval", "gcl_eval_long_fp32.cu", "gcl_pallas.py:347",
             False, 128),
            ("gcl_bwd_data", "gcl_bwd_data_long.cu", "gcl_pallas_bwd.py:528",
             False, 128),
            ("gcl_bwd_weight", "gcl_bwd_weight_long.cu",
             "gcl_pallas_bwd.py:564", False, 128),
            ("gcl_fwd_bf16", "gcl_eval_long_bf16_tc.cu", "gcl_pallas.py:347",
             True, 256),
            ("gcl_eval_bf16", "gcl_eval_long_bf16_tc.cu",
             "gcl_pallas.py:347", True, 256),
            ("gcl_bwd_data_bf16", "gcl_bwd_data_long.cu",
             "gcl_pallas_bwd.py:528", True, 256),
            ("gcl_bwd_weight_bf16", "gcl_bwd_weight_long.cu",
             "gcl_pallas_bwd.py:564", True, 256)):
        r = tp_cols[(bf16, nbar, 256, s)]["kernels"][name]
        kernels.append(entry(f"{name}_cols_s{s}",
                             f"polyphemus_tpu_torch/csrc/{src}",
                             f"polyphemus_tpu/ops/kernels/{replaces}", r))
    # the generation kernels at the grids of phase 12's models, each held
    # and timed at 512 bars in 12 (i), launched by 12 (ii) and (iii)
    launches.update(grid_launches)
    for r in GRID_MODELS:
        s = 4 * r
        for name, src, replaces in (
                ("gcl_eval", "gcl_eval_grid_fp32.cu", "gcl_pallas.py:440"),
                ("gcl_eval_bf16", "gcl_eval_grid_bf16_tc.cu",
                 "gcl_pallas.py:440"),
                ("chord_tail", "chord_tail_fp32.cu", "chord_tail.py:101"),
                ("chord_tail_bf16", "chord_tail_bf16_tc.cu",
                 "chord_tail.py:101")):
            kernels.append(entry(f"{name}_s{s}",
                                 f"polyphemus_tpu_torch/csrc/{src}",
                                 f"polyphemus_tpu/ops/kernels/{replaces}",
                                 grid_checks[r][name]))
    # the training kernels at the grids of phase 12's models, each held and
    # timed at the training microbatch's bars in 12 (iv), launched by 12 (v)
    for r in GRID_MODELS:
        s = 4 * r
        for name, src, replaces in (
                ("gcl_fwd", "gcl_eval_grid_fp32.cu", "gcl_pallas.py:347"),
                ("gcl_bwd_data", "gcl_bwd_data_grid.cu",
                 "gcl_pallas_bwd.py:528"),
                ("gcl_bwd_weight", "gcl_bwd_weight_grid.cu",
                 "gcl_pallas_bwd.py:564"),
                ("gcl_fwd_bf16", "gcl_eval_grid_bf16_tc.cu",
                 "gcl_pallas.py:347"),
                ("gcl_bwd_fused", "gcl_bwd_fused_grid_bf16_tc.cu",
                 "gcl_pallas_bwd.py:453")):
            kernels.append(entry(f"{name}_s{s}",
                                 f"polyphemus_tpu_torch/csrc/{src}",
                                 f"polyphemus_tpu/ops/kernels/{replaces}",
                                 grid_train_checks[r][name]))
    # the generation kernels at resolution LONG_MODEL (bars of 4 x 96
    # cells), each held and timed at 512 bars in 13 (i), launched by 13
    # (ii)-(iv): the long-bar GCL one layer a launch
    launches.update(long_launches)
    s = 4 * LONG_MODEL
    for name, src, replaces in (
            ("gcl_eval_k1", "gcl_eval_long_fp32.cu", "gcl_pallas.py:440"),
            ("gcl_eval_bf16_k1", "gcl_eval_long_bf16_tc.cu",
             "gcl_pallas.py:440"),
            ("chord_tail", "chord_tail_fp32.cu", "chord_tail.py:101"),
            ("chord_tail_bf16", "chord_tail_bf16_tc.cu",
             "chord_tail.py:101")):
        kernels.append(entry(f"{name}_s{s}",
                             f"polyphemus_tpu_torch/csrc/{src}",
                             f"polyphemus_tpu/ops/kernels/{replaces}",
                             long_checks[LONG_MODEL][name]))
    # the training kernels at resolution LONG_MODEL, each held and timed at
    # the training microbatch's bars (fp32 128, bf16 256) in 13 (vi),
    # launched by 13 (vii)
    for name, src, replaces in (
            ("gcl_fwd", "gcl_eval_long_fp32.cu", "gcl_pallas.py:347"),
            ("gcl_bwd_data", "gcl_bwd_data_long.cu", "gcl_pallas_bwd.py:528"),
            ("gcl_bwd_weight", "gcl_bwd_weight_long.cu",
             "gcl_pallas_bwd.py:564"),
            ("gcl_fwd_bf16", "gcl_eval_long_bf16_tc.cu", "gcl_pallas.py:347"),
            ("gcl_bwd_data_bf16", "gcl_bwd_data_long.cu",
             "gcl_pallas_bwd.py:528"),
            ("gcl_bwd_weight_bf16", "gcl_bwd_weight_long.cu",
             "gcl_pallas_bwd.py:564")):
        kernels.append(entry(f"{name}_s{s}",
                             f"polyphemus_tpu_torch/csrc/{src}",
                             f"polyphemus_tpu/ops/kernels/{replaces}",
                             long_train_checks[LONG_MODEL][name]))
    # the reconstruct encoder's eval layers, one a launch, at the grid of
    # phase 12 (iii)
    s = 4 * GRID_MODELS[0]
    kernels.append(entry(f"gcl_eval_k1_s{s}",
                         "polyphemus_tpu_torch/csrc/gcl_eval_grid_fp32.cu",
                         "polyphemus_tpu/ops/kernels/gcl_pallas.py:347",
                         grid_checks[GRID_MODELS[0]]["gcl_eval_k1"]))
    # launches at 4096 bars (the batch-256 bench) beside their times; the
    # CLIs' launches (2 sequences, 32 bars a call) apart
    lmd16_kernels = {
        "gcl_eval_k2_4096_bars": dict(
            l16["gcl_eval"],
            launches=l16["gen_launches"]["gcl_eval_by_k"][2],
            cli_launches_32_bars=(lmd16_gen["gcl_eval"]
                                  - l16["gen_launches"]["gcl_eval_by_k"][2])),
        "chord_tail_4096_bars": dict(
            l16["chord_tail"], launches=l16["gen_launches"]["chord_tail"],
            cli_launches_32_bars=(lmd16_gen["chord_tail"]
                                  - l16["gen_launches"]["chord_tail"]))}
    lmd16_kernels.update({f"{k}_256_bars": dict(l16["train_kernels"][k],
                                                launches=l16_launches[k])
                          for k in ("gcl_fwd", "gcl_bwd_data",
                                    "gcl_bwd_weight")})
    print(json.dumps({"lmd16_kernels": lmd16_kernels, "card": card}))
    print(f"chip_smoke: {time.perf_counter() - START:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["rank_child"]:
        sys.exit(rank_child(sys.argv[2]))
    sys.exit(main())
