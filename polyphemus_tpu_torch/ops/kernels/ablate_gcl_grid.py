"""Take the bf16 grid GCL kernel apart on the card.

    python -m polyphemus_tpu_torch.ops.kernels.ablate_gcl_grid [NBAR]

Builds patched copies of `csrc/gcl_eval_grid_bf16_tc.cu` into
`build/ablate_gcl_grid/`, one library each, and times them in turns on the
same inputs (NBAR bars, default 512, d = 512, K = 2 eval layers, bf16) at S
= 12, 16, 48 and 32 steps a bar: the whole kernel; the track product
without the second B fragment of a warp whose m16 tiles lie in two tracks
(`no_split`); without the (bar, column) items of the shared segments'
build (`no_shared_items`); without any A build (`no_builds`); without the
MMAs (`no_mma`). At S = 32 it also times the S = 32 kernels
(`gcl_eval_bf16_tc.cu`, `gcl_eval_fp32.cu`) and the unpatched grid
kernels of both dtypes on the same inputs: what the grid form costs. A
patched copy computes wrong values; only the whole kernel is checked, against
`gcl_eval_plain` (within 2e-2 x max |plain|). Prints one JSON line: ms per
launch, two rounds each, and the card's name and power limit.
"""
from __future__ import annotations

import json
import subprocess
import sys

import torch

from . import _build, gcl

KERNEL = "gcl_eval_grid_bf16"
OUT = _build.BUILD_DIR.parent / "ablate_gcl_grid"
TRACK_MMA = """        if (trow[0] == trow[1])
          mma_k16(acc, sm.a[0], wt, trow[0], row0, rstep, col0, lane);
        else
          mma_k16_split(acc, sm.a[0], wt, trow, row0, rstep, col0, lane);
"""
SHARED_MMA = ("          mma_k16(acc, sm.a[seg], wt, seg * BK, row0, rstep, "
              "col0, lane);\n")
VARIANTS = {
    "whole": [],
    "no_split": [("        if (trow[0] == trow[1])\n", "        if (true)\n")],
    "no_shared_items": [("    if (mask == 0) continue;\n", "    continue;\n")],
    "no_builds": [("""      if (track)
        build_track(sm, ibuild, tid);
      else
        build_shared(sm, gd, item, ibuild, tid);
""", "")],
    "no_mma": [(TRACK_MMA, ""), (SHARED_MMA, "")],
}
STEPS = (12, 16, 48, 32)


def inputs(nbar: int, d: int, s: int, dtype, device):
    """Seeded x (masked at a density of 0.3), aux, gates and K = 2 layers of
    packed weights, as `gcl_eval` takes them, over bars of 4 x s cells."""
    g = torch.Generator().manual_seed(0)
    mask = torch.rand(nbar, 4, s, generator=g) < 0.3
    mask[:, 0, 0] = True
    x = torch.randn(nbar, 4 * s, d, generator=g) * mask.reshape(nbar, -1, 1)
    aux = gcl.build_kernel_aux(mask).reshape(nbar, gcl.N_AUX, 4 * s)
    gates = torch.randn(s, d, generator=g) * 0.3
    w = torch.stack([gcl.pack_weights(
        torch.randn(6, d, d, generator=g) * d ** -0.5,
        torch.randn(d, d, generator=g) * d ** -0.5, 4) for _ in range(2)])
    b, ea, eb = (torch.randn(2, d, generator=g) * 0.1 + o for o in (0, 1, 0))
    return [v.to(device, dtype) if v.is_floating_point() else v.to(device)
            for v in (x, aux, gates, w, b, ea, eb)]


def time_ms(fn, reps: int = 10) -> float:
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


def main(nbar: int = 512) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the kernel runs on the card only")
    device = torch.device("cuda")
    d = 512
    stream = _build.stream_handle(device)
    fns = _build.build_variants(KERNEL, VARIANTS, OUT)
    res = {"nbar": nbar, "d": d, "k": 2}
    for s in STEPS:
        args = inputs(nbar, d, s, torch.bfloat16, device)
        out, scratch = torch.empty_like(args[0]), torch.empty_like(args[0])
        ptrs = [a.data_ptr() for a in args] + [out.data_ptr(),
                                               scratch.data_ptr()]

        def run(fn, name):
            return lambda: _build.check(name, fn(*ptrs, nbar, s, d, d, 0, 2,
                                                 stream))

        run(fns["whole"], "whole")()
        ref = gcl.gcl_eval_plain(*args).float()
        err = (out.float() - ref).abs().max().item()
        if err > 2e-2 * ref.abs().max().item():
            raise SystemExit(f"the whole kernel at S = {s} is off its plain "
                             f"version by {err}")
        calls = {name: run(fn, name) for name, fn in fns.items()}
        if s == 32:
            a32 = inputs(nbar, d, s, torch.float32, device)
            o32, s32 = torch.empty_like(a32[0]), torch.empty_like(a32[0])
            grid32 = _build.launcher("gcl_eval_grid")
            p32 = [a.data_ptr() for a in a32] + [o32.data_ptr(),
                                                 s32.data_ptr()]
            calls["s32_kernel"] = lambda: gcl.gcl_eval(*args)
            calls["fp32_grid_whole"] = lambda: _build.check(
                "gcl_eval_grid", grid32(*p32, nbar, s, d, d, 0, 2, stream))
            calls["fp32_s32_kernel"] = lambda: gcl.gcl_eval(*a32)
        times = {name: [] for name in calls}
        for order in (list(calls), list(calls)[::-1]):
            for name in order:
                times[name].append(time_ms(calls[name]))
        res[f"s{s}"] = {"ms": times, "whole_max_abs_err": err}
    res["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:2]))
