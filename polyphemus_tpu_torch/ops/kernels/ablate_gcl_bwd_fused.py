"""Take the bf16 fused GCL backward apart on the card.

    python -m polyphemus_tpu_torch.ops.kernels.ablate_gcl_bwd_fused [NBAR] [D]

Builds patched copies of `csrc/gcl_bwd_fused_bf16_tc.cu` into
`build/ablate_gcl_bwd_fused/`, one library each, and times them in turns on
the same inputs (NBAR bars, default 256, the bf16 training microbatch, at
width D, default 512). The source holds two kernels, the dH kernel (dx,
dgate, dbias) and the dW kernel (dWbig). Variants: the whole backward;
the dW kernel without its MMAs (its fragment loads kept), without its
rebuild of the messages (the MMAs read stale tiles), and not launched; the
dH kernel not launched, without its MMAs (its stages and fragment loads
kept), without its whole product (no stages, no fragment loads, no MMAs)
and without the scatters of its phase 3. A patched copy computes wrong
gradients; only the whole backward is checked: every output within 2e-2 x
max |plain| of `gcl_bwd_fused_plain`. Prints one JSON line: ms per launch,
two rounds each, the card's name and power limit.
"""
from __future__ import annotations

import json
import subprocess
import sys

import torch

from . import _build, gcl, gcl_bwd
from .ablate_chord_tail import time_ms

KERNEL = "gcl_bwd_fused_bf16"
OUT = _build.BUILD_DIR.parent / "ablate_gcl_bwd_fused"
# the dW product's MMAs sit in `csrc/gcl_dw_bf16.cuh`: a flag defined
# before its include leaves them out
DW_INCLUDE = '#include "gcl_dw_bf16.cuh"'
H_BUILD = "  for (int it = tid; it < S * WR / 4; it += THREADS) {"
DW_LAUNCH = "  gcl_bwd_dw_bf16_tc_kernel<<<"
DH_LAUNCH = "  gcl_bwd_fused_bf16_tc_kernel<<<"
DH_MMA = """              mma_bf16(acc[s][2 * jp], a, b[0], b[1]);
              mma_bf16(acc[s][2 * jp + 1], a, b[2], b[3]);"""
DH_LOOP = "      for (int st = 0; st < nstage; ++st) {"
SCATTERS = """    // ---- 3. relu masks from the recomputed pre-activations, scatters ----
    for (int e = tid; e < N * BC; e += THREADS) {"""
VARIANTS = {
    "whole": [],
    "no_dw_mma": [(DW_INCLUDE, "#define GCL_DW_NO_MMA\n" + DW_INCLUDE)],
    "no_h_rebuild": [(H_BUILD, H_BUILD.replace("it = tid", "it = S * WR / 4"))],
    # nbar > 0 where the kernels launch: the condition never holds
    "no_dw_launch": [(DW_LAUNCH, "  if (nbar < 0)" + DW_LAUNCH)],
    "no_dh_launch": [(DH_LAUNCH, "  if (nbar < 0)" + DH_LAUNCH)],
    "no_dh_mma": [(DH_MMA, "")],
    "no_dh_product": [(DH_LOOP, DH_LOOP.replace("st = 0", "st = nstage"))],
    "no_scatters": [(SCATTERS, SCATTERS.replace("e = tid", "e = N * BC"))],
}


def inputs(nbar: int, d: int, device):
    """Seeded bf16 x (masked, 30 % of cells active), upstream g, aux, gate
    table and packed weights of one training GCL layer."""
    g = torch.Generator().manual_seed(0)
    mask = torch.rand(nbar, 4, 32, generator=g) < 0.3
    mask[:, :, 0] = True
    x = torch.randn(nbar, 128, d, generator=g) * mask.reshape(nbar, 128, 1)
    up = torch.randn(nbar, 128, d, generator=g)
    aux = gcl.build_kernel_aux(mask).reshape(nbar, gcl.N_AUX, 128)
    gates = torch.randn(32, d, generator=g) * 0.3
    wbig = gcl.pack_weights(torch.randn(6, d, d, generator=g) * d ** -0.5,
                            torch.randn(d, d, generator=g) * d ** -0.5, 4)
    return [v.contiguous().to(device) if v.dtype == torch.int32
            else v.to(torch.bfloat16).contiguous().to(device)
            for v in (x, up, aux, gates, wbig)]


def main(nbar: int = 256, d: int = 512) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the kernel runs on the card only")
    device = torch.device("cuda")
    x, up, aux, gates, wbig = inputs(nbar, d, device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    chunks = gcl_bwd.fused_chunks(nbar, d, sms)
    f32 = torch.float32
    dx = torch.empty_like(x)
    part_gb = torch.empty((chunks, 33 * d), dtype=f32, device=device)
    dwbig = torch.empty((8 * d, d), dtype=f32, device=device)
    out = torch.empty(33 * d, dtype=f32, device=device)
    stream = _build.stream_handle(device)
    fns = _build.build_variants(KERNEL, VARIANTS, OUT)

    def run(name):
        _build.check(name, fns[name](
            *(v.data_ptr() for v in (x, up, aux, gates, wbig, dx, part_gb,
                                     dwbig, out)),
            nbar, d, d, chunks, stream))

    run("whole")
    want = gcl_bwd.gcl_bwd_fused_plain(x, up, aux, gates, wbig)
    got = (dx, out[:32 * d].view(32, d), out[32 * d:], dwbig)
    rel = {}
    for n, a, b in zip(("dx", "dgate", "dbias", "dwbig"), got, want):
        rel[n] = ((a.float() - b.float()).abs().max()
                  / b.float().abs().max()).item()
        if not rel[n] <= 2e-2:
            raise SystemExit(f"the whole kernel's {n} is {rel[n]:.3e} x max "
                             f"|plain| off the plain version")
    times = {name: [] for name in VARIANTS}
    for order in (list(VARIANTS), list(VARIANTS)[::-1]):
        for name in order:
            times[name].append(time_ms(lambda: run(name)))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    res = {"nbar": nbar, "d": d, "card": card,
           "whole_err_over_max_plain": rel, "ms": times}
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:3]))
