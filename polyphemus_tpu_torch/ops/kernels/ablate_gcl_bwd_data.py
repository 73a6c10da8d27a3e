"""Take the fp32 GCL data backward apart on the card.

    python -m polyphemus_tpu_torch.ops.kernels.ablate_gcl_bwd_data [NBAR] [D]

Builds patched copies of `csrc/gcl_bwd_data.cu` into
`build/ablate_gcl_bwd_data/`, one library each, and times them in turns on
the same inputs (NBAR bars, default 128, the fp32 training microbatch, at
width D, default 512). Variants: the whole kernel; without its FFMAs (the
product and its shared-memory reads); without its scatters (the gathers
of dx and dgate; dx is not written); without its asynchronous staging
(only each CTA's first stage is copied in, later stages read stale
buffers); and its loads only (no FFMAs, no scatters).

A patched copy computes wrong results; only the whole kernel is checked:
dx within rtol = atol = 2e-4 of `gcl_bwd_data_plain`, dgate and dbias
within 1e-4 x max |plain|. Prints one JSON line: ms per launch, two rounds
each, the card's name and power limit.
"""
from __future__ import annotations

import json
import subprocess
import sys

import torch

from . import _build, gcl, gcl_bwd
from .ablate_chord_tail import time_ms

KERNEL = "gcl_bwd_data"
OUT = _build.BUILD_DIR.parent / "ablate_gcl_bwd_data"
FFMA_LOOP = "  for (int kc = 0; kc < BK / 4; ++kc) {"
GATHER = ("    gather_bar(sm, dgw[warp], dx + bar * bar_size, d, c0, warp, "
          "lane);\n")
STAGING = "      if (tid == 0 && (st + 1 < nstage || bar + nchunks < nbar))"
WAIT = "      mbar_wait(&sm.full[u & 1], (u >> 1) & 1);"
NO_FFMA = (FFMA_LOOP, FFMA_LOOP.replace("kc < BK / 4", "kc < 0"))
NO_SCATTERS = (GATHER, "")
VARIANTS = {
    "whole": [],
    "no_ffma": [NO_FFMA],
    "no_scatters": [NO_SCATTERS],
    # nbar > 0 where the kernel launches: no later stage is copied, and
    # only the first is waited for (a wait for a stage that never comes
    # would not end)
    "no_staging": [(STAGING, "      if (nbar < 0)"),
                   (WAIT, WAIT.replace("mbar_wait", "if (u == 0) mbar_wait"))],
    "loads_only": [NO_FFMA, NO_SCATTERS],
}


def inputs(nbar: int, d: int, device):
    """Seeded fp32 x (masked, 30 % of cells active), upstream g, aux, gate
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
    return [v.contiguous().to(device) for v in (x, up, aux, gates, wbig)]


def main(nbar: int = 128, d: int = 512) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the kernel runs on the card only")
    device = torch.device("cuda")
    x, up, aux, gates, wbig = inputs(nbar, d, device)
    f32 = torch.float32
    dx = torch.empty_like(x)
    part = torch.empty((nbar, 33 * d), dtype=f32, device=device)
    out = torch.empty(33 * d, dtype=f32, device=device)
    stream = _build.stream_handle(device)
    fns = _build.build_variants(KERNEL, VARIANTS, OUT)

    def run(name):
        _build.check(name, fns[name](
            *(v.data_ptr() for v in (x, up, aux, gates, wbig, dx, part, out)),
            nbar, d, d, stream))

    run("whole")
    want = gcl_bwd.gcl_bwd_data_plain(x, up, aux, gates, wbig)
    torch.cuda.synchronize()
    if not torch.allclose(dx, want[0], rtol=2e-4, atol=2e-4):
        raise SystemExit("the whole kernel's dx is off the plain version: "
                         f"{(dx - want[0]).abs().max().item():.3e}")
    rel = {}
    for n, a, b in (("dgate", out[:32 * d].view(32, d), want[1]),
                    ("dbias", out[32 * d:], want[2])):
        rel[n] = ((a - b).abs().max() / b.abs().max()).item()
        if not rel[n] <= 1e-4:
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
