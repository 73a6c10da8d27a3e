"""Take the fp32 GCL weight backward apart on the card.

    python -m polyphemus_tpu_torch.ops.kernels.ablate_gcl_bwd_weight [NBAR] [D]

Builds patched copies of `csrc/gcl_bwd_weight.cu` into
`build/ablate_gcl_bwd_weight/`, one library each, and times them in turns
on the same inputs (NBAR bars, default 128, the fp32 training microbatch,
at width D, default 512). Variants: the whole kernel; without its FFMAs
(the product and its shared-memory reads); without its rebuild of the
messages (the FFMAs read stale tiles); without its asynchronous staging
(only bar 0 is copied in; later bars read stale stages); and its loads
only (staging and the statics' decode, no rebuild, no FFMAs). A patched
copy computes a wrong dWbig; only the whole kernel is checked: within
1e-4 x max |plain| of `gcl_bwd_weight_plain`. Prints one JSON line: ms per
launch, two rounds each, the card's name and power limit.
"""
from __future__ import annotations

import json
import subprocess
import sys

import torch

from . import _build, gcl, gcl_bwd
from .ablate_chord_tail import time_ms

KERNEL = "gcl_bwd_weight"
OUT = _build.BUILD_DIR.parent / "ablate_gcl_bwd_weight"
FFMA_LOOP = "    for (int kk = 0; kk < S; ++kk) {"
REBUILD = "  for (int it = tid; it < S * CT / 4; it += THREADS) {"
STAGING = "    if (bar + 1 < nbar) stage(bar + 1);"
NO_FFMA = (FFMA_LOOP, FFMA_LOOP.replace("kk < S", "kk < 0"))
NO_REBUILD = (REBUILD, REBUILD.replace("it = tid", "it = S * CT / 4"))
VARIANTS = {
    "whole": [],
    "no_ffma": [NO_FFMA],
    "no_rebuild": [NO_REBUILD],
    # nbar > 0 where the kernel launches: the condition never holds
    "no_staging": [(STAGING, STAGING.replace("bar + 1 < nbar", "nbar < 0"))],
    "loads_only": [NO_FFMA, NO_REBUILD],
}


def inputs(nbar: int, d: int, device):
    """Seeded fp32 x (masked, 30 % of cells active), upstream g, aux and
    gate table of one training GCL layer."""
    g = torch.Generator().manual_seed(0)
    mask = torch.rand(nbar, 4, 32, generator=g) < 0.3
    mask[:, :, 0] = True
    x = torch.randn(nbar, 128, d, generator=g) * mask.reshape(nbar, 128, 1)
    up = torch.randn(nbar, 128, d, generator=g)
    aux = gcl.build_kernel_aux(mask).reshape(nbar, gcl.N_AUX, 128)
    gates = torch.randn(32, d, generator=g) * 0.3
    return [v.contiguous().to(device) for v in (x, up, aux, gates)]


def main(nbar: int = 128, d: int = 512) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the kernel runs on the card only")
    device = torch.device("cuda")
    x, up, aux, gates = inputs(nbar, d, device)
    dwbig = torch.empty((8 * d, d), dtype=torch.float32, device=device)
    stream = _build.stream_handle(device)
    fns = _build.build_variants(KERNEL, VARIANTS, OUT)

    def run(name):
        _build.check(name, fns[name](
            *(v.data_ptr() for v in (x, up, aux, gates, dwbig)), nbar, d, d,
            stream))

    run("whole")
    want = gcl_bwd.gcl_bwd_weight_plain(x, up, aux, gates)
    rel = ((dwbig - want).abs().max() / want.abs().max()).item()
    if not rel <= 1e-4:
        raise SystemExit(f"the whole kernel's dWbig is {rel:.3e} x max "
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
