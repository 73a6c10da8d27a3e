"""Take the bf16 chord-tail kernel apart on the card.

    python -m polyphemus_tpu_torch.ops.kernels.ablate_chord_tail [NBAR] [D]

Builds patched copies of `csrc/chord_tail_bf16_tc.cu` into
`build/ablate_chord_tail/`, one library each, and times them in turns on the
same inputs (NBAR bars, default 512, at width D, default 512): the whole
kernel, and the kernel without the projection's MMAs, without the unembed's
MMAs, without the copies into shared memory (the stages are not waited for
and hold whatever they held), and without any of them. A patched copy
computes wrong ids; only the whole kernel is checked: it must give
`chord_tail_plain`'s ids on 99.9 % of them (near-ties may differ). Prints
one JSON line: ms per launch, two rounds each, the card's name and power
limit.
"""
from __future__ import annotations

import json
import subprocess
import sys

import torch

from . import _build, chord_tail

KERNEL = "chord_tail_bf16"
OUT = _build.BUILD_DIR.parent / "ablate_chord_tail"
PROJ_MMA = """            mma_bf16(acc[mi][2 * jp], a[mi], b[0], b[1]);
            mma_bf16(acc[mi][2 * jp + 1], a[mi], b[2], b[3]);"""
UNEMBED_MMA = """          mma_bf16(lg[2 * jp], a[p], b[0], b[1]);
          mma_bf16(lg[2 * jp + 1], a[p], b[2], b[3]);"""
WAIT = "  mbar_wait(cx.bars + q % NSTAGE, (q / NSTAGE) & 1);\n"
START = "  if (cx.tid != 0 || item >= cx.nitems) return;"
NO_COPY = [(WAIT, ""), (START, "  return;")]
VARIANTS = {
    "whole": [],
    "no_projection_mma": [(PROJ_MMA, "")],
    "no_unembed_mma": [(UNEMBED_MMA, "")],
    "no_copies": NO_COPY,
    "no_mma_no_copies": NO_COPY + [(PROJ_MMA, ""), (UNEMBED_MMA, "")],
}


def inputs(nbar: int, d: int, device):
    """Seeded bf16 x (every cell active) and weights at the model's
    vocabularies (131 pitch, 99 duration tokens)."""
    g = torch.Generator().manual_seed(0)
    h = d // 2
    shapes = [(nbar, 4, 32, d), (d, 15 * d), (15 * d,), (h, 131), (131,),
              (h, 131), (131,), (h, 99), (99,)]
    scales = [1.0, d ** -0.5, 0.1, h ** -0.5, 0.1, h ** -0.5, 0.1,
              h ** -0.5, 0.1]
    return [(torch.randn(s, generator=g) * c).bfloat16().to(device)
            for s, c in zip(shapes, scales)]


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


def main(nbar: int = 512, d: int = 512) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the kernel runs on the card only")
    device = torch.device("cuda")
    args = inputs(nbar, d, device)
    ops = chord_tail.pack(torch.bfloat16, *args[1:])
    ids = torch.empty(nbar, 4, 32, 15, 2, dtype=torch.int32, device=device)
    stream = _build.stream_handle(device)
    fns = _build.build_variants(KERNEL, VARIANTS, OUT)

    def run(name):
        _build.check(name, fns[name](
            args[0].data_ptr(), *(a.data_ptr() for a in ops), ids.data_ptr(),
            nbar, 32, d, 15, 131, 99, stream))

    run("whole")
    want = chord_tail.chord_tail_plain(*args, n_slots=15)
    agree = (ids == want).float().mean().item()
    if agree < 0.999:
        raise SystemExit(f"the whole kernel agrees with the plain ids on "
                         f"{agree:.4%} only")
    times = {name: [] for name in VARIANTS}
    for order in (list(VARIANTS), list(VARIANTS)[::-1]):
        for name in order:
            times[name].append(time_ms(lambda: run(name)))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    res = {"nbar": nbar, "d": d, "card": card,
           "ids_equal_plain": agree, "ms": times}
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:3]))
