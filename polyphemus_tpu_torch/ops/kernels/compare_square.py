"""Hold this checkout's square GCL launches (output width n = d) to another
checkout's, bit for bit, on the card.

    python -m polyphemus_tpu_torch.ops.kernels.compare_square OTHER_ROOT

OTHER_ROOT is a directory that holds another checkout's
`polyphemus_tpu_torch` (for one commit: `git archive COMMIT
polyphemus_tpu_torch | tar -x -C build/other`). Each package runs in a
process of its own, building its kernels from its own sources, on the same
seeded inputs (128 bars, d = 512): `gcl_fwd` and `gcl_eval` at K = 1 and 2
and `gcl_bwd_fused` in fp32 and bf16, `gcl_bwd_data` and `gcl_bwd_weight`.
Prints one JSON line: for each output whether the two are equal (a list
for a tuple of outputs), and the card's name and power limit. The sums
that the fused backwards add by atomics (dgate; dx in fp32) need not
repeat bit for bit even between two launches of one build.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
THIS_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))


def square_outputs(root: str, out_path: str) -> None:
    """The square launches of the package under `root`, saved to
    out_path."""
    sys.path.insert(0, root)
    from polyphemus_tpu_torch.ops.kernels import gcl, gcl_bwd

    if not gcl.__file__.startswith(os.path.abspath(root)):
        raise SystemExit(f"imported {gcl.__file__}, not the package under "
                         f"{root}")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(7)
    nbar, d = 128, 512
    mask = torch.rand(nbar, 4, 32, generator=g) < 0.3
    mask[:, :, 0] = True
    x = torch.randn(nbar, 128, d, generator=g) * mask.reshape(nbar, 128, 1)
    up = torch.randn(nbar, 128, d, generator=g)
    aux = gcl.build_kernel_aux(mask).reshape(nbar, gcl.N_AUX, 128)
    gates = torch.randn(32, d, generator=g) * 0.3
    w = torch.stack([gcl.pack_weights(
        torch.randn(6, d, d, generator=g) * d ** -0.5,
        torch.randn(d, d, generator=g) * d ** -0.5, 4) for _ in range(2)])
    b, ea, eb = (torch.randn(2, d, generator=g) * 0.1 + o for o in (0, 1, 0))
    x, up, aux, gates, w, b, ea, eb = (
        v.contiguous().to(dev) for v in (x, up, aux, gates, w, b, ea, eb))
    res = {}
    for dt in (torch.float32, torch.bfloat16):
        k = "fp32" if dt == torch.float32 else "bf16"
        X, U, G, W, B, EA, EB = (v.to(dt) for v in (x, up, gates, w, b, ea,
                                                      eb))
        res[f"gcl_fwd_{k}"] = gcl.gcl_fwd(X, aux, G, W[0].contiguous(),
                                          B[0].contiguous())
        res[f"gcl_eval_k1_{k}"] = gcl.gcl_eval(
            X, aux, G, *(v[:1].contiguous() for v in (W, B, EA, EB)))
        res[f"gcl_eval_k2_{k}"] = gcl.gcl_eval(X, aux, G, W, B, EA, EB)
        res[f"gcl_bwd_fused_{k}"] = gcl_bwd.gcl_bwd_fused(
            X, U, aux, G, W[0].contiguous())
    res["gcl_bwd_data"] = gcl_bwd.gcl_bwd_data(x, up, aux, gates,
                                               w[0].contiguous())
    res["gcl_bwd_weight"] = gcl_bwd.gcl_bwd_weight(x, up, aux, gates)
    torch.cuda.synchronize()
    torch.save({k: [t.cpu() for t in v] if isinstance(v, tuple) else v.cpu()
                for k, v in res.items()}, out_path)


def main(other_root: str) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the kernels run on the card only")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    other_root = os.path.abspath(other_root)
    build = os.path.join(THIS_ROOT, "build")
    os.makedirs(build, exist_ok=True)
    outs = {}
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        for name, root in (("other", other_root), ("this", THIS_ROOT)):
            outs[name] = os.path.join(tmp, f"{name}.pt")
            # this file as a script, so that the package it imports is
            # the one under `root`
            run = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--square", root,
                 outs[name]], cwd=root, capture_output=True, text=True,
                timeout=600)
            if run.returncode != 0:
                raise SystemExit(f"{root}: {run.stdout[-2000:]}\n"
                                 f"{run.stderr[-4000:]}")
        a, b = (torch.load(outs[k]) for k in ("other", "this"))
    equal = {k: ([bool(torch.equal(p, q)) for p, q in zip(v, b[k])]
                 if isinstance(v, list) else bool(torch.equal(v, b[k])))
             for k, v in a.items()}
    res = {"other": other_root, "equal": equal,
           "card": card}
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    if sys.argv[1:2] == ["--square"]:
        square_outputs(sys.argv[2], sys.argv[3])
    else:
        main(sys.argv[1])
