"""Build and load the port's CUDA kernels.

Each `csrc/<source>.cu` exports plain C launchers (one or more; `SIGNATURES`
maps each kernel name to its source and launcher). At first use it is
compiled by `nvcc` for Hopper (`sm_90a`) into a shared library under
`build/polyphemus_tpu_torch/` beside the package, named by a hash of the
source and the shared headers (`csrc/*.cuh`) so a stale build is never picked
up, and loaded with `ctypes`. No PyTorch header is compiled, so a build takes
seconds.

Every launcher returns `cudaGetLastError()` after its launch; `check` turns
a non-zero code into an exception. Nothing here runs when a module is
imported: the CPU tests import every module without a CUDA toolchain.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "polyphemus_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

VP, INT = ctypes.c_void_p, ctypes.c_int
# kernel name -> (source stem, launcher, argtypes); each launcher returns an
# int CUDA error code
SIGNATURES = {
    "gcl_eval": ("gcl_eval_fp32", "gcl_eval_launch",
                 [VP] * 9 + [INT] * 5 + [VP]),
    "gcl_eval_bf16": ("gcl_eval_bf16_tc", "gcl_eval_bf16_launch",
                      [VP] * 9 + [INT] * 5 + [VP]),
    "gcl_fwd": ("gcl_eval_fp32", "gcl_fwd_launch",
                [VP] * 6 + [INT] * 3 + [VP]),
    "gcl_fwd_bf16": ("gcl_eval_bf16_tc", "gcl_fwd_bf16_launch",
                     [VP] * 6 + [INT] * 3 + [VP]),
    # the eval form at bar grids of 4 x S cells other than S = 32
    "gcl_eval_grid": ("gcl_eval_grid_fp32", "gcl_eval_grid_launch",
                      [VP] * 9 + [INT] * 6 + [VP]),
    "gcl_eval_grid_bf16": ("gcl_eval_grid_bf16_tc",
                           "gcl_eval_grid_bf16_launch",
                           [VP] * 9 + [INT] * 6 + [VP]),
    # the eval layer at bars of 4 x S cells above S = 48, one layer a launch
    # (nbar, S, d, n, c0)
    "gcl_eval_long": ("gcl_eval_long_fp32", "gcl_eval_long_launch",
                      [VP] * 8 + [INT] * 5 + [VP]),
    "gcl_eval_long_bf16": ("gcl_eval_long_bf16_tc",
                           "gcl_eval_long_bf16_launch",
                           [VP] * 8 + [INT] * 5 + [VP]),
    # the training kernels at bar grids of 4 x S cells other than S = 32
    "gcl_fwd_grid": ("gcl_eval_grid_fp32", "gcl_fwd_grid_launch",
                     [VP] * 6 + [INT] * 4 + [VP]),
    "gcl_fwd_grid_bf16": ("gcl_eval_grid_bf16_tc", "gcl_fwd_grid_bf16_launch",
                          [VP] * 6 + [INT] * 4 + [VP]),
    "gcl_bwd_data_grid": ("gcl_bwd_data_grid", "gcl_bwd_data_grid_launch",
                          [VP] * 8 + [INT] * 4 + [VP]),
    "gcl_bwd_weight_grid": ("gcl_bwd_weight_grid",
                            "gcl_bwd_weight_grid_launch",
                            [VP] * 5 + [INT] * 4 + [VP]),
    "gcl_bwd_fused_grid_bf16": ("gcl_bwd_fused_grid_bf16_tc",
                                "gcl_bwd_fused_grid_bf16_launch",
                                [VP] * 9 + [INT] * 5 + [VP]),
    # the training kernels at bars of 4 x S cells above S = 48 (bf16: the
    # training forward and the split backward, as JAX trains there)
    "gcl_fwd_long": ("gcl_eval_long_fp32", "gcl_fwd_long_launch",
                     [VP] * 6 + [INT] * 4 + [VP]),
    "gcl_fwd_long_bf16": ("gcl_eval_long_bf16_tc", "gcl_fwd_long_bf16_launch",
                          [VP] * 6 + [INT] * 4 + [VP]),
    "gcl_bwd_data_long": ("gcl_bwd_data_long", "gcl_bwd_data_long_launch",
                          [VP] * 9 + [INT] * 4 + [VP]),
    "gcl_bwd_data_long_bf16": ("gcl_bwd_data_long",
                               "gcl_bwd_data_long_bf16_launch",
                               [VP] * 9 + [INT] * 4 + [VP]),
    "gcl_bwd_weight_long": ("gcl_bwd_weight_long",
                            "gcl_bwd_weight_long_launch",
                            [VP] * 5 + [INT] * 4 + [VP]),
    "gcl_bwd_weight_long_bf16": ("gcl_bwd_weight_long",
                                 "gcl_bwd_weight_long_bf16_launch",
                                 [VP] * 5 + [INT] * 4 + [VP]),
    "gcl_bwd_data": ("gcl_bwd_data", "gcl_bwd_data_launch",
                     [VP] * 8 + [INT] * 3 + [VP]),
    "gcl_bwd_weight": ("gcl_bwd_weight", "gcl_bwd_weight_launch",
                       [VP] * 5 + [INT] * 3 + [VP]),
    "gcl_bwd_fused": ("gcl_bwd_fused", "gcl_bwd_fused_launch",
                      [VP] * 10 + [INT] * 3 + [VP]),
    "gcl_bwd_fused_bf16": ("gcl_bwd_fused_bf16_tc",
                           "gcl_bwd_fused_bf16_launch",
                           [VP] * 9 + [INT] * 4 + [VP]),
    "chord_tail": ("chord_tail_fp32", "chord_tail_fp32_launch",
                   [VP] * 6 + [INT] * 6 + [VP]),
    "chord_tail_bf16": ("chord_tail_bf16_tc", "chord_tail_bf16_launch",
                        [VP] * 6 + [INT] * 6 + [VP]),
}

_launchers: dict = {}
_logs: dict = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(source: str) -> tuple[Path, Path]:
    src = CSRC / f"{source}.cu"
    h = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return src, BUILD_DIR / f"lib{source}-{h.hexdigest()[:12]}.so"


def _compile_cmd(src: Path, out: Path) -> list:
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)]


def build(names=tuple(SIGNATURES)) -> dict:
    """Compile the sources of the named kernels that are not built yet, one
    `nvcc` process per source, all started together. Returns {source:
    compiler log}; raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = sorted({SIGNATURES[n][0] for n in names})
    procs = {}
    for name in sources:
        src, out = _target(name)
        if out.exists():
            _logs.setdefault(name, "(cached)")
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            _compile_cmd(src, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        _logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {n: _logs.get(n, "") for n in sources}


def library(name: str) -> Path:
    """The shared library that holds kernel `name` once it is built."""
    return _target(SIGNATURES[name][0])[1]


def launcher(name: str):
    """The C launcher of kernel `name`, building its source at first use."""
    with _lock:
        fn = _launchers.get(name)
        if fn is not None:
            return fn
        _, fn_name, argtypes = SIGNATURES[name]
        out = library(name)
        if not out.exists():
            build((name,))
        fn = getattr(ctypes.CDLL(str(out)), fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _launchers[name] = fn
        return fn


def build_variants(name: str, variants: dict, out: Path) -> dict:
    """Patched copies of kernel `name`'s source, for taking it apart on the
    card: `variants` maps a variant to its (old, new) text replacements,
    each `old` occurring exactly once in the source. Writes each copy into
    `out`, compiles them all in parallel and returns {variant: launcher}."""
    source, fn_name, argtypes = SIGNATURES[name]
    src = (CSRC / f"{source}.cu").read_text()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for variant, patches in variants.items():
        text = src
        for old, new in patches:
            if text.count(old) != 1:
                raise RuntimeError(f"{variant}: the source holds {old!r} "
                                   f"{text.count(old)} times, not once")
            text = text.replace(old, new)
        path = out / f"{variant}.cu"
        path.write_text(text)
        # the source's own directory for its includes
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC),
               "-o", str(out / f"lib{variant}.so"), str(path)]
        procs[variant] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True)
    fns = {}
    for variant, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {variant}:\n{log}")
        fn = getattr(ctypes.CDLL(str(out / f"lib{variant}.so")), fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[variant] = fn
    return fns


def check(name: str, err: int) -> None:
    """Raise if a launcher reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
