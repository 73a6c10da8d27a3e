"""The ctypes bindings of the port's CUDA kernels against their sources.

`ops/kernels/_build.SIGNATURES` names, for each kernel, the source under
`csrc/`, its C launcher and the launcher's argument types. The sources are
compiled only on a machine with nvcc, so these CPU tests read them as text:
every launcher is defined once in its source with the arguments ctypes
passes (a pointer where ctypes passes a pointer, an int where it passes an
int), and the fp32 eval GCL is bound to its own source."""
import re

import pytest

from polyphemus_tpu_torch.ops.kernels import _build


def launcher_params(name):
    source, fn, _ = _build.SIGNATURES[name]
    text = (_build.CSRC / f"{source}.cu").read_text()
    found = re.findall(r'extern "C" int ' + fn + r"\(([^)]*)\)", text)
    assert len(found) == 1, f"{fn} defined {len(found)} times in {source}.cu"
    return [p.strip() for p in found[0].split(",")]


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_launcher_takes_what_ctypes_passes(name):
    params = launcher_params(name)
    want = _build.SIGNATURES[name][2]
    assert len(params) == len(want)
    for p, t in zip(params, want):
        if t is _build.VP:
            assert re.match(r"(const )?void\* \w+$", p), p
        else:
            assert t is _build.INT and re.match(r"int \w+$", p), p


def test_fp32_eval_gcl_is_bound_to_its_own_source():
    """`gcl_eval` in fp32 binds `csrc/gcl_eval_fp32.cu`, and the training
    forward's source no longer defines an eval launcher of the same name."""
    assert _build.SIGNATURES["gcl_eval"][0] == "gcl_eval_fp32"
    assert "gcl_eval_launch" not in (_build.CSRC / "gcl_eval.cu").read_text()
