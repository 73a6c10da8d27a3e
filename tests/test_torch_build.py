"""The ctypes bindings of the port's CUDA kernels against their sources.

`ops/kernels/_build.SIGNATURES` names, for each kernel, the source under
`csrc/`, its C launcher and the launcher's argument types. The sources are
compiled only on a machine with nvcc, so these CPU tests read them as text:
every launcher is defined once in its source with the arguments ctypes
passes (a pointer where ctypes passes a pointer, an int where it passes an
int), each eval GCL source also holds its dtype's training forward, each
dtype of the fused backward has its own source (the bf16 one two kernels,
dH and dW, and no per-chunk dW partials), the fp32 weight backward is one
kernel with no partials, the fp32 data backward one kernel with TMA
stages and no atomics, and every text anchor of the ablation modules'
patches occurs exactly once in its source."""
import re

import pytest

from polyphemus_tpu_torch.ops.kernels import (_build, ablate_chord_tail,
                                              ablate_gcl_bwd_data,
                                              ablate_gcl_bwd_fused,
                                              ablate_gcl_bwd_weight,
                                              ablate_gcl_grid)


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
    """The eval GCL and the training forward share one source per dtype:
    `gcl_eval`/`gcl_fwd` bind `csrc/gcl_eval_fp32.cu`, `gcl_eval_bf16`/
    `gcl_fwd_bf16` bind `csrc/gcl_eval_bf16_tc.cu`, and every source that
    `SIGNATURES` names exists under `csrc/`."""
    sources = {name: sig[0] for name, sig in _build.SIGNATURES.items()}
    assert sources["gcl_eval"] == sources["gcl_fwd"] == "gcl_eval_fp32"
    assert (sources["gcl_eval_bf16"] == sources["gcl_fwd_bf16"]
            == "gcl_eval_bf16_tc")
    for source in set(sources.values()):
        assert (_build.CSRC / f"{source}.cu").is_file(), source


def test_fused_backward_is_bound_to_its_own_sources():
    """The fp32 fused backward binds `csrc/gcl_bwd_fused.cu` (FFMA), the
    bf16 one `csrc/gcl_bwd_fused_bf16_tc.cu` (the tensor-core dH product),
    and neither source exports the other's launcher."""
    sources = {name: sig[0] for name, sig in _build.SIGNATURES.items()}
    assert sources["gcl_bwd_fused"] == "gcl_bwd_fused"
    assert sources["gcl_bwd_fused_bf16"] == "gcl_bwd_fused_bf16_tc"
    for name, other in (("gcl_bwd_fused", "gcl_bwd_fused_bf16"),
                        ("gcl_bwd_fused_bf16", "gcl_bwd_fused")):
        text = (_build.CSRC / f"{sources[name]}.cu").read_text()
        assert _build.SIGNATURES[other][1] + "(" not in text


def test_bf16_fused_backward_source_holds_both_kernels():
    """`csrc/gcl_bwd_fused_bf16_tc.cu` defines the dH kernel and the dW
    kernel, and its launcher launches both; dWbig has no per-chunk partial
    (`part_w`) and is summed by no `sum_rows`, so the launcher takes one
    scratch pointer fewer than the fp32 form's (and, unlike it, the output
    width n of a column shard)."""
    text = (_build.CSRC / "gcl_bwd_fused_bf16_tc.cu").read_text()
    kernels = re.findall(r"__global__ void __launch_bounds__\([^)]*\)\s+(\w+)\(",
                         text)
    assert kernels == ["gcl_bwd_fused_bf16_tc_kernel",
                       "gcl_bwd_dw_bf16_tc_kernel"]
    for k in kernels:
        assert text.count(k + "<<<") == 1, k
    assert "part_w" not in text
    assert text.count("sum_rows(") == 1  # dgate and dbias only
    params = launcher_params("gcl_bwd_fused_bf16")

    def pointers(ps):
        return sum("void*" in p for p in ps)

    assert pointers(params) == pointers(launcher_params("gcl_bwd_fused")) - 1
    assert "void* part_gb" in params and "int n" in params


def test_fp32_weight_backward_is_one_kernel_without_partials():
    """`csrc/gcl_bwd_weight.cu` defines one kernel, launched once, that
    writes dWbig itself: no per-chunk partial (`part`), no chunk count and
    no `sum_rows` pass; its launcher takes x, g, aux, the gate table,
    dWbig, nbar, d, the output width n and the stream."""
    text = (_build.CSRC / "gcl_bwd_weight.cu").read_text()
    kernels = re.findall(r"__global__ void __launch_bounds__\([^)]*\)\s+(\w+)\(",
                         text)
    assert kernels == ["gcl_bwd_weight_kernel"]
    assert text.count("gcl_bwd_weight_kernel<<<") == 1
    assert "sum_rows" not in text
    assert not re.search(r"\bpart\b|nchunks", text)
    names = [p.rsplit(" ", 1)[-1] for p in launcher_params("gcl_bwd_weight")]
    assert names == ["x", "g", "aux", "gates", "dwbig", "nbar", "d", "n",
                     "stream"]


def test_fp32_data_backward_walks_its_bars_without_atomics():
    """`gcl_bwd_data` binds `csrc/gcl_bwd_data.cu`, which defines one
    kernel, launched once, whose CTAs walk a run of bars (`nchunks`, chosen
    by the launcher) with stages of TMA boxes; its scatters run as gathers,
    so the source holds no atomic, and one `sum_rows` pass adds the CTAs'
    dgate/dbias partial rows. The launcher takes x, g, aux, the gate table,
    wbig, dx, the partials' scratch, the output, nbar, d, the output
    width n and the stream,
    and the source reports its dynamic shared memory."""
    assert _build.SIGNATURES["gcl_bwd_data"][:2] == ("gcl_bwd_data",
                                                     "gcl_bwd_data_launch")
    text = (_build.CSRC / "gcl_bwd_data.cu").read_text()
    kernels = re.findall(r"__global__ void __launch_bounds__\([^)]*\)\s+(\w+)\(",
                         text)
    assert kernels == ["gcl_bwd_data_kernel"]
    assert text.count("gcl_bwd_data_kernel<<<") == 1
    assert text.count("sum_rows(") == 1
    assert "atomicAdd" not in text
    assert "load_2d(sm.st" in text and "load_3d(sm.st" in text
    assert "nchunks" in text
    assert 'extern "C" int gcl_bwd_data_smem_bytes()' in text
    names = [p.rsplit(" ", 1)[-1] for p in launcher_params("gcl_bwd_data")]
    assert names == ["x", "g", "aux", "gates", "wbig", "dx", "part", "out",
                     "nbar", "d", "n", "stream"]


@pytest.mark.parametrize("module", [ablate_chord_tail, ablate_gcl_bwd_data,
                                    ablate_gcl_bwd_fused,
                                    ablate_gcl_bwd_weight, ablate_gcl_grid],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_ablation_anchors_are_in_their_sources(module):
    """Each patch of each variant replaces text that occurs exactly once in
    the source the module ablates, so no later edit of the source turns a
    variant silently into the whole kernel (or patches two places)."""
    source = _build.SIGNATURES[module.KERNEL][0]
    text = (_build.CSRC / f"{source}.cu").read_text()
    assert module.VARIANTS["whole"] == []
    for name, patches in module.VARIANTS.items():
        for old, new in patches:
            assert text.count(old) == 1, (name, old)
            assert new != old, name
