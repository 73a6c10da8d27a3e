"""The kernel wrappers' launch counts (`ops/kernels/counts.py`) and the
names `kernels.launch_counts()` gives them, as the train CLI prints them
and chip_smoke's `kernels` line reads them. No kernel runs: the counts are
added by hand."""
import pytest

from polyphemus_tpu_torch.ops import kernels
from polyphemus_tpu_torch.ops.kernels import counts, gcl


@pytest.fixture
def fresh():
    saved, cols = dict(counts.launches), dict(gcl.col_launches)
    counts.reset()
    yield
    counts.restore(saved)
    gcl.col_launches.update(cols)


def test_counts_by_kernel_grid_and_layers(fresh):
    counts.count("gcl_eval", 32, 2)
    counts.count("gcl_eval", 32, 2)
    counts.count("gcl_eval", 32, 1)
    before = dict(counts.launches)
    counts.count("gcl_eval", 16, 2)
    counts.count("chord_tail", 16)
    assert counts.total("gcl_eval") == 3
    assert counts.total("gcl_eval", k=2) == 2
    assert counts.total("gcl_eval", 16) == 1
    assert counts.total("gcl_bwd_data") == 0
    assert counts.since(before) == {("gcl_eval", 16, 2): 1,
                                    ("chord_tail", 16, 1): 1}
    counts.restore(before)
    assert counts.launches == before
    counts.reset()
    assert counts.launches == {}


def test_launch_counts_names_each_grid_apart(fresh):
    for key in [("gcl_eval", 32, 2), ("gcl_eval", 32, 1), ("gcl_eval", 16, 2),
                ("gcl_eval", 16, 1), ("chord_tail_bf16", 48, 1),
                ("gcl_bwd_data", 32, 1)]:
        counts.count(*key)
    gcl.count_cols("gcl_eval", 256, 512)
    got = kernels.launch_counts()
    # every 4 x 32 name is there, launched or not
    assert {k: got[k] for k in kernels.KERNELS} == dict(
        dict.fromkeys(kernels.KERNELS, 0), gcl_eval=2, gcl_bwd_data=1)
    assert got["gcl_eval_s16"] == 2 and got["chord_tail_bf16_s48"] == 1
    assert got["gcl_eval_cols"] == gcl.col_launches["gcl_eval"]
    assert set(got) == set(kernels.KERNELS) | {
        "gcl_eval_s16", "chord_tail_bf16_s48"} | {
        f"{k}_cols" for k in gcl.COL_KERNELS}
