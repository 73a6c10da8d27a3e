"""The port's packed-shard format and native batch gather against the JAX
package's, on the same directory: `pack_dataset` (the index by value, the
shards array by array: np.savez stamps zip times), `ShardedDataset` and
`FastShardedBatcher` row by row across shard boundaries; the native gather
(built here by g++) against the plain numpy gather; the refusal of a
compressed shard, of int32 tokens and of shards that disagree with the
index or with each other; `BatchLoader` taking `gather_batch`,
also through `cli.train`'s subset view; `ShardedDataset` under the
loader's threads; a failed native build raising instead of falling
back."""
import json
import os

import numpy as np
import pytest

from polyphemus_tpu.data import fastloader as jfast
from polyphemus_tpu.data import sharded as jsharded
from polyphemus_tpu_torch import native
from polyphemus_tpu_torch.cli import train as train_cli
from polyphemus_tpu_torch.data import BatchLoader, PolyphemusDataset
from polyphemus_tpu_torch.data import fastloader as pfast
from polyphemus_tpu_torch.data import sharded as psharded
from polyphemus_tpu_torch.data.preprocess import save_npz_uncompressed

from . import torch_port_case  # noqa: F401  (one torch thread a worker)

N, SHARD = 37, 8


def make_sample_dir(directory, n=N, n_bars=2, seed=0):
    """n reference-format samples; sample 3 has a bar without any onset
    (the loader's fix-up sets its cell [0, 0])."""
    os.makedirs(directory)
    rng = np.random.default_rng(seed)
    for i in range(n):
        c = rng.integers(0, 90, (4, n_bars * 32, 16, 2)).astype(np.int16)
        s = rng.random((4, n_bars * 32)) < 0.2
        if i == 3:
            s[:, 32:64] = False
        save_npz_uncompressed(os.path.join(directory, f"s{i:03d}"),
                              c_tensor=c, s_tensor=s)
    return str(directory)


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    """(sample dir, the port's packed dir, JAX's packed dir)."""
    tmp = tmp_path_factory.mktemp("sharded")
    src = make_sample_dir(tmp / "samples")
    assert psharded.pack_dataset(src, str(tmp / "port"), 2, SHARD) == N
    assert jsharded.pack_dataset(src, str(tmp / "jax"), 2, SHARD) == N
    return src, str(tmp / "port"), str(tmp / "jax")


def test_pack_dataset_matches_jax(packed):
    _, port, jax_dir = packed
    with open(os.path.join(port, psharded.INDEX_NAME)) as f:
        index = json.load(f)
    with open(os.path.join(jax_dir, jsharded.INDEX_NAME)) as f:
        assert index == json.load(f)
    assert [s["n"] for s in index["shards"]] == [8, 8, 8, 8, 5]
    assert sorted(os.listdir(port)) == sorted(os.listdir(jax_dir))
    for sh in index["shards"]:
        with np.load(os.path.join(port, sh["file"])) as a, \
                np.load(os.path.join(jax_dir, sh["file"])) as b:
            assert sorted(a.files) == sorted(b.files) == ["mask", "tokens"]
            for k in a.files:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


def test_sharded_dataset_and_batcher_match_jax(packed):
    src, port, jax_dir = packed
    per_sample = PolyphemusDataset(src, 2)
    ds = psharded.ShardedDataset(port, n_bars=2)
    jds = jsharded.ShardedDataset(jax_dir, n_bars=2)
    fast = pfast.FastShardedBatcher(port, n_threads=2)
    jfast_ = jfast.FastShardedBatcher(jax_dir, n_threads=2)
    assert len(ds) == len(jds) == len(fast) == len(jfast_) == N
    for i in range(N):
        t, m = ds[i]
        jt, jm = jds[i]
        np.testing.assert_array_equal(t, jt)
        np.testing.assert_array_equal(m, jm)
        pt, pm = per_sample[i]
        np.testing.assert_array_equal(t, pt)
        np.testing.assert_array_equal(m, pm)
    # sample 3's silent bar: the fix-up's cell [0, 0] alone
    assert ds[3][1][1].sum() == 1 and ds[3][1][1, 0, 0]
    # batches across shard boundaries, repeats, the last (short) shard
    idxs = np.asarray([0, 7, 8, 9, 15, 16, 36, 35, 3, 3, 24, 31, 32])
    toks, mask = fast.gather_batch(idxs)
    jtoks, jmask = jfast_.gather_batch(idxs)
    assert toks.dtype == np.int32 and mask.dtype == bool
    np.testing.assert_array_equal(toks, jtoks)
    np.testing.assert_array_equal(mask, jmask)
    t, m = fast[36]
    np.testing.assert_array_equal(t, ds[36][0])
    np.testing.assert_array_equal(m, ds[36][1])
    with pytest.raises(ValueError, match="n_bars"):
        psharded.ShardedDataset(port, n_bars=16)
    with pytest.raises(IndexError):
        ds[N]


def test_sharded_dataset_serves_batch_loader_threads(packed):
    """BatchLoader's 8 threads on a one-shard LRU, switching threads every
    microsecond: every batch holds the rows it names (JAX's
    ShardedDataset loses an evicted shard under this load)."""
    import sys

    plain = psharded.ShardedDataset(packed[1])
    want = [plain[i] for i in range(N)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for seed in range(5):
            loader = BatchLoader(
                psharded.ShardedDataset(packed[1], cache_shards=1), 4,
                seed=seed, num_workers=8)
            order = np.arange(N)
            np.random.default_rng(seed).shuffle(order)
            for b, (toks, mask) in enumerate(loader):
                for k, i in enumerate(order[4 * b:4 * b + 4]):
                    np.testing.assert_array_equal(toks[k], want[i][0])
                    np.testing.assert_array_equal(mask[k], want[i][1])
    finally:
        sys.setswitchinterval(interval)


def test_native_gather_matches_the_plain_gather(packed):
    fast = pfast.FastShardedBatcher(packed[1], n_threads=4)
    rng = np.random.default_rng(1)
    before = pfast.gathers
    for b in (1, 5, 8, 37, 64):  # one thread below 8 samples, 4 above
        idxs = rng.integers(0, N, b)
        toks, mask = fast.gather_batch(idxs)
        ptoks, pmask = pfast.gather_plain(fast.tok_views, fast.mask_views,
                                          fast.offsets, idxs)
        np.testing.assert_array_equal(toks, ptoks)
        np.testing.assert_array_equal(mask, pmask)
        assert ptoks.dtype == np.int32 and pmask.dtype == bool
    assert pfast.gathers == before + 5
    # fresh arrays, not views of the mmapped shards
    assert toks.flags.writeable and toks.base is None
    with pytest.raises(IndexError):
        fast.gather_batch([0, N])


def test_batcher_refuses_what_the_native_gather_cannot_read(tmp_path,
                                                            packed):
    port = packed[1]
    with open(os.path.join(port, psharded.INDEX_NAME)) as f:
        index = json.load(f)
    shard = os.path.join(port, index["shards"][0]["file"])
    with np.load(shard) as z:
        toks, mask = z["tokens"], z["mask"]
    for name, save, arrays, match in (
            ("compressed", np.savez_compressed, (toks, mask), "compressed"),
            ("int32", np.savez, (toks.astype(np.int32), mask), "int16"),
            ("uint8_mask", np.savez, (toks, mask.astype(np.uint8)), "bool")):
        d = tmp_path / name
        d.mkdir()
        save(d / "shard_00000.npz", tokens=arrays[0], mask=arrays[1])
        (d / psharded.INDEX_NAME).write_text(json.dumps(
            {"n_bars": 2, "shard_size": SHARD,
             "shards": [{"file": "shard_00000.npz", "n": len(toks)}]}))
        with pytest.raises(ValueError, match=match):
            pfast.FastShardedBatcher(str(d))
        with pytest.raises(ValueError, match=match):
            jfast.FastShardedBatcher(str(d))
    # rows the gather would read past a shard's end, or of another shape:
    # refused here (the JAX package reads them)
    for name, n, shard_toks, match in (
            ("short", len(toks) + 1, toks, "the index says"),
            ("wide", len(toks), np.concatenate([toks, toks], axis=1),
             "the first shard's")):
        d = tmp_path / name
        d.mkdir()
        np.savez(d / "shard_00000.npz", tokens=toks, mask=mask)
        np.savez(d / "shard_00001.npz", tokens=shard_toks[:4], mask=mask[:4])
        (d / psharded.INDEX_NAME).write_text(json.dumps(
            {"n_bars": 2, "shard_size": SHARD,
             "shards": [{"file": "shard_00000.npz", "n": n},
                        {"file": "shard_00001.npz", "n": 4}]}))
        with pytest.raises(ValueError, match=match):
            pfast.FastShardedBatcher(str(d))


class Spy:
    """A batcher that records how it was read."""

    def __init__(self, inner):
        self.inner, self.rows, self.batches = inner, 0, []

    def __len__(self):
        return len(self.inner)

    def __getitem__(self, i):
        self.rows += 1
        return self.inner[i]

    def gather_batch(self, idxs):
        self.batches.append(np.asarray(idxs))
        return self.inner.gather_batch(idxs)


def test_batch_loader_takes_gather_batch_through_the_cli_subset(packed):
    fast = pfast.FastShardedBatcher(packed[1])
    plain = psharded.ShardedDataset(packed[1])
    spy = Spy(fast)
    idxs = np.random.default_rng(2).permutation(N)[:24]
    subset = train_cli._Subset(spy, idxs)
    batches = list(BatchLoader(subset, 8, shuffle=True, seed=3,
                               num_workers=2))
    assert len(batches) == 3 and spy.rows == 0
    assert len(spy.batches) == 3
    # the batches read each of the subset's rows once
    seen = np.concatenate(spy.batches)
    assert sorted(seen.tolist()) == sorted(idxs.tolist())
    for (toks, mask), rows in zip(batches, spy.batches):
        assert toks.dtype == np.int32 and toks.shape[0] == 8
        for k, i in enumerate(rows):
            np.testing.assert_array_equal(toks[k], plain[int(i)][0])
            np.testing.assert_array_equal(mask[k], plain[int(i)][1])
    # the same batches as the per-row path of the same subset and seed
    rows = list(BatchLoader(train_cli._Subset(plain, idxs), 8, shuffle=True,
                            seed=3, num_workers=2))
    for (a, am), (b, bm) in zip(batches, rows):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(am, bm)


def test_failed_native_build_raises(tmp_path, monkeypatch, packed):
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_libs", {})
    with pytest.raises(RuntimeError, match="no-such-g"):
        native.load_fastloader()
    with pytest.raises(RuntimeError, match="no-such-g"):
        pfast.FastShardedBatcher(packed[1])
    assert not list((tmp_path / "build").glob("*.so"))


def test_native_library_is_named_by_source_and_flags(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_libs", {})
    lib = native.load_fastloader()
    built = native.library_path("fastloader.cpp")
    assert built.parent == tmp_path and built.exists()
    assert [p.name for p in tmp_path.iterdir()] == [built.name]  # no .tmp
    assert native.load_fastloader() is lib
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ["-O2"])
    assert native.library_path("fastloader.cpp") != built
