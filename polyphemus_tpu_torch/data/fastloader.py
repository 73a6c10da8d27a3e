"""Zero-copy reader of a packed shard directory with a native batch gather.

A copy of `polyphemus_tpu/data/fastloader.py`. The shard .npz files
(np.savez: STORED zip members) are mmapped once and their members exposed as
numpy views; each batch's rows are gathered, and the tokens widened from
int16 to int32, by the C++ gather of `native/fastloader.cpp` on a few
threads. `gather_batch` is the batch-level hook that `BatchLoader` prefers
over per-sample `__getitem__`.

Unlike the JAX package there is no numpy fallback: `FastShardedBatcher`
builds the native library or raises. `gather_plain` is the gather in numpy,
the plain version the native one is held against; the batcher never calls
it. `gathers` counts the native gather's calls.
"""
from __future__ import annotations

import ast
import ctypes
import json
import mmap
import os
import struct
import zipfile
from typing import List, Sequence, Tuple

import numpy as np

from ..native import load_fastloader
from .sharded import INDEX_NAME

gathers = 0  # native gather calls


def _npz_member_views(path: str, members: Tuple[str, ...]):
    """mmap an uncompressed npz and return {name: ndarray view} (zero copy)."""
    f = open(path, "rb")
    mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    views = {}
    with zipfile.ZipFile(f) as zf:
        for info in zf.infolist():
            name = info.filename.removesuffix(".npy")
            if name not in members:
                continue
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError(
                    f"{path}:{info.filename} is compressed; fastloader needs "
                    "uncompressed shards (np.savez, not savez_compressed)")
            # local file header: data starts after 30-byte header + name +
            # extra (extra length may differ from the central directory's)
            ho = info.header_offset
            name_len, extra_len = struct.unpack_from("<HH", mm, ho + 26)
            payload = ho + 30 + name_len + extra_len
            # .npy header
            magic = mm[payload:payload + 6]
            if magic != b"\x93NUMPY":
                raise ValueError(f"{path}:{info.filename}: bad npy magic")
            major = mm[payload + 6]
            if major == 1:
                (hlen,) = struct.unpack_from("<H", mm, payload + 8)
                data_off = payload + 10 + hlen
                header = bytes(mm[payload + 10:payload + 10 + hlen])
            else:
                (hlen,) = struct.unpack_from("<I", mm, payload + 8)
                data_off = payload + 12 + hlen
                header = bytes(mm[payload + 12:payload + 12 + hlen])
            meta = ast.literal_eval(header.decode("latin-1").strip())
            dtype = np.dtype(meta["descr"])
            shape = meta["shape"]
            if meta.get("fortran_order"):
                raise ValueError("fortran-order npy not supported")
            count = int(np.prod(shape)) if shape else 1
            arr = np.frombuffer(mm, dtype=dtype, count=count,
                                offset=data_off).reshape(shape)
            views[name] = arr
    return views, mm, f


def _locate(offsets: Sequence[int], idxs: np.ndarray):
    """Global sample indices -> (shard ids, rows within the shard)."""
    shard_ids = np.searchsorted(offsets, idxs, side="right") - 1
    return shard_ids, idxs - np.asarray(offsets)[shard_ids]


def gather_plain(tok_views: Sequence[np.ndarray],
                 mask_views: Sequence[np.ndarray], offsets: Sequence[int],
                 idxs) -> Tuple[np.ndarray, np.ndarray]:
    """The batch gather in numpy: (tokens int32 (B, ...), mask bool (B, ...))
    of samples `idxs` of the shards whose views are given."""
    idxs = np.asarray(idxs, np.int64)
    shard_ids, row_ids = _locate(offsets, idxs)
    out_t = np.empty((len(idxs),) + tok_views[0].shape[1:], np.int32)
    out_m = np.empty((len(idxs),) + mask_views[0].shape[1:], bool)
    for k in range(len(idxs)):
        out_t[k] = tok_views[shard_ids[k]][row_ids[k]]
        out_m[k] = mask_views[shard_ids[k]][row_ids[k]]
    return out_t, out_m


class FastShardedBatcher:
    """Batch-level reader over a packed shard directory.

    gather_batch(idxs) -> (tokens int32 (B, ...), mask bool (B, ...)), both
    fresh arrays (never views of the mmapped shards).
    """

    def __init__(self, directory: str, n_threads: int = 4):
        with open(os.path.join(directory, INDEX_NAME)) as f:
            self.index = json.load(f)
        self.n_threads = n_threads
        self._lib = load_fastloader()
        self._keepalive: List = []
        self.tok_views: List[np.ndarray] = []
        self.mask_views: List[np.ndarray] = []
        self.offsets: List[int] = []
        off = 0
        for sh in self.index["shards"]:
            views, mm, f = _npz_member_views(
                os.path.join(directory, sh["file"]), ("tokens", "mask"))
            self._keepalive.append((mm, f))
            # The C++ gather reads int16 token rows and 1-byte mask rows;
            # any other dtype would be misread into corrupted batches.
            if views["tokens"].dtype != np.int16:
                raise ValueError(
                    f"{sh['file']}: tokens dtype {views['tokens'].dtype}, "
                    "expected int16 (pack_dataset writes int16; the native "
                    "gather reads int16 rows)")
            if views["mask"].dtype != np.bool_:
                raise ValueError(
                    f"{sh['file']}: mask dtype {views['mask'].dtype}, "
                    "expected bool")
            # the gather reads up to the index's count of rows of the
            # first shard's shape from each shard
            if len(views["tokens"]) != sh["n"] or len(views["mask"]) != sh["n"]:
                raise ValueError(
                    f"{sh['file']}: tokens {views['tokens'].shape}, mask "
                    f"{views['mask'].shape}; the index says {sh['n']} samples")
            self.tok_views.append(views["tokens"])
            self.mask_views.append(views["mask"])
            self.offsets.append(off)
            off += sh["n"]
        self.total = off
        self.sample_tok_shape = self.tok_views[0].shape[1:]
        self.sample_mask_shape = self.mask_views[0].shape[1:]
        for sh, t, m in zip(self.index["shards"], self.tok_views,
                            self.mask_views):
            if (t.shape[1:], m.shape[1:]) != (self.sample_tok_shape,
                                              self.sample_mask_shape):
                raise ValueError(
                    f"{sh['file']}: samples of tokens {t.shape[1:]}, mask "
                    f"{m.shape[1:]}; the first shard's are "
                    f"{self.sample_tok_shape}, {self.sample_mask_shape}")
        self._tok_elems = int(np.prod(self.sample_tok_shape))
        self._mask_bytes = int(np.prod(self.sample_mask_shape))
        n = len(self.tok_views)
        self._tok_bases = (ctypes.c_void_p * n)(
            *[v.ctypes.data for v in self.tok_views])
        self._mask_bases = (ctypes.c_void_p * n)(
            *[v.ctypes.data for v in self.mask_views])

    def __len__(self):
        return self.total

    def __getitem__(self, idx: int):
        toks, mask = self.gather_batch(np.asarray([idx]))
        return toks[0], mask[0]

    def gather_batch(self, idxs):
        global gathers
        idxs = np.asarray(idxs, np.int64)
        if idxs.size and (idxs.min() < 0 or idxs.max() >= self.total):
            raise IndexError(f"sample index out of range [0, {self.total})")
        shard_ids, row_ids = _locate(self.offsets, idxs)
        b = len(idxs)
        out_t = np.empty((b,) + self.sample_tok_shape, np.int32)
        out_m = np.empty((b,) + self.sample_mask_shape, np.uint8)
        sid = np.ascontiguousarray(shard_ids, np.int64)
        rid = np.ascontiguousarray(row_ids, np.int64)
        self._lib.poly_gather_batch(
            sid.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            rid.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int64(b), self._tok_bases, self._mask_bases,
            ctypes.c_int64(self._tok_elems),
            ctypes.c_int64(self._mask_bytes),
            out_t.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            out_m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int32(self.n_threads))
        gathers += 1
        return out_t, out_m.view(bool)
