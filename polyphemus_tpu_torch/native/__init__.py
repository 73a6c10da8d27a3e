"""Native (C++) host code of the port, bound with ctypes.

`fastloader.cpp` holds the packed-shard loader's batch gather
(`poly_gather_batch`), `midirender.cpp` the token -> MIDI file renderer
(`poly_render_midi`). Each is compiled by `CXX` at first use, never at
import, into `build/polyphemus_tpu_torch/` beside the package, named by a
hash of the source, the compiler and its flags, and written through a
temporary file of this process before `os.replace` moves it in, so worker
processes that build it together do not race. A failed build raises: no
caller falls back to a Python path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

HERE = Path(__file__).resolve().parent
BUILD_DIR = HERE.parents[1] / "build" / "polyphemus_tpu_torch"
CXX = "g++"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread", "-std=c++17"]

_libs: dict = {}
_lock = threading.Lock()


def library_path(src_name: str) -> Path:
    """Where the shared library of `src_name` is built."""
    src = HERE / src_name
    h = hashlib.sha1(src.read_bytes() + " ".join([CXX, *CXX_FLAGS]).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:12]}.so"


def build(src_name: str) -> ctypes.CDLL:
    """Compile `src_name` (once; a library already built is reused) and
    load it. Raises RuntimeError if the compiler is missing or fails."""
    with _lock:
        lib = _libs.get(src_name)
        if lib is not None:
            return lib
        out = library_path(src_name)
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [CXX, *CXX_FLAGS, str(HERE / src_name), "-o", str(tmp)]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
            except OSError as e:
                raise RuntimeError(f"cannot run the C++ compiler {CXX!r} to "
                                   f"build {src_name}: {e}") from e
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stderr}")
            os.replace(tmp, out)
        lib = _libs[src_name] = ctypes.CDLL(str(out))
        return lib


def load_fastloader() -> ctypes.CDLL:
    """The batch gather's library, its `poly_gather_batch` typed."""
    lib = build("fastloader.cpp")
    fn = lib.poly_gather_batch
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int32]
    fn.restype = None
    return lib


def load_midirender() -> ctypes.CDLL:
    """The MIDI renderer's library, its `poly_render_midi` typed."""
    lib = build("midirender.cpp")
    c = ctypes
    fn = lib.poly_render_midi
    fn.argtypes = [
        c.POINTER(c.c_int32), c.POINTER(c.c_uint8),
        c.c_int32, c.c_int32, c.c_int32, c.c_int32,
        c.POINTER(c.c_int32), c.POINTER(c.c_uint8),
        c.POINTER(c.c_int32), c.c_int32, c.c_int32, c.c_int32,
        c.POINTER(c.c_uint8), c.c_int64]
    fn.restype = c.c_int64
    return lib
