"""The port's native host code: the covisibility random-walk sampler, built with
g++ at first use and bound through ctypes.

Counterpart of ``mapanything_tpu/native/__init__.py`` (:31-99). ``get_lib()``
compiles ``csrc/covis_sampler.cpp`` into ``build/native/`` at the repository
root, under a name that hashes the source and the flags (as ``ops/_build.py``
names the kernels), so an edited source is rebuilt and a stale library never
loaded. Unlike the JAX package, a failed build raises: the datasets run the
numpy walk only when their ``use_native_sampler`` is False, never in its place.
Nothing runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCE = PACKAGE_DIR / "csrc" / "covis_sampler.cpp"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """The library's path: its name hashes the source and the flags."""
    h = hashlib.sha1(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libcovis_sampler_{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the sampler unless its library exists; raise if g++ is missing or fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the covisibility sampler (csrc/covis_sampler.cpp) is built with it")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True, text=True,
                          timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SOURCE.name} (exit {proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)  # atomic: processes building side by side each leave a whole library
    return out


def get_lib() -> ctypes.CDLL:
    """Load the sampler's library, building it first if needed, once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.covis_random_walk.restype = ctypes.c_int
        lib.covis_random_walk.argtypes = [
            ctypes.POINTER(ctypes.c_float),  # covis
            ctypes.c_int,  # n
            ctypes.c_float,  # thres
            ctypes.c_int,  # num_samples
            ctypes.c_int,  # max_retries
            ctypes.c_int,  # bidirectional
            ctypes.c_uint64,  # seed
            ctypes.POINTER(ctypes.c_int),  # out
        ]
        _lib = lib
    return _lib


def covis_random_walk_native(
    covis: np.ndarray,
    thres: float,
    num_samples: int,
    seed: int,
    max_retries: int = 4,
    bidirectional: bool = True,
) -> np.ndarray:
    """The native random walk over ``covis`` (materialised as contiguous float32):
    up to ``num_samples`` view indices, fewer when no connected set is that large."""
    lib = get_lib()
    c = np.ascontiguousarray(covis, dtype=np.float32)
    out = np.zeros(num_samples, dtype=np.int32)
    count = lib.covis_random_walk(
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        c.shape[0],
        ctypes.c_float(thres),
        num_samples,
        max_retries,
        1 if bidirectional else 0,
        ctypes.c_uint64(seed & 0xFFFFFFFFFFFFFFFF),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    return out[:count]
