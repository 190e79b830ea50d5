"""Build the port's CUDA kernels with nvcc and bind them through ctypes.

Each source under ``mapanything_tpu_torch/csrc/`` exposes a plain C entry
point. ``load(stem)`` compiles ``csrc/<stem>.cu`` for Hopper (``sm_90a``)
into ``build/kernels/`` at the repository root on first use, then loads the
shared library. The library's name carries a hash of the source, so an
edited kernel is rebuilt and a stale one is never loaded. Nothing here runs
at import time: the module imports on a host without nvcc or a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_libs: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the port's kernels")


def library_path(stem: str) -> Path:
    src = CSRC_DIR / f"{stem}.cu"
    digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{stem}_{digest}.so"


def build(stem: str) -> Path:
    """Compile ``csrc/<stem>.cu`` unless the library for this source exists.

    The compiler's output (with ``-Xptxas -v``: registers, shared memory and
    spills of each kernel) is kept beside the library as ``<name>.log``.
    """
    out = library_path(stem)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{stem}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {stem}.cu (exit {proc.returncode}):\n{proc.stderr[-4000:]}"
        )
    os.replace(tmp, out)
    return out


def load(stem: str) -> ctypes.CDLL:
    """Build (if needed) and load the library of ``csrc/<stem>.cu``, once per process."""
    if stem not in _libs:
        _libs[stem] = ctypes.CDLL(str(build(stem)))
    return _libs[stem]
