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
    """The library's path; its name hashes the source, the shared headers and the flags."""
    h = hashlib.sha1((CSRC_DIR / f"{stem}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{stem}_{h.hexdigest()[:12]}.so"


def build(*stems: str) -> list:
    """Compile ``csrc/<stem>.cu`` for each stem whose library does not exist yet.

    The nvcc processes run side by side, one per source. The compiler's output
    (with ``-Xptxas -v``: registers, shared memory and spills of each kernel)
    is kept beside each library as ``<name>.log``. Returns the libraries' paths.
    """
    outs = [library_path(stem) for stem in stems]
    jobs = []
    for stem, out in zip(stems, outs):
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{stem}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs.append((stem, out, tmp, proc))
    failures = []
    for stem, out, tmp, proc in jobs:
        stdout, stderr = proc.communicate()
        out.with_suffix(".log").write_text(stdout + stderr)
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {stem}.cu (exit {proc.returncode}):\n{stderr[-4000:]}")
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return outs


def load(stem: str) -> ctypes.CDLL:
    """Build (if needed) and load the library of ``csrc/<stem>.cu``, once per process."""
    if stem not in _libs:
        _libs[stem] = ctypes.CDLL(str(build(stem)[0]))
    return _libs[stem]
