"""Builds the port's CUDA kernel from ``kernels/csrc/flash_decode.cu``.

``nvcc`` compiles the source into a shared library with a plain C
interface, ``build/kernels/libflash_decode-<hash>.so`` at the root of the
checkout, which is loaded with ``ctypes``. The file name carries a hash of
the source, so an edited kernel is never served from a stale build. The
build happens at first use and needs only the CUDA toolkit: no PyTorch
headers are compiled, which keeps a build to seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Optional, Tuple

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
ROOT = pathlib.Path(__file__).resolve().parents[3]
BUILD_DIR = ROOT / "build" / "kernels"

#: the port's one kernel source
SOURCE = CSRC / "flash_decode.cu"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIB: Optional[ctypes.CDLL] = None


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def _target(source: pathlib.Path = SOURCE) -> pathlib.Path:
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{source.stem}-{digest}.so"


def build() -> Tuple[pathlib.Path, str]:
    """Compile the library unless it is built already. Returns its path and
    nvcc's output (the ``-Xptxas -v`` register and shared-memory report;
    empty when the build was reused). Raises with that output if nvcc
    fails."""

    out = _target()
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"kernel build failed: nvcc exit {proc.returncode}\n{proc.stdout}")
    os.replace(tmp, out)
    return out, proc.stdout


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""

    global _LIB
    if _LIB is None:
        _LIB = ctypes.CDLL(str(build()[0]))
    return _LIB
