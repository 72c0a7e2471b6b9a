"""Builds the port's CUDA kernels from ``kernels/csrc/*.cu``.

``nvcc`` compiles each source into its own shared library with a plain C
interface, ``build/kernels/lib<source>-<hash>.so`` at the root of the
checkout, which is loaded with ``ctypes``. The file name carries a hash of
the source, of the headers beside it (``csrc/*.cuh``) and of the flags, so
an edited kernel is never served from a stale build. A library is built at
first use and needs only the CUDA toolkit: no PyTorch headers are
compiled, which keeps a build to seconds. :func:`build_all` starts one
``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict, List, Tuple

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
ROOT = pathlib.Path(__file__).resolve().parents[3]
BUILD_DIR = ROOT / "build" / "kernels"

#: the kernel sources, one library each
SOURCES = {p.stem: p for p in sorted(CSRC.glob("*.cu"))}

#: ``--split-compile=0`` runs nvcc's optimizer on all the host's cores: the
#: training attention sources, dozens of template instantiations each, then
#: build in less than half the time (``chip_smoke.py``'s build phase prints
#: each source's seconds)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--split-compile=0", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def _target(source: pathlib.Path) -> pathlib.Path:
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}-{h.hexdigest()[:12]}.so"


def _source(name: str) -> pathlib.Path:
    if name not in SOURCES:
        raise ValueError(f"no kernel source {name!r}; have {sorted(SOURCES)}")
    return SOURCES[name]


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists. Returns (target,
    process or None, temporary output path)."""
    source = _source(name)
    out = _target(source)
    if out.exists():
        return out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return out, proc, tmp


def _finish(name: str, out, proc, tmp) -> str:
    if proc is None:
        return ""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"kernel build of {name} failed: nvcc exit "
                           f"{proc.returncode}\n{log}")
    os.replace(tmp, out)
    return log


def build(name: str) -> Tuple[pathlib.Path, str]:
    """Compile the library of ``csrc/<name>.cu`` unless it is built already.
    Returns its path and nvcc's output (the ``-Xptxas -v`` register and
    shared-memory report; empty when the build was reused). Raises with
    that output if nvcc fails."""

    out, proc, tmp = _start(name)
    return out, _finish(name, out, proc, tmp)


def build_all() -> List[Tuple[str, pathlib.Path, str, float]]:
    """Every source at once, one nvcc process each. Returns (name, library,
    nvcc output, seconds from the start until that build ended) per
    source; raises on the first failed build after all have ended."""

    t0 = time.perf_counter()
    started = [(name, *_start(name)) for name in SOURCES]
    results, errors = [], []
    for name, out, proc, tmp in started:
        try:
            log = _finish(name, out, proc, tmp)
        except RuntimeError as e:
            errors.append(str(e))
            continue
        results.append((name, out, log, time.perf_counter() - t0))
    if errors:
        raise RuntimeError("\n".join(errors))
    return results


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""

    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build(name)[0]))
    return _LIBS[name]
