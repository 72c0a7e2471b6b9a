"""What the wrappers of the flat adaptation-product kernels share
(``adam_adapt``, ``lion_adapt``, ``adafactor_adapt``; ``csrc/flat_pass.cuh``
on the CUDA side): the grid, the input checks, the device scalars and the
launch itself.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build, dispatch

#: threads per block and the most blocks one launch takes (csrc/flat_pass.cuh)
THREADS = 256
MAX_BLOCKS = 8 * 132


def sumsq32(out: torch.Tensor) -> torch.Tensor:
    """Sum of squares accumulated in f32 (``ref._sumsq32``)."""
    out32 = out.float()
    return torch.sum(out32 * out32)


def blocks(n: int) -> int:
    """The fixed grid for ``n`` elements: a function of ``n`` only, so the
    partial sums come out the same on every run."""
    return max(1, min(MAX_BLOCKS, math.ceil(n / (4 * THREADS))))


def check(kernel: str, **arrays: torch.Tensor) -> None:
    """Raise unless every array is flat, non-empty, contiguous f32 of one
    shape on one CUDA device."""
    first = next(iter(arrays.values()))
    if first.dim() != 1 or first.numel() < 1:
        raise ValueError(f"{kernel}: inputs must be flat and non-empty, got "
                         f"{tuple(first.shape)}")
    for name, x in arrays.items():
        if x.shape != first.shape:
            raise ValueError(f"{kernel}: {name} is {tuple(x.shape)}, the first input is "
                             f"{tuple(first.shape)}")
        if x.dtype != torch.float32:
            raise ValueError(f"{kernel}: {name} is {x.dtype}; the kernel takes float32")
        if x.device != first.device or x.device.type != "cuda":
            raise ValueError(f"{kernel}: {name} is on {x.device}; the kernel takes cuda "
                             f"tensors on one device (the first input is on {first.device})")
        if not x.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")


def device_scalars(device, *values) -> torch.Tensor:
    """Python numbers or 0-d tensors as one f32 tensor on ``device``: a
    traced step count or a scheduled rate never costs a host sync."""
    return torch.stack([torch.as_tensor(x, dtype=torch.float32, device=device).reshape(())
                        for x in values])


@functools.lru_cache(maxsize=None)
def _fn(name: str, n_arrays: int, n_floats: int):
    """``<name>_launch(arrays..., sched, out, partial, n, blocks, floats...,
    stream)`` from ``csrc/<name>.cu``."""
    fn = getattr(build.load(name), f"{name}_launch")
    fn.argtypes = ([ctypes.c_void_p] * (n_arrays + 3) + [ctypes.c_longlong, ctypes.c_int]
                   + [ctypes.c_float] * n_floats + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def launch(name: str, arrays, sched: torch.Tensor, floats):
    """One launch of kernel ``name`` over the checked flat ``arrays`` with
    ``sched`` on the device and the constants ``floats``. Returns (out,
    sum of out**2 in f32)."""
    first = arrays[0]
    n = first.numel()
    nb = blocks(n)
    out = torch.empty_like(first)
    partial = torch.empty(nb, dtype=torch.float32, device=first.device)
    stream = torch.cuda.current_stream(first.device).cuda_stream
    err = _fn(name, len(arrays), len(floats))(
        *(x.data_ptr() for x in arrays), sched.data_ptr(), out.data_ptr(), partial.data_ptr(),
        n, nb, *floats, stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    dispatch.count_launch(name)
    return out, torch.sum(partial)
