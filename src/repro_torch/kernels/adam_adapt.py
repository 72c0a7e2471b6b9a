"""SAMA's Adam adaptation product: the CUDA kernel's wrapper and its plain
PyTorch version.

Counterpart of ``src/repro/kernels/adam_adapt.py`` (the Pallas kernel) and
of ``adam_adapt_math`` in ``src/repro/kernels/ref.py`` (its ``ref`` twin).
The kernel is ``csrc/adam_adapt.cu``: one pass over flat f32 ``g, m, v,
g_meta`` that writes ``out = diag(du/dg) * g_meta`` and one partial sum of
``out**2`` per block; the partials are summed here, as the JAX code sums
the kernel's per-tile partials outside it.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build, dispatch

#: threads per block and the most blocks one launch takes (csrc/adam_adapt.cu)
THREADS = 256
MAX_BLOCKS = 8 * 132


def _sumsq32(out: torch.Tensor) -> torch.Tensor:
    """Sum of squares accumulated in f32 (``ref._sumsq32``)."""
    out32 = out.float()
    return torch.sum(out32 * out32)


def adam_adapt_plain(g, m, v, g_meta, *, t, b1, b2, eps, lr):
    """The plain version: ``ref.adam_adapt_math`` in the inputs' dtype, with
    the bias corrections formed in at least f32 (in bf16, 1 - 0.999**t
    rounds to 0 and poisons vhat). Returns (out, sum(out**2) in f32)."""

    dt = torch.promote_types(g.dtype, torch.float32)
    t = torch.as_tensor(t, device=g.device).to(dt)
    bc1 = (1.0 - b1 ** t).to(g.dtype)
    bc2 = (1.0 - b2 ** t).to(g.dtype)
    m1 = b1 * m + (1.0 - b1) * g
    v1 = b2 * v + (1.0 - b2) * g * g
    mhat = m1 / bc1
    vhat = v1 / bc2
    denom = torch.sqrt(vhat) + eps
    a = (1.0 - b1) / bc1
    b = (1.0 - b2) / bc2
    safe_sqrt = torch.clamp_min(torch.sqrt(vhat), 1e-15)
    diag = lr * (a / denom - mhat * b * g / (safe_sqrt * denom * denom))
    out = diag * g_meta
    return out, _sumsq32(out)


def adam_adapt(g, m, v, g_meta, *, t, b1=0.9, b2=0.999, eps=1e-8, lr=1.0, backend=None):
    """Flat (N,) ``g, m, v, g_meta``; ``t`` (the step, count + 1) and ``lr``
    are Python numbers or 0-d tensors on the inputs' device. Returns
    (out (N,), sum(out**2) f32 scalar).

    CUDA tensors launch the kernel (f32 only); CPU tensors (or
    ``backend="plain"``) take :func:`adam_adapt_plain`."""
    if dispatch.route("adam_adapt", g, backend) == dispatch.PLAIN:
        return adam_adapt_plain(g, m, v, g_meta, t=t, b1=b1, b2=b2, eps=eps, lr=lr)
    return _adam_adapt_cuda(g, m, v, g_meta, t=t, b1=b1, b2=b2, eps=eps, lr=lr)


@functools.lru_cache(maxsize=1)
def _lib():
    fn = build.load("adam_adapt").adam_adapt_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_int]
                   + [ctypes.c_float] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(g, m, v, g_meta):
    if g.dim() != 1 or g.numel() < 1:
        raise ValueError(f"adam_adapt: inputs must be flat and non-empty, got {tuple(g.shape)}")
    for name, x in (("g", g), ("m", m), ("v", v), ("g_meta", g_meta)):
        if x.shape != g.shape:
            raise ValueError(f"adam_adapt: {name} is {tuple(x.shape)}, g is {tuple(g.shape)}")
        if x.dtype != torch.float32:
            raise ValueError(f"adam_adapt: {name} is {x.dtype}; the kernel takes float32")
        if x.device != g.device or x.device.type != "cuda":
            raise ValueError(f"adam_adapt: {name} is on {x.device}; the kernel takes cuda "
                             f"tensors on one device (g is on {g.device})")
        if not x.is_contiguous():
            raise ValueError(f"adam_adapt: {name} must be contiguous")


def _adam_adapt_cuda(g, m, v, g_meta, *, t, b1, b2, eps, lr):
    _check(g, m, v, g_meta)
    n = g.numel()
    blocks = max(1, min(MAX_BLOCKS, math.ceil(n / (4 * THREADS))))
    # (t, lr) stay on the device: a traced step count and a scheduled rate
    # never cost a host sync
    sched = torch.stack([torch.as_tensor(t, dtype=torch.float32, device=g.device).reshape(()),
                         torch.as_tensor(lr, dtype=torch.float32, device=g.device).reshape(())])
    out = torch.empty_like(g)
    partial = torch.empty(blocks, dtype=torch.float32, device=g.device)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = _lib()(g.data_ptr(), m.data_ptr(), v.data_ptr(), g_meta.data_ptr(), sched.data_ptr(),
                 out.data_ptr(), partial.data_ptr(), n, blocks, b1, 1.0 - b1, b2, 1.0 - b2,
                 eps, stream)
    if err != 0:
        raise RuntimeError(f"adam_adapt: kernel launch failed with CUDA error {err}")
    dispatch.count_launch("adam_adapt")
    return out, torch.sum(partial)
