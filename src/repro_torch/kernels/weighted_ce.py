"""Per-row cross-entropy over a large vocabulary: the CUDA kernels'
wrappers, their plain PyTorch versions and the autograd function.

Counterpart of ``src/repro/kernels/weighted_ce.py`` (the Pallas forward and
backward behind a custom VJP) and of ``ops.cross_entropy``, which flattens
``(..., V)`` logits and ``(...)`` targets to rows. :func:`cross_entropy`
returns the f32 per-row CE. Like the JAX custom VJP it saves ``(logits,
targets, lse)``, and its backward rebuilds the softmax from ``lse``:
``dlogits = (exp(x - lse) - onehot) * g`` in f32, stored in the logits'
dtype. Targets get no gradient.

The kernels are ``csrc/weighted_ce.cu``: the forward with one block per
row (an online max and sum of exponentials, f32 ``ce`` and ``lse``), the
backward one elementwise pass. They read the rows where they lie: logits
whose leading axes fold into two strides, such as the LM loss's
``logits[:, :-1]`` view, are not copied.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import build, dispatch

FWD, BWD = "weighted_ce_fwd", "weighted_ce_bwd"

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def cross_entropy_fwd_plain(logits: torch.Tensor, targets: torch.Tensor):
    """logits (R, V), targets (R,) int: (ce, lse), both (R,) f32
    (``ref.cross_entropy``)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    tgt = torch.gather(lf, -1, targets.long()[:, None])[:, 0]
    return lse - tgt, lse


def cross_entropy_bwd_plain(logits, targets, lse, g):
    """d(sum_r g[r] ce[r]) / dlogits from the saved ``lse``, computed in f32
    and returned in the logits' dtype (``_ce_bwd_kernel``'s arithmetic)."""
    p = torch.exp(logits.float() - lse[:, None])
    rows = torch.arange(p.shape[0], device=p.device)
    p[rows, targets.long()] -= 1.0
    return (p * g.float()[:, None]).to(logits.dtype)


class _CrossEntropy(torch.autograd.Function):
    """Forward saves (logits, targets, lse); backward launches the backward
    kernel (or, with ``plain``, takes its plain version)."""

    @staticmethod
    def forward(ctx, logits, targets, plain):
        if plain:
            ce, lse = cross_entropy_fwd_plain(logits.reshape(-1, logits.shape[-1]), targets)
        else:
            ce, lse = _fwd_cuda(logits, targets)
        ctx.save_for_backward(logits, targets, lse)
        ctx.plain = plain
        return ce

    @staticmethod
    def backward(ctx, g):
        logits, targets, lse = ctx.saved_tensors
        g = g.float().contiguous()
        if ctx.plain:
            d = cross_entropy_bwd_plain(logits.reshape(-1, logits.shape[-1]), targets, lse, g)
            return d.reshape(logits.shape), None, None
        return _bwd_cuda(logits, targets, lse, g), None, None


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor, *, backend=None) -> torch.Tensor:
    """Per-token CE for (..., V) logits and (...) int targets: (...) f32,
    differentiable in ``logits``. CUDA tensors launch the kernels in both
    passes (f32 or bf16 logits); CPU tensors (or ``backend="plain"``) take
    the plain versions."""
    if logits.shape[:-1] != targets.shape:
        raise ValueError(f"weighted_ce: logits {tuple(logits.shape)} do not match targets "
                         f"{tuple(targets.shape)}")
    plain = dispatch.route("weighted_ce", logits, backend) == dispatch.PLAIN
    flat_targets = targets.reshape(-1).to(torch.int32).contiguous()
    ce = _CrossEntropy.apply(logits, flat_targets, plain)
    return ce.reshape(targets.shape)


# ---------------------------------------------------------------------------
# the CUDA route
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _fn(name: str):
    fn = getattr(build.load("weighted_ce"), name)
    n_ptr = {"weighted_ce_fwd_launch": 4, "weighted_ce_bwd_launch": 5}[name]
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_longlong] * 5
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def row_layout(logits: torch.Tensor) -> Tuple[int, int, int, int]:
    """(rows, inner_n, s_outer, s_inner): row r of the (..., V) ``logits``
    starts ``(r // inner_n) * s_outer + (r % inner_n) * s_inner`` elements
    into its storage. The leading axes must fold into at most two strides
    and the rows must be contiguous; anything else raises."""
    if logits.dim() < 1 or logits.stride(-1) != 1 and logits.shape[-1] > 1:
        raise ValueError(f"weighted_ce: the kernels take rows of contiguous logits, got "
                         f"strides {logits.stride()}")
    levels = []  # (count, stride), outermost first, axes of size 1 dropped
    for n, s in zip(logits.shape[:-1], logits.stride()[:-1]):
        if n == 1:
            continue
        if levels and levels[-1][1] == n * s:
            levels[-1] = (levels[-1][0] * n, s)
        else:
            levels.append((n, s))
    rows = 1
    for n, _ in levels:
        rows *= n
    if not levels:
        return rows, 1, 0, 0
    if len(levels) == 1:
        return rows, levels[0][0], 0, levels[0][1]
    if len(levels) == 2:
        return rows, levels[1][0], levels[0][1], levels[1][1]
    raise ValueError(f"weighted_ce: the leading axes of logits {tuple(logits.shape)} with "
                     f"strides {logits.stride()} do not fold into two strides")


def _check(logits, targets):
    if logits.dtype not in _DTYPE_CODES:
        raise ValueError(f"weighted_ce: logits are {logits.dtype}; the kernels take float32 "
                         "or bfloat16")
    if logits.shape[-1] < 1 or logits.numel() < 1:
        raise ValueError(f"weighted_ce: empty logits {tuple(logits.shape)}")
    rows, inner_n, s_outer, s_inner = row_layout(logits)
    if targets.dtype != torch.int32 or tuple(targets.shape) != (rows,) \
            or not targets.is_contiguous():
        raise ValueError(f"weighted_ce: targets must be ({rows},) contiguous int32, got "
                         f"{targets.dtype} {tuple(targets.shape)}")
    for name, x in (("logits", logits), ("targets", targets)):
        if x.device != logits.device or x.device.type != "cuda":
            raise ValueError(f"weighted_ce: {name} is on {x.device}; the kernels take cuda "
                             f"tensors on one device (logits are on {logits.device})")
    return rows, logits.shape[-1], inner_n, s_outer, s_inner


def _fwd_cuda(logits, targets):
    rows, v, inner_n, s_outer, s_inner = _check(logits, targets)
    ce = torch.empty(rows, dtype=torch.float32, device=logits.device)
    lse = torch.empty(rows, dtype=torch.float32, device=logits.device)
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    err = _fn("weighted_ce_fwd_launch")(
        logits.data_ptr(), targets.data_ptr(), ce.data_ptr(), lse.data_ptr(), rows, v, inner_n,
        s_outer, s_inner, _DTYPE_CODES[logits.dtype], stream)
    if err != 0:
        raise RuntimeError(f"weighted_ce: forward launch failed with CUDA error {err}")
    dispatch.count_launch(FWD)
    return ce, lse


def _bwd_cuda(logits, targets, lse, g):
    rows, v, inner_n, s_outer, s_inner = _check(logits, targets)
    for name, x in (("lse", lse), ("g", g)):
        if x.dtype != torch.float32 or tuple(x.shape) != (rows,) or not x.is_contiguous() \
                or x.device != logits.device:
            raise ValueError(f"weighted_ce: {name} must be contiguous float32 ({rows},) on "
                             f"{logits.device}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    dlogits = torch.empty(logits.shape, dtype=logits.dtype, device=logits.device)
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    err = _fn("weighted_ce_bwd_launch")(
        logits.data_ptr(), targets.data_ptr(), lse.data_ptr(), g.data_ptr(), dlogits.data_ptr(),
        rows, v, inner_n, s_outer, s_inner, _DTYPE_CODES[logits.dtype], stream)
    if err != 0:
        raise RuntimeError(f"weighted_ce: backward launch failed with CUDA error {err}")
    dispatch.count_launch(BWD)
    return dlogits
