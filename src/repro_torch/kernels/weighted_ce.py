"""Per-row cross-entropy over a large vocabulary: the CUDA kernels'
wrappers, their plain PyTorch versions and the CUDA route's autograd
function.

Counterpart of ``src/repro/kernels/weighted_ce.py`` (the Pallas forward and
backward behind a custom VJP) and of ``ops.cross_entropy``, which flattens
``(..., V)`` logits and ``(...)`` targets to rows. :func:`cross_entropy`
returns the f32 per-row CE. On the CUDA route, like the JAX custom VJP, it
saves ``(logits, targets, lse)``, and its backward rebuilds the softmax
from ``lse``: ``dlogits = (exp(x - lse) - onehot) * g`` in f32, stored in
the logits' dtype. The plain route is the forward's ops under autograd.
Targets get no gradient.

The kernels are ``csrc/weighted_ce.cu``: the forward with one block per
row (an online max and sum of exponentials, f32 ``ce`` and ``lse``), the
backward one elementwise pass. They read the rows where they lie: logits
whose leading axes fold into two strides, such as the LM loss's
``logits[:, :-1]`` view, are not copied, and a row at any alignment of its
dtype takes 16-byte loads and stores past a scalar head (the backward's
stores aligned on the contiguous dlogits, its loads re-phased from the
logits row's own 16-byte lines).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import build, dispatch, work

FWD, BWD = "weighted_ce_fwd", "weighted_ce_bwd"

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: each dtype's instantiation also counts its launches under its own name,
#: ``FWD`` + ``"_f16"`` and so on, beside the kernel's count
INSTANCES = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16"}


def cross_entropy_fwd_plain(logits: torch.Tensor, targets: torch.Tensor):
    """logits (R, V), targets (R,) int: (ce, lse), both (R,) f32
    (``ref.cross_entropy``)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    tgt = torch.gather(lf, -1, targets.long()[:, None])[:, 0]
    return lse - tgt, lse


def cross_entropy_bwd_plain(logits, targets, lse, g):
    """d(sum_r g[r] ce[r]) / dlogits from the saved ``lse``, computed in f32
    and returned in the logits' dtype (``_ce_bwd_kernel``'s arithmetic):
    what the backward kernel is held against on the card."""
    p = torch.exp(logits.float() - lse[:, None])
    # p - onehot out of place: exp saved p for its own backward
    p = p.scatter_add(1, targets.long()[:, None], p.new_full((p.shape[0], 1), -1.0))
    return (p * g.float()[:, None]).to(logits.dtype)


class _CrossEntropy(torch.autograd.Function):
    """The CUDA route: the forward kernel saves (logits, targets, lse), the
    backward kernel rebuilds the softmax from lse. First order only: a
    second derivative raises (``dispatch.first_order_only``), as the JAX
    package's Pallas path does."""

    @staticmethod
    def forward(ctx, logits, targets):
        ce, lse = _fwd_cuda(logits, targets)
        ctx.save_for_backward(logits, targets, lse)
        return ce

    @staticmethod
    def backward(ctx, g):
        logits, targets, lse = ctx.saved_tensors
        dispatch.charge(BWD, work.ce(lse.shape[0], logits.shape[-1], logits.dtype, True))
        with dispatch.uncounted():
            d = _bwd_cuda(logits, targets, lse, g.float().contiguous())
            (d,) = dispatch.first_order_only("weighted_ce", (logits, g), (d,))
        return d, None


class _MetaCrossEntropy(torch.autograd.Function):
    """The meta route: empty outputs of the kernels' shapes and dtypes, the
    backward's work charged where it runs."""

    @staticmethod
    def forward(ctx, logits, targets):
        ctx.shape, ctx.dtype = logits.shape, logits.dtype
        return logits.new_empty((targets.numel(),), dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        dispatch.charge(BWD, work.ce(g.numel(), ctx.shape[-1], ctx.dtype, True))
        with dispatch.uncounted():
            return g.new_empty(ctx.shape, dtype=ctx.dtype), None


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor, *, backend=None) -> torch.Tensor:
    """Per-token CE for (..., V) logits and (...) int targets: (...) f32,
    differentiable in ``logits``. CUDA tensors launch the kernels in both
    passes (f32, bf16 or f16 logits; first order only, a second derivative
    raises). CPU tensors (or ``backend="plain"``) take the plain forward's
    ops under autograd, as the JAX package's ``ref`` twin does, so they
    differentiate to any order. Meta tensors give empty outputs. Every
    route charges each pass's work (``kernels.work.ce``) and computes it
    inside ``dispatch.uncounted``."""
    if logits.shape[:-1] != targets.shape:
        raise ValueError(f"weighted_ce: logits {tuple(logits.shape)} do not match targets "
                         f"{tuple(targets.shape)}")
    chosen = dispatch.route("weighted_ce", logits, backend)
    flat_targets = targets.reshape(-1).to(torch.int32).contiguous()
    rows, v = flat_targets.numel(), logits.shape[-1]
    with dispatch.uncounted():
        if chosen == dispatch.PLAIN:
            ce, _ = cross_entropy_fwd_plain(logits.reshape(-1, v), flat_targets)
        elif chosen == dispatch.META:
            ce = _MetaCrossEntropy.apply(logits, flat_targets)
        else:
            ce = _CrossEntropy.apply(logits, flat_targets)
    dispatch.charge(FWD, work.ce(rows, v, logits.dtype))
    if chosen == dispatch.PLAIN:
        dispatch.plain_backward(ce, [logits], lambda: dispatch.charge(
            BWD, work.ce(rows, v, logits.dtype, True)))
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
        raise ValueError(f"weighted_ce: logits are {logits.dtype}; the kernels take float16, "
                         "float32 or bfloat16")
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
    dispatch.count_launch(f"{FWD}_{INSTANCES[logits.dtype]}")
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
    dispatch.count_launch(f"{BWD}_{INSTANCES[logits.dtype]}")
    return dlogits
