"""Public wrappers around the registered kernels, after
``src/repro/kernels/ops.py``: the shape plumbing (flattening token axes,
reshaping back) on top of ``kernels.dispatch.get_kernel``, which picks the
kernel's wrapper on a CUDA tensor (it launches the kernel, counted by
``dispatch.count_launch``) and the plain version on a CPU tensor, from an
explicit ``backend=``, ``$REPRO_KERNEL_BACKEND`` or the device; a choice
that disagrees with the device raises. The oracles of ``ref.py`` stay the
numerical ground truth.

The reference's ``INTERPRET`` / ``REPRO_PALLAS_COMPILE`` knob is dead there
(superseded by ``REPRO_KERNEL_BACKEND``) and has no counterpart here.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import dispatch, ref


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor, *, backend=None) -> torch.Tensor:
    """Per-token CE for (..., V) logits and (...) int targets through the
    registered ``weighted_ce`` kernel, differentiable; (...) f32."""
    shape = targets.shape
    r = math.prod(shape)
    ce = dispatch.get_kernel("weighted_ce", backend=backend)(
        logits.reshape(r, logits.shape[-1]), targets.reshape(r))
    return ce.reshape(shape)


def adam_adapt_product(g, m, v, g_meta, *, t, b1=0.9, b2=0.999, eps=1e-8, lr=1.0,
                       backend=None):
    """SAMA's fused Adam adaptation product over flat arrays: (out, sum of
    out**2 in f32)."""
    return dispatch.get_kernel("adam_adapt", backend=backend)(
        g, m, v, g_meta, t=t, b1=b1, b2=b2, eps=eps, lr=lr)


def lion_adapt_product(g, m, g_meta, *, lr=1.0, b1=0.9, delta=1e-3, backend=None):
    """SAMA's fused Lion (surrogate-sign) adaptation product over flat arrays."""
    return dispatch.get_kernel("lion_adapt", backend=backend)(
        g, m, g_meta, lr=lr, b1=b1, delta=delta)


def adafactor_adapt_product(vhat, g_meta, *, lr=1.0, eps=1e-8, backend=None):
    """SAMA's fused Adafactor (frozen-statistics) adaptation product over a
    flat array of bias-corrected second moments."""
    return dispatch.get_kernel("adafactor_adapt", backend=backend)(vhat, g_meta, lr=lr,
                                                                  eps=eps)


__all__ = [
    "adafactor_adapt_product",
    "adam_adapt_product",
    "cross_entropy",
    "lion_adapt_product",
    "ref",
]
