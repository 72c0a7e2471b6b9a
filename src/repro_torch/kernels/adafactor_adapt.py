"""SAMA's Adafactor adaptation product: the CUDA kernel's wrapper and its
plain PyTorch version.

Counterpart of ``src/repro/kernels/adafactor_adapt.py`` (the Pallas kernel)
and of ``adafactor_adapt_math`` in ``src/repro/kernels/ref.py``.
Adafactor's factored second moment couples whole rows and columns, so
``optim.adafactor`` declares the frozen-statistics diagonal and this
product is

    out = lr / (sqrt(vhat) + eps) * g_meta

with the sum of ``out**2`` from the same pass. The caller rebuilds the
bias-corrected ``vhat`` (rank-1 for a factored leaf) in torch first. The
kernel is ``csrc/adafactor_adapt.cu``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import dispatch, flat


def adafactor_adapt_plain(vhat, g_meta, *, lr, eps):
    """The plain version (``ref.adafactor_adapt_math``) in the inputs'
    dtype. Returns (out, sum(out**2) in f32)."""
    out = (lr / (torch.sqrt(vhat) + eps)) * g_meta
    return out, flat.sumsq32(out)


def adafactor_adapt(vhat, g_meta, *, lr=1.0, eps=1e-8, backend=None):
    """Flat (N,) ``vhat`` (non-negative) and ``g_meta``; ``lr`` a Python
    number or a 0-d tensor on the inputs' device. Returns (out (N,),
    sum(out**2) f32 scalar).

    CUDA tensors launch the kernel (f32 only); CPU tensors (or
    ``backend="plain"``) take :func:`adafactor_adapt_plain`; meta tensors
    give empty outputs. Every route charges the call's work (``flat.run``)."""

    def cuda():
        flat.check("adafactor_adapt", vhat=vhat, g_meta=g_meta)
        return flat.launch("adafactor_adapt", (vhat, g_meta),
                           flat.device_scalars(vhat.device, lr), (eps,))

    return flat.run("adafactor_adapt", vhat, dispatch.route("adafactor_adapt", vhat, backend),
                    lambda: adafactor_adapt_plain(vhat, g_meta, lr=lr, eps=eps), cuda)
