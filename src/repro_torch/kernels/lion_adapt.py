"""SAMA's Lion adaptation product: the CUDA kernel's wrapper and its plain
PyTorch version.

Counterpart of ``src/repro/kernels/lion_adapt.py`` (the Pallas kernel) and
of ``lion_adapt_math`` in ``src/repro/kernels/ref.py``. Lion's step is
``lr * sign(c)``, ``c = b1*m + (1-b1)*g``; the derivative of ``sign`` is
zero almost everywhere, so ``optim.lion`` declares the smoothed surrogate
``c / (|c| + delta)`` and this product is its diagonal times ``g_meta``:

    out = lr * (1-b1) * delta / (|c| + delta)**2 * g_meta

with the sum of ``out**2`` from the same pass. The kernel is
``csrc/lion_adapt.cu``.
"""

from __future__ import annotations

from repro_torch.kernels import dispatch, flat


def lion_adapt_plain(g, m, g_meta, *, lr, b1, delta):
    """The plain version (``ref.lion_adapt_math``) in the inputs' dtype.
    Returns (out, sum(out**2) in f32)."""
    c = b1 * m + (1.0 - b1) * g
    ad = c.abs() + delta
    diag = lr * (1.0 - b1) * delta / (ad * ad)
    out = diag * g_meta
    return out, flat.sumsq32(out)


def lion_adapt(g, m, g_meta, *, lr=1.0, b1=0.9, delta=1e-3, backend=None):
    """Flat (N,) ``g, m, g_meta``; ``lr`` a Python number or a 0-d tensor
    on the inputs' device. Returns (out (N,), sum(out**2) f32 scalar).

    CUDA tensors launch the kernel (f32 only); CPU tensors (or
    ``backend="plain"``) take :func:`lion_adapt_plain`."""
    if dispatch.route("lion_adapt", g, backend) == dispatch.PLAIN:
        return lion_adapt_plain(g, m, g_meta, lr=lr, b1=b1, delta=delta)
    flat.check("lion_adapt", g=g, m=m, g_meta=g_meta)
    return flat.launch("lion_adapt", (g, m, g_meta), flat.device_scalars(g.device, lr),
                       (b1, 1.0 - b1, delta))
