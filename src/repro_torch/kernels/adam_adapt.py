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

import torch

from repro_torch.kernels import dispatch, flat


#: elements per piece of the plain version: its temporaries stay a piece's
#: size where a whole expert stack's (346 M elements) would take ~10 GB
PLAIN_CHUNK = 1 << 26


def adam_adapt_plain(g, m, v, g_meta, *, t, b1, b2, eps, lr):
    """The plain version: ``ref.adam_adapt_math`` in the inputs' dtype, with
    the bias corrections formed in at least f32 (in bf16, 1 - 0.999**t
    rounds to 0 and poisons vhat). Returns (out, sum(out**2) in f32).
    A flat input above ``PLAIN_CHUNK`` elements is taken in pieces of that
    many: the arithmetic is elementwise, so the values are the same."""

    dt = torch.promote_types(g.dtype, torch.float32)
    t = torch.as_tensor(t, device=g.device).to(dt)
    bc1 = (1.0 - b1 ** t).to(g.dtype)
    bc2 = (1.0 - b2 ** t).to(g.dtype)

    def product(g, m, v, g_meta):
        m1 = b1 * m + (1.0 - b1) * g
        v1 = b2 * v + (1.0 - b2) * g * g
        mhat = m1 / bc1
        vhat = v1 / bc2
        denom = torch.sqrt(vhat) + eps
        a = (1.0 - b1) / bc1
        b = (1.0 - b2) / bc2
        safe_sqrt = torch.clamp_min(torch.sqrt(vhat), 1e-15)
        diag = lr * (a / denom - mhat * b * g / (safe_sqrt * denom * denom))
        return diag * g_meta

    n = g.numel()
    if g.dim() != 1 or n <= PLAIN_CHUNK:
        out = product(g, m, v, g_meta)
    else:
        out = None
        for start in range(0, n, PLAIN_CHUNK):
            piece = slice(start, start + PLAIN_CHUNK)
            part = product(g[piece], m[piece], v[piece], g_meta[piece])
            if out is None:
                out = torch.empty(n, dtype=part.dtype, device=part.device)
            out[piece] = part
    return out, flat.sumsq32(out)


def adam_adapt(g, m, v, g_meta, *, t, b1=0.9, b2=0.999, eps=1e-8, lr=1.0, backend=None):
    """Flat (N,) ``g, m, v, g_meta``; ``t`` (the step, count + 1) and ``lr``
    are Python numbers or 0-d tensors on the inputs' device. Returns
    (out (N,), sum(out**2) f32 scalar).

    CUDA tensors launch the kernel (f32 only); CPU tensors (or
    ``backend="plain"``) take :func:`adam_adapt_plain`; meta tensors give
    empty outputs. Every route charges the call's work (``flat.run``)."""
    kw = dict(t=t, b1=b1, b2=b2, eps=eps, lr=lr)
    return flat.run("adam_adapt", g, dispatch.route("adam_adapt", g, backend),
                    lambda: adam_adapt_plain(g, m, v, g_meta, **kw),
                    lambda: _adam_adapt_cuda(g, m, v, g_meta, **kw))


def _check(g, m, v, g_meta):
    flat.check("adam_adapt", g=g, m=m, v=v, g_meta=g_meta)


def _adam_adapt_cuda(g, m, v, g_meta, *, t, b1, b2, eps, lr):
    _check(g, m, v, g_meta)
    sched = flat.device_scalars(g.device, t, lr)
    return flat.launch("adam_adapt", (g, m, v, g_meta), sched,
                       (b1, 1.0 - b1, b2, 1.0 - b2, eps))
