"""The JAX package's oracles (``src/repro/kernels/ref.py``) under their
names and semantics, built on the port's plain versions. Tests hold the
kernels and the ``ops`` functions against these; they are never a route
of a kernel.

Two layers, as in the reference:

* ``*_math``: the adaptation products in the inputs' native dtype, with
  the sum of squares accumulated in f32 (the plain versions themselves);
* the public oracles: the same after casting every input to f32, the
  kernels' own arithmetic.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import adafactor_adapt, adam_adapt, lion_adapt, weighted_ce


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """logits (R, V), targets (R,) int: per-row CE (R,) f32."""
    return weighted_ce.cross_entropy_fwd_plain(logits, targets)[0]


def cross_entropy_grad(logits: torch.Tensor, targets: torch.Tensor,
                       g: torch.Tensor) -> torch.Tensor:
    """d(sum_r g[r] CE[r]) / dlogits = (softmax - onehot) * g, computed in
    f32 and returned in the logits' dtype."""
    _, lse = weighted_ce.cross_entropy_fwd_plain(logits, targets)
    return weighted_ce.cross_entropy_bwd_plain(logits, targets, lse, g)


# ---------------------------------------------------------------------------
# native-dtype adaptation math
# ---------------------------------------------------------------------------

adam_adapt_math = adam_adapt.adam_adapt_plain
lion_adapt_math = lion_adapt.lion_adapt_plain
adafactor_adapt_math = adafactor_adapt.adafactor_adapt_plain


# ---------------------------------------------------------------------------
# f32 oracles
# ---------------------------------------------------------------------------


def _f32(*xs):
    return tuple(x.float() for x in xs)


def adam_adapt_product(g, m, v, g_meta, *, t, b1, b2, eps, lr):
    """SAMA's Adam perturbation direction (paper Appendix C, exact), all f32:
    (out, sum(out**2))."""
    g, m, v, g_meta = _f32(g, m, v, g_meta)
    return adam_adapt_math(g, m, v, g_meta, t=t, b1=b1, b2=b2, eps=eps, lr=lr)


def lion_adapt_product(g, m, g_meta, *, lr=1.0, b1=0.9, delta=1e-3):
    """Lion's surrogate adaptation product, all f32."""
    g, m, g_meta = _f32(g, m, g_meta)
    return lion_adapt_math(g, m, g_meta, lr=lr, b1=b1, delta=delta)


def adafactor_adapt_product(vhat, g_meta, *, lr=1.0, eps=1e-8):
    """Adafactor's frozen-statistics adaptation product, all f32."""
    vhat, g_meta = _f32(vhat, g_meta)
    return adafactor_adapt_math(vhat, g_meta, lr=lr, eps=eps)
