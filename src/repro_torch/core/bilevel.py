"""Bilevel problem specification, after ``src/repro/core/bilevel.py``.

A meta-learning program (paper Sec. 2) is

    lam* = argmin_lam  L_meta(D_meta; theta*(lam))
    s.t. theta*(lam) = argmin_theta L_base(D_base; theta, lam)

captured as two scalar loss functions over trees of tensors. Everything in
``core`` is generic over this spec.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

Tree = Any
Batch = Any
LossFn = Callable[[Tree, Tree, Batch], Any]  # (theta, lam, batch) -> scalar


@dataclasses.dataclass(frozen=True)
class BilevelSpec:
    """The bilevel program. Loss functions return a 0-d tensor (or
    (scalar, aux) when ``has_aux``) that autograd can differentiate with
    respect to theta's and lam's leaves."""

    base_loss: LossFn
    meta_loss: LossFn
    has_aux: bool = False

    def base_scalar(self, theta, lam, batch):
        out = self.base_loss(theta, lam, batch)
        return out[0] if self.has_aux else out

    def meta_scalar(self, theta, lam, batch):
        out = self.meta_loss(theta, lam, batch)
        return out[0] if self.has_aux else out
