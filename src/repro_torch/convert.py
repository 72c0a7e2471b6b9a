"""Carries parameter trees between the JAX package and the port.

``jax.random`` and ``torch.Generator`` draw different numbers from one
seed, so the two packages compute the same thing only on the same
weights: the JAX side exports its tree as numpy
(``jax.tree_util.tree_map(np.asarray, params)``) and the port takes it
here. The trees have the same nested-dict structure and stacked layer
axes on both sides, so leaves map one to one. The same functions carry
decode caches.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models import common as cm

Tree = Any


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes: no numpy-native bf16
        return torch.from_numpy(a.astype(np.float32)).to(device=device,
                                                          dtype=torch.bfloat16)
    # a copy: JAX's buffers are read-only, and the port writes caches in place
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_jax(tree: Tree, *, device="cuda") -> Tree:
    """A nested dict of numpy arrays (a JAX tree after ``np.asarray``) as a
    nested dict of tensors on ``device``, dtypes kept."""

    device = cm.resolve_device(device)
    return cm.tree_map(lambda a: _to_tensor(a, device), tree)


def params_to_numpy(tree: Tree) -> Tree:
    """The inverse: tensors to numpy (bf16 leaves come back as f32, which
    holds them exactly)."""

    def to_np(t: torch.Tensor):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return cm.tree_map(to_np, tree)
