"""Meta-learner modules (the lambda side of the bilevel program), after
``src/repro/core/meta_modules.py``:

* MetaWeightNet-style reweighting net ``w(features; lam_r)``, fed the
  per-sample loss (and optionally the prediction uncertainty, paper
  Sec. 4.3);
* label corrector ``c(x, y; lam_c)`` producing a corrected soft label from
  (detached) model beliefs and the observed noisy label.

Both are plain trees + functions. Their random init draws from a
``torch.Generator`` and differs from ``jax.random``'s: carry JAX's trees
across with ``repro_torch.convert`` to compare.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

Tree = Any


def _dense_init(gen, n_in, n_out, *, device, scale=None):
    scale = scale if scale is not None else 1.0 / math.sqrt(n_in)
    w = torch.randn((n_in, n_out), generator=gen, dtype=torch.float32, device=device) * scale
    return {"w": w, "b": torch.zeros((n_out,), dtype=torch.float32, device=device)}


def _dense(p, x):
    # JAX's type promotion: bf16 or f16 features (a low-precision policy's
    # per-example losses) meet f32 weights in f32
    return x.to(torch.promote_types(x.dtype, p["w"].dtype)) @ p["w"] + p["b"]


# ---------------------------------------------------------------------------
# MetaWeightNet
# ---------------------------------------------------------------------------


def init_weight_net(gen, in_dim: int = 2, hidden: int = 100, *, device) -> Tree:
    return {"l1": _dense_init(gen, in_dim, hidden, device=device),
            "l2": _dense_init(gen, hidden, 1, device=device)}


def apply_weight_net(params: Tree, feats: torch.Tensor) -> torch.Tensor:
    """feats (B, in_dim), typically [loss, uncertainty]. Returns (B,)
    weights in (0, 1); lambda flows only through the MLP."""

    h = F.relu(_dense(params["l1"], feats))
    return torch.sigmoid(_dense(params["l2"], h))[..., 0]


def weight_features(per_sample_loss: torch.Tensor,
                    uncertainty: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Assemble (and detach) the MWN input features."""

    feats = [per_sample_loss.detach()]
    if uncertainty is not None:
        feats.append(uncertainty.detach())
    return torch.stack(feats, dim=-1)


# ---------------------------------------------------------------------------
# Label corrector
# ---------------------------------------------------------------------------


def init_label_corrector(gen, num_classes: int, hidden: int = 128, *, device) -> Tree:
    return {
        "l1": _dense_init(gen, 2 * num_classes, hidden, device=device),
        "l2": _dense_init(gen, hidden, num_classes, device=device),
        "mix": _dense_init(gen, hidden, 1, device=device),
    }


def apply_label_corrector(params: Tree, model_probs: torch.Tensor,
                          noisy_onehot: torch.Tensor) -> torch.Tensor:
    """Corrected soft labels (B, C): a learned convex mix of the observed
    noisy label and an MLP-proposed distribution."""

    x = torch.cat([model_probs.detach(), noisy_onehot], dim=-1)
    h = F.relu(_dense(params["l1"], x))
    proposed = torch.softmax(_dense(params["l2"], h), dim=-1)
    gate = torch.sigmoid(_dense(params["mix"], h))  # (B, 1)
    return (1.0 - gate) * noisy_onehot + gate * proposed
