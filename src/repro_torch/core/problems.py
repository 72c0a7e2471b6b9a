"""Builders of BilevelSpecs for the paper's data-optimization applications
(Sec. 4), after ``src/repro/core/problems.py``:

``make_data_optimization_spec``: noisy-data reweighting (+ optional label
correction), Sec. 4.1 / data pruning Sec. 4.3 (uncertainty feature). The
auxiliary-loss spec of Sec. 4.2 comes with the continued-pretraining path.

They are model-agnostic: the caller supplies a ``per_example_fn`` mapping
(theta, batch) to per-sample quantities.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import meta_modules as mm
from repro_torch.core.bilevel import BilevelSpec
from repro_torch.kernels import dispatch, weighted_ce
from repro_torch.device import resolve_device

Tree = Any


@dataclasses.dataclass
class PerExample:
    """Per-sample quantities from the base model on one batch."""

    loss: torch.Tensor  # (B,) per-sample loss under the observed labels
    logits: Optional[torch.Tensor] = None  # (B, C), for label correction
    label_onehot: Optional[torch.Tensor] = None  # (B, C)
    uncertainty: Optional[torch.Tensor] = None  # (B,)


PerExampleFn = Callable[[Tree, Any], PerExample]


def vocab_cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-row CE (...) f32 over (..., V) logits: the route the JAX package
    takes through its ``weighted_ce`` kernel at ``CE_VOCAB_THRESHOLD``
    classes and above (``ops.cross_entropy``). A CUDA tensor launches the
    port's ``weighted_ce`` kernels, forward and backward; a CPU tensor
    takes their plain versions."""

    return weighted_ce.cross_entropy(logits, targets)


def init_data_optimization_lam(
    seed: int = 0,
    *,
    reweight: bool = True,
    correct: bool = False,
    num_classes: Optional[int] = None,
    use_uncertainty: bool = False,
    hidden: int = 100,
    device="cuda",
) -> Tree:
    """Random meta parameters from ``seed`` on ``device`` (``"cuda"``
    unless the caller passes ``device="cpu"``)."""

    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    lam = {}
    if reweight:
        in_dim = 2 if use_uncertainty else 1
        lam["reweight"] = mm.init_weight_net(gen, in_dim=in_dim, hidden=hidden, device=device)
    if correct:
        if num_classes is None:
            raise ValueError("label correction needs num_classes")
        lam["correct"] = mm.init_label_corrector(gen, num_classes=num_classes, device=device)
    return lam


def make_data_optimization_spec(
    per_example_fn: PerExampleFn,
    *,
    reweight: bool = True,
    correct: bool = False,
    use_uncertainty: bool = False,
) -> BilevelSpec:
    """Sec. 4.1:  min_lam L(D_clean; theta*)  s.t.
    theta* = argmin mean_i w(L_i; lam_r) * CE(f(x_i), c(x_i, y_i; lam_c))."""

    def base_loss(theta, lam, batch):
        pe = per_example_fn(theta, batch)
        loss_i = pe.loss
        if correct:
            probs = torch.softmax(pe.logits, dim=-1)
            corrected = mm.apply_label_corrector(lam["correct"], probs, pe.label_onehot)
            logp = F.log_softmax(pe.logits, dim=-1)
            loss_i = -torch.sum(corrected * logp, dim=-1)
        if reweight:
            feats = mm.weight_features(loss_i, pe.uncertainty if use_uncertainty else None)
            w = mm.apply_weight_net(lam["reweight"], feats)
            return torch.mean(w * loss_i)
        return torch.mean(loss_i)

    def meta_loss(theta, lam, batch):
        del lam  # the meta loss is plain risk on clean/meta data
        pe = per_example_fn(theta, batch)
        return torch.mean(pe.loss)

    return BilevelSpec(base_loss=base_loss, meta_loss=meta_loss)


def softmax_per_example(apply_fn: Callable[[Tree, torch.Tensor], torch.Tensor]) -> PerExampleFn:
    """Adapter for plain classifiers: batch = {'x': (B, ...), 'y': (B,)
    int}. Uncertainty is the in-batch predictive entropy. At
    ``CE_VOCAB_THRESHOLD`` classes and above the CE takes
    :func:`vocab_cross_entropy` (f32 whatever the logits' dtype)."""

    def fn(theta, batch):
        logits = apply_fn(theta, batch["x"])
        num_classes = logits.shape[-1]
        onehot = F.one_hot(batch["y"].long(), num_classes).to(logits.dtype)
        logp = F.log_softmax(logits, dim=-1)
        if num_classes >= dispatch.CE_VOCAB_THRESHOLD:
            loss = vocab_cross_entropy(logits, batch["y"])
        else:
            loss = -torch.sum(onehot * logp, dim=-1)
        p = torch.exp(logp)
        entropy = -torch.sum(p * logp, dim=-1)
        return PerExample(loss=loss, logits=logits, label_onehot=onehot, uncertainty=entropy)

    return fn
