"""Optimizer substrate: tree optimizers + analytic SAMA adaptation matrices."""

from repro_torch.optim import schedules
from repro_torch.optim.optimizers import (
    OptState,
    Optimizer,
    adafactor,
    adam,
    adamw,
    apply_updates,
    get_optimizer,
    lion,
    momentum,
    rmsprop,
    sgd,
)

__all__ = [
    "OptState",
    "Optimizer",
    "adafactor",
    "adam",
    "adamw",
    "apply_updates",
    "get_optimizer",
    "lion",
    "momentum",
    "rmsprop",
    "sgd",
    "schedules",
]
