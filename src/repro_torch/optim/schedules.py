"""Learning-rate schedules as functions of the step count, after
``src/repro/optim/schedules.py``.

Every schedule maps the optimizer's step count (a 0-d int32 tensor on the
training device) to a 0-d f32 tensor on the same device, so a scheduled
rate never costs a host sync. ``resolve(lr)`` lets optimizer factories
accept either a float or a schedule.
"""

from __future__ import annotations

import math
from typing import Callable, Union

import torch

Schedule = Callable[[torch.Tensor], torch.Tensor]
ScalarOrSchedule = Union[float, Schedule]


def constant(value: float) -> Schedule:
    def sched(step):
        # a fill on the step's device, not a host-to-device copy
        return torch.full((), value, dtype=torch.float32, device=step.device)

    return sched


def cosine_decay(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    def sched(step):
        frac = torch.clamp(step.float() / max(decay_steps, 1), 0.0, 1.0)
        cosine = 0.5 * (1.0 + torch.cos(math.pi * frac))
        return init_value * ((1.0 - alpha) * cosine + alpha)

    return sched


def linear_warmup_cosine(
    init_value: float, warmup_steps: int, decay_steps: int, end_value: float = 0.0
) -> Schedule:
    def sched(step):
        step = step.float()
        warm = init_value * step / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps) / max(decay_steps - warmup_steps, 1), 0.0, 1.0)
        cos = end_value + (init_value - end_value) * 0.5 * (1.0 + torch.cos(math.pi * frac))
        return torch.where(step < warmup_steps, warm, cos)

    return sched


def linear_decay_with_warmup(
    init_value: float, total_steps: int, warmup_proportion: float = 0.1
) -> Schedule:
    """The BERT-style schedule used in the paper's continued-pretraining runs."""

    warmup_steps = max(int(total_steps * warmup_proportion), 1)

    def sched(step):
        step = step.float()
        warm = init_value * step / warmup_steps
        decay = init_value * torch.clamp(
            (total_steps - step) / max(total_steps - warmup_steps, 1), 0.0, 1.0
        )
        return torch.where(step < warmup_steps, warm, decay)

    return sched


def resolve(lr: ScalarOrSchedule) -> Schedule:
    if callable(lr):
        return lr
    return constant(float(lr))
