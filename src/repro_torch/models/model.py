"""Model: the user-facing handle tying an ArchConfig to init and decode on
one device, after ``src/repro/models/model.py``. The losses come with the
training slice."""

from __future__ import annotations

import dataclasses
from typing import Any, Union

import torch

from repro_torch.models import common as cm
from repro_torch.models import transformer as tf

Tree = Any


@dataclasses.dataclass(eq=False)
class Model:
    """``device`` defaults to ``"cuda"`` and raises there without a card;
    pass ``device="cpu"`` to run on the CPU."""

    cfg: Any
    device: Union[str, torch.device] = "cuda"

    def __post_init__(self):
        self.device = cm.resolve_device(self.device)

    # -- params / caches --
    def init(self, seed: int = 0) -> Tree:
        return tf.init_params(self.cfg, seed, device=self.device)

    def init_cache(self, batch: int, cache_len: int, dtype=torch.bfloat16,
                   device=None) -> Tree:
        return tf.init_cache(self.cfg, batch, cache_len, dtype,
                             device=self.device if device is None else device)

    # -- compute paths --
    @torch.no_grad()
    def decode_step(self, params, cache, tokens, pos):
        return tf.decode_step(self.cfg, params, cache, tokens, pos)

    def num_params(self, params) -> int:
        return sum(x.numel() for x in cm.tree_flatten(params)[0])
