"""Model: the user-facing handle tying an ArchConfig to init, the training
forward, its per-example losses and decode on one device, after
``src/repro/models/model.py``.

The per-example adapters return what SAMA's data reweighting consumes: the
per-sequence mean token CE of an LM (``per_example``) or the per-sample CE
of a classifier (``classifier_per_example``), each with its predictive
entropy. At ``CE_VOCAB_THRESHOLD`` classes and above (or with
``use_ce_kernel``) the CE takes the ``weighted_ce`` kernels
(``core.problems.vocab_cross_entropy``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Union

import torch
import torch.nn.functional as F

from repro_torch.core.problems import PerExample, vocab_cross_entropy
from repro_torch.kernels import dispatch
from repro_torch.models import common as cm
from repro_torch.models import transformer as tf

Tree = Any


def token_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                        use_kernel: bool = False, sharded: bool = False) -> torch.Tensor:
    """logits (B, S, V) f32, targets (B, S) int: per-token CE (B, S). At
    V >= ``CE_VOCAB_THRESHOLD``, or for any V with ``use_kernel=True``, it
    routes through ``weighted_ce`` (f32 result); below, a log-softmax in
    the logits' dtype.

    ``sharded=True`` is the JAX package's one-hot-reduction form (plain
    ops, no kernel there either): the lse from a max and a sum over V and
    the target logit from a compare-select sum, reductions that a
    vocab-sharded V axis turns into (token,)-sized all-reduces where a
    gather would collect the whole logits tensor. The port's model axis is
    FSDP (``launch.fsdp``): each rank gathers the whole parameters, so its
    logits keep the whole V axis and no V axis is sharded (that needs
    tensor parallelism); ``cfg.sharded_ce`` selects the form all the
    same."""
    if sharded:
        m = torch.amax(logits, dim=-1, keepdim=True)
        lse = torch.log(torch.sum(torch.exp(logits - m), dim=-1)) + m[..., 0]
        ids = torch.arange(logits.shape[-1], device=logits.device)
        hit = ids == targets[..., None].long()
        tgt = torch.sum(torch.where(hit, logits, torch.zeros((), dtype=logits.dtype,
                                                             device=logits.device)), dim=-1)
        return lse - tgt
    if use_kernel or logits.shape[-1] >= dispatch.CE_VOCAB_THRESHOLD:
        return vocab_cross_entropy(logits, targets)
    logp = F.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, targets.long()[..., None])[..., 0]


@dataclasses.dataclass(eq=False)
class Model:
    """``device`` defaults to ``"cuda"`` and raises there without a card;
    pass ``device="cpu"`` to run on the CPU. ``use_ce_kernel`` sends the LM
    losses' CE through ``weighted_ce`` at any vocabulary size."""

    cfg: Any
    device: Union[str, torch.device] = "cuda"
    use_ce_kernel: bool = False

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
    def forward(self, params, batch):
        return tf.forward(self.cfg, params, batch)

    @torch.no_grad()
    def decode_step(self, params, cache, tokens, pos):
        return tf.decode_step(self.cfg, params, cache, tokens, pos)

    # -- losses --
    def lm_loss(self, params, batch) -> torch.Tensor:
        """Next-token LM loss (scalar) + aux. batch: tokens (B, S)."""
        logits, aux = self.forward(params, batch)
        ce = token_cross_entropy(logits[:, :-1], batch["tokens"][:, 1:], self.use_ce_kernel,
                                 self.cfg.sharded_ce)
        return torch.mean(ce) + aux

    def per_example(self, params, batch) -> PerExample:
        """Per-sequence loss for data-optimization meta learning."""
        logits, _ = self.forward(params, batch)
        ce = token_cross_entropy(logits[:, :-1], batch["tokens"][:, 1:], self.use_ce_kernel,
                                 self.cfg.sharded_ce)
        loss = torch.mean(ce, dim=-1)  # (B,)
        logp = F.log_softmax(logits[:, -1].float(), dim=-1)
        entropy = -torch.sum(torch.exp(logp) * logp, dim=-1)
        return PerExample(loss=loss, uncertainty=entropy)

    def classifier_per_example(self, params, batch) -> PerExample:
        """family == 'encoder': batch = {tokens (B, S), y (B,)}."""
        logits, _ = self.forward(params, batch)
        onehot = cm.one_hot(batch["y"], logits.shape[-1], logits.dtype)
        logp = F.log_softmax(logits, dim=-1)
        if logits.shape[-1] >= dispatch.CE_VOCAB_THRESHOLD:
            loss = vocab_cross_entropy(logits, batch["y"])
        else:
            loss = -torch.sum(onehot * logp, dim=-1)
        p = torch.exp(logp)
        entropy = -torch.sum(p * logp, dim=-1)
        return PerExample(loss=loss, logits=logits, label_onehot=onehot, uncertainty=entropy)

    def num_params(self, params) -> int:
        return sum(x.numel() for x in cm.tree_flatten(params)[0])
