"""The level-1 public API, after ``src/repro/api.py``: ``MetaLearner``
owns the bilevel program end to end. Pick optimizers by name and a
hypergradient method by registry name (or hand in a ``HypergradMethod``),
then ``init / step / fit``; the remaining keywords are ``EngineConfig``
fields (``alpha``, ``base_nudge``, ``adapt_clip``, ``scale``).
Checkpointing (``save`` / ``load``), meshes and the distributed schedules
come with their slices.

Typical use::

    from repro_torch import api
    from repro_torch.core import problems

    learner = api.MetaLearner(spec, base_opt="adam", base_lr=1e-2,
                              meta_opt="adam", meta_lr=1e-2,
                              method="sama", unroll_steps=2)
    learner.init(theta0, lam0)
    history = learner.fit(batch_iter, steps=200, log_every=50)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

from repro_torch import optim
from repro_torch.core.bilevel import BilevelSpec
from repro_torch.core.engine import (EngineConfig, EngineState, init_state, make_meta_step,
                                     run_loop)
from repro_torch.core.methods import HypergradMethod

Tree = Any

_ENGINE_FIELDS = {f.name for f in dataclasses.fields(EngineConfig)}


class MetaLearner:
    """Facade over the meta step. Holds the step function and the current
    EngineState; all mutation is confined to ``self.state``. The state
    lives on the device of the trees given to ``init``."""

    def __init__(
        self,
        spec: BilevelSpec,
        *,
        base_opt: Union[str, optim.Optimizer] = "adam",
        base_lr: float = 1e-3,
        meta_opt: Union[str, optim.Optimizer] = "adam",
        meta_lr: float = 1e-3,
        method: Union[str, HypergradMethod] = "sama",
        unroll_steps: int = 1,
        **method_knobs,
    ):
        unknown = set(method_knobs) - _ENGINE_FIELDS
        if unknown:
            raise TypeError(f"unknown method knobs {sorted(unknown)}; "
                            f"EngineConfig accepts {sorted(_ENGINE_FIELDS)}")
        self.spec = spec
        self.base_opt = (optim.get_optimizer(base_opt, base_lr) if isinstance(base_opt, str)
                         else base_opt)
        self.meta_opt = (optim.get_optimizer(meta_opt, meta_lr) if isinstance(meta_opt, str)
                         else meta_opt)
        self.cfg = EngineConfig(method=method, unroll_steps=unroll_steps, **method_knobs)
        self.method = self.cfg.resolve()
        self.state: Optional[EngineState] = None
        self.step_fn = make_meta_step(self.spec, self.base_opt, self.meta_opt, self.cfg)

    def init(self, theta: Tree, lam: Tree) -> EngineState:
        """Build the EngineState: both levels' params + optimizer moments."""
        self.state = init_state(theta, lam, self.base_opt, self.meta_opt)
        return self.state

    def step(self, base_batches, meta_batch) -> Dict[str, Any]:
        """One meta step: K base updates + one meta update. Advances
        ``self.state`` and returns the metric dict (0-d tensors on the
        device: reading one waits for the step)."""

        if self.state is None:
            raise RuntimeError("call init(theta, lam) before step()")
        self.state, metrics = self.step_fn(self.state, base_batches, meta_batch)
        return metrics

    def fit(self, batch_iter: Iterator[Tuple[Any, Any]], steps: int, *,
            log_every: int = 0) -> List[Dict[str, float]]:
        """Run ``steps`` meta steps from an iterator of (base_batches[K],
        meta_batch); returns the metrics read at the ``log_every`` cadence
        (one device-to-host copy per logged step, ``run_loop``)."""

        if self.state is None:
            raise RuntimeError("call init(theta, lam) before fit()")

        def step_adapter(state, base_batches, meta_batch):
            metrics = self.step(base_batches, meta_batch)  # advances self.state
            return self.state, metrics

        _, history = run_loop(step_adapter, self.state, batch_iter, steps, log_every)
        return history
