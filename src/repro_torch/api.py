"""The level-1 public API, after ``src/repro/api.py``: ``MetaLearner``
owns the bilevel program end to end. Pick optimizers by name and a
hypergradient method by registry name (or hand in a ``HypergradMethod``),
then ``init / step / fit / save / load``, with checkpointing in the JAX
package's format (``repro_torch.checkpoint``) and ``profile`` through
``repro_torch.perf``; the remaining keywords are ``EngineConfig`` fields
(``alpha``, ``base_nudge``, ``adapt_clip``, the baselines'
``neumann_terms``, ``neumann_scale``, ``cg_iters``, ``cg_damping``, and
``scale``, a ``repro_torch.scale.ScaleConfig``: precision policy and
microbatch count). Meshes and the distributed schedules come with their
slices.

Typical use::

    from repro_torch import api
    from repro_torch.core import problems

    learner = api.MetaLearner(spec, base_opt="adam", base_lr=1e-2,
                              meta_opt="adam", meta_lr=1e-2,
                              method="sama", unroll_steps=2,
                              checkpoint_dir="out/ck")
    learner.init(theta0, lam0)
    history = learner.fit(batch_iter, steps=200, log_every=50)
    learner.save()
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

from repro_torch import checkpoint, optim
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
        checkpoint_dir: Optional[str] = None,
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
        self.checkpoint_dir = checkpoint_dir
        self.state: Optional[EngineState] = None
        self.step_fn = make_meta_step(self.spec, self.base_opt, self.meta_opt, self.cfg)

    def init(self, theta: Tree, lam: Tree) -> EngineState:
        """Build the EngineState: both levels' params + optimizer moments;
        a loss-scaling precision policy (f16) also seeds its
        LossScaleState from ``cfg.scale``."""
        self.state = init_state(theta, lam, self.base_opt, self.meta_opt, scale=self.cfg.scale)
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
            log_every: int = 0, save_every: int = 0) -> List[Dict[str, float]]:
        """Run ``steps`` meta steps from an iterator of (base_batches[K],
        meta_batch); returns the metrics read at the ``log_every`` cadence
        (one device-to-host copy per logged step, ``run_loop``). Saves a
        checkpoint every ``save_every`` steps into ``checkpoint_dir``."""

        if save_every and self.checkpoint_dir is None:
            raise ValueError("fit(save_every=...) needs a checkpoint_dir")
        if self.state is None:
            raise RuntimeError("call init(theta, lam) or load(...) before fit()")

        def step_adapter(state, base_batches, meta_batch):
            metrics = self.step(base_batches, meta_batch)  # advances self.state
            return self.state, metrics

        def on_step(i, state):
            if save_every and (i + 1) % save_every == 0:
                self.save()

        _, history = run_loop(step_adapter, self.state, batch_iter, steps, log_every,
                              on_step=on_step)
        return history

    def profile(self, base_batches, meta_batch, *, warmup: int = 2, repeats: int = 5,
                name: Optional[str] = None, samples_per_step: Optional[float] = None):
        """Measure this learner's step on example batches through
        ``repro_torch.perf.profile_step``: warmup/repeat/synchronize timing,
        the first call's seconds and, on the card, peak memory. Returns a
        ``perf.PerfRecord``. Every call steps from ``self.state``, which is
        not advanced."""

        from repro_torch import perf

        if self.state is None:
            raise RuntimeError("call init(theta, lam) or load(...) before profile()")
        extra = {"method": self.method.name, "unroll_steps": self.cfg.unroll_steps,
                 "microbatch": self.cfg.scale.microbatch,
                 "policy": self.cfg.scale.resolve().name}
        return perf.profile_step(name or self.method.name, self.step_fn, self.state,
                                 base_batches, meta_batch, samples_per_step=samples_per_step,
                                 warmup=warmup, repeats=repeats, extra=extra)

    # -- checkpointing -----------------------------------------------------

    def save(self, path: Optional[str] = None, *, meta: Optional[Dict[str, Any]] = None) -> str:
        """Checkpoint the full EngineState. Default path:
        ``{checkpoint_dir}/step_{NNNNNN}``. ``meta`` entries are merged into
        the manifest beside the learner's own (method, unroll_steps)."""

        if self.state is None:
            raise RuntimeError("nothing to save: no state")
        step = int(self.state.step)
        if path is None:
            if self.checkpoint_dir is None:
                raise ValueError("no path given and no checkpoint_dir configured")
            path = os.path.join(self.checkpoint_dir, f"step_{step:06d}")
        manifest_meta = {"method": self.method.name, "unroll_steps": self.cfg.unroll_steps}
        if meta:
            manifest_meta.update(meta)
        checkpoint.save(path, self.state, step=step, meta=manifest_meta)
        return path

    def load(self, path: Optional[str] = None) -> EngineState:
        """Restore the EngineState that ``save`` (or the JAX package's
        ``MetaLearner.save``) wrote. With no ``path``, the newest ``step_*``
        under ``checkpoint_dir``. Needs a template state (from ``init``):
        the restored leaves take its devices and dtypes."""

        if self.state is None:
            raise RuntimeError("call init(theta, lam) first: restore validates "
                               "against the live state structure")
        if path is None:
            if self.checkpoint_dir is None:
                raise ValueError("no path given and no checkpoint_dir configured")
            path = checkpoint.latest_step(self.checkpoint_dir)
            if path is None:
                raise FileNotFoundError(f"no step_* checkpoints under {self.checkpoint_dir}")
        state, manifest = checkpoint.restore(path, self.state)
        # the EngineState structure is method-independent, so a structural
        # match alone would silently resume another estimator's trajectory
        meta = manifest.get("meta", {})
        for key, mine in (("method", self.method.name),
                          ("unroll_steps", self.cfg.unroll_steps)):
            if key in meta and meta[key] != mine:
                raise ValueError(
                    f"checkpoint {path} was saved with {key}={meta[key]!r} but this "
                    f"learner uses {mine!r}; construct a matching MetaLearner "
                    "(or restore via repro_torch.checkpoint directly to override)")
        self.state = state
        return self.state
