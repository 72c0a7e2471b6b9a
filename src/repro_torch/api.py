"""The level-1 public API, after ``src/repro/api.py``: ``MetaLearner``
owns the bilevel program end to end. Pick optimizers by name and a
hypergradient method by registry name (or hand in a ``HypergradMethod``),
then ``init / step / fit / save / load``, with checkpointing in the JAX
package's format (``repro_torch.checkpoint``) and ``profile`` through
``repro_torch.perf``; the remaining keywords are ``EngineConfig`` fields
(``alpha``, ``base_nudge``, ``adapt_clip``, the baselines'
``neumann_terms``, ``neumann_scale``, ``cg_iters``, ``cg_damping``, and
``scale``, a ``repro_torch.scale.ScaleConfig``: precision policy and
microbatch count). A ``mesh`` (``repro_torch.launch.mesh``) runs the step
data parallel over ``torch.distributed`` with one of the ``SCHEDULES``:
the paper's single-sync schedule or the global-batch (pjit) baseline
(``repro_torch.launch.distributed``). Every rank builds the same learner,
calls it with the same global batches and keeps the same state; only
rank 0 writes a checkpoint, and every rank loads it.

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
from repro_torch.core.engine import EngineConfig, EngineState, init_state, run_loop
from repro_torch.core.methods import HypergradMethod

Tree = Any

#: "auto": single_sync when a mesh is given, else the Engine step;
#: "pjit": the global-batch step (the Engine step without a mesh);
#: "single_sync": the paper's one-bucket schedule, which needs a mesh
SCHEDULES = ("auto", "pjit", "single_sync")

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
        mesh=None,
        schedule: str = "auto",
        allow_nonlinear: bool = False,
        checkpoint_dir: Optional[str] = None,
        **method_knobs,
    ):
        if schedule not in SCHEDULES:
            raise ValueError(f"schedule {schedule!r} not in {SCHEDULES}")
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
        self.mesh = mesh
        if schedule == "auto":
            schedule = "single_sync" if mesh is not None else "pjit"
        from repro_torch.launch.distributed import make_manual_step, make_pjit_step

        if schedule == "single_sync":
            if mesh is None:
                raise ValueError("schedule='single_sync' needs a mesh")
            self.step_fn = make_manual_step(self.spec, self.base_opt, self.meta_opt, self.cfg,
                                            mesh, allow_nonlinear=allow_nonlinear)
        else:  # the Engine step, as the global-batch estimator under a mesh
            self.step_fn = make_pjit_step(self.spec, self.base_opt, self.meta_opt, self.cfg,
                                          mesh)
        self.schedule = schedule

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
        extra = {"method": self.method.name, "schedule": self.schedule,
                 "unroll_steps": self.cfg.unroll_steps,
                 "microbatch": self.cfg.scale.microbatch,
                 "policy": self.cfg.scale.resolve().name}
        if self.mesh is not None:
            extra.update(mesh=dict(self.mesh.shape), backend=self.mesh.backend)
        return perf.profile_step(name or self.method.name, self.step_fn, self.state,
                                 base_batches, meta_batch, samples_per_step=samples_per_step,
                                 warmup=warmup, repeats=repeats, extra=extra)

    def verify_census(self, base_batches, meta_batch) -> Dict[str, Any]:
        """Run one step on these batches under a ``CollectiveCounter`` and
        check the census against the pinned ``unroll_steps + 1``
        all-reduces (``perf.verify_single_sync``). The learner's state does
        not advance (the step is a function of it). Meaningful on the
        single-sync schedule: the others pin nothing. Under a mesh every
        rank must call it, as every collective needs every rank."""

        from repro_torch.launch.distributed import CollectiveCounter
        from repro_torch.perf import collectives

        if self.state is None:
            raise RuntimeError("call init(theta, lam) or load(...) before verify_census()")
        with CollectiveCounter() as counter:
            self.step_fn(self.state, base_batches, meta_batch)
        return collectives.verify_single_sync(counter, self.cfg.unroll_steps)

    # -- checkpointing -----------------------------------------------------

    def save(self, path: Optional[str] = None, *, meta: Optional[Dict[str, Any]] = None) -> str:
        """Checkpoint the full EngineState. Default path:
        ``{checkpoint_dir}/step_{NNNNNN}``. ``meta`` entries are merged into
        the manifest beside the learner's own (method, unroll_steps, and
        the schedule under a mesh). Under a mesh every rank calls it: rank
        0 writes (the ranks hold one state) and all return after it has."""

        if self.state is None:
            raise RuntimeError("nothing to save: no state")
        step = int(self.state.step)
        if path is None:
            if self.checkpoint_dir is None:
                raise ValueError("no path given and no checkpoint_dir configured")
            path = os.path.join(self.checkpoint_dir, f"step_{step:06d}")
        manifest_meta = {"method": self.method.name, "unroll_steps": self.cfg.unroll_steps}
        if self.mesh is not None:
            manifest_meta["schedule"] = self.schedule
        if meta:
            manifest_meta.update(meta)
        if self.mesh is None or self.mesh.rank == 0:
            checkpoint.save(path, self.state, step=step, meta=manifest_meta)
        if self.mesh is not None:
            # every rank returns once the checkpoint is on disk
            from repro_torch.launch.distributed import collective

            collective("barrier", None, self.mesh)
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
