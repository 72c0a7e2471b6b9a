"""The level-1 public API, after ``src/repro/api.py``: ``MetaLearner``
owns the bilevel program end to end. Pick optimizers by name and a
hypergradient method by registry name (or hand in a ``HypergradMethod``),
then ``init / step / fit / save / load``, with checkpointing in the JAX
package's format (``repro_torch.checkpoint``) and ``profile`` through
``repro_torch.perf``; the remaining keywords are ``EngineConfig`` fields
(``alpha``, ``base_nudge``, ``adapt_clip``, the baselines'
``neumann_terms``, ``neumann_scale``, ``cg_iters``, ``cg_damping``, and
``scale``, a ``repro_torch.scale.ScaleConfig``: precision policy and
microbatch count). ``obs`` (a ``repro_torch.obs.Obs``) receives the
metrics, loss-scale and gate events at ``fit``'s log boundary, the
census verdict of ``verify_census`` and the checkpoint events;
``phase_profile`` gives each phase's wall time. A ``mesh``
(``repro_torch.launch.mesh``) runs the step
data parallel over ``torch.distributed`` with one of the ``SCHEDULES``:
the paper's single-sync schedule or the global-batch (pjit) baseline
(``repro_torch.launch.distributed``). On a mesh with a model extent above
1 ``init`` places the state sharded over the model group by the partition
rules (``launch.fsdp.FSDP`` of theta, with ``model_cfg``'s head
alignment). Every rank builds the same learner, calls
it with the same global batches and keeps its part of one state; a
checkpoint holds the whole leaves, written by rank 0 of the world, and
every rank loads its part.

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

import torch

from repro_torch import checkpoint, optim
from repro_torch import obs as obs_mod
from repro_torch import tree as tu
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
        model_cfg=None,
        allow_nonlinear: bool = False,
        checkpoint_dir: Optional[str] = None,
        obs=None,
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
        self.obs = obs if obs is not None else obs_mod.NULL_OBS
        self.state: Optional[EngineState] = None
        self.mesh = mesh
        if schedule == "auto":
            schedule = "single_sync" if mesh is not None else "pjit"
        if schedule == "single_sync" and mesh is None:
            raise ValueError("schedule='single_sync' needs a mesh")
        self.schedule, self.model_cfg = schedule, model_cfg
        self._allow_nonlinear = allow_nonlinear
        #: the state's layout over the model group (``launch.fsdp.FSDP``),
        #: made by ``init`` on a mesh whose model extent exceeds 1
        self.sharding = None
        self.step_fn = None if self._sharded_mesh else self._make_step()

    @property
    def _sharded_mesh(self) -> bool:
        return self.mesh is not None and self.mesh.model_size > 1

    def _make_step(self):
        from repro_torch.launch.distributed import make_manual_step, make_pjit_step

        if self.schedule == "single_sync":
            return make_manual_step(self.spec, self.base_opt, self.meta_opt, self.cfg,
                                    self.mesh, allow_nonlinear=self._allow_nonlinear,
                                    sharding=self.sharding)
        # the Engine step, as the global-batch estimator under a mesh
        return make_pjit_step(self.spec, self.base_opt, self.meta_opt, self.cfg, self.mesh,
                              sharding=self.sharding)

    def init(self, theta: Tree, lam: Tree) -> EngineState:
        """Build the EngineState: both levels' params + optimizer moments;
        a loss-scaling precision policy (f16) also seeds its
        LossScaleState from ``cfg.scale``. ``theta`` holds the whole
        leaves; on a mesh with a model extent above 1 the state keeps this
        rank's blocks of theta and the base moments (``self.sharding``)."""
        if self._sharded_mesh:
            from repro_torch.launch.fsdp import FSDP

            self.sharding = FSDP(theta, self.mesh, self.model_cfg)
            self.step_fn = self._make_step()
        self.state = init_state(theta, lam, self.base_opt, self.meta_opt, scale=self.cfg.scale,
                                sharding=self.sharding)
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
            log_every: int = 0, save_every: int = 0, obs=None) -> List[Dict[str, float]]:
        """Run ``steps`` meta steps from an iterator of (base_batches[K],
        meta_batch); returns the metrics read at the ``log_every`` cadence
        (one device-to-host copy per logged step, ``run_loop``). Saves a
        checkpoint every ``save_every`` steps into ``checkpoint_dir``.
        ``obs`` (the learner's own by default) receives the metrics, scale
        and gate events at the same boundary: no added sync point."""

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
                              on_step=on_step, obs=obs if obs is not None else self.obs)
        return history

    def profile(self, base_batches, meta_batch, *, warmup: int = 2, repeats: int = 5,
                name: Optional[str] = None, samples_per_step: Optional[float] = None,
                attribution: bool = False, attribution_spans=None):
        """Measure this learner's step on example batches through
        ``repro_torch.perf.profile_step``: warmup/repeat/synchronize timing,
        the first call's seconds and, on the card, peak memory. Returns a
        ``perf.PerfRecord``. Every call steps from ``self.state``, which is
        not advanced. ``attribution=True`` adds the per-phase attribution
        of one step (``obs.profile``); ``attribution_spans`` (from
        :meth:`phase_profile`) join each phase's wall time and utilization
        into it."""

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
                                 warmup=warmup, repeats=repeats, extra=extra,
                                 attribution=attribution, attribution_spans=attribution_spans)

    def phase_profile(self, base_batches, meta_batch):
        """Per-phase wall times: ONE step under an activated span tracer
        that synchronises the device at each span's end, so each span of
        the engine's phases (base unroll, local terms with SAMA's meta pass
        and CD passes, finalize, meta update, and the flat-bucket
        all-reduce on the single-sync schedule) is the phase's wall time,
        device work included. Returns the ``repro_torch.obs.Span`` list;
        with an enabled obs on the learner each span is also a ``span``
        event. The state does not advance (the step is a function of it).
        The syncs cost the overlap of host and device, so read the spans as
        the phases' relative cost; ``profile`` times whole steps."""

        if self.state is None:
            raise RuntimeError("call init(theta, lam) or load(...) before phase_profile()")
        on_card = tu.tree_leaves(self.state.theta)[0].is_cuda
        tracer = obs_mod.Tracer(obs=self.obs if self.obs.enabled else None,
                                sync=torch.cuda.synchronize if on_card else None)
        with obs_mod.activate(tracer):
            self.step_fn(self.state, base_batches, meta_batch)
        return tracer.runtime_spans()

    def verify_census(self, base_batches, meta_batch) -> Dict[str, Any]:
        """Run one step on these batches under a ``CollectiveCounter`` and
        check the census against the pinned ``unroll_steps + 1``
        all-reduces of the data group (``perf.verify_single_sync``; the
        model group's collectives beside them). The learner's state does
        not advance (the step is a function of it). Meaningful on the
        single-sync schedule: the others pin nothing. Under a mesh every
        rank must call it, as every collective needs every rank. With an
        enabled obs the verdict is a ``census`` event (a mismatch trips the
        census health monitor)."""

        from repro_torch.launch.distributed import CollectiveCounter
        from repro_torch.perf import collectives

        if self.state is None:
            raise RuntimeError("call init(theta, lam) or load(...) before verify_census()")
        with CollectiveCounter() as counter:
            self.step_fn(self.state, base_batches, meta_batch)
        stats = collectives.verify_single_sync(counter, self.cfg.unroll_steps)
        if self.obs.enabled:
            self.obs.observe_census(stats.get("all-reduce_count", 0),
                                    stats["expected_all_reduces"],
                                    detail={"schedule": self.schedule})
        return stats

    # -- checkpointing -----------------------------------------------------

    def save(self, path: Optional[str] = None, *, meta: Optional[Dict[str, Any]] = None) -> str:
        """Checkpoint the full EngineState. Default path:
        ``{checkpoint_dir}/step_{NNNNNN}``. ``meta`` entries are merged into
        the manifest beside the learner's own (method, unroll_steps, and
        the schedule under a mesh). Under a mesh every rank calls it: rank
        0 of the world writes (the ranks hold one state; sharded leaves are
        gathered whole first) and all return after it has."""

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
        if self.sharding is not None:
            checkpoint.save(path, self.state, step=step, meta=manifest_meta,
                            sharding=self.sharding)
        elif self.mesh is None or self.mesh.world_rank == 0:
            checkpoint.save(path, self.state, step=step, meta=manifest_meta)
        if self.mesh is not None:
            # every rank returns once the checkpoint is on disk
            from repro_torch.launch.distributed import collective

            collective("barrier", None, self.mesh, over="world")
        if self.obs.enabled:
            self.obs.emit("checkpoint", "save", step=step, data={"path": path})
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
        state, manifest = checkpoint.restore(path, self.state, sharding=self.sharding)
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
        if self.obs.enabled:
            self.obs.emit("checkpoint", "restore", step=int(state.step),
                          data={"path": path})
        return self.state
