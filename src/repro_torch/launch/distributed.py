"""The paper's distributed execution schedule (Fig. 2) on
``torch.distributed``, after ``src/repro/launch/distributed.py``: pure data
parallelism over a mesh's data axes (``launch.mesh``), one rank per
device, every rank holding the whole state.

Two implementations of one meta step, each with the Engine step's
signature ``(state, base_batches[K], meta_batch) -> (state, metrics)``
over the GLOBAL batches; each rank takes its own rows (axis 1 of the base
batches, axis 0 of the meta batch: the reference's ``batch_spec`` and
``meta_spec``):

* :func:`make_manual_step`, the paper's single-sync schedule: the base
  unroll keeps its per-step DDP reduce (one flat bucket per base step, on
  the gradient accumulated over M microbatches); ``local_terms`` runs on
  the rank's rows with no collective; ONE flat bucket carries the terms
  the method's ``reduce_contract`` names plus the base-loss metric; then
  ``finalize`` and the guarded meta update on replica-consistent values.
  Exactly ``unroll_steps + 1`` all-reduces per meta step, whatever M and
  the precision policy. A nonlinear contract (CG, Neumann, iterdiff) is
  refused unless ``allow_nonlinear=True`` takes the average of local
  solves.
* :func:`make_pjit_step`, the naive-DDP baseline: the global-batch
  estimator that JAX's partitioner makes of the Engine step. The Engine
  step runs on the rank's rows under a reducer (``core.sync``) that the
  port's gradient chokepoints read, so every gradient of a batch-mean loss
  is averaged over the ranks where the step takes it, and the batch-mean
  metrics once at the end. On N ranks with distinct shards it equals the
  one-process Engine step on the concatenated batch up to rounding.

Every collective the port makes goes through :func:`collective`, which
counts calls and bytes per kind inside a :class:`CollectiveCounter`: the
census (``perf.collectives``) that the JAX package reads off the lowered
HLO (``count_data_allreduces``) is read here off the executed step. A
1-rank mesh without a process group runs each collective as the identity
and counts it all the same. ``gloo`` has no average, so a mean is a SUM
followed by a division by the data extent.

:func:`spawn` runs a function on N ranks of a fresh process group (the
tests and ``chip_smoke.py`` use it; ``torchrun`` replaces it in
production), and :func:`emulate_manual_step` is the single-sync step of N
ranks computed in one process, the oracle for distinct shards.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import os
import uuid
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch import tree as tu
from repro_torch.core import methods as methods_mod
from repro_torch.core import sync
from repro_torch.core.bilevel import BilevelSpec
from repro_torch.core.engine import (
    EngineConfig,
    EngineState,
    _unroll_base,
    guarded_meta_update,
    make_context,
    make_meta_step,
    step_metrics,
)
from repro_torch.launch.mesh import Mesh, data_axes
from repro_torch.obs.trace import phase
from repro_torch.optim import Optimizer
from repro_torch.scale import accum as accum_mod
from repro_torch.scale import policy as policy_mod

Tree = Any

#: what the manual schedule emits per step (a static set, as the
#: reference's shard_map out_specs); under a loss-scaling policy the
#: automaton's scalars ride along
METRIC_KEYS = ("base_loss", "meta_loss", "hypergrad_norm", "eps")
SCALE_METRIC_KEYS = ("loss_scale", "meta_skipped")

#: the metrics that are means over the batch, averaged over the ranks by
#: the global-batch step
BATCH_MEAN_METRICS = ("base_loss", "meta_loss")

#: the collective kinds a census reports (the reference's HLO kinds)
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

#: each leaf's slot in a flat bucket starts at a multiple of this many
#: elements, so that every unraveled view keeps the 16-byte alignment the
#: flat kernels' vector loads take (csrc/flat_pass.cuh)
BUCKET_ALIGN = 16

# ---------------------------------------------------------------------------
# the one entry of every collective, and its census
# ---------------------------------------------------------------------------

_COUNTERS: List["CollectiveCounter"] = []


class CollectiveCounter:
    """Counts the collectives made while it is entered, per kind: calls
    and bytes (each call's buffer). Counters nest; every open counter sees
    every call."""

    def __init__(self):
        self.counts: Dict[str, int] = collections.defaultdict(int)
        self.bytes: Dict[str, int] = collections.defaultdict(int)

    def __enter__(self):
        _COUNTERS.append(self)
        return self

    def __exit__(self, *exc):
        _COUNTERS.remove(self)
        return False

    def add(self, kind: str, nbytes: int) -> None:
        self.counts[kind] += 1
        self.bytes[kind] += nbytes


def collective(kind: str, tensor: Optional[torch.Tensor], mesh: Mesh) -> Optional[torch.Tensor]:
    """Make one collective over the mesh's data axes, in place on
    ``tensor``: ``"all-reduce"`` (SUM) or ``"barrier"`` (no tensor).
    Counted in every open :class:`CollectiveCounter`; on a mesh without a
    process group (one rank) the identity."""

    nbytes = 0 if tensor is None else tensor.numel() * tensor.element_size()
    for c in _COUNTERS:
        c.add(kind, nbytes)
    if mesh.group is None:
        return tensor
    if kind == "all-reduce":
        if tensor.device != mesh.device:
            raise ValueError(f"all-reduce of a tensor on {tensor.device} over a mesh on "
                             f"{mesh.device}")
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=mesh.group)
    elif kind == "barrier":
        dist.barrier(group=mesh.group)
    else:
        raise ValueError(f"collective kind {kind!r} is not made by the port")
    return tensor


# ---------------------------------------------------------------------------
# the reduce buckets
# ---------------------------------------------------------------------------


def flat_pmean(tree: Tree, mesh: Mesh) -> Tree:
    """Mean-reduce a tree over the data axes through ONE all-reduce: every
    leaf raveled into one flat bucket (``torch.cat``, each slot padded to
    :data:`BUCKET_ALIGN` elements), SUM-reduced, divided by the data
    extent and unraveled into views of the bucket, which is the reduced
    tree's storage. Leaves must share a dtype (callers cast to f32 first,
    :func:`cast_for_reduce`)."""

    leaves = tu.flatten_with_keys(tree)[1]
    if not leaves:
        return tree
    dtype = leaves[0].dtype
    if any(x.dtype != dtype for x in leaves):
        raise ValueError(f"flat_pmean takes leaves of one dtype, got "
                         f"{sorted({str(x.dtype) for x in leaves})}: cast_for_reduce first")
    pieces, offsets, off = [], [], 0
    for x in leaves:
        n = x.numel()
        pad = -n % BUCKET_ALIGN
        pieces.append(x.reshape(-1))
        if pad:
            pieces.append(x.new_zeros(pad))
        offsets.append(off)
        off += n + pad
    flat = torch.cat(pieces)
    del pieces
    collective("all-reduce", flat, mesh)
    if mesh.size > 1:
        flat.div_(mesh.size)
    return tu.unflatten_like(tree, [flat[o:o + x.numel()].view(x.shape)
                                    for o, x in zip(offsets, leaves)])


def tree_pmean(tree: Tree, mesh: Mesh) -> Tree:
    """Per-leaf mean-reduce: one all-reduce per leaf (the reference keeps
    it for a live "model" axis, which the port does not shard yet)."""

    def one(x):
        y = x.clone()
        collective("all-reduce", y, mesh)
        return y.div_(mesh.size) if mesh.size > 1 else y

    return tu.tree_map(one, tree)


def cast_for_reduce(tree: Tree) -> Tree:
    """Promote only the sub-f32 float leaves (bf16, f16) to f32 before a
    reduce: a cross-replica mean accumulated in bf16 loses what the f32
    master weights keep. f32, f64 and integer leaves come back as the very
    same objects. Callers cast the reduced leaves back where the consumer
    needs the narrow dtype."""

    def one(x):
        if x.is_floating_point() and x.element_size() < 4:
            return x.to(torch.float32)
        return x

    return tu.tree_map(one, tree)


def _pmean_cast_back(tree: Tree, mesh: Mesh) -> Tree:
    """:func:`flat_pmean` of the promoted tree, each leaf cast back to its
    own dtype (the DDP gradient reduce, ``ddp_grad_reduce`` in the
    reference)."""

    red = flat_pmean(cast_for_reduce(tree), mesh)
    return tu.tree_map(lambda r, x: r if r.dtype == x.dtype else r.to(x.dtype), red, tree)


def _check_axes(mesh: Mesh, axes) -> None:
    """The manual axes must be the mesh's data axes (plus the model axis
    of extent 1, as "all axes" in the reference)."""

    if axes is None:
        return
    extent = 1
    for a in axes:
        if a not in mesh.axis_names:
            raise ValueError(f"axis {a!r} not in the mesh's {mesh.axis_names}")
        extent *= mesh.shape[a]
    if not set(data_axes(mesh)) <= set(axes) or extent != mesh.size:
        raise ValueError(f"manual axes {tuple(axes)} must cover the data axes "
                         f"{data_axes(mesh)}: the port is data parallel only")


# ---------------------------------------------------------------------------
# the schedules
# ---------------------------------------------------------------------------


def make_manual_step(spec: BilevelSpec, base_opt: Optimizer, meta_opt: Optimizer,
                     cfg: EngineConfig, mesh: Mesh, axes=None, *,
                     allow_nonlinear: bool = False):
    """The single-sync schedule for any method whose reduce contract is
    linear. Returns a step with the Engine step's signature over the
    global batches; each rank computes on its own rows.

    ``axes``: the manual data-parallel axes (default the mesh's data
    axes; all axes is the same thing, the model extent being 1).
    ``allow_nonlinear``: run a method whose contract declares
    ``linear=False`` anyway, as the average of local solves, which is not
    the method's own estimator on the global batch."""

    _check_axes(mesh, axes)
    method = cfg.resolve()
    policy = cfg.scale.resolve()
    spec = policy_mod.apply_to_spec(spec, policy)
    micro = cfg.scale.microbatch
    metric_keys = METRIC_KEYS + (SCALE_METRIC_KEYS if policy.dynamic_scaling else ())
    contract = method.reduce_contract
    if not contract.linear and not allow_nonlinear:
        raise ValueError(
            f"hypergrad method {method.name!r} declares a nonlinear reduce contract: "
            "averaging its per-shard estimates is not the method's own estimator on "
            "the global batch. Pass allow_nonlinear=True to accept the "
            "local-solve approximation, or use the pjit path.")

    def ddp_grad_reduce(g_loc):
        """The per-base-step DDP sync: one flat bucket over the data axes,
        run on the gradient accumulated over the microbatches."""
        return _pmean_cast_back(g_loc, mesh)

    def manual_step(state: EngineState, base_batches, meta_batch):
        base_batches = mesh.local(base_batches, 1)
        meta_batch = mesh.local(meta_batch, 0)
        with phase("base_unroll"):
            (theta, b_state, g_base, st_at_g, losses, scale_state,
             base_ok) = _unroll_base(spec, base_opt, state.theta, state.base_opt_state,
                                     state.lam, base_batches, scale_cfg=cfg.scale,
                                     scale_state=state.scale, grad_reduce=ddp_grad_reduce)
        ctx = make_context(base_opt, state, base_batches, meta_batch,
                           theta=theta, base_opt_state=st_at_g, g_base=g_base,
                           loss_scale=scale_state.scale if scale_state is not None else None)
        # method stage 1: strictly local terms, no collective
        with phase("local_terms"):
            terms = methods_mod.validate_terms(method, accum_mod.microbatch_local_terms(
                method, spec, ctx, micro, policy.accum_torch))
        # THE single synchronization point: the contract's terms and the
        # base-loss metric, so that logging costs no second sync
        bucket = {k: terms[k] for k in contract.terms}
        bucket["__base_loss__"] = torch.mean(losses)
        with phase("allreduce_flat"):
            reduced = flat_pmean(cast_for_reduce(bucket), mesh)
        del bucket
        base_loss = reduced.pop("__base_loss__")
        terms = dict(terms, **reduced)
        with phase("finalize"):
            hyper, theta_post = method.finalize(terms, ctx)
        with phase("meta_update"):
            lam, m_state, theta_post, meta_ok = guarded_meta_update(
                meta_opt, hyper, theta_post, state, theta_pre=theta,
                guard=policy.dynamic_scaling, base_ok=base_ok)
            if meta_ok is not None:
                scale_state = policy_mod.backoff_on(scale_state, meta_ok, policy)
        metrics = step_metrics(method, terms, hyper, losses)
        metrics["base_loss"] = base_loss
        if meta_ok is not None:
            metrics["loss_scale"] = scale_state.scale
            metrics["meta_skipped"] = 1.0 - meta_ok.to(torch.float32)
        metrics = {k: metrics[k] for k in metric_keys}
        new_state = EngineState(theta=theta_post, base_opt_state=b_state, lam=lam,
                                meta_opt_state=m_state, step=state.step + 1, scale=scale_state)
        return new_state, metrics

    return manual_step


class _Enter(torch.autograd.Function):
    """Identity forward; the backward averages the cotangents over the
    ranks in one flat bucket."""

    @staticmethod
    def forward(ctx, mesh, *xs):
        ctx.mesh = mesh
        ctx.like = [(x.shape, x.dtype, x.device) for x in xs]
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        gs = [torch.zeros(s, dtype=d, device=dev) if g is None else g
              for g, (s, d, dev) in zip(gs, ctx.like)]
        return (None, *_pmean_cast_back(list(gs), ctx.mesh))


class _MeanGraph(torch.autograd.Function):
    """Mean over the ranks forward; identity backward."""

    @staticmethod
    def forward(ctx, mesh, *xs):
        return tuple(_pmean_cast_back([x.detach() for x in xs], mesh))

    @staticmethod
    def backward(ctx, *gs):
        return (None, *gs)


@dataclasses.dataclass(frozen=True)
class GlobalBatchReducer:
    """The reducer the global-batch step installs (``core.sync``): every
    reduce is one flat bucket over the mesh's data axes."""

    mesh: Mesh

    def mean(self, tree: Tree) -> Tree:
        return _pmean_cast_back(tree, self.mesh)

    def _apply(self, fn, tree: Tree) -> Tree:
        leaves = tu.flatten_with_keys(tree)[1]
        return tu.unflatten_like(tree, list(fn.apply(self.mesh, *leaves)))

    def enter(self, tree: Tree) -> Tree:
        return self._apply(_Enter, tree)

    def mean_graph(self, tree: Tree) -> Tree:
        return self._apply(_MeanGraph, tree)


def make_pjit_step(spec: BilevelSpec, base_opt: Optimizer, meta_opt: Optimizer,
                   cfg: EngineConfig, mesh: Optional[Mesh] = None):
    """The naive-DDP baseline: the Engine step as the global-batch
    estimator. Without a mesh, the Engine step itself."""

    step = make_meta_step(spec, base_opt, meta_opt, cfg)
    if mesh is None:
        return step
    reducer = GlobalBatchReducer(mesh)

    def pjit_step(state: EngineState, base_batches, meta_batch):
        base_batches = mesh.local(base_batches, 1)
        meta_batch = mesh.local(meta_batch, 0)
        with sync.reducing(reducer):
            new_state, metrics = step(state, base_batches, meta_batch)
            metrics.update(reducer.mean({k: metrics[k] for k in BATCH_MEAN_METRICS}))
        return new_state, metrics

    return pjit_step


def emulate_manual_step(spec: BilevelSpec, base_opt: Optimizer, meta_opt: Optimizer,
                        cfg: EngineConfig, n: int, state: EngineState, base_batches,
                        meta_batch):
    """The single-sync step of ``n`` ranks, in one process: the DDP base
    unroll (the mean of the ranks' gradients, taken as n x M microbatches
    of the global batch), each rank's ``local_terms`` on its rows, the
    contract's terms averaged, then ``finalize`` and the meta update. The
    oracle of :func:`make_manual_step` on distinct shards (equal up to
    rounding; nonlinear contracts included, as the average of local
    solves)."""

    method = cfg.resolve()
    policy = cfg.scale.resolve()
    spec = policy_mod.apply_to_spec(spec, policy)
    micro = cfg.scale.microbatch
    unroll_scale = dataclasses.replace(cfg.scale, microbatch=n * micro)
    (theta, b_state, g_base, st_at_g, losses, scale_state,
     base_ok) = _unroll_base(spec, base_opt, state.theta, state.base_opt_state, state.lam,
                             base_batches, scale_cfg=unroll_scale, scale_state=state.scale)
    shards = []
    for r in range(n):
        def rows(x, axis, r=r):
            b = x.shape[axis] // n
            return x.narrow(axis, r * b, b)
        base_r = tu.tree_map(lambda x: rows(x, 1), base_batches)
        meta_r = tu.tree_map(lambda x: rows(x, 0), meta_batch)
        ctx = make_context(base_opt, state, base_r, meta_r, theta=theta, base_opt_state=st_at_g,
                           g_base=g_base,
                           loss_scale=scale_state.scale if scale_state is not None else None)
        shards.append(methods_mod.validate_terms(method, accum_mod.microbatch_local_terms(
            method, spec, ctx, micro, policy.accum_torch)))
    terms = dict(shards[0])
    for k in method.reduce_contract.terms:
        terms[k] = tu.tree_map(lambda *xs: torch.stack([x.float() for x in xs]).mean(0),
                               *[s[k] for s in shards])
    hyper, theta_post = method.finalize(terms, ctx)
    lam, m_state, theta_post, meta_ok = guarded_meta_update(
        meta_opt, hyper, theta_post, state, theta_pre=theta, guard=policy.dynamic_scaling,
        base_ok=base_ok)
    if meta_ok is not None:
        scale_state = policy_mod.backoff_on(scale_state, meta_ok, policy)
    metrics = step_metrics(method, terms, hyper, losses)
    new_state = EngineState(theta=theta_post, base_opt_state=b_state, lam=lam,
                            meta_opt_state=m_state, step=state.step + 1, scale=scale_state)
    return new_state, metrics


# ---------------------------------------------------------------------------
# ranks
# ---------------------------------------------------------------------------


def _rank_entry(rank: int, fn: Callable, nprocs: int, backend: str, store_path: str,
                timeout_s: float, args: Sequence):
    store = dist.FileStore(store_path, nprocs)
    dist.init_process_group(backend, store=store, rank=rank, world_size=nprocs,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, args: Sequence = (), *, store_dir: str,
          backend: str = "gloo", timeout_s: float = 600.0) -> None:
    """Run ``fn(rank, *args)`` on ``nprocs`` fresh processes (the ``spawn``
    start method, so a parent that holds a CUDA context may call it), each
    rank of one process group of ``backend`` that meets through a
    ``FileStore`` under ``store_dir``; ``fn`` builds its mesh with
    ``launch.mesh.make_data_mesh``. Returns when every rank has ended;
    a rank that raises ends the others and makes this call raise.
    Kernels are built at first use: build them in the parent first
    (``kernels.build.build_all``) so that the ranks find them."""

    import torch.multiprocessing as mp

    os.makedirs(store_dir, exist_ok=True)
    store_path = os.path.join(store_dir, f"store-{uuid.uuid4().hex}")
    mp.start_processes(_rank_entry, args=(fn, nprocs, backend, store_path, timeout_s,
                                          tuple(args)),
                       nprocs=nprocs, join=True, start_method="spawn")
