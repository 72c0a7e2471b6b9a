"""The paper's distributed execution schedule (Fig. 2) on
``torch.distributed``, after ``src/repro/launch/distributed.py``: data
parallelism over a mesh's data axes (``launch.mesh``), one rank per
device, and, on a mesh with a model extent above 1, the parameters sharded
over the model axis (FSDP, ``launch.fsdp``).

Two implementations of one meta step, each with the Engine step's
signature ``(state, base_batches[K], meta_batch) -> (state, metrics)``
over the GLOBAL batches; each rank takes its own rows (axis 1 of the base
batches, axis 0 of the meta batch: the reference's ``batch_spec`` and
``meta_spec``; ``Mesh.local`` splits a data shard's rows over its model
group):

* :func:`make_manual_step`, the paper's single-sync schedule: the base
  unroll keeps its per-step DDP reduce (one flat bucket per base step, on
  the gradient accumulated over M microbatches); ``local_terms`` runs on
  the rank's rows with no collective of the data group; ONE flat bucket
  carries the terms the method's ``reduce_contract`` names plus the
  base-loss metric; then ``finalize`` and the guarded meta update on
  replica-consistent values. Exactly ``unroll_steps + 1`` all-reduces of
  the data group per meta step, whatever M, the precision policy and the
  model extent. ``axes`` are the reference's manual axes: the data axes
  (the default; each model group works together on its data shard,
  sharing one estimate, as JAX's automatic "model" axis does), or every
  axis (pure DDP over data x model, every rank holding the whole state).
  A nonlinear contract (CG, Neumann, iterdiff) is refused unless
  ``allow_nonlinear=True`` takes the average of local solves.
* :func:`make_pjit_step`, the naive-DDP baseline: the global-batch
  estimator that JAX's partitioner makes of the Engine step. The Engine
  step runs on the rank's rows under a reducer (``core.sync``) that the
  port's gradient chokepoints read, so every gradient of a batch-mean loss
  is averaged over the data ranks where the step takes it, and the
  batch-mean metrics once at the end; under a live model axis the
  sharded loss (``launch.fsdp``) has already summed each gradient over
  the model group, so the step is reduced over the world. On N ranks with
  distinct shards it equals the one-process Engine step on the
  concatenated batch up to rounding.

Every collective the port makes goes through :func:`collective`, which
counts calls and bytes per kind and per group ("data", "model", "world")
inside a :class:`CollectiveCounter`: the census (``perf.collectives``)
that the JAX package reads off the lowered HLO (``count_data_allreduces``)
is read here off the executed step. A group of one rank without a process
group runs each collective as the identity and counts it all the same.
``gloo`` has no average, so a mean is a SUM followed by a division by the
group's extent.

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
    """Counts the collectives made while it is entered, per kind (calls
    and bytes: each call's result buffer, as the reference's HLO census
    counts them) and per kind of each group (``by_group[group][kind]``,
    ``bytes_by_group``). ``counts`` and ``bytes`` are the totals over the
    groups. Counters nest; every open counter sees every call."""

    def __init__(self):
        self.counts: Dict[str, int] = collections.defaultdict(int)
        self.bytes: Dict[str, int] = collections.defaultdict(int)
        self.by_group: Dict[str, Dict[str, int]] = collections.defaultdict(
            lambda: collections.defaultdict(int))
        self.bytes_by_group: Dict[str, Dict[str, int]] = collections.defaultdict(
            lambda: collections.defaultdict(int))

    def __enter__(self):
        _COUNTERS.append(self)
        return self

    def __exit__(self, *exc):
        _COUNTERS.remove(self)
        return False

    def add(self, kind: str, nbytes: int, over: str = "data") -> None:
        self.counts[kind] += 1
        self.bytes[kind] += nbytes
        self.by_group[over][kind] += 1
        self.bytes_by_group[over][kind] += nbytes


def _staged(tensor: torch.Tensor, backend: str) -> bool:
    """gloo reduces CUDA tensors (all-reduce) but neither gathers nor
    scatters them: those two stage through the host."""
    return tensor.is_cuda and backend == "gloo"


def collective(kind: str, tensor: Optional[torch.Tensor], mesh: Mesh, *, over: str = "data",
               dim: int = 0) -> Optional[torch.Tensor]:
    """Make one collective over the mesh's group ``over`` ("data", the
    default; "model"; "world"):

    * ``"all-reduce"``: SUM, in place on ``tensor``, which it returns;
    * ``"all-gather"``: the group's blocks concatenated along ``dim`` in
      rank order (a new tensor);
    * ``"reduce-scatter"``: this rank's block along ``dim`` of the SUM of
      the group's tensors (a new tensor; ``dim`` must divide evenly);
    * ``"barrier"``: no tensor.

    Counted in every open :class:`CollectiveCounter` under ``kind`` and
    ``over``; over a group of one rank without a process group the
    identity. Under gloo a CUDA tensor's all-gather and reduce-scatter go
    through the host (gloo makes neither on the card); they count as what
    they compute."""

    if kind not in ("all-reduce", "all-gather", "reduce-scatter", "barrier"):
        raise ValueError(f"collective kind {kind!r} is not made by the port")
    group = mesh.process_group(over)
    n = mesh.extent(over)
    if tensor is None:
        nbytes = 0
    else:
        size = tensor.numel() * tensor.element_size()
        nbytes = {"all-gather": size * n, "reduce-scatter": size // max(n, 1)}.get(kind, size)
    for c in _COUNTERS:
        c.add(kind, nbytes, over)
    if group is None:
        if n != 1:
            raise ValueError(f"the {over} group of {n} ranks has no process group")
        return None if tensor is None else (tensor if kind == "all-reduce" else tensor.clone())
    if kind == "barrier":
        dist.barrier(group=group)
        return None
    if tensor.device != mesh.device:
        raise ValueError(f"{kind} of a tensor on {tensor.device} over a mesh on {mesh.device}")
    if kind == "all-reduce":
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=group)
        return tensor
    staged = _staged(tensor, dist.get_backend(group))
    x = tensor.movedim(dim, 0).contiguous()
    if staged:
        x = x.cpu()
    if kind == "all-gather":
        out = x.new_empty((x.shape[0] * n,) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
    else:
        if x.shape[0] % n:
            raise ValueError(f"reduce-scatter of dim {dim} ({x.shape[0]}) over {n} ranks")
        out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
        dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM, group=group)
    if staged:
        out = out.to(mesh.device)
    return out.movedim(0, dim).contiguous()


# ---------------------------------------------------------------------------
# the reduce buckets
# ---------------------------------------------------------------------------


def flat_pmean(tree: Tree, mesh: Mesh, over: str = "data") -> Tree:
    """Mean-reduce a tree over the group ``over`` through ONE all-reduce:
    every leaf raveled into one flat bucket (``torch.cat``, each slot
    padded to :data:`BUCKET_ALIGN` elements), SUM-reduced, divided by the
    group's extent and unraveled into views of the bucket, which is the
    reduced tree's storage. Leaves must share a dtype (callers cast to f32
    first, :func:`cast_for_reduce`). Under FSDP the leaves may be this
    rank's blocks: the data group's ranks hold the same blocks."""

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
    collective("all-reduce", flat, mesh, over=over)
    if mesh.extent(over) > 1:
        flat.div_(mesh.extent(over))
    return tu.unflatten_like(tree, [flat[o:o + x.numel()].view(x.shape)
                                    for o, x in zip(offsets, leaves)])


def tree_pmean(tree: Tree, mesh: Mesh, over: str = "data") -> Tree:
    """Per-leaf mean-reduce over the group ``over``: one all-reduce per
    leaf. The reference keeps it for a live "model" axis, whose partitioner
    a flat bucket would defeat; the port's FSDP blocks are plain tensors,
    so its schedules take :func:`flat_pmean` on every mesh, and this form
    serves callers that want one collective per leaf."""

    def one(x):
        y = x.clone()
        collective("all-reduce", y, mesh, over=over)
        return y.div_(mesh.extent(over)) if mesh.extent(over) > 1 else y

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


def _pmean_cast_back(tree: Tree, mesh: Mesh, over: str = "data") -> Tree:
    """:func:`flat_pmean` of the promoted tree, each leaf cast back to its
    own dtype (the DDP gradient reduce, ``ddp_grad_reduce`` in the
    reference)."""

    red = flat_pmean(cast_for_reduce(tree), mesh, over)
    return tu.tree_map(lambda r, x: r if r.dtype == x.dtype else r.to(x.dtype), red, tree)


def _check_axes(mesh: Mesh, axes) -> str:
    """The group the manual schedule reduces over, from its manual axes:
    the data axes (the default; "data": the model group shares the state
    and each data shard's estimate), or every axis of the mesh ("world":
    pure DDP over data x model, every rank holding the whole state). Other
    subsets raise."""

    if axes is None:
        return "data"
    for a in axes:
        if a not in mesh.axis_names:
            raise ValueError(f"axis {a!r} not in the mesh's {mesh.axis_names}")
    if set(axes) == set(data_axes(mesh)) or mesh.model_size == 1 and set(axes) == set(
            data_axes(mesh)) | {"model"}:
        return "data"
    if set(axes) == set(mesh.axis_names):
        return "world"
    raise ValueError(f"manual axes {tuple(axes)} must be the data axes {data_axes(mesh)} or "
                     f"every axis {mesh.axis_names}")


def _fsdp_for(mesh: Mesh, over: str, sharding):
    """The FSDP layout a step on ``mesh`` reducing over ``over`` runs
    with: None on a mesh with a model extent of 1 and under pure DDP
    (``over`` "world"), else ``sharding``, which must then be given."""

    if mesh is None or mesh.model_size == 1 or over == "world":
        if sharding is not None and over == "world":
            raise ValueError("manual axes over every axis hold the whole state on every "
                             "rank: pass no sharding")
        return None
    if sharding is None:
        raise ValueError(f"a mesh with a model extent of {mesh.model_size} shards the "
                         "parameters over the model group: pass sharding= (a "
                         "launch.fsdp.FSDP of theta over this mesh)")
    if sharding.mesh is not mesh:
        raise ValueError("the sharding was made over another mesh")
    return sharding


# ---------------------------------------------------------------------------
# the schedules
# ---------------------------------------------------------------------------


def make_manual_step(spec: BilevelSpec, base_opt: Optimizer, meta_opt: Optimizer,
                     cfg: EngineConfig, mesh: Mesh, axes=None, *,
                     allow_nonlinear: bool = False, sharding=None):
    """The single-sync schedule for any method whose reduce contract is
    linear. Returns a step with the Engine step's signature over the
    global batches; each rank computes on its own rows.

    ``axes``: the manual axes, the data axes by default; every axis of
    the mesh is pure DDP over data x model. ``sharding`` (a
    ``launch.fsdp.FSDP``) is the parameters' layout over the model group,
    which the state's theta and base moments hold: needed with the data
    axes on a mesh whose model extent exceeds 1 (the model group then
    shares one estimate of its data shard, its norms summed over the
    group). ``allow_nonlinear``: run a method whose contract declares
    ``linear=False`` anyway, as the average of local solves, which is not
    the method's own estimator on the global batch."""

    over = _check_axes(mesh, axes)
    fsdp = _fsdp_for(mesh, over, sharding)
    method = cfg.resolve()
    policy = cfg.scale.resolve()
    if fsdp is not None:
        fsdp.check_optimizer(base_opt)
        spec = fsdp.apply_to_spec(spec)  # inside the policy's casts: gathers move bf16
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
        """The per-base-step DDP sync: one flat bucket over the reducing
        group, run on the gradient accumulated over the microbatches."""
        return _pmean_cast_back(g_loc, mesh, over)

    def manual_step(state: EngineState, base_batches, meta_batch):
        base_batches = mesh.local(base_batches, 1)
        meta_batch = mesh.local(meta_batch, 0)
        with sync.sharded(fsdp):
            with phase("base_unroll"):
                (theta, b_state, g_base, st_at_g, losses, scale_state,
                 base_ok) = _unroll_base(spec, base_opt, state.theta, state.base_opt_state,
                                         state.lam, base_batches, scale_cfg=cfg.scale,
                                         scale_state=state.scale, grad_reduce=ddp_grad_reduce)
            ctx = make_context(base_opt, state, base_batches, meta_batch,
                               theta=theta, base_opt_state=st_at_g, g_base=g_base,
                               loss_scale=scale_state.scale if scale_state is not None
                               else None)
            # method stage 1: local terms, no collective of the reducing group
            with phase("local_terms"):
                terms = methods_mod.validate_terms(method, accum_mod.microbatch_local_terms(
                    method, spec, ctx, micro, policy.accum_torch))
            # THE single synchronization point: the contract's terms and the
            # base-loss metric, so that logging costs no second sync
            bucket = {k: terms[k] for k in contract.terms}
            bucket["__base_loss__"] = torch.mean(losses)
            with phase("allreduce_flat"):
                reduced = flat_pmean(cast_for_reduce(bucket), mesh, over)
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
    data ranks in one flat bucket."""

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
    """Mean over the data ranks forward; identity backward."""

    @staticmethod
    def forward(ctx, mesh, *xs):
        return tuple(_pmean_cast_back([x.detach() for x in xs], mesh))

    @staticmethod
    def backward(ctx, *gs):
        return (None, *gs)


@dataclasses.dataclass(frozen=True)
class GlobalBatchReducer:
    """The reducer the global-batch step installs (``core.sync``): every
    reduce is one flat bucket over the mesh's data axes (under FSDP the
    sharded loss has summed each gradient over the model group already)."""

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
                   cfg: EngineConfig, mesh: Optional[Mesh] = None, *, sharding=None):
    """The naive-DDP baseline: the Engine step as the global-batch
    estimator. Without a mesh, the Engine step itself. On a mesh with a
    model extent above 1, ``sharding`` (a ``launch.fsdp.FSDP``) is the
    parameters' layout over the model group, and the step is reduced over
    the world: the model group inside the sharded loss, the data group at
    the chokepoints."""

    fsdp = _fsdp_for(mesh, "data", sharding)
    if fsdp is not None:
        fsdp.check_optimizer(base_opt)
        spec = fsdp.apply_to_spec(spec)
    step = make_meta_step(spec, base_opt, meta_opt, cfg)
    if mesh is None:
        return step
    reducer = GlobalBatchReducer(mesh)

    def pjit_step(state: EngineState, base_batches, meta_batch):
        base_batches = mesh.local(base_batches, 1)
        meta_batch = mesh.local(meta_batch, 0)
        with sync.sharded(fsdp), sync.reducing(reducer):
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
