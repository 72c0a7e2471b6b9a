"""The dry run's jobs, after ``src/repro/launch/specs.py``: for every
(architecture x input shape), the step function and its full-size
arguments, built on ``device="meta"`` (shapes and dtypes, no storage).

The train shape is the FULL SAMA bilevel step (one unrolled base Adam step,
the Eq. 5 meta gradient, the meta update), as in the reference: the
paper's technique is what is dry-run. The prefill shape is the training
forward's logits; the decode shapes are one ``decode_step`` against a
cache of ``seq_len`` rows, every lane at its last position.

The reference attaches a ``NamedSharding`` to each argument and lets the
partitioner place the work; the port traces the whole (global) step once
and reads each rank's bytes from the partition rules of
``launch/sharding.py`` on the production mesh's extents
(:func:`per_rank_bytes`): theta and the base optimizer's moments in this
rank's blocks (``launch/fsdp.py`` shards both alike), lambda and the meta
optimizer's state whole, the decode cache by ``cache_spec``. The
reference's layout variants (``sharded_ce``, ``chunked_attn``,
``head_align``, ``dp_only``, ``manual``) are hill-climbs of its GSPMD
partitioning with no counterpart here: the dry run traces the baseline.
"""

from __future__ import annotations

import math
import types
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import optim
from repro_torch import tree as tu
from repro_torch.configs import ArchConfig, InputShape
from repro_torch.core import EngineConfig, init_state, make_meta_step, problems
from repro_torch.launch import sharding as sh
from repro_torch.models import Model
from repro_torch.models.common import dtype_of

META = torch.device("meta")

META_BATCH_FRACTION = 8  # meta batch = global_batch / 8 (clean data is scarce)

class Job(NamedTuple):
    """A step function and its full-size meta arguments, ready to trace."""

    name: str
    step_fn: Callable
    args: Tuple
    kind: str  # train | prefill | decode
    cfg: ArchConfig
    #: theta (train) or the parameters (prefill, decode), on meta
    params: Any
    #: the decode cache (decode), else None
    cache: Any = None
    #: the whole EngineState (train), else None
    state: Any = None


def mesh_of(mesh_shape: Dict[str, int]):
    """The axes and extents the partition rules read (``mesh.shape``,
    ``mesh.axis_names``) of a mesh that no process group backs."""
    return types.SimpleNamespace(shape=dict(mesh_shape), axis_names=tuple(mesh_shape))


def _divisor(spec, mesh_shape: Dict[str, int]) -> int:
    n = 1
    for entry in spec:
        for a in ((entry,) if isinstance(entry, str) else tuple(entry or ())):
            n *= mesh_shape[a]
    return n


def _blocks_bytes(tree, specs, mesh_shape) -> float:
    leaves = tu.flatten_with_keys(tree)[1]
    return float(sum(math.prod(x.shape) * x.element_size() / _divisor(s, mesh_shape)
                     for x, s in zip(leaves, specs)))


def _whole_bytes(tree) -> float:
    return float(sum(math.prod(x.shape) * x.element_size()
                     for x in tu.flatten_with_keys(tree)[1] if isinstance(x, torch.Tensor)))


def per_rank_bytes(job: Job, mesh_shape: Dict[str, int]) -> Dict[str, float]:
    """Bytes one rank holds for ``job`` on a mesh of ``mesh_shape``:
    ``params`` (theta's blocks), ``moments`` (the base optimizer's state,
    laid out as theta), ``meta`` (lambda and its optimizer's state, whole),
    ``cache`` (the decode cache's blocks) and their ``total``."""
    mesh = mesh_of(mesh_shape)
    specs = sh.param_specs(job.params, mesh)[1]
    out = {"params": _blocks_bytes(job.params, specs, mesh_shape), "moments": 0.0,
           "meta": 0.0, "cache": 0.0}
    if job.state is not None:
        opt = job.state.base_opt_state
        for moment in (opt.mu, opt.nu):
            if moment is not None:
                out["moments"] += _blocks_bytes(moment, specs, mesh_shape)
        out["meta"] = _whole_bytes((job.state.lam, job.state.meta_opt_state))
    if job.cache is not None:
        cnames, cleaves = tu.flatten_with_keys(job.cache)
        out["cache"] = float(sum(
            math.prod(x.shape) * x.element_size()
            / _divisor(sh.cache_spec(n, tuple(x.shape), mesh), mesh_shape)
            for n, x in zip(cnames, cleaves)))
    out["total"] = sum(out.values())
    return out


def _dp_size(mesh_shape: Dict[str, int]) -> int:
    return math.prod(mesh_shape.get(a, 1) for a in ("pod", "data"))


def _batch(cfg: ArchConfig, batch: int, seq: int, *, unroll: Optional[int] = None,
           labels: bool = False) -> Dict[str, torch.Tensor]:
    lead = (unroll, batch) if unroll is not None else (batch,)
    b = {"tokens": torch.empty(lead + (seq,), dtype=torch.int32, device=META)}
    act = dtype_of(cfg.dtype)
    if cfg.family == "vlm":
        b["patches"] = torch.empty(lead + (cfg.vision_tokens, cfg.vision_dim), dtype=act,
                                   device=META)
    if cfg.family == "audio":
        b["frames"] = torch.empty(lead + (cfg.encoder_seq, cfg.d_model), dtype=act,
                                  device=META)
    if labels and cfg.family == "encoder":
        b["y"] = torch.empty(lead, dtype=torch.int64, device=META)
    return b


def make_train_job(cfg: ArchConfig, shape: InputShape, mesh_shape: Dict[str, int], *,
                   engine_cfg: Optional[EngineConfig] = None) -> Job:
    """The SAMA bilevel train step at the global batch, on meta."""

    model = Model(cfg, device=META)
    engine_cfg = engine_cfg or EngineConfig(method="sama", unroll_steps=1)
    base_opt, meta_opt = optim.adam(1e-4), optim.adam(1e-4)
    spec = problems.make_data_optimization_spec(
        model.classifier_per_example if cfg.family == "encoder" else model.per_example,
        reweight=True)
    step = make_meta_step(spec, base_opt, meta_opt, engine_cfg)
    theta = model.init(0)
    lam = problems.init_data_optimization_lam(1, reweight=True, device=META)
    state = init_state(theta, lam, base_opt, meta_opt, scale=engine_cfg.scale)
    k = engine_cfg.unroll_steps
    base = _batch(cfg, shape.global_batch, shape.seq_len, unroll=k, labels=True)
    meta = _batch(cfg, max(shape.global_batch // META_BATCH_FRACTION, _dp_size(mesh_shape)),
                  shape.seq_len, labels=True)
    return Job(name=f"{cfg.name}:{shape.name}:sama_train", step_fn=step,
               args=(state, base, meta), kind="train", cfg=cfg, params=theta, state=state)


def make_prefill_job(cfg: ArchConfig, shape: InputShape, mesh_shape: Dict[str, int]) -> Job:
    model = Model(cfg, device=META)
    params = model.init(0)

    def prefill(params, batch):
        logits, _ = model.forward(params, batch)
        return logits

    return Job(name=f"{cfg.name}:{shape.name}:prefill", step_fn=prefill,
               args=(params, _batch(cfg, shape.global_batch, shape.seq_len)), kind="prefill",
               cfg=cfg, params=params)


def make_decode_job(cfg: ArchConfig, shape: InputShape, mesh_shape: Dict[str, int]) -> Job:
    model = Model(cfg, device=META)
    params = model.init(0)
    cache = model.init_cache(shape.global_batch, shape.seq_len, dtype_of(cfg.dtype))
    tokens = torch.empty((shape.global_batch, 1), dtype=torch.int32, device=META)

    def serve_step(params, cache, tokens, pos):
        return model.decode_step(params, cache, tokens, pos)

    return Job(name=f"{cfg.name}:{shape.name}:serve_decode", step_fn=serve_step,
               args=(params, cache, tokens, shape.seq_len - 1), kind="decode", cfg=cfg,
               params=params, cache=cache)


def make_job(cfg: ArchConfig, shape: InputShape, mesh_shape: Dict[str, int]) -> Optional[Job]:
    """The job of one (arch, shape) pair in bf16 parameters and
    activations, or None where the reference's rule refuses it: long_500k
    only for sub-quadratic or sliding-window architectures (DESIGN.md §4)."""

    if shape.name == "long_500k" and not cfg.supports_long_context:
        return None
    dry = cfg.replace(param_dtype="bfloat16", dtype="bfloat16")
    make = {"train": make_train_job, "prefill": make_prefill_job,
            "decode": make_decode_job}[shape.kind]
    return make(dry, shape, mesh_shape)
