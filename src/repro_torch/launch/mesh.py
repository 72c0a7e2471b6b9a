"""Meshes as process groups, after ``src/repro/launch/mesh.py``.

The JAX package names its devices by a mesh of axes ("data", "model") or
("pod", "data", "model"): the batch shards over the pod and data axes,
the parameters over "model". The port keeps the names and the shape and
puts ``torch.distributed`` process groups behind them, one process (rank)
per device. The ranks of the world are laid out row-major over the axes,
model innermost, so the ranks of one model group are adjacent (on one
node: joined by NVLink). A mesh holds three groups:

* the data group: the ranks with this rank's model coordinate, over
  which the schedules reduce (``Mesh.group``, ``rank``, ``size``: the
  data axes, as a pure data-parallel mesh has them);
* the model group: the ranks with this rank's data coordinates, over
  which the parameters are sharded (``launch.fsdp``) and a data shard's
  rows are split (``Mesh.local``; a MoE layer gathers them back where its
  dispatch groups need the shard's tokens, ``models.moe``);
* the world: every rank of the mesh.

The JAX package's ``shard_map`` and ``AxisType`` are version shims of JAX
with no counterpart here.

* :func:`make_host_mesh`: the 1-rank mesh, no process group (tests,
  single-device runs);
* :func:`make_data_mesh`: a pure data-parallel mesh over an initialised
  process group (the default group unless one is given);
* :func:`make_mesh`: a mesh of any extents over an initialised process
  group, the counterpart of the reference's ``make_mesh``;
* :func:`make_production_mesh`: reads the ``torchrun`` environment
  (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``), joins an NCCL group, one card per rank, and lays it
  out as the reference's production mesh where the world has its size.

Every mesh runs on the card unless the caller passes ``device="cpu"``; a
mesh on the card never falls back to the CPU or to another backend than
the one asked for.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

Tree = Any

#: the axes a batch shards over, as ``data_axes`` in the JAX package
DATA_AXES = ("pod", "data")
#: the axes of the 2-D meshes made here
_AXES = ("data", "model")
#: the reference's production meshes: one pod of 16 x 16 chips, two pods
PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}

#: the groups a collective runs over (``launch.distributed.collective``)
GROUPS = ("data", "model", "world")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """The named axes and their extents, the data axes' process group
    (None on one rank without ``torch.distributed``), this process's rank
    in it and its size (the data extent), and the device this rank runs
    on. ``shape`` maps axis name to extent, as a JAX mesh's does. A model
    extent above 1 needs ``model_group`` (the ranks sharing this rank's
    data coordinates), ``model_rank`` (this rank's model coordinate) and
    ``world_group``; with a model extent of 1 the world is the data group."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    group: Optional[Any]
    rank: int
    size: int
    device: torch.device
    model_group: Optional[Any] = None
    model_rank: int = 0
    world_group: Optional[Any] = None

    def __post_init__(self):
        if tuple(self.shape) != tuple(self.axis_names):
            raise ValueError(f"shape {self.shape} does not follow the axes {self.axis_names}")
        unknown = set(self.axis_names) - set(DATA_AXES) - {"model"}
        if unknown:
            raise ValueError(f"axes {sorted(unknown)} are none of {DATA_AXES + ('model',)}")
        extent = 1
        for a in data_axes(self):
            extent *= self.shape[a]
        if extent != self.size:
            raise ValueError(f"the data axes {data_axes(self)} of {self.shape} hold {extent} "
                             f"ranks but the group has {self.size}")
        if not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} outside a group of {self.size}")
        if self.group is None and self.size != 1:
            raise ValueError("a mesh of more than one rank needs a process group")
        m = self.model_size
        if not 0 <= self.model_rank < m:
            raise ValueError(f"model rank {self.model_rank} outside a model extent of {m}")
        if m == 1:
            if self.world_group is None:
                object.__setattr__(self, "world_group", self.group)
        elif self.model_group is None or self.world_group is None:
            raise ValueError(f"a model extent of {m} needs a model group and a world group")

    @property
    def model_size(self) -> int:
        """The model extent."""
        return self.shape.get("model", 1)

    @property
    def world_size(self) -> int:
        return self.size * self.model_size

    @property
    def world_rank(self) -> int:
        """This rank's place in the world: row-major, model innermost."""
        return self.rank * self.model_size + self.model_rank

    @property
    def backend(self) -> Optional[str]:
        g = self.world_group
        return None if g is None else dist.get_backend(g)

    def coords(self) -> Dict[str, int]:
        """This rank's coordinate on every axis."""
        out, r = {}, self.world_rank
        for a in reversed(self.axis_names):
            out[a] = r % self.shape[a]
            r //= self.shape[a]
        return out

    def extent(self, over: str) -> int:
        """The number of ranks in the group ``over`` ("data", "model" or
        "world")."""
        return {"data": self.size, "model": self.model_size, "world": self.world_size}[over]

    def process_group(self, over: str):
        """The process group behind ``over``: None where it has one rank and
        no group."""
        if over not in GROUPS:
            raise ValueError(f"group {over!r} not in {GROUPS}")
        return {"data": self.group, "model": self.model_group, "world": self.world_group}[over]

    def rows(self, n: int) -> slice:
        """This rank's rows of a batch axis of ``n`` rows over the data
        axes: the contiguous ``n / size`` block at ``rank``, as a
        NamedSharding over the data axes places them. ``n`` must divide
        evenly."""

        if n % self.size:
            raise ValueError(f"a batch of {n} rows does not shard evenly over {self.size} "
                             "data-parallel ranks")
        b = n // self.size
        return slice(self.rank * b, (self.rank + 1) * b)

    def _model_block(self, x: torch.Tensor, axis: int, total: int,
                     microbatch: int) -> torch.Tensor:
        """This rank's rows along ``axis`` of a data shard ``x`` (of a global
        batch of ``total`` rows): of each of the ``microbatch`` contiguous
        microbatches the shard is cut into, the contiguous ``1 / model
        extent`` block at the model coordinate. The model group's blocks
        of microbatch i, gathered in model-rank order, are then the
        shard's microbatch i."""

        m, n = self.model_size, x.shape[axis]
        if n % (m * microbatch):
            split = f" in {microbatch} microbatches" if microbatch > 1 else ""
            raise ValueError(f"a batch of {total} rows over {self.size} data ranks gives "
                             f"data shards of {n} rows, which do not split evenly over "
                             f"{m} model ranks{split}")
        b = n // (m * microbatch)
        lead, rest = tuple(x.shape[:axis]), tuple(x.shape[axis + 1:])
        x = x.reshape(lead + (microbatch, m, b) + rest).select(axis + 1, self.model_rank)
        return x.reshape(lead + (microbatch * b,) + rest)

    def local(self, batch: Tree, axis: int, microbatch: int = 1) -> Tree:
        """This rank's slice of ``batch`` along ``axis`` (1 for base
        batches (K, B, ...), 0 for a meta batch): its data shard's rows
        (:meth:`rows`), split evenly over the model group, so that each
        rank takes its block of the world in world-rank order; with
        ``microbatch`` M > 1, its block of each of the shard's M
        microbatches (the step's ``ScaleConfig.microbatch``), so that a
        MoE layer's gathered tokens are the shard's microbatch. A
        :class:`LocalBatch` holds this data shard's rows already: only the
        model group's split applies to it."""

        from repro_torch import tree as tu

        def one(x, data_split):
            n = x.shape[axis]
            if data_split:
                x = x[(slice(None),) * axis + (self.rows(n),)]
            if self.model_size > 1:
                x = self._model_block(x, axis, n, microbatch)
            return x

        if isinstance(batch, LocalBatch):
            if self.model_size == 1:
                return batch
            return LocalBatch(tu.tree_map(lambda x: one(x, False), dict(batch)))
        return tu.tree_map(lambda x: one(x, True), batch)


class LocalBatch(dict):
    """A batch that holds only this data shard's rows of a global batch
    (what ``ReweightedIterator(mesh=)`` yields): :meth:`Mesh.local` does
    not slice it over the data axes again, as a sharded global array needs
    no resharding."""


def data_axes(mesh) -> Tuple[str, ...]:
    """The batch-sharding axes of a mesh."""
    return tuple(a for a in mesh.axis_names if a in DATA_AXES)


def make_host_mesh(device="cuda") -> Mesh:
    """The 1-rank mesh (axes ("data", "model"), extents 1) with no process
    group: the schedules run their collectives as identities and count
    them all the same."""

    return Mesh(_AXES, {"data": 1, "model": 1}, None, 0, 1, resolve_device(device))


def _rank_device(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_data_mesh(group=None, *, device="cuda") -> Mesh:
    """A data-parallel mesh over an initialised process group (``group``,
    or the default group). ``device`` is this rank's device: ``"cuda"``
    takes the current card. Raises if ``torch.distributed`` is not
    initialised."""

    if not dist.is_initialized():
        raise RuntimeError("make_data_mesh needs an initialised process group: call "
                           "torch.distributed.init_process_group first (or make_host_mesh "
                           "for one rank)")
    g = group if group is not None else dist.group.WORLD
    size = dist.get_world_size(g)
    return Mesh(_AXES, {"data": size, "model": 1}, g, dist.get_rank(g), size,
                _rank_device(device))


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str], *, group=None,
              device="cuda") -> Mesh:
    """A mesh of the given extents over an initialised process group
    (``group``, or the default group), the counterpart of the reference's
    ``make_mesh``: axes among "pod", "data" and "model", in that order;
    their product must be the group's size. The group's ranks are laid out
    row-major, model innermost. Where both the data and the model extent
    exceed 1 the data and model groups are made here with
    ``torch.distributed.new_group``, which every process of the default
    group must enter: every process calls ``make_mesh`` with the same
    arguments."""

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group: call "
                           "torch.distributed.init_process_group first (or make_host_mesh "
                           "for one rank)")
    names, shapes = tuple(axis_names), tuple(int(n) for n in axis_shapes)
    order = [a for a in ("pod", "data", "model") if a in names]
    if list(names) != order or len(names) != len(shapes):
        raise ValueError(f"axes {names} with extents {shapes}: name each of pod, data, model "
                         "at most once, in that order")
    g = group if group is not None else dist.group.WORLD
    world = dist.get_world_size(g)
    shape = dict(zip(names, shapes))
    m = shape.get("model", 1)
    if world % m or int(torch.tensor(shapes).prod()) != world:
        raise ValueError(f"a mesh of {shape} needs {int(torch.tensor(shapes).prod())} ranks; "
                         f"the group has {world}")
    d, wrank = world // m, dist.get_rank(g)
    dev = _rank_device(device)
    if m == 1:
        return Mesh(names, shape, g, wrank, d, dev)
    if d == 1:
        return Mesh(names, shape, None, 0, 1, dev, model_group=g, model_rank=wrank,
                    world_group=g)
    members = [dist.get_global_rank(g, r) for r in range(world)]
    data_group = model_group = None
    for j in range(m):  # the data groups: one per model coordinate
        grp = dist.new_group([members[i * m + j] for i in range(d)])
        if wrank % m == j:
            data_group = grp
    for i in range(d):  # the model groups: one per data coordinate
        grp = dist.new_group([members[i * m + j] for j in range(m)])
        if wrank // m == i:
            model_group = grp
    return Mesh(names, shape, data_group, wrank // m, d, dev, model_group=model_group,
                model_rank=wrank % m, world_group=g)


def make_production_mesh(multi_pod: bool = False) -> Mesh:
    """The mesh of a ``torchrun`` launch: one rank per card, an NCCL group
    over all of them (initialised here from the launcher's environment
    unless it is already), this rank on ``cuda:LOCAL_RANK``. NCCL only:
    without a card this raises rather than taking gloo.

    A world of 256 ranks is laid out as the reference's production mesh,
    (data 16, model 16); with ``multi_pod`` a world of 512 as (pod 2, data
    16, model 16). Any other world keeps the pure data-parallel mesh
    (data = world, model 1)."""

    missing = [k for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK") if k not in os.environ]
    if missing:
        raise RuntimeError(f"make_production_mesh reads the torchrun environment; {missing} "
                           "unset: launch with torchrun --standalone --nproc_per_node N ...")
    if not torch.cuda.is_available():
        raise RuntimeError("make_production_mesh runs NCCL on the cards but "
                           "torch.cuda.is_available() is false")
    local = int(os.environ["LOCAL_RANK"])
    device = torch.device("cuda", local)
    torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl")
    elif dist.get_backend() != "nccl":
        raise RuntimeError(f"the default group runs {dist.get_backend()!r}; the production "
                           "mesh takes NCCL")
    shape, names = PRODUCTION[bool(multi_pod)]
    if int(torch.tensor(shape).prod()) == dist.get_world_size():
        return make_mesh(shape, names, device=device)
    return make_data_mesh(device=device)
