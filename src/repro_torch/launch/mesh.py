"""Meshes as process groups, after ``src/repro/launch/mesh.py``.

The JAX package names its devices by a mesh of axes ("data", "model") or
("pod", "data", "model"): the batch shards over the pod and data axes,
tensor parallelism over "model". The port keeps the names and the shape
and puts one ``torch.distributed`` process group behind the data axes:
each process (rank) holds one device and one slice of every batch.

Pure data parallelism only: a "model" extent above 1 (tensor or FSDP
sharding of the parameters) raises ``NotImplementedError`` naming ROADMAP
queue 1 item 3, which holds that half. The JAX package's ``shard_map`` and
``AxisType`` are version shims of JAX with no counterpart here.

* :func:`make_host_mesh`: the 1-rank mesh, no process group (tests,
  single-device runs);
* :func:`make_data_mesh`: a mesh over an already initialised process group
  (the default group unless one is given);
* :func:`make_production_mesh`: reads the ``torchrun`` environment
  (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``) and joins an NCCL group, one card per rank.

Every mesh runs on the card unless the caller passes ``device="cpu"``; a
mesh on the card never falls back to the CPU or to another backend than
the one asked for.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

Tree = Any

#: the axes a batch shards over, as ``data_axes`` in the JAX package
DATA_AXES = ("pod", "data")
#: the axes of the meshes made here; a ("pod", "data", "model") mesh is
#: built as a :class:`Mesh` directly
_AXES = ("data", "model")

_MODEL_AXIS = ("a model axis of extent {n} (tensor or FSDP sharding of the parameters) is "
               "not ported: the port is data parallel only (ROADMAP queue 1 item 3)")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """The named axes and their extents, the data axes' process group
    (None on one rank without ``torch.distributed``), this process's rank
    in it and its size (the data extent), and the device this rank runs
    on. ``shape`` maps axis name to extent, as a JAX mesh's does."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    group: Optional[Any]
    rank: int
    size: int
    device: torch.device

    def __post_init__(self):
        if tuple(self.shape) != tuple(self.axis_names):
            raise ValueError(f"shape {self.shape} does not follow the axes {self.axis_names}")
        if self.shape.get("model", 1) != 1:
            raise NotImplementedError(_MODEL_AXIS.format(n=self.shape["model"]))
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

    @property
    def backend(self) -> Optional[str]:
        return None if self.group is None else dist.get_backend(self.group)

    def rows(self, n: int) -> slice:
        """This rank's rows of a batch axis of ``n`` rows: the contiguous
        ``n / size`` block at ``rank``, as a NamedSharding over the data
        axes places them. ``n`` must divide evenly."""

        if n % self.size:
            raise ValueError(f"a batch of {n} rows does not shard evenly over {self.size} "
                             "data-parallel ranks")
        b = n // self.size
        return slice(self.rank * b, (self.rank + 1) * b)

    def local(self, batch: Tree, axis: int) -> Tree:
        """This rank's slice of ``batch`` along ``axis`` (1 for base
        batches (K, B, ...), 0 for a meta batch). A :class:`LocalBatch`
        holds this rank's rows already and comes back as it is."""

        if isinstance(batch, LocalBatch):
            return batch
        from repro_torch import tree as tu

        return tu.tree_map(lambda x: x[(slice(None),) * axis + (self.rows(x.shape[axis]),)],
                           batch)


class LocalBatch(dict):
    """A batch that holds only this rank's rows of a global batch (what
    ``ReweightedIterator(mesh=)`` yields): :meth:`Mesh.local` passes it
    through, as a sharded global array needs no resharding."""


def data_axes(mesh) -> Tuple[str, ...]:
    """The batch-sharding axes of a mesh."""
    return tuple(a for a in mesh.axis_names if a in DATA_AXES)


def make_host_mesh(device="cuda") -> Mesh:
    """The 1-rank mesh (axes ("data", "model"), extents 1) with no process
    group: the schedules run their collectives as identities and count
    them all the same."""

    return Mesh(_AXES, {"data": 1, "model": 1}, None, 0, 1, resolve_device(device))


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
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    size = dist.get_world_size(g)
    return Mesh(_AXES, {"data": size, "model": 1}, g, dist.get_rank(g), size, dev)


def make_production_mesh() -> Mesh:
    """The mesh of a ``torchrun`` launch: one rank per card, an NCCL group
    over all of them (initialised here from the launcher's environment
    unless it is already), this rank on ``cuda:LOCAL_RANK``. NCCL only:
    without a card this raises rather than taking gloo."""

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
    size = dist.get_world_size()
    return Mesh(_AXES, {"data": size, "model": 1}, dist.group.WORLD, dist.get_rank(), size,
                device)
