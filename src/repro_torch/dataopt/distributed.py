"""Full-dataset scoring, sharded over a mesh's data axes when one is
given, after ``src/repro/dataopt/distributed.py``.

Every score of this subsystem is a per-example quantity with no
cross-example reduction, so a dataset is scored batch by batch.
``map_batches`` is the one primitive: drive a batch function over a
dataset in fixed-size batches, the tail padded by wrapping around to row 0
so that every call sees one shape, under ``torch.no_grad()``, the results
brought to the host as numpy and the padding sliced off.

With a ``mesh`` (``repro_torch.launch.mesh``) each batch shards over the
data axes as a training batch does (``batch_sharding``): each rank scores
its contiguous ``batch_size / ranks`` rows of every batch and writes them
into a zero-filled (N, ...) buffer per output leaf; one all-reduce SUM
per leaf then gives every rank the full result (adding zeros is exact,
and gloo all-reduces CUDA tensors where it would not all-gather them).
Per row the math is the one-device math, on batches of another size.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

Tree = Any


def batch_sharding(mesh) -> Optional[Callable[[int], slice]]:
    """This rank's rows of a (B, ...) batch over the mesh's data axes, as a
    function of B (``Mesh.rows``); None without a mesh. A non-``Mesh``
    object raises ``TypeError``."""

    if mesh is None:
        return None
    from repro_torch.launch.mesh import Mesh

    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a repro_torch.launch.mesh.Mesh, got "
                        f"{type(mesh).__name__}")
    return mesh.rows


def _map_out(fn, out):
    """``fn`` over the tensor leaves of a batch function's output: a
    tensor, a dict, a tuple or list, or a dataclass such as
    ``PerExample`` (None fields kept)."""

    if out is None:
        return None
    if isinstance(out, torch.Tensor) or isinstance(out, np.ndarray):
        return fn(out)
    if isinstance(out, dict):
        return {k: _map_out(fn, v) for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        return type(out)(_map_out(fn, v) for v in out)
    if dataclasses.is_dataclass(out):
        return dataclasses.replace(out, **{f.name: _map_out(fn, getattr(out, f.name))
                                           for f in dataclasses.fields(out)})
    raise TypeError(f"map_batches: unsupported output leaf {type(out).__name__}")


def _concat(chunks):
    first = chunks[0]
    if first is None:
        return None
    if isinstance(first, np.ndarray):
        return np.concatenate(chunks, axis=0)
    if isinstance(first, dict):
        return {k: _concat([c[k] for c in chunks]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_concat([c[i] for c in chunks]) for i in range(len(first)))
    return dataclasses.replace(first, **{f.name: _concat([getattr(c, f.name) for c in chunks])
                                         for f in dataclasses.fields(first)})


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:  # no numpy bf16: f32 holds it exactly
        t = t.float()
    return t.cpu().numpy()


def _pad_to(n: int, batch_size: int, mesh) -> int:
    """Padded dataset length: a multiple of batch_size, which must divide
    over the mesh's data-parallel ranks."""

    if mesh is not None and batch_size % mesh.size:
        raise ValueError(f"batch_size {batch_size} must divide over the mesh's data axes "
                         f"({mesh.size} ranks) for sharded scoring")
    return ((n + batch_size - 1) // batch_size) * batch_size


def map_batches(batch_fn: Callable[..., Any], dataset: Dict[str, np.ndarray], *,
                args: Tuple = (), fields: Tuple[str, ...], batch_size: int = 128, mesh=None,
                device="cuda") -> Any:
    """``batch_fn(*args, batch)`` over the whole dataset (batch: a dict of
    (B, ...) tensors on ``device``, ``"cuda"`` unless the caller passes
    ``device="cpu"``; the mesh's device under a mesh, where the outputs
    must be tensors), the outputs concatenated along the leading axis as
    numpy. The tail batch is padded
    by wrapping to row 0 and the padding is sliced off, so every call sees
    ``batch_size`` rows (``batch_size / ranks`` under a mesh). Runs under
    ``torch.no_grad()``: a batch function that needs gradients enables
    them itself (the GraNd scorer)."""

    rows = batch_sharding(mesh)
    device = mesh.device if mesh is not None else resolve_device(device)
    n = len(next(iter(dataset.values())))
    npad = _pad_to(n, batch_size, mesh)
    idx = np.arange(npad) % n
    mine = rows(batch_size) if rows is not None else slice(None)
    chunks, bufs = [], None
    with torch.no_grad():
        for start in range(0, npad, batch_size):
            sel = idx[start:start + batch_size][mine]
            batch = {k: torch.from_numpy(np.ascontiguousarray(dataset[k][sel])).to(device)
                     for k in fields if k in dataset}
            out = batch_fn(*args, batch)
            if mesh is None:
                chunks.append(_map_out(_to_numpy, out))
                continue
            if bufs is None:
                bufs = _map_out(lambda t: t.new_zeros((npad,) + tuple(t.shape[1:])), out)
            at = slice(start + mine.start, start + mine.stop)
            _zip_out(lambda buf, t: buf[at].copy_(t), bufs, out)
        if mesh is None:
            return _map_out(lambda x: x[:n], _concat(chunks))
        from repro_torch.launch.distributed import collective

        return _map_out(lambda buf: _to_numpy(collective("all-reduce", buf, mesh))[:n], bufs)


def _zip_out(fn, bufs, out):
    """``fn(buf, leaf)`` over the leaves of two outputs of one structure."""

    if bufs is None:
        return
    if isinstance(bufs, torch.Tensor):
        fn(bufs, out)
    elif isinstance(bufs, dict):
        for k in bufs:
            _zip_out(fn, bufs[k], out[k])
    elif isinstance(bufs, (tuple, list)):
        for b, o in zip(bufs, out):
            _zip_out(fn, b, o)
    else:
        for f in dataclasses.fields(bufs):
            _zip_out(fn, getattr(bufs, f.name), getattr(out, f.name))


def score_dataset(per_example_fn: Callable[[Tree, Dict[str, torch.Tensor]], Any], theta: Tree,
                  dataset: Dict[str, np.ndarray], *, fields: Tuple[str, ...] = ("tokens", "y"),
                  batch_size: int = 128, mesh=None, device="cuda"):
    """A ``PerExample`` adapter over the full dataset (sharded under a
    mesh): the PerExample with stacked (N, ...) numpy fields."""

    return map_batches(per_example_fn, dataset, args=(theta,), fields=fields,
                       batch_size=batch_size, mesh=mesh, device=device)
