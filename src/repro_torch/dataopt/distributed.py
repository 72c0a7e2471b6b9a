"""Full-dataset scoring on one device, after ``src/repro/dataopt/distributed.py``.

Every score of this subsystem is a per-example quantity with no
cross-example reduction, so a dataset is scored batch by batch.
``map_batches`` is the one primitive: drive a batch function over a
dataset in fixed-size batches, the tail padded by wrapping around to row 0
so that every call sees one shape, under ``torch.no_grad()``, the results
brought to the host as numpy and the padding sliced off.

The JAX package also shards these passes over a mesh's data axes
(``batch_sharding``, ``mesh=``). The port runs on one device: a mesh waits
for the distributed schedule (ROADMAP queue 1 item 3), and passing one
raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

Tree = Any

_NO_MESH = ("sharded scoring over a mesh comes with the distributed schedule "
            "(ROADMAP queue 1 item 3); the port scores on one device: pass mesh=None")


def check_no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(_NO_MESH)


def batch_sharding(mesh):
    """The batch sharding over a mesh's data axes: None without a mesh; a
    mesh raises (ROADMAP queue 1 item 3)."""

    check_no_mesh(mesh)
    return None


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


def map_batches(batch_fn: Callable[..., Any], dataset: Dict[str, np.ndarray], *,
                args: Tuple = (), fields: Tuple[str, ...], batch_size: int = 128, mesh=None,
                device="cuda") -> Any:
    """``batch_fn(*args, batch)`` over the whole dataset (batch: a dict of
    (B, ...) tensors on ``device``, ``"cuda"`` unless the caller passes
    ``device="cpu"``), the outputs concatenated along the leading axis as
    numpy. The tail batch is padded by wrapping to row 0 and the padding
    is sliced off, so every call sees ``batch_size`` rows. Runs under
    ``torch.no_grad()``: a batch function that needs gradients enables
    them itself (the GraNd scorer)."""

    check_no_mesh(mesh)
    device = resolve_device(device)
    n = len(next(iter(dataset.values())))
    npad = ((n + batch_size - 1) // batch_size) * batch_size
    idx = np.arange(npad) % n
    chunks = []
    with torch.no_grad():
        for start in range(0, npad, batch_size):
            rows = idx[start:start + batch_size]
            batch = {k: torch.from_numpy(np.ascontiguousarray(dataset[k][rows])).to(device)
                     for k in fields if k in dataset}
            chunks.append(_map_out(_to_numpy, batch_fn(*args, batch)))
    return _map_out(lambda x: x[:n], _concat(chunks))


def score_dataset(per_example_fn: Callable[[Tree, Dict[str, torch.Tensor]], Any], theta: Tree,
                  dataset: Dict[str, np.ndarray], *, fields: Tuple[str, ...] = ("tokens", "y"),
                  batch_size: int = 128, mesh=None, device="cuda"):
    """A ``PerExample`` adapter over the full dataset: the PerExample with
    stacked (N, ...) numpy fields."""

    return map_batches(per_example_fn, dataset, args=(theta,), fields=fields,
                       batch_size=batch_size, mesh=mesh, device=device)
