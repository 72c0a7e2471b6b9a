"""Tree checkpointing, after ``src/repro/checkpoint/checkpoint.py``, in its
on-disk format: ``arrays.npz`` holds the leaves as blobs ``a0, a1, ...``
and ``manifest.json`` their ``names`` (``jax.tree_util.keystr`` of each
leaf's path, in JAX's leaf order), ``shapes``, ``dtypes``, the ``step`` and
the caller's ``meta``. A checkpoint the JAX package writes restores here
and the reverse: the port's ``EngineState`` renders the same names
(``tree.flatten_with_keys``). Its ``scale`` field is an empty subtree
unless a loss-scaling policy (f16) runs, so an f32 or bf16 state keeps
its layout (63 leaves at bert-base); under f16 the ``LossScaleState``
adds ``.scale.scale`` (f32) and ``.scale.good_steps`` (int32) last, in
JAX's leaf order.

The leaves go to numpy on the host to be saved (bf16 as f32, which holds
it exactly); on restore they come back on the device and in the dtype of
the ``like`` tree's leaves.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tu

Tree = Any

MANIFEST = "manifest.json"
ARRAYS = "arrays.npz"


def _to_numpy(leaf) -> np.ndarray:
    t = torch.as_tensor(leaf).detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def save(path: str, tree: Tree, *, step: Optional[int] = None, meta: Optional[Dict] = None,
         sharding=None):
    """Write ``tree``. ``sharding`` (a ``launch.fsdp.FSDP``): ``tree``
    holds this rank's blocks of the sharded leaves (theta, or a state);
    they are gathered whole over the model group, so every rank of the
    mesh calls, and the world's rank 0 writes the one-rank layout."""

    if sharding is not None:
        tree = sharding.unshard(tree)
        if sharding.mesh.world_rank != 0:
            return
    os.makedirs(path, exist_ok=True)
    names, leaves = tu.flatten_with_keys(tree)
    arrays = [_to_numpy(leaf) for leaf in leaves]
    np.savez(os.path.join(path, ARRAYS), **{f"a{i}": a for i, a in enumerate(arrays)})
    manifest = {
        "names": names,
        "shapes": [list(a.shape) for a in arrays],
        "dtypes": [str(a.dtype) for a in arrays],
        "step": step,
        "meta": meta or {},
    }
    with open(os.path.join(path, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)


def restore(path: str, like: Tree, *, sharding=None) -> Tuple[Tree, Dict]:
    """Restore into the structure of ``like``: the leaf names must equal
    the manifest's, in order, and each shape its leaf's; each leaf comes
    back on the device and in the dtype of ``like``'s. ``sharding`` (a
    ``launch.fsdp.FSDP``): ``like`` holds this rank's blocks, and each
    sharded leaf's whole array gives its block (no collective)."""

    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    names, leaves_like = tu.flatten_with_keys(like)
    if names != manifest["names"]:
        raise ValueError(
            f"checkpoint structure mismatch: {set(names) ^ set(manifest['names'])}")
    restored = []
    with np.load(os.path.join(path, ARRAYS)) as blobs:
        for i, (name, ref) in enumerate(zip(names, leaves_like)):
            arr = blobs[f"a{i}"]
            if arr.dtype.name == "bfloat16":  # ml_dtypes, as the JAX package writes it
                arr = arr.astype(np.float32)
            t = torch.from_numpy(np.array(arr, copy=True))
            if sharding is not None:
                t = sharding.block_of(name, t)
            if list(t.shape) != list(ref.shape):
                raise ValueError(f"{name}: shape {tuple(t.shape)} != expected "
                                 f"{tuple(ref.shape)}")
            restored.append(t.to(device=ref.device, dtype=ref.dtype))
    return tu.unflatten_like(like, restored), manifest


def latest_step(root: str) -> Optional[str]:
    """Given the root/step_000123 layout, the newest checkpoint dir."""

    if not os.path.isdir(root):
        return None
    steps = sorted(d for d in os.listdir(root) if d.startswith("step_"))
    return os.path.join(root, steps[-1]) if steps else None
