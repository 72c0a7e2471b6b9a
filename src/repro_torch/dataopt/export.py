"""Score and mask export and import, after ``src/repro/dataopt/export.py``,
in its format: the ``repro_torch.checkpoint`` npz + manifest with a
dataopt envelope in the manifest's meta:

    kind    = "dataopt.scores"   (foreign checkpoints are refused)
    version = 1
    scorer  = the provider's name (checked on import when expected)
    n       = the dataset length (checked against the caller's)

Scores exported by either package import into the other. Import rebuilds
the template from the manifest itself and restores through
``checkpoint.restore``, so a drift in shape or names fails loudly.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import checkpoint
from repro_torch.checkpoint.checkpoint import MANIFEST

KIND = "dataopt.scores"
VERSION = 1


def export_scores(path: str, scores: np.ndarray, *, scorer: str,
                  mask: Optional[np.ndarray] = None, meta: Optional[Dict[str, Any]] = None) -> str:
    """Write scores (f32, and optionally a boolean keep mask) with the
    manifest."""

    scores = np.asarray(scores, np.float32)
    if scores.ndim != 1:
        raise ValueError(f"scores must be 1-D, got shape {scores.shape}")
    if not np.all(np.isfinite(scores)):
        raise ValueError("refusing to export non-finite scores")
    tree = {"scores": torch.from_numpy(scores)}
    if mask is not None:
        mask = np.asarray(mask, dtype=bool)
        if mask.shape != scores.shape:
            raise ValueError(f"mask shape {mask.shape} != scores shape {scores.shape}")
        tree["mask"] = torch.from_numpy(mask)
    manifest_meta = {"kind": KIND, "version": VERSION, "scorer": scorer, "n": int(len(scores))}
    if meta:
        overlap = set(meta) & set(manifest_meta)
        if overlap:
            raise ValueError(f"meta keys {sorted(overlap)} are reserved")
        manifest_meta.update(meta)
    checkpoint.save(path, tree, meta=manifest_meta)
    return path


def import_scores(path: str, *, expect_n: Optional[int] = None,
                  expect_scorer: Optional[str] = None
                  ) -> Tuple[np.ndarray, Optional[np.ndarray], Dict[str, Any]]:
    """``(scores, mask or None, manifest meta)``, validated."""

    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    meta = manifest.get("meta", {})
    if meta.get("kind") != KIND:
        raise ValueError(f"{path} is not a dataopt score export "
                         f"(manifest kind={meta.get('kind')!r})")
    if meta.get("version") != VERSION:
        raise ValueError(f"{path}: unsupported score-export version {meta.get('version')!r}")

    like: Dict[str, torch.Tensor] = {}
    for name, shape, dtype in zip(manifest["names"], manifest["shapes"], manifest["dtypes"]):
        key = name.strip("[]'\"")
        if key not in ("scores", "mask"):
            raise ValueError(f"{path}: unexpected entry {name!r} in score export")
        like[key] = torch.from_numpy(np.zeros(shape, dtype=dtype))
    tree, _ = checkpoint.restore(path, like)

    scores = tree["scores"].numpy()
    mask = tree["mask"].numpy() if "mask" in tree else None
    if meta.get("n") != len(scores):
        raise ValueError(f"{path}: manifest n={meta.get('n')} but scores have length "
                         f"{len(scores)}: corrupt export")
    if expect_n is not None and len(scores) != expect_n:
        raise ValueError(f"{path}: scores are for a dataset of {len(scores)} examples, "
                         f"caller's dataset has {expect_n}")
    if expect_scorer is not None and meta.get("scorer") != expect_scorer:
        raise ValueError(f"{path}: scored by {meta.get('scorer')!r}, expected {expect_scorer!r}")
    return scores, mask, meta
