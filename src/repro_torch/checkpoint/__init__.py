"""Checkpoint substrate, after ``src/repro/checkpoint``: npz blobs plus a
JSON manifest, in the JAX package's format."""

from repro_torch.checkpoint.checkpoint import latest_step, restore, save

__all__ = ["latest_step", "restore", "save"]
