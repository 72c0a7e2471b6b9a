"""PyTorch/CUDA port of the ``repro`` package for one NVIDIA H100.

Laid out module for module like ``src/repro/`` (the JAX reference, which
this package never imports). Ported so far: gemma3-1b-class dense serving,
with the split-KV decode attention as a hand-written CUDA kernel.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
