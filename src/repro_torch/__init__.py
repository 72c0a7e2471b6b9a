"""PyTorch/CUDA port of the ``repro`` package for one NVIDIA H100.

Laid out module for module like ``src/repro/`` (the JAX reference, which
this package never imports). Ported so far: gemma3-1b-class dense serving
with the split-KV decode attention kernel, and the SAMA meta step
(``api.MetaLearner``, ``core/``, ``optim/``) on the bert-base encoder
classifier, with the training flash-attention forward and backward and the
Adam adaptation product as hand-written CUDA kernels. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""
