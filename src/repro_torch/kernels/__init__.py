"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version, routed by the tensor's device (``kernels/dispatch.py``), behind
the JAX package's registry names (``src/repro/kernels/__init__.py``):

* ``adam_adapt`` / ``lion_adapt`` / ``adafactor_adapt``: the fused
  adaptation-diagonal x meta-gradient product and its sum of squares;
* ``weighted_ce``: per-row cross-entropy over a large vocabulary, forward
  and backward;
* ``flash_attention`` and ``flash_decode``: blockwise training attention
  and split-KV decode.

``ops`` holds the public wrappers, ``ref`` the JAX package's oracles, and
``work`` each kernel call's analytic FLOPs and bytes.
"""

from repro_torch.kernels import ops, ref
from repro_torch.kernels.dispatch import (
    BACKENDS,
    CE_VOCAB_THRESHOLD,
    ENV_VAR,
    KernelImpl,
    available_kernels,
    backend_order,
    clear_dispatch_log,
    dispatch_log,
    get_kernel,
    kernel_backends,
    register_kernel,
    unregister_kernel,
)

__all__ = [
    "BACKENDS",
    "CE_VOCAB_THRESHOLD",
    "ENV_VAR",
    "KernelImpl",
    "available_kernels",
    "backend_order",
    "clear_dispatch_log",
    "dispatch_log",
    "get_kernel",
    "kernel_backends",
    "ops",
    "ref",
    "register_kernel",
    "unregister_kernel",
]
