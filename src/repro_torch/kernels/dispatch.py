"""Kernel routing of the port: the tensor's device picks the implementation.

Every kernel of the port has two implementations of one calling
convention: the hand-written CUDA kernel and its plain PyTorch version.

* A CUDA tensor launches the kernel. A shape, dtype or layout the kernel
  does not take raises: nothing on the card falls through to the plain
  version.
* A CPU tensor takes the plain version (the CPU tests run it).
* ``backend="plain"`` computes the plain version whatever the device, and
  so does every call inside :func:`plain_everywhere`. Both exist for the
  comparisons of kernel and plain version on the card (tests,
  ``chip_smoke.py``); no training or serving path passes the one or enters
  the other.
* Every call inside :func:`second_order` takes the plain version too, with
  the reason ``"second order"``: the kernels' backward is first order only
  (:func:`first_order_only`), so the baseline hypergradient estimators
  (``core/baselines.py``) enter it around exactly the passes that
  differentiate twice (their Hessian-vector and mixed products and
  iterative differentiation's re-unroll). Nothing catches a kernel's raise
  and retries plain: outside the context a second derivative through the
  kernels still raises.

Each wrapper calls :func:`count_launch` exactly where it launches its
kernel, so a run can show that its main path went through the kernel:
reset the counts, drive the path, read :func:`launches`. Beside them,
:func:`route_counts` counts the routing decisions by (route, reason), so a
run can show which passes took which route (the dispatch log keeps only
the latest 4096). When the process-global obs pipeline
(``repro_torch.obs.set_default``) is enabled, every decision is mirrored
into it: ``dispatch_total{kernel,backend,reason}`` counts calls, and a
``dispatch`` event marks the first of each triple
(``Obs.observe_dispatch``).
"""

from __future__ import annotations

import collections
import contextlib
from typing import Dict, Iterator, List, Optional, Tuple

import torch

from repro_torch import obs as obs_mod

CUDA = "cuda"
PLAIN = "plain"
SECOND_ORDER = "second order"

#: class count at or above which per-example CE takes the ``weighted_ce``
#: kernel's route (``src/repro/kernels/dispatch.py``); below it a plain
#: log-softmax is all the work there is.
CE_VOCAB_THRESHOLD = 4096

#: routing decisions: (kernel, route, reason). Bounded, since the serve
#: loop routes every layer of every step.
_DISPATCH_LOG: "collections.deque[Tuple[str, str, str]]" = collections.deque(maxlen=4096)

#: launches of each kernel since the last reset, counted by the wrappers.
_LAUNCHES: Dict[str, int] = collections.defaultdict(int)

#: routing decisions by (route, reason) since the last reset
_ROUTES: Dict[Tuple[str, str], int] = collections.defaultdict(int)

#: depth of open plain_everywhere() and second_order() contexts
_PLAIN_DEPTH = 0
_SECOND_ORDER_DEPTH = 0


def _device_route(name: str, x: torch.Tensor) -> Tuple[str, str]:
    if x.device.type == "cuda":
        return CUDA, "cuda tensor"
    if x.device.type == "cpu":
        return PLAIN, "cpu tensor"
    raise ValueError(f"kernel {name!r} has no route for device {x.device}")


def route(name: str, x: torch.Tensor, backend: Optional[str] = None) -> str:
    """``"cuda"`` or ``"plain"`` for a call of kernel ``name`` on ``x``."""

    if backend is not None and backend != PLAIN:
        raise ValueError(f"backend must be None or {PLAIN!r}, got {backend!r}")
    if backend == PLAIN or _PLAIN_DEPTH:
        chosen, reason = PLAIN, "forced"
    elif _SECOND_ORDER_DEPTH:
        chosen, reason = PLAIN, SECOND_ORDER
    else:
        chosen, reason = _device_route(name, x)
    _DISPATCH_LOG.append((name, chosen, reason))
    _ROUTES[(chosen, reason)] += 1
    obs = obs_mod.get_default()
    if obs.enabled:
        obs.observe_dispatch(name, chosen, reason)
    return chosen


@contextlib.contextmanager
def plain_everywhere() -> Iterator[None]:
    """Every kernel call inside takes its plain version, on any device: a
    whole training step computed without the kernels, to hold the kernels'
    step against (``chip_smoke.py``). Comparison only."""

    global _PLAIN_DEPTH
    _PLAIN_DEPTH += 1
    try:
        yield
    finally:
        _PLAIN_DEPTH -= 1


@contextlib.contextmanager
def second_order() -> Iterator[None]:
    """Every kernel call inside takes its plain version, on any device, with
    the reason ``"second order"``: the passes that differentiate twice
    (``core/baselines.py``), which the first-order kernels cannot take."""

    global _SECOND_ORDER_DEPTH
    _SECOND_ORDER_DEPTH += 1
    try:
        yield
    finally:
        _SECOND_ORDER_DEPTH -= 1


class _FirstOrderOnly(torch.autograd.Function):
    """Passes a kernel backward's gradients through unchanged; taking a
    derivative of them raises, naming the kernel."""

    @staticmethod
    def forward(ctx, name, n_grads, *tensors):
        ctx.name = name
        return tuple(g.view_as(g) for g in tensors[len(tensors) - n_grads:])

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(f"{ctx.name}: a second derivative through the CUDA kernels is not "
                           "supported: their backward is first order only (the plain route, "
                           "backend='plain', dispatch.second_order() or CPU tensors, "
                           "differentiates to any order)")


def first_order_only(name: str, inputs, grads):
    """``grads``, the gradients a kernel's backward computed for ``inputs``,
    tied to ``inputs`` so that differentiating them again raises instead of
    returning a wrong value (the kernel's recompute treats what its forward
    saved as constants). A no-op unless the backward runs with
    ``create_graph=True``."""

    if not torch.is_grad_enabled():
        return tuple(grads)
    return _FirstOrderOnly.apply(name, len(grads), *inputs, *grads)


def count_launch(name: str) -> None:
    _LAUNCHES[name] += 1


def launches(name: str) -> int:
    return _LAUNCHES[name]


def launch_counts() -> Dict[str, int]:
    """Launches since the last reset, by kernel."""

    return dict(_LAUNCHES)


def route_counts() -> Dict[Tuple[str, str], int]:
    """Routing decisions since the last reset, by (route, reason)."""

    return dict(_ROUTES)


def reset_launches() -> None:
    """Sets the launch counts and the route counts to 0."""

    _LAUNCHES.clear()
    _ROUTES.clear()


def dispatch_log() -> List[Tuple[str, str, str]]:
    """Routing decisions so far (most recent 4096): (kernel, route, reason)."""

    return list(_DISPATCH_LOG)


def clear_dispatch_log() -> None:
    _DISPATCH_LOG.clear()
