"""Kernel routing of the port: the tensor's device picks the implementation,
and the kernel registry of the JAX package's names on top of it.

Every kernel of the port has two implementations of one calling
convention: the hand-written CUDA kernel and its plain PyTorch version.

* A CUDA tensor launches the kernel. A shape, dtype or layout the kernel
  does not take raises: nothing on the card falls through to the plain
  version.
* A CPU tensor takes the plain version (the CPU tests run it).
* A ``meta`` tensor takes the meta route: empty outputs of the kernel's
  shapes and dtypes, with the call's analytic work charged (the dry run,
  ``launch/dryrun.py``). Only a ``meta`` tensor takes it.
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
* ``REPRO_KERNEL_BACKEND`` (:data:`ENV_VAR`: ``cuda`` or ``plain``) is
  honoured only where it agrees with the tensor's device: ``plain`` on a
  CUDA tensor raises, naming the variable, and so does ``cuda`` on a CPU
  tensor. A ``meta`` tensor takes its route whatever the variable says.
  The JAX package's registry falls back down its ``backend_order``; this
  one never does.

The registry (:func:`register_kernel`, :func:`get_kernel`, ...) keeps the
JAX package's names, ``src/repro/kernels/dispatch.py``: its ``pallas-tpu``
backend is ``"cuda"`` here, and its ``ref`` and ``pallas-interpret`` are
``"plain"``. ``get_kernel(name)`` resolves a backend per call from an
explicit ``backend=``, else the variable, else the tensor's device, and
refuses a choice that disagrees with the device: the registry cannot undo
the routing rule above. An ineligible shape on the card raises.

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

A hand-written kernel is a call the attribution (``obs/profile.py``)
cannot see, so each wrapper reports its call's analytic work
(``kernels/work.py``) through :func:`charge` on every route, and computes
inside :func:`uncounted`, where the attribution counts no operation: the
work of a kernel's function counts the same whichever route computes it.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

from repro_torch import obs as obs_mod

CUDA = "cuda"
PLAIN = "plain"
META = "meta"
SECOND_ORDER = "second order"

#: the environment variable that picks a backend where it agrees with the
#: tensor's device
ENV_VAR = "REPRO_KERNEL_BACKEND"

#: the registry's backends: the kernel's wrapper and its plain version
BACKENDS = (CUDA, PLAIN)

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


def _env_backend() -> Optional[str]:
    forced = os.environ.get(ENV_VAR) or None
    if forced is not None and forced not in BACKENDS:
        raise ValueError(f"{ENV_VAR} must be one of {BACKENDS}, got {forced!r}")
    return forced


def _agree(name: str, backend: str, device: torch.device, what: str) -> None:
    """Raise where ``backend`` disagrees with a tensor on ``device``."""
    if device.type == "cuda" and backend != CUDA:
        raise ValueError(f"kernel {name!r}: {what}={backend!r} on a cuda tensor is refused: a "
                         "cuda tensor launches the kernel (the plain version on the card is "
                         "for comparisons only: backend='plain' on the wrapper, "
                         "dispatch.plain_everywhere())")
    if device.type == "cpu" and backend != PLAIN:
        raise ValueError(f"kernel {name!r}: {what}={backend!r} on a cpu tensor is refused: "
                         "the kernels run on the card only")


def _device_route(name: str, x: torch.Tensor) -> Tuple[str, str]:
    forced = _env_backend()
    if forced is not None:
        _agree(name, forced, x.device, ENV_VAR)
    if x.device.type == "cuda":
        return CUDA, "cuda tensor"
    if x.device.type == "cpu":
        return PLAIN, "cpu tensor"
    raise ValueError(f"kernel {name!r} has no route for device {x.device}")


def route(name: str, x: torch.Tensor, backend: Optional[str] = None) -> str:
    """``"cuda"``, ``"plain"`` or ``"meta"`` for a call of kernel ``name``
    on ``x``. A meta tensor takes ``"meta"`` whatever else is asked."""

    if backend is not None and backend != PLAIN:
        raise ValueError(f"backend must be None or {PLAIN!r}, got {backend!r}")
    if x.device.type == "meta":
        chosen, reason = META, "meta tensor"
    elif backend == PLAIN or _PLAIN_DEPTH:
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


# ---------------------------------------------------------------------------
# the work charged to an attribution (obs/profile.py)
# ---------------------------------------------------------------------------

#: the attribution's receiver of kernel charges, ``sink(name, work)``, or None
_SINK: Optional[Callable[[str, Any], None]] = None

#: depth of open uncounted() scopes
_UNCOUNTED = 0


def set_work_sink(sink: Optional[Callable[[str, Any], None]]):
    """Install ``sink`` as the receiver of :func:`charge`; returns the one
    it replaces (``obs.profile.attribute`` installs and restores it)."""
    global _SINK
    prev, _SINK = _SINK, sink
    return prev


def charge(name: str, work) -> None:
    """Report the analytic work of one call of kernel ``name``
    (``kernels.work.Work``) to the attribution, if one counts."""
    if _SINK is not None:
        _SINK(name, work)


@contextlib.contextmanager
def uncounted() -> Iterator[None]:
    """The attribution counts no operation made inside: a kernel's own
    tensor work, on every route, whose analytic count :func:`charge`
    reports instead. The depth is process-global, so an autograd engine
    thread running a kernel's backward sees it."""
    global _UNCOUNTED
    _UNCOUNTED += 1
    try:
        yield
    finally:
        _UNCOUNTED -= 1


def uncounted_depth() -> int:
    return _UNCOUNTED


def plain_backward(out: torch.Tensor, inputs, charge_backward: Callable[[], None]) -> None:
    """On the plain route of a differentiable kernel, while an attribution
    counts: tag the autograd nodes between ``out`` and ``inputs`` (the
    graph the plain version built) so that none of their backward
    operations counts, and run ``charge_backward`` (the kernel's analytic
    backward) each time ``out``'s gradient arrives."""
    if _SINK is None or not out.requires_grad:
        return
    stop = {id(x.grad_fn) for x in inputs if x.grad_fn is not None}
    todo = [out.grad_fn]
    seen = set()
    while todo:
        node = todo.pop()
        if node is None or id(node) in seen or id(node) in stop:
            continue
        seen.add(id(node))
        if type(node).__name__ == "AccumulateGrad":
            continue
        node.metadata["repro_uncounted"] = True
        todo.extend(nxt for nxt, _ in node.next_functions)
    out.register_hook(lambda g: charge_backward())


# ---------------------------------------------------------------------------
# the registry: the JAX package's names over the port's routes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KernelImpl:
    """One registered implementation of a kernel."""

    name: str
    backend: str
    fn: Callable[..., Any]
    #: eligibility predicate on the call's arguments; None = always eligible
    eligible: Optional[Callable[..., bool]] = None

    def is_eligible(self, *args, **kwargs) -> bool:
        if self.eligible is None:
            return True
        return bool(self.eligible(*args, **kwargs))


_REGISTRY: Dict[str, Dict[str, KernelImpl]] = {}
_BUILTINS = False


def register_kernel(name: str, backend: str, impl: Optional[Callable[..., Any]] = None, *,
                    eligible: Optional[Callable[..., bool]] = None, overwrite: bool = False):
    """Register ``impl`` as the ``backend`` (``"cuda"`` or ``"plain"``)
    implementation of kernel ``name``; usable as a decorator. All
    implementations of one name share a calling convention. A second
    registration of one (name, backend) raises unless ``overwrite``."""

    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; have {BACKENDS}")

    def _install(fn):
        _builtins()
        per_kernel = _REGISTRY.setdefault(name, {})
        if backend in per_kernel and not overwrite:
            raise ValueError(f"kernel {name!r} already has a {backend!r} implementation "
                             "(pass overwrite=True to replace)")
        per_kernel[backend] = KernelImpl(name=name, backend=backend, fn=fn, eligible=eligible)
        return fn

    if impl is None:
        return _install
    return _install(impl)


def unregister_kernel(name: str, backend: Optional[str] = None) -> None:
    """Remove a kernel (or one backend of it)."""
    _builtins()
    if backend is None:
        _REGISTRY.pop(name, None)
    elif name in _REGISTRY:
        _REGISTRY[name].pop(backend, None)


def available_kernels() -> Tuple[str, ...]:
    _builtins()
    return tuple(sorted(_REGISTRY))


def kernel_backends(name: str) -> Tuple[str, ...]:
    """Backends registered for ``name``."""
    _builtins()
    if name not in _REGISTRY:
        raise ValueError(f"unknown kernel {name!r}; have {available_kernels()}")
    return tuple(b for b in BACKENDS if b in _REGISTRY[name])


def backend_order(backend: Optional[str] = None, device=None) -> Tuple[str, ...]:
    """The backend a call takes, as a one-entry tuple (the JAX package's
    precedence list, with no fallback): an explicit ``backend``, else
    ``$REPRO_KERNEL_BACKEND``, else the device's (``cuda`` on a CUDA
    device, ``plain`` on the CPU; a ``meta`` tensor takes the wrapper, whose
    meta route counts). With ``device`` given, a choice that disagrees with
    it raises. Without one the device is the card where there is one."""

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "meta":
        return (CUDA,)
    if backend is not None:
        if backend not in BACKENDS:
            raise ValueError(f"backend= must be one of {BACKENDS}, got {backend!r}")
        _agree("*", backend, device, "backend")
        return (backend,)
    forced = _env_backend()
    if forced is not None:
        _agree("*", forced, device, ENV_VAR)
        return (forced,)
    return (CUDA,) if device.type == "cuda" else (PLAIN,)


def _first_tensor(args, kwargs) -> torch.Tensor:
    for x in list(args) + list(kwargs.values()):
        if isinstance(x, torch.Tensor):
            return x
    raise ValueError("a kernel call needs a tensor argument")


def get_kernel(name: str, *, backend: Optional[str] = None) -> Callable[..., Any]:
    """A callable that runs ``name`` on the backend :func:`backend_order`
    picks for its first tensor argument at each call. An unregistered or
    ineligible choice raises: nothing falls through."""

    _builtins()
    if name not in _REGISTRY:
        raise ValueError(f"unknown kernel {name!r}; have {available_kernels()}")

    def dispatch(*args, **kwargs):
        device = _first_tensor(args, kwargs).device
        try:
            (cand,) = backend_order(backend, device)
        except ValueError as e:
            raise ValueError(f"kernel {name!r}: {e}") from None
        impl = _REGISTRY[name].get(cand)
        if impl is None:
            raise ValueError(f"kernel {name!r} has no {cand!r} implementation")
        if not impl.is_eligible(*args, **kwargs):
            raise ValueError(f"kernel {name!r}: the {cand!r} implementation does not take "
                             "these arguments")
        return impl.fn(*args, **kwargs)

    dispatch.__name__ = f"dispatch[{name}]"
    return dispatch


def _flat_ok(*arrays, **kwargs) -> bool:
    return all(a.dim() == 1 for a in arrays) and arrays[0].numel() > 0


def _ce_ok(logits, targets, **kwargs) -> bool:
    return logits.dim() == 2


def _attn_ok(q, k, v, *args, **kwargs) -> bool:
    return (q.dim() == 4 and k.dim() == 4 and v.shape == k.shape
            and q.shape[0] == k.shape[0] and q.shape[-1] == k.shape[-1]
            and k.shape[2] > 0 and q.shape[2] % k.shape[2] == 0
            and q.dtype in (torch.float32, torch.bfloat16, torch.float16))


def _decode_ok(q, k, v, *args, **kwargs) -> bool:
    return _attn_ok(q, k, v) and q.shape[1] == 1


def _builtins() -> None:
    """The package's support matrix: each kernel's wrapper as ``cuda`` (on
    a CPU tensor the registry never picks it) and its plain version as
    ``plain`` (on a CUDA tensor the registry never picks it)."""
    global _BUILTINS
    if _BUILTINS:
        return
    _BUILTINS = True
    from repro_torch.kernels import (adafactor_adapt, adam_adapt, flash_attn, lion_adapt,
                                     weighted_ce)

    for name, fn, ok in (("adam_adapt", adam_adapt.adam_adapt, _flat_ok),
                         ("lion_adapt", lion_adapt.lion_adapt, _flat_ok),
                         ("adafactor_adapt", adafactor_adapt.adafactor_adapt, _flat_ok),
                         ("weighted_ce", weighted_ce.cross_entropy, _ce_ok),
                         ("flash_attention", flash_attn.flash_attention, _attn_ok),
                         ("flash_decode", flash_attn.flash_decode, _decode_ok)):
        per_kernel = _REGISTRY.setdefault(name, {})
        per_kernel[CUDA] = KernelImpl(name, CUDA, fn, ok)
        per_kernel[PLAIN] = KernelImpl(
            name, PLAIN, lambda *a, _fn=fn, **k: _fn(*a, backend=PLAIN, **k), ok)
