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
  ``chip_smoke.py``); the model never passes the one or enters the other.

Each wrapper calls :func:`count_launch` exactly where it launches its
kernel, so a run can show that its main path went through the kernel:
reset the counts, drive the path, read :func:`launches`.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Dict, Iterator, List, Optional, Tuple

import torch

CUDA = "cuda"
PLAIN = "plain"

#: class count at or above which per-example CE takes the ``weighted_ce``
#: kernel's route (``src/repro/kernels/dispatch.py``); below it a plain
#: log-softmax is all the work there is.
CE_VOCAB_THRESHOLD = 4096

#: routing decisions: (kernel, route, reason). Bounded, since the serve
#: loop routes every layer of every step.
_DISPATCH_LOG: "collections.deque[Tuple[str, str, str]]" = collections.deque(maxlen=4096)

#: launches of each kernel since the last reset, counted by the wrappers.
_LAUNCHES: Dict[str, int] = collections.defaultdict(int)

#: depth of open plain_everywhere() contexts
_PLAIN_DEPTH = 0


def route(name: str, x: torch.Tensor, backend: Optional[str] = None) -> str:
    """``"cuda"`` or ``"plain"`` for a call of kernel ``name`` on ``x``."""

    if backend is not None and backend != PLAIN:
        raise ValueError(f"backend must be None or {PLAIN!r}, got {backend!r}")
    if backend == PLAIN or _PLAIN_DEPTH:
        chosen, reason = PLAIN, "forced"
    elif x.device.type == "cuda":
        chosen, reason = CUDA, "cuda tensor"
    elif x.device.type == "cpu":
        chosen, reason = PLAIN, "cpu tensor"
    else:
        raise ValueError(f"kernel {name!r} has no route for device {x.device}")
    _DISPATCH_LOG.append((name, chosen, reason))
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


def count_launch(name: str) -> None:
    _LAUNCHES[name] += 1


def launches(name: str) -> int:
    return _LAUNCHES[name]


def reset_launches() -> None:
    _LAUNCHES.clear()


def dispatch_log() -> List[Tuple[str, str, str]]:
    """Routing decisions so far (most recent 4096): (kernel, route, reason)."""

    return list(_DISPATCH_LOG)


def clear_dispatch_log() -> None:
    _DISPATCH_LOG.clear()
