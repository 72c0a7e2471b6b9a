"""The HypergradMethod protocol and registry, after
``src/repro/core/methods/base.py`` (DESIGN.md sections 2-3).

A hypergradient estimator is an object with a declared communication
contract, driven through three stages:

    1. ``local_terms(spec, ctx)``: shard-local math, returning named terms;
       ``"hypergrad"`` and ``"meta_loss"`` are mandatory.
    2. reduction, owned by the caller: the identity on one device.
    3. ``finalize(terms, ctx)``: ``(hypergrad, theta_post)``.

Methods register a factory under a name and then work wherever an
``EngineConfig.method`` string is accepted.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.core.bilevel import BilevelSpec
from repro_torch.optim import Optimizer, OptState

Tree = Any

#: a method's per-shard output: named tensors. "hypergrad" (tree like lam)
#: and "meta_loss" (scalar) are mandatory; extra keys are method state.
LocalTerms = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ReduceContract:
    """What a distributed schedule may do with local terms: ``terms`` ride
    its one bucketed all-reduce (an unweighted mean over data shards);
    ``linear`` says that shard mean is the method's own estimator on the
    global batch."""

    terms: Tuple[str, ...] = ("hypergrad", "meta_loss")
    linear: bool = True

    def __post_init__(self):
        for required in ("hypergrad", "meta_loss"):
            if required not in self.terms:
                raise ValueError(f"reduce contract must include {required!r}, got {self.terms}")


@dataclasses.dataclass(frozen=True)
class MethodContext:
    """Everything the base-level unroll hands to a hypergradient method,
    built once per meta step after the K-step unroll."""

    base_opt: Optimizer
    theta0: Tree  # base params BEFORE the unroll
    theta: Tree  # base params AFTER the unroll (theta*)
    lam: Tree
    g_base: Optional[Tree]  # last base gradient
    base_opt_state: OptState  # optimizer state AT WHICH g_base was computed
    base_batches: Any  # full unroll batches, leading axis K
    last_batch: Any  # base_batches[-1]
    meta_batch: Any


class HypergradMethod:
    """Base class for hypergradient estimators. Subclasses set ``name`` and
    ``reduce_contract`` and implement ``local_terms``; ``finalize``
    defaults to the identity post-update (no theta change)."""

    name: str = "abstract"
    reduce_contract: ReduceContract = ReduceContract()

    def local_terms(self, spec: BilevelSpec, ctx: MethodContext) -> LocalTerms:
        raise NotImplementedError

    def finalize(self, terms: LocalTerms, ctx: MethodContext) -> Tuple[Tree, Tree]:
        return terms["hypergrad"], ctx.theta

    def metrics(self, terms: LocalTerms) -> Dict[str, Any]:
        """Per-method scalar metrics merged into the step's metric dict."""
        return {}


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

#: name -> factory(engine_cfg) -> HypergradMethod
MethodFactory = Callable[[Any], HypergradMethod]

_REGISTRY: Dict[str, MethodFactory] = {}


def register_method(name: str, factory: Optional[Any] = None, *, overwrite: bool = False):
    """Register a hypergradient method under ``name``: as a decorator on a
    factory(cfg), with a factory, or with an instance (cfg ignored)."""

    def _install(f: MethodFactory) -> MethodFactory:
        if not overwrite and name in _REGISTRY:
            raise ValueError(f"hypergrad method {name!r} already registered "
                             "(pass overwrite=True to replace)")
        _REGISTRY[name] = f
        return f

    if factory is None:
        return _install
    if isinstance(factory, HypergradMethod):
        instance = factory
        return _install(lambda cfg, _m=instance: _m)
    return _install(factory)


def unregister_method(name: str):
    _REGISTRY.pop(name, None)


def available_methods() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def resolve_method(method: Any, cfg: Any = None) -> HypergradMethod:
    """An EngineConfig.method value (name or instance) as a method object."""

    if isinstance(method, HypergradMethod):
        return method
    if isinstance(method, str):
        if method not in _REGISTRY:
            raise ValueError(
                f"unknown hypergrad method {method!r}; registered: {available_methods()}")
        m = _REGISTRY[method](cfg)
        if not isinstance(m, HypergradMethod):
            raise TypeError(f"factory for {method!r} returned {type(m).__name__}, "
                            "expected a HypergradMethod")
        return m
    raise TypeError(f"method must be a name or HypergradMethod, got {type(method).__name__}")


def validate_terms(method: HypergradMethod, terms: LocalTerms) -> LocalTerms:
    """Mandatory keys + contract coverage."""

    for required in ("hypergrad", "meta_loss"):
        if required not in terms:
            raise ValueError(f"{method.name}: local_terms missing {required!r}")
    missing = [t for t in method.reduce_contract.terms if t not in terms]
    if missing:
        raise ValueError(f"{method.name}: reduce contract names terms {missing} that "
                         f"local_terms did not produce (got {sorted(terms)})")
    return terms
