"""The paper's primary contribution, after ``src/repro/core``: SAMA,
scalable meta learning as bilevel optimization with (i) identity
base-Jacobian approximation and (ii) analytic algorithmic adaptation for
adaptive optimizers. Hypergradient estimators sit behind the
``repro_torch.core.methods`` registry."""

from repro_torch.core import meta_modules, methods
from repro_torch.core.bilevel import BilevelSpec
from repro_torch.core.engine import (
    Engine,
    EngineConfig,
    EngineState,
    ScaleConfig,
    init_state,
    make_meta_step,
)
from repro_torch.core.methods import (
    HypergradMethod,
    MethodContext,
    ReduceContract,
    available_methods,
    register_method,
    resolve_method,
)
from repro_torch.core.sama import SAMAConfig, SAMAResult, sama_hypergrad

__all__ = [
    "BilevelSpec",
    "Engine",
    "EngineConfig",
    "EngineState",
    "HypergradMethod",
    "MethodContext",
    "ReduceContract",
    "SAMAConfig",
    "SAMAResult",
    "ScaleConfig",
    "available_methods",
    "init_state",
    "make_meta_step",
    "meta_modules",
    "methods",
    "register_method",
    "resolve_method",
    "sama_hypergrad",
]
