"""First-class hypergradient estimators (DESIGN.md sections 2-3), after
``src/repro/core/methods``. Importing this package registers the six
built-in methods: ``sama``, ``sama_na`` and the baselines ``t1t2``,
``neumann``, ``cg`` and ``iterdiff``."""

from repro_torch.core.methods.base import (
    HypergradMethod,
    LocalTerms,
    MethodContext,
    ReduceContract,
    available_methods,
    register_method,
    resolve_method,
    unregister_method,
    validate_terms,
)
from repro_torch.core.methods.sama import SAMAMethod
from repro_torch.core.methods.baselines import (
    CGConfig,
    CGMethod,
    IterDiffConfig,
    IterDiffMethod,
    NeumannConfig,
    NeumannMethod,
    T1T2Config,
    T1T2Method,
)

__all__ = [
    "CGConfig",
    "CGMethod",
    "HypergradMethod",
    "IterDiffConfig",
    "IterDiffMethod",
    "LocalTerms",
    "MethodContext",
    "NeumannConfig",
    "NeumannMethod",
    "ReduceContract",
    "SAMAMethod",
    "T1T2Config",
    "T1T2Method",
    "available_methods",
    "register_method",
    "resolve_method",
    "unregister_method",
    "validate_terms",
]
