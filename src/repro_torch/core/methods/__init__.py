"""First-class hypergradient estimators (DESIGN.md sections 2-3), after
``src/repro/core/methods``. Importing this package registers ``sama`` and
``sama_na``; the baselines (t1t2, neumann, cg, iterdiff) come later."""

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

__all__ = [
    "HypergradMethod",
    "LocalTerms",
    "MethodContext",
    "ReduceContract",
    "SAMAMethod",
    "available_methods",
    "register_method",
    "resolve_method",
    "unregister_method",
    "validate_terms",
]
