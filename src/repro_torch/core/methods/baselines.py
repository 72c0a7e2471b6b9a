"""Baseline hypergradient estimators as HypergradMethod objects, after
``src/repro/core/methods/baselines.py``.

T1-T2's exact mixed VJP is an average of per-example terms, so it shares
SAMA's linear reduce contract. Neumann, CG and iterative differentiation
solve or unroll on the local shard; averaging those local solutions is NOT
the global estimator (the solve is nonlinear in the shard data), so they
declare ``linear=False``.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import baselines as bl
from repro_torch.core.methods.base import (
    HypergradMethod,
    LocalTerms,
    MethodContext,
    ReduceContract,
    register_method,
)


@dataclasses.dataclass(frozen=True)
class T1T2Config:
    pass  # T1-T2 has no knobs: identity Jacobian, exact mixed VJP


@dataclasses.dataclass(frozen=True)
class NeumannConfig:
    num_terms: int = 5
    scale: float = 0.1


@dataclasses.dataclass(frozen=True)
class CGConfig:
    num_iters: int = 5
    damping: float = 1e-3


@dataclasses.dataclass(frozen=True)
class IterDiffConfig:
    pass  # the unroll length is the Engine's unroll_steps


def _meta_loss(spec, ctx: MethodContext):
    return spec.meta_scalar(ctx.theta, ctx.lam, ctx.meta_batch)


@dataclasses.dataclass(frozen=True)
class T1T2Method(HypergradMethod):
    cfg: T1T2Config = T1T2Config()
    name: str = "t1t2"

    reduce_contract = ReduceContract(linear=True)

    def local_terms(self, spec, ctx: MethodContext) -> LocalTerms:
        hyper = bl.t1t2_hypergrad(spec, ctx.theta, ctx.lam, ctx.last_batch, ctx.meta_batch)
        return {"hypergrad": hyper, "meta_loss": _meta_loss(spec, ctx)}


@dataclasses.dataclass(frozen=True)
class NeumannMethod(HypergradMethod):
    cfg: NeumannConfig = NeumannConfig()
    name: str = "neumann"

    reduce_contract = ReduceContract(linear=False)

    def local_terms(self, spec, ctx: MethodContext) -> LocalTerms:
        hyper = bl.neumann_hypergrad(
            spec, ctx.theta, ctx.lam, ctx.last_batch, ctx.meta_batch,
            num_terms=self.cfg.num_terms, scale=self.cfg.scale,
        )
        return {"hypergrad": hyper, "meta_loss": _meta_loss(spec, ctx)}


@dataclasses.dataclass(frozen=True)
class CGMethod(HypergradMethod):
    cfg: CGConfig = CGConfig()
    name: str = "cg"

    reduce_contract = ReduceContract(linear=False)

    def local_terms(self, spec, ctx: MethodContext) -> LocalTerms:
        hyper = bl.cg_hypergrad(
            spec, ctx.theta, ctx.lam, ctx.last_batch, ctx.meta_batch,
            num_iters=self.cfg.num_iters, damping=self.cfg.damping,
        )
        return {"hypergrad": hyper, "meta_loss": _meta_loss(spec, ctx)}


@dataclasses.dataclass(frozen=True)
class IterDiffMethod(HypergradMethod):
    """MAML-style: differentiate through the whole unroll from theta0
    (memory ~ K backward graphs: the cost the paper argues against)."""

    cfg: IterDiffConfig = IterDiffConfig()
    name: str = "iterdiff"

    reduce_contract = ReduceContract(linear=False)

    def local_terms(self, spec, ctx: MethodContext) -> LocalTerms:
        hyper = bl.iterdiff_hypergrad(
            spec, ctx.theta0, ctx.lam, ctx.base_batches, ctx.meta_batch,
            base_opt=ctx.base_opt,
        )
        return {"hypergrad": hyper, "meta_loss": _meta_loss(spec, ctx)}


@register_method("t1t2")
def _make_t1t2(cfg) -> T1T2Method:
    del cfg
    return T1T2Method()


@register_method("neumann")
def _make_neumann(cfg) -> NeumannMethod:
    if cfg is None:
        return NeumannMethod()
    return NeumannMethod(cfg=NeumannConfig(num_terms=cfg.neumann_terms, scale=cfg.neumann_scale))


@register_method("cg")
def _make_cg(cfg) -> CGMethod:
    if cfg is None:
        return CGMethod()
    return CGMethod(cfg=CGConfig(num_iters=cfg.cg_iters, damping=cfg.cg_damping))


@register_method("iterdiff")
def _make_iterdiff(cfg) -> IterDiffMethod:
    del cfg
    return IterDiffMethod()
