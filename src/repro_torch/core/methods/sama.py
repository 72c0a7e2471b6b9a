"""SAMA and SAMA-NA as HypergradMethod objects (paper Sec. 3), after
``src/repro/core/methods/sama.py``. The math lives in
``repro_torch.core.sama``; the reduce contract is the paper's single-sync
schedule: hypergradient, ``v``, ``eps`` and the meta loss ride one
bucketed all-reduce, so the base nudge in ``finalize`` sees
replica-consistent values. (The microbatched ``micro_local_terms`` waits
for the port of ``scale/``.)
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import sama as sama_mod
from repro_torch.core.methods.base import (
    HypergradMethod,
    LocalTerms,
    MethodContext,
    ReduceContract,
    register_method,
)


@dataclasses.dataclass(frozen=True)
class SAMAMethod(HypergradMethod):
    """Paper Eq. 3-5. ``cfg.adapt=False`` is the SAMA-NA ablation."""

    cfg: sama_mod.SAMAConfig = sama_mod.SAMAConfig()
    name: str = "sama"

    reduce_contract = ReduceContract(terms=("hypergrad", "v", "eps", "meta_loss"), linear=True)

    def local_terms(self, spec, ctx: MethodContext) -> LocalTerms:
        meta_loss, v, v_sumsq = sama_mod.perturbation_direction(
            spec, ctx.theta, ctx.lam, ctx.meta_batch,
            base_opt=ctx.base_opt, base_opt_state=ctx.base_opt_state,
            g_base=ctx.g_base, cfg=self.cfg,
        )
        hyper, eps = sama_mod.central_difference_hypergrad(
            spec, ctx.theta, ctx.lam, ctx.last_batch, v, cfg=self.cfg, v_sumsq=v_sumsq,
        )
        return {"hypergrad": hyper, "meta_loss": meta_loss, "v": v, "eps": eps}

    def finalize(self, terms: LocalTerms, ctx: MethodContext):
        theta = sama_mod.apply_base_nudge(ctx.theta, terms["v"], terms["eps"], self.cfg)
        return terms["hypergrad"], theta

    def metrics(self, terms: LocalTerms):
        return {"eps": terms["eps"]}


@register_method("sama")
def _make_sama(cfg) -> SAMAMethod:
    return SAMAMethod(cfg=_sama_cfg(cfg, adapt=True), name="sama")


@register_method("sama_na")
def _make_sama_na(cfg) -> SAMAMethod:
    return SAMAMethod(cfg=_sama_cfg(cfg, adapt=False), name="sama_na")


def _sama_cfg(cfg, *, adapt: bool) -> sama_mod.SAMAConfig:
    if cfg is None:
        return sama_mod.SAMAConfig(adapt=adapt)
    return sama_mod.SAMAConfig(alpha=cfg.alpha, adapt=adapt, base_nudge=cfg.base_nudge,
                               adapt_clip=cfg.adapt_clip)
