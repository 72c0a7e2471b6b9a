"""SAMA and SAMA-NA as HypergradMethod objects (paper Sec. 3), after
``src/repro/core/methods/sama.py``. The math lives in
``repro_torch.core.sama``; the reduce contract is the paper's single-sync
schedule: hypergradient, ``v``, ``eps`` and the meta loss ride one
bucketed all-reduce, so the base nudge in ``finalize`` sees
replica-consistent values. ``micro_local_terms`` is SAMA's staged stage 1
under microbatch accumulation (``repro_torch.scale.accum``).
"""

from __future__ import annotations

import dataclasses

from torch.profiler import record_function

from repro_torch import tree as tu
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
            g_base=ctx.g_base, cfg=self.cfg, loss_scale=ctx.loss_scale,
        )
        hyper, eps = sama_mod.central_difference_hypergrad(
            spec, ctx.theta, ctx.lam, ctx.last_batch, v, cfg=self.cfg, v_sumsq=v_sumsq,
            loss_scale=ctx.loss_scale,
        )
        return {"hypergrad": hyper, "meta_loss": meta_loss, "v": v, "eps": eps}

    def finalize(self, terms: LocalTerms, ctx: MethodContext):
        theta = sama_mod.apply_base_nudge(ctx.theta, terms["v"], terms["eps"], self.cfg)
        return terms["hypergrad"], theta

    def metrics(self, terms: LocalTerms):
        return {"eps": terms["eps"]}

    def micro_local_terms(self, spec, ctx: MethodContext, m: int, accum_dtype) -> LocalTerms:
        """SAMA's stage 1 over M microbatches, staged around its one
        nonlinearity (``src/repro/core/methods/sama.py``):

        A (linear): accumulate ``(meta_loss, g_meta)`` over M meta
          microbatches: the mean of equal-slice gradients is the
          full-batch gradient;
        B: ``v = du/dg .* g_meta`` and ``eps = alpha / ||v||`` once, from
          the accumulated g_meta (where a virtual-shard mean would differ:
          it takes an eps per microbatch);
        C (linear): accumulate the central-difference delta over M
          last-batch microbatches at the one (theta+, theta-) pair of B.

        Every model-sized backward pass (the meta pass and both CD passes)
        sees a batch / M slice."""

        from repro_torch.scale import accum  # scale sits above core

        with record_function("meta_pass"):
            meta_loss, g_meta = accum.accumulated_value_and_grad(
                spec.meta_scalar, ctx.theta, ctx.lam, ctx.meta_batch, m, accum_dtype,
                ctx.loss_scale)
            # the adaptation kernels take g_meta in the parameters' dtype
            g_meta = tu.tree_map(lambda g, t: g.to(t.dtype), g_meta, ctx.theta)
            v, v_sumsq = sama_mod.adaptation_product(
                ctx.base_opt, ctx.base_opt_state, ctx.theta, ctx.g_base, g_meta, self.cfg)
            del g_meta

        with record_function("cd_passes"):
            eps = sama_mod.step_size(v, v_sumsq, self.cfg)
            theta_p, theta_m = sama_mod.perturbed_params(ctx.theta, v, eps)

            def cd_term(mb):
                return sama_mod.central_difference_delta(spec, theta_p, theta_m, ctx.lam, mb,
                                                         loss_scale=ctx.loss_scale)

            delta = accum.accumulate_mean(cd_term, accum.split_batch(ctx.last_batch, m), m,
                                          accum_dtype)
            hyper = tu.tree_map(lambda d: -d / (2.0 * eps), delta)
        return {"hypergrad": hyper, "meta_loss": meta_loss, "v": v, "eps": eps}


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
