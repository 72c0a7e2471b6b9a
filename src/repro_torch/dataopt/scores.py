"""Score providers: one number per training example, after
``src/repro/dataopt/scores.py``.

The contract every provider keeps:

    scorer(ctx: ScoreContext) -> np.ndarray of shape (N,), float32,
    where a higher score is a higher keep-priority.

Providers register under a name (``register_scorer``, as
``core.methods`` registers estimators), so ``scorer="meta"`` and
``"el2n"`` differ by one argument everywhere. Scorers whose raw quantity
measures hardness (el2n, grand, loss) default to keeping the easy
examples (score = -hardness) and take ``keep_hard=True`` for the other
direction.

Built-ins:

* ``meta``: the paper's Sec. 4.3 scorer, MetaWeightNet importance learned
  by bilevel meta-training through any registered hypergradient method
  (``method="sama"`` by default), with optional EMA score tracking;
* ``el2n``: ||softmax(logits) - onehot||_2 from an early-trained model;
* ``grand``: the exact per-example gradient norm from an early-trained
  model. The JAX package takes it with a ``jax.vmap`` over singleton
  batches; the port's CUDA kernels sit behind ``torch.autograd.Function``s
  that launch through ``ctypes``, which ``torch.func.vmap`` cannot batch,
  so the port loops over the rows, one backward pass each, through the
  kernels;
* ``margin``: p_y - max_{c != y} p_c;
* ``loss``: the negative per-example cross-entropy;
* ``random``: seeded uniform scores (the control arm).

Random draws: the JAX package draws the fresh theta and lam from
``jax.random``; the port draws them from ``torch.Generator``s seeded the
same way (``init_fn(seed)``, ``problems.init_data_optimization_lam``), so
the two packages start from different weights for one seed. Every index
draw is numpy's and equal in both.

``ctx.obs`` (the observability pipeline) waits for ROADMAP queue 1 item
6 and must be None. ``ctx.mesh`` (``repro_torch.launch.mesh``) shards
every full-dataset pass over its data axes and is forwarded to the meta
scorer's ``MetaLearner``, whose "auto" schedule is then the single-sync
one; every rank calls the scorer and gets the same scores.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import optim
from repro_torch import tree as tu
from repro_torch.api import MetaLearner
from repro_torch.core import problems
from repro_torch.core.meta_modules import apply_weight_net, weight_features
from repro_torch.core.sama import value_and_grad
from repro_torch.data import BatchIterator
from repro_torch.dataopt.distributed import batch_sharding, map_batches, score_dataset
from repro_torch.device import resolve_device

Tree = Any

_NO_OBS = ("the observability pipeline (obs=) comes with the port of obs/ "
           "(ROADMAP queue 1 item 6); pass obs=None")


def check_no_obs(obs) -> None:
    if obs is not None:
        raise NotImplementedError(_NO_OBS)


# ---------------------------------------------------------------------------
# EMA tracking and EMA-disagreement uncertainty
# ---------------------------------------------------------------------------


class EMATracker:
    """Exponential moving average of a per-example array across meta steps.
    The first ``update`` sets the average to the observed value."""

    def __init__(self, decay: float = 0.9):
        if not 0.0 <= decay < 1.0:
            raise ValueError(f"decay must be in [0, 1), got {decay}")
        self.decay = decay
        self.value: Optional[np.ndarray] = None
        self.updates = 0

    def update(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float32)
        if self.value is None:
            self.value = x.copy()
        else:
            if self.value.shape != x.shape:
                raise ValueError(f"EMA shape changed: {self.value.shape} -> {x.shape}")
            self.value = self.decay * self.value + (1.0 - self.decay) * x
        self.updates += 1
        return self.value


def ema_disagreement(probs: np.ndarray, ema_probs: np.ndarray) -> np.ndarray:
    """The paper's uncertainty signal: 1 - <p_t, p_ema> per example; 0 where
    the predictive distribution agrees with its running average, near 1
    where predictions keep moving across meta steps."""

    probs = np.asarray(probs, np.float32)
    ema_probs = np.asarray(ema_probs, np.float32)
    return 1.0 - np.sum(probs * ema_probs, axis=-1)


def _softmax(logits: np.ndarray) -> np.ndarray:
    """Row softmax in f32 (``jax.nn.softmax``)."""

    return torch.softmax(torch.from_numpy(np.asarray(logits, np.float32)), dim=-1).numpy()


# ---------------------------------------------------------------------------
# the scoring context
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ScoreContext:
    """Everything a scorer may need. ``per_example_fn`` maps (theta, batch)
    to ``problems.PerExample``; ``init_fn(seed)`` draws fresh base
    parameters on ``device`` (``"cuda"`` unless the caller passes
    ``device="cpu"``)."""

    per_example_fn: Callable[[Tree, Any], problems.PerExample]
    init_fn: Callable[[int], Tree]
    train: Dict[str, np.ndarray]
    meta: Optional[Dict[str, np.ndarray]] = None  # meta/dev split; None = train
    fields: Tuple[str, ...] = ("tokens", "y")
    mesh: Any = None
    batch_size: int = 128
    seed: int = 0
    theta: Optional[Tree] = None  # pre-trained parameters, reused when given
    num_classes: Optional[int] = None  # needed by label correction
    obs: Any = None
    device: Any = "cuda"

    def __post_init__(self):
        batch_sharding(self.mesh)  # a non-Mesh raises
        check_no_obs(self.obs)
        self.device = self.mesh.device if self.mesh is not None else resolve_device(self.device)

    @property
    def n(self) -> int:
        return len(next(iter(self.train.values())))

    @property
    def meta_data(self) -> Dict[str, np.ndarray]:
        return self.train if self.meta is None else self.meta

    def per_example_all(self, theta) -> problems.PerExample:
        """PerExample over the full train set, numpy fields."""

        return score_dataset(self.per_example_fn, theta, self.train, fields=self.fields,
                             batch_size=self.batch_size, mesh=self.mesh, device=self.device)


class ScoreProvider:
    """Base class: set ``name``, implement ``__call__(ctx) -> (N,) scores``
    (higher = keep). Plain callables work too."""

    name: str = "abstract"

    def __call__(self, ctx: ScoreContext) -> np.ndarray:
        raise NotImplementedError

    def __repr__(self):  # pragma: no cover - debugging nicety
        return f"{type(self).__name__}(name={self.name!r})"


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

#: name -> factory(**knobs) -> scorer callable
ScorerFactory = Callable[..., Callable[[ScoreContext], np.ndarray]]

_REGISTRY: Dict[str, ScorerFactory] = {}


def register_scorer(name: str, factory: Optional[Any] = None, *, overwrite: bool = False):
    """Register a score provider under ``name``: as a decorator on a
    factory(**knobs), with a factory, or with a ScoreProvider instance
    (which then takes no knobs)."""

    def _install(f: ScorerFactory) -> ScorerFactory:
        if not overwrite and name in _REGISTRY:
            raise ValueError(f"scorer {name!r} already registered "
                             "(pass overwrite=True to replace)")
        _REGISTRY[name] = f
        return f

    if factory is None:
        return _install
    if isinstance(factory, ScoreProvider):
        instance = factory

        def _from_instance(**knobs):
            if knobs:
                raise TypeError(f"scorer {name!r} was registered as an instance "
                                f"and takes no knobs, got {sorted(knobs)}")
            return instance

        return _install(_from_instance)
    return _install(factory)


def unregister_scorer(name: str):
    """Remove a registered scorer (test hygiene)."""
    _REGISTRY.pop(name, None)


def available_scorers() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def resolve_scorer(scorer: Any, **knobs) -> Callable[[ScoreContext], np.ndarray]:
    """A scorer name, provider or callable as a scorer callable."""

    if isinstance(scorer, str):
        if scorer not in _REGISTRY:
            raise ValueError(f"unknown scorer {scorer!r}; registered: {available_scorers()}")
        return _REGISTRY[scorer](**knobs)
    if callable(scorer):
        if knobs:
            raise TypeError(f"knobs {sorted(knobs)} given with an already-built scorer")
        return scorer
    raise TypeError(f"scorer must be a name or callable, got {type(scorer).__name__}")


# ---------------------------------------------------------------------------
# plain training (the heuristic scorers and the retrain harness)
# ---------------------------------------------------------------------------


def fit_plain(per_example_fn, theta0: Tree, train: Dict[str, np.ndarray], *, steps: int,
              seed: int = 0, batch: int = 32, lr: float = 1e-3,
              fields: Tuple[str, ...] = ("tokens", "y")) -> Tree:
    """The no-meta training loop: Adam on the mean per-example loss, on
    theta0's device, with numpy's index draws (the JAX package's batches
    for the same seed)."""

    opt = optim.adam(lr)
    st = opt.init(theta0)
    rng = np.random.default_rng(seed)
    n = len(next(iter(train.values())))
    device = tu.tree_leaves(theta0)[0].device
    grad_fn = value_and_grad(lambda p, b: torch.mean(per_example_fn(p, b).loss), 0)
    theta = theta0
    for _ in range(steps):
        idx = rng.integers(0, n, batch)
        b = {k: torch.from_numpy(np.ascontiguousarray(train[k][idx])).to(device)
             for k in fields if k in train}
        _, g = grad_fn(theta, b)
        upd, st = opt.update(g, st, theta)
        theta = optim.apply_updates(theta, upd)
    return theta


def _early_theta(ctx: ScoreContext, train_steps: int, lr: float) -> Tree:
    """The early-trained model the heuristic scorers probe (``ctx.theta``
    when the caller has one)."""

    if ctx.theta is not None:
        return ctx.theta
    theta0 = ctx.init_fn(ctx.seed)
    return fit_plain(ctx.per_example_fn, theta0, ctx.train, steps=train_steps, seed=ctx.seed,
                     fields=ctx.fields)


def _oriented(hardness: np.ndarray, keep_hard: bool) -> np.ndarray:
    """A raw hardness on the keep-priority axis."""

    h = np.asarray(hardness, np.float32)
    return h if keep_hard else -h


# ---------------------------------------------------------------------------
# heuristic providers
# ---------------------------------------------------------------------------


@register_scorer("el2n")
def _make_el2n(train_steps: int = 20, keep_hard: bool = False, lr: float = 1e-3):
    def el2n(ctx: ScoreContext) -> np.ndarray:
        theta = _early_theta(ctx, train_steps, lr)
        pe = ctx.per_example_all(theta)
        p = _softmax(pe.logits)
        norm = np.linalg.norm(p - np.asarray(pe.label_onehot, np.float32), axis=-1)
        return _oriented(norm, keep_hard)

    return el2n


@register_scorer("grand")
def _make_grand(train_steps: int = 20, keep_hard: bool = False, lr: float = 1e-3,
                grad_batch: int = 16):
    def grand(ctx: ScoreContext) -> np.ndarray:
        theta = _early_theta(ctx, train_steps, lr)
        grad_fn = value_and_grad(lambda p, b: torch.sum(ctx.per_example_fn(p, b).loss), 0)

        def batch_fn(b):
            # one backward pass per row, each through the kernels
            norms = []
            for i in range(len(next(iter(b.values())))):
                _, g = grad_fn(theta, {k: v[i:i + 1] for k, v in b.items()})
                norms.append(torch.sqrt(sum(torch.sum(torch.square(x.float()))
                                            for x in tu.tree_leaves(g))))
            return torch.stack(norms)

        norm = map_batches(batch_fn, ctx.train, fields=ctx.fields, batch_size=grad_batch,
                           mesh=ctx.mesh, device=ctx.device)
        return _oriented(norm, keep_hard)

    return grand


@register_scorer("margin")
def _make_margin(train_steps: int = 20, keep_hard: bool = False, lr: float = 1e-3):
    def margin(ctx: ScoreContext) -> np.ndarray:
        theta = _early_theta(ctx, train_steps, lr)
        pe = ctx.per_example_all(theta)
        p = _softmax(pe.logits)
        onehot = np.asarray(pe.label_onehot)
        p_y = np.sum(p * onehot, axis=-1)
        p_rival = np.max(np.where(onehot > 0, -np.inf, p), axis=-1)
        m = p_y - p_rival  # positive = confidently correct (easy)
        return _oriented(m, keep_hard=not keep_hard)  # margin is an easiness axis

    return margin


@register_scorer("loss")
def _make_loss(train_steps: int = 20, keep_hard: bool = False, lr: float = 1e-3):
    def loss(ctx: ScoreContext) -> np.ndarray:
        theta = _early_theta(ctx, train_steps, lr)
        pe = ctx.per_example_all(theta)
        return _oriented(np.asarray(pe.loss), keep_hard)

    return loss


@register_scorer("random")
def _make_random(seed: Optional[int] = None):
    def random_scores(ctx: ScoreContext) -> np.ndarray:
        rng = np.random.default_rng(ctx.seed if seed is None else seed)
        return rng.random(ctx.n).astype(np.float32)

    return random_scores


# ---------------------------------------------------------------------------
# the meta-learned provider (the paper's Sec. 4.3 scorer)
# ---------------------------------------------------------------------------


def _weights(lam, pe, unc: Optional[np.ndarray], device) -> np.ndarray:
    """MetaWeightNet's weights for a PerExample's losses (and uncertainty)."""

    loss = torch.from_numpy(np.asarray(pe.loss, np.float32)).to(device)
    u = None if unc is None else torch.from_numpy(np.asarray(unc, np.float32)).to(device)
    with torch.no_grad():
        return apply_weight_net(lam["reweight"], weight_features(loss, u)).cpu().numpy()


def fit_meta(ctx: ScoreContext, *, method: Any = "sama", steps: int = 80, unroll: int = 2,
             reweight: bool = True, correct: bool = False, use_uncertainty: bool = False,
             base_lr: float = 1e-3, meta_lr: float = 1e-3, batch: int = 32,
             meta_batch: int = 32, log_every: int = 0, ema_decay: float = 0.0,
             score_every: int = 10, schedule: str = "auto", scale: Optional[Any] = None,
             learner_kwargs: Optional[Dict[str, Any]] = None,
             ) -> Tuple[MetaLearner, Optional[EMATracker], Optional[EMATracker]]:
    """Meta-train MetaWeightNet (and optionally the label corrector) on
    ``ctx.train`` against ``ctx.meta_data`` through any registered
    hypergradient method. ``scale`` (a ``repro_torch.scale.ScaleConfig``)
    applies a precision policy and microbatch accumulation to the
    meta-train. A ``ctx.mesh`` is forwarded to the MetaLearner with
    ``schedule`` (``learner_kwargs`` overrides it): every rank draws the
    same global batches and the step takes its rows.

    With ``ema_decay > 0`` the full train set is rescored every
    ``score_every`` meta steps and two EMAs advance: MetaWeightNet's
    weights and the predictive probabilities that ``ema_disagreement``
    reads. Returns ``(learner, weight_ema, prob_ema)``, the trackers None
    without EMA tracking."""

    spec = problems.make_data_optimization_spec(ctx.per_example_fn, reweight=reweight,
                                                correct=correct, use_uncertainty=use_uncertainty)
    lam = problems.init_data_optimization_lam(ctx.seed + 10, reweight=reweight, correct=correct,
                                              use_uncertainty=use_uncertainty,
                                              num_classes=ctx.num_classes, device=ctx.device)
    kwargs = {"mesh": ctx.mesh, **(learner_kwargs or {})}
    if scale is not None:
        kwargs.setdefault("scale", scale)
    learner = MetaLearner(spec, base_opt="adam", base_lr=base_lr, meta_opt="adam",
                          meta_lr=meta_lr, method=method, unroll_steps=unroll,
                          schedule=schedule, **kwargs)
    theta0 = ctx.theta if ctx.theta is not None else ctx.init_fn(ctx.seed)
    learner.init(theta0, lam)
    it = BatchIterator(ctx.train, ctx.meta_data, batch_size=batch, meta_batch_size=meta_batch,
                       unroll=unroll, seed=ctx.seed, fields=ctx.fields, device=ctx.device)

    def fit_chunk(n_steps):
        for row in learner.fit(it, n_steps, log_every=log_every):
            if ctx.mesh is None or ctx.mesh.rank == 0:
                print({k: round(v, 4) for k, v in row.items()})

    if ema_decay <= 0.0:
        fit_chunk(steps)
        return learner, None, None

    if score_every < 1:
        raise ValueError(f"score_every must be >= 1 with EMA tracking, got {score_every}")
    weight_ema, prob_ema = EMATracker(ema_decay), EMATracker(ema_decay)
    done = 0
    while done < steps:
        chunk = min(score_every, steps - done)
        fit_chunk(chunk)
        done += chunk
        pe = ctx.per_example_all(learner.state.theta)
        if reweight:
            weight_ema.update(_weights(learner.state.lam, pe,
                                       pe.uncertainty if use_uncertainty else None, ctx.device))
        if pe.logits is not None:
            prob_ema.update(_softmax(pe.logits))
    return learner, weight_ema, prob_ema


def meta_train(model, train: Dict[str, np.ndarray], meta: Optional[Dict[str, np.ndarray]] = None,
               *, seed: int = 0, mesh=None, batch_size: int = 128,
               fields: Tuple[str, ...] = ("tokens", "y"), **fit_knobs) -> MetaLearner:
    """``fit_meta`` for a ``repro_torch.models.Model`` on its device:
    returns the MetaLearner, whose ``state.theta`` is the
    reweighting-trained base model."""

    ctx = ScoreContext(per_example_fn=model.classifier_per_example, init_fn=model.init,
                       train=train, meta=meta, fields=fields, mesh=mesh, batch_size=batch_size,
                       seed=seed, num_classes=getattr(model.cfg, "num_labels", None),
                       device=model.device)
    learner, _, _ = fit_meta(ctx, **fit_knobs)
    return learner


@register_scorer("meta")
def _make_meta(uncertainty: str = "entropy", **fit_knobs):
    """``uncertainty``: the signal beside the loss in the final MetaWeightNet
    pass: "none", "entropy" (in-batch predictive entropy) or "ema" (the
    paper's EMA disagreement; turns EMA tracking on)."""

    if uncertainty not in ("none", "entropy", "ema"):
        raise ValueError(f"uncertainty must be none|entropy|ema, got {uncertainty!r}")

    def meta(ctx: ScoreContext) -> np.ndarray:
        knobs = dict(fit_knobs)
        if knobs.get("reweight") is False:
            raise ValueError("the meta scorer needs reweight=True: the MWN weight is the score")
        # MetaWeightNet's input width must match between training and the
        # final pass, so use_uncertainty follows from `uncertainty`
        want_unc = uncertainty != "none"
        if knobs.setdefault("use_uncertainty", want_unc) != want_unc:
            raise ValueError(f"use_uncertainty={knobs['use_uncertainty']} contradicts "
                             f"uncertainty={uncertainty!r}; drop the use_uncertainty knob")
        if uncertainty == "ema" and knobs.get("ema_decay", 0.0) <= 0.0:
            knobs["ema_decay"] = 0.9
        learner, weight_ema, prob_ema = fit_meta(ctx, **knobs)
        pe = ctx.per_example_all(learner.state.theta)
        if uncertainty == "ema":
            unc = ema_disagreement(_softmax(pe.logits), prob_ema.value)
        elif uncertainty == "entropy":
            unc = pe.uncertainty
        else:
            unc = None
        w = _weights(learner.state.lam, pe, unc, ctx.device)
        if weight_ema is not None:
            w = weight_ema.update(w)
        return w.astype(np.float32)

    return meta
