"""The "model" mesh axis as FSDP (ZeRO-3) over the model process group.

The reference partitions each parameter by the rules of
``launch/sharding.py`` and lets GSPMD place the compute; whatever it
chooses, the step computes the same function. The port stores each leaf
whose rule names "model" on a dim as this rank's contiguous block along
that dim (``sharding.shard``: the block a ``NamedSharding`` with the same
spec places) and gathers it whole where a loss reads it. Every f32
parameter-sized tree of the step (theta, the base optimizer's moments, the
base gradient, SAMA's ``v`` and the perturbed copies) then lives in blocks,
which is what sets the memory per rank. The rules replicate the norms,
biases, scalars and routers, and the meta-learner's parameters stay whole.

A model group shares one estimate of its data shard: the data shard's
rows are split evenly over the group (``Mesh.local``), and the loss a
model rank differentiates is the group's, made at one place, the entry of
the spec's losses (:meth:`FSDP.apply_to_spec`, the shape of the precision
policy's single cast boundary, ``scale.policy.apply_to_spec``, inside
which it sits so that a gather moves the policy's bf16):

* a sharded leaf enters the loss through :class:`_AllGather` (forward: an
  all-gather of the blocks; backward: a reduce-scatter, which sums the
  ranks' gradients of the whole leaf and leaves each its block);
* the replicated leaves, and lam, through :class:`_Replicate` (forward:
  the identity; backward: the sum over the group, one bucket);
* the loss is the group's: :class:`_GroupSum` of each rank's loss over
  the model extent (forward: the sum over the group; backward: the
  identity), so that every rank reads the data shard's mean loss.

Each function's backward is the next one's forward, so second derivatives
pass (the Hessian-vector baselines): the reduce-scatter's backward is the
all-gather, the group sum's is the identity, as
``torch.distributed.nn.functional``'s collectives pair them. Every
gradient that leaves a loss is then the model group's; the plain values
taken over a tree of blocks (norms, CG's dot products, finiteness gates)
go through :meth:`FSDP.leaf_sum` and :meth:`FSDP.all_true`
(``core.sync``).

Two things of a loss are not row means, and the loss's entry marks its
rows as split over the group (``models.moe.rows_split``) for them: a MoE
layer routes the data shard's tokens in dispatch groups and takes its
load-balance loss over all of them. Where this rank's rows hold whole
dispatch groups it routes them itself and sums the load-balance
statistics over the group (:meth:`FSDP.group_sum`: forward and backward
an all-reduce); otherwise it gathers the layer's tokens over the group
(:meth:`FSDP.gather_rows`) and keeps its rows of the output. Either way
the layer computes JAX's function of the whole data shard.

Adafactor's factored second moment averages a 2-D leaf's squared
gradient over each of its dims; over a sharded dim the block's sum goes
through :meth:`FSDP.group_sum` (``optim.optimizers``), and the statistic
indexed by the sharded dim is stored as a block of its own (the layout of
``.base_opt_state.nu``'s ``r``, ``c`` and ``v`` leaves). Gathering per
layer, with prefetch, is later work: here a loss gathers every leaf at
its entry.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch import tree as tu
from repro_torch.core.bilevel import BilevelSpec
from repro_torch.launch.distributed import collective
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.sharding import Spec, model_dim, param_specs, shard, unshard
from repro_torch.models import moe

Tree = Any

#: the name prefixes of a state's leaves that are theta-like trees (the
#: bare theta, an EngineState's theta and its base optimizer's moments)
_THETA_LIKE = ("", ".theta", ".base_opt_state.mu", ".base_opt_state.nu")


def _promoted(x: torch.Tensor) -> torch.Tensor:
    return x.float() if x.is_floating_point() and x.element_size() < 4 else x


class _AllGather(torch.autograd.Function):
    """Blocks -> the whole leaf (all-gather over the model group along
    ``dim``); backward: :class:`_ReduceScatter`."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return collective("all-gather", x, mesh, over="model", dim=dim)

    @staticmethod
    def backward(ctx, g):
        return _ReduceScatter.apply(g, ctx.mesh, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    """The sum over the model group, this rank's block along ``dim`` (in
    f32 for a narrower float, cast back); backward: :class:`_AllGather`."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        out = collective("reduce-scatter", _promoted(x), mesh, over="model", dim=dim)
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return _AllGather.apply(g, ctx.mesh, ctx.dim), None, None


def _group_sum(mesh: Mesh, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """The sum over the model group of each tensor, in one f32 bucket."""
    flat = torch.cat([_promoted(x).reshape(-1) for x in xs])
    collective("all-reduce", flat, mesh, over="model")
    out, off = [], 0
    for x in xs:
        out.append(flat[off:off + x.numel()].view(x.shape).to(x.dtype))
        off += x.numel()
    return out


class _GroupSum(torch.autograd.Function):
    """Each rank's values -> their sum over the model group, on every rank
    (one bucket); backward: the identity."""

    @staticmethod
    def forward(ctx, mesh, *xs):
        return tuple(_group_sum(mesh, [x.detach() for x in xs]))

    @staticmethod
    def backward(ctx, *gs):
        return (None, *gs)


class _AllReduce(torch.autograd.Function):
    """A rank's partial -> the sum over the model group, on every rank (in
    f32 for a narrower float, cast back); backward: the same sum of the
    ranks' cotangents."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _group_sum(mesh, [x.detach()])[0]

    @staticmethod
    def backward(ctx, g):
        return _AllReduce.apply(g, ctx.mesh), None


class _Replicate(torch.autograd.Function):
    """Replicated values as each rank's loss reads them: the identity;
    backward: :class:`_GroupSum` of the ranks' cotangents."""

    @staticmethod
    def forward(ctx, mesh, *xs):
        ctx.mesh = mesh
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        return (None, *_GroupSum.apply(ctx.mesh, *gs))


class _Leaf(NamedTuple):
    spec: Spec
    dim: int
    full: Tuple[int, ...]
    block: Tuple[int, ...]


class FSDP:
    """theta's layout over ``mesh``'s model group: each leaf's spec by the
    partition rules (``sharding.param_specs(theta, mesh, cfg)``; ``cfg``,
    the model's config, enables head alignment), the dim it is sharded
    on and its whole and block shapes. ``theta`` holds the whole leaves
    (tensors, or anything with a ``shape``). Every method that
    communicates runs over the model group, whose every rank must call it
    in the same order."""

    def __init__(self, theta: Tree, mesh: Mesh, cfg=None):
        if mesh.model_size == 1:
            raise ValueError("FSDP needs a mesh with a model extent above 1")
        self.mesh, self.cfg = mesh, cfg
        names, specs = param_specs(theta, mesh, cfg)
        leaves = tu.flatten_with_keys(theta)[1]
        self.names = names
        self.specs = specs
        self._leaves: Dict[str, _Leaf] = {}
        #: Adafactor's statistics of a sharded leaf, by the leaf's name and
        #: the key under it: the full moment "v" as the leaf; of a 2-D leaf
        #: the row means "r" (indexed by dim 0) or the column means "c"
        #: (dim 1), whichever the sharded dim indexes, as a 1-D block
        self._stats: Dict[str, _Leaf] = {}
        m = mesh.model_size
        for name, spec, x in zip(names, specs, leaves):
            dim = model_dim(spec)
            if dim is None:
                continue
            full = tuple(x.shape)
            block = full[:dim] + (full[dim] // m,) + full[dim + 1:]
            self._leaves[name] = leaf = _Leaf(spec, dim, full, block)
            if len(full) == 2:
                key = "rc"[dim]
                self._stats[f"{name}['{key}']"] = _Leaf(("model",), 0, (full[dim],),
                                                        (block[dim],))
            else:
                self._stats[name + "['v']"] = leaf

    @property
    def sharded(self) -> Dict[str, Tuple[int, Tuple[int, ...]]]:
        """Each sharded leaf's name -> (dim, block shape)."""
        return {n: (leaf.dim, leaf.block) for n, leaf in self._leaves.items()}

    def _leaf(self, name: str, shape, whole: bool) -> Optional[_Leaf]:
        """The layout of a state leaf named ``name`` (a theta-like tree's
        leaf: the bare theta, ``.theta``, ``.base_opt_state.mu`` or
        ``.nu``, or one of Adafactor's statistics under ``.nu``) if it is
        sharded and has the whole shape (``whole``) or the block shape."""
        i = name.find("[")
        if i < 0 or name[:i] not in _THETA_LIKE:
            return None
        leaf = self._leaves.get(name[i:])
        if leaf is None and name[:i] == ".base_opt_state.nu":
            leaf = self._stats.get(name[i:])
        if leaf is None or tuple(shape) != (leaf.full if whole else leaf.block):
            return None
        return leaf

    def sharded_dims(self, tree: Tree) -> List[Optional[int]]:
        """Per leaf of a theta-like tree of blocks: its sharded dim, or None."""
        names, leaves = tu.flatten_with_keys(tree)
        out = []
        for name, x in zip(names, leaves):
            leaf = self._leaf(name, x.shape, whole=False)
            out.append(None if leaf is None else leaf.dim)
        return out

    def group_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of each rank's ``x`` over the model group, on every rank
        (:class:`_AllReduce`, differentiable twice)."""
        return _AllReduce.apply(x, self.mesh)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The data shard's rows of ``x`` (dim 0 this rank's rows, as
        ``Mesh.local`` splits them): an all-gather over the model group in
        model-rank order; backward: the reduce-scatter (:class:`_AllGather`)."""
        return _AllGather.apply(x, self.mesh, 0)

    # -- placing and gathering ------------------------------------------------

    def shard(self, tree: Tree) -> Tree:
        """This rank's blocks of a tree of whole leaves: theta, or a state
        whose theta-like trees (``.theta``, the base optimizer's moments)
        hold whole leaves. No collective."""

        names, leaves = tu.flatten_with_keys(tree)
        out = []
        for name, x in zip(names, leaves):
            leaf = self._leaf(name, x.shape, whole=True)
            out.append(x if leaf is None else shard(x, leaf.spec, self.mesh))
        return tu.unflatten_like(tree, out)

    def block_of(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole leaf ``x`` named ``name`` (a
        checkpoint's leaf), or ``x`` where it is not sharded."""
        leaf = self._leaf(name, x.shape, whole=True)
        return x if leaf is None else shard(x, leaf.spec, self.mesh)

    def unshard(self, tree: Tree) -> Tree:
        """The whole leaves of a tree of blocks (theta or a state): one
        all-gather over the model group per sharded leaf, no autograd."""

        names, leaves = tu.flatten_with_keys(tree)
        out = []
        for name, x in zip(names, leaves):
            leaf = self._leaf(name, x.shape, whole=False)
            out.append(x if leaf is None else unshard(x.detach(), leaf.spec, self.mesh))
        return tu.unflatten_like(tree, out)

    def gather(self, theta: Tree) -> Tree:
        """The whole parameters as a rank's loss reads them: each sharded
        leaf through :class:`_AllGather`, the replicated ones through one
        :class:`_Replicate`. Differentiable, twice."""

        names, leaves = tu.flatten_with_keys(theta)
        if names != self.names:
            raise ValueError(f"theta's leaves {names} are not the layout's {self.names}")
        out: List[Optional[torch.Tensor]] = [None] * len(leaves)
        rep = []
        for i, (name, x) in enumerate(zip(names, leaves)):
            leaf = self._leaf(name, x.shape, whole=False)
            if leaf is None:
                if name in self._leaves:
                    raise ValueError(f"{name}: shape {tuple(x.shape)} is not this rank's "
                                     f"block {self._leaves[name].block}")
                rep.append(i)
            else:
                out[i] = _AllGather.apply(x, self.mesh, leaf.dim)
        if rep:
            for i, y in zip(rep, _Replicate.apply(self.mesh, *[leaves[i] for i in rep])):
                out[i] = y
        return tu.unflatten_like(theta, out)

    def _replicate(self, tree: Tree) -> Tree:
        """A replicated tree (lam) as a rank's loss reads it
        (:class:`_Replicate`)."""
        leaves = tu.flatten_with_keys(tree)[1]
        if not leaves:
            return tree
        return tu.unflatten_like(tree, list(_Replicate.apply(self.mesh, *leaves)))

    def _group_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The model group's mean of its ranks' losses, on every rank
        (:class:`_GroupSum` of each over the model extent)."""
        return _GroupSum.apply(self.mesh, loss / self.mesh.model_size)[0]

    def apply_to_spec(self, spec: BilevelSpec) -> BilevelSpec:
        """The spec whose losses take theta's blocks: each loss gathers
        theta (:meth:`gather`), reads lam through :meth:`_replicate` and
        returns the group's loss (:meth:`_group_loss`); an aux passes
        through as the rank's own."""

        def wrap(loss_fn):
            def wrapped(theta, lam, batch):
                with moe.rows_split(self):
                    out = loss_fn(self.gather(theta), self._replicate(lam), batch)
                if spec.has_aux:
                    return self._group_loss(out[0]), out[1]
                return self._group_loss(out)

            return wrapped

        return BilevelSpec(base_loss=wrap(spec.base_loss), meta_loss=wrap(spec.meta_loss),
                           has_aux=spec.has_aux)

    # -- plain values over a tree of blocks (core.sync) -----------------------

    def leaf_sum(self, tree: Tree, partials: List[torch.Tensor]) -> torch.Tensor:
        """Per-leaf partials (``tree``'s leaves in order) summed over the
        whole parameters: the sharded leaves' (this rank's blocks) over
        the model group, in one all-reduce; the replicated ones once. A
        tree with no sharded leaf (lam, the hypergradient) makes no
        collective."""

        names, leaves = tu.flatten_with_keys(tree)
        sh = rep = None
        for name, x, p in zip(names, leaves, partials):
            if self._leaf(name, x.shape, whole=False) is not None:
                sh = p if sh is None else sh + p
            else:
                rep = p if rep is None else rep + p
        if sh is not None:
            buf = sh.detach().to(torch.float32).reshape(1).clone()
            collective("all-reduce", buf, self.mesh, over="model")
            sh = buf[0].to(sh.dtype)
            return sh if rep is None else sh + rep
        return rep

    def all_true(self, flag: torch.Tensor) -> torch.Tensor:
        """A 0-d bool gate, true on every rank only where it is on each."""
        bad = torch.logical_not(flag).to(torch.float32).reshape(1)
        collective("all-reduce", bad, self.mesh, over="model")
        return bad[0] == 0
