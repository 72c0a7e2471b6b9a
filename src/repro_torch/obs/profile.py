"""Per-phase cost attribution of one executed step, the port's counterpart
of ``src/repro/obs/profile.py``.

The JAX package walks a compiled step's HLO and charges each instruction
to the innermost phase scope on its ``op_name``. The port runs eagerly, so
:func:`attribute` runs one call of the step under a ``TorchDispatchMode``
and charges each aten operation to the innermost open phase of
``obs.trace.phase`` (``trace.PHASE_STACK``), by the JAX rules of
``instr_flops``:

* **FLOPs**: matmul class (``mm``, ``addmm``, ``bmm``, ``baddbmm``,
  ``dot``, ``mv``, ``convolution``) = 2 x output elements x contracted
  size; a reduction = its input elements; elementwise and transcendental
  (operators tagged pointwise) = output elements; data movement = 0. The
  few fused aten operators (softmax, log-softmax, layer norm and their
  backward) are charged as the ops XLA would split them into.
* **Bytes**: each operation's tensor operands plus its results. An eager
  operation's traffic is real, where XLA counts only the boundaries of its
  fusions, so the port's bytes are larger than the JAX package's for the
  same step: a departure, not a defect. Views and allocations move nothing
  and count nothing.
* **Kernels**: a hand-written kernel is a ctypes call the mode cannot see.
  Each wrapper charges its call's analytic FLOPs and bytes
  (``kernels/work.py``) through ``kernels.dispatch.charge`` on every route
  and computes inside ``dispatch.uncounted``, where no operation counts, so
  the work of a kernel counts the same on the card, on the CPU and on
  ``meta`` tensors.
* **Collectives**: per phase, the calls and result bytes of
  ``launch.distributed.collective`` (the census's count).
* **Modules**: the file of the innermost frame under ``repro_torch/models/``
  (``attention.py``, ``common.py``, ...), for a kernel the model file that
  called it and ``kernels/<name>.py`` where no model did (the optimizers'
  adaptation products). A backward operation takes the module of the
  forward operation that made its autograd node: a ``TorchFunctionMode``
  tags each new node's ``metadata``.
* **Backward**: the autograd engine runs a CUDA backward on a thread of its
  own; the phase stack is process-global, so that thread charges the
  backward to the phase that called ``backward`` or ``autograd.grad``.
* **Memory**: on the card each phase's ``peak_live_bytes`` is
  ``torch.cuda.max_memory_allocated`` over the intervals it was the
  innermost phase (the peak is reset at each phase boundary); on the CPU and
  on ``meta`` tensors it is None (``memory_source`` says which).

Joined with measured per-phase wall times (``MetaLearner.phase_profile``'s
spans), each phase also carries ``wall_us``, ``achieved_flops_per_s`` and
``utilization`` against the H100 peak of the step's compute dtype
(``roofline.analysis.peak_flops``: the dtype of most of its matmul FLOPs).

The result is the optional ``attribution`` section of a PerfRecord
(``perf.record.validate_attribution``), in the JAX package's keys. CLI::

    PYTHONPATH=src python -m repro_torch.obs.profile --smoke-arch gemma3-1b \\
        --device cpu --out attr.json
    PYTHONPATH=src python -m repro_torch.obs.profile --validate attr.json
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import os
import sys
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import tree as tu
from repro_torch.kernels import dispatch
from repro_torch.obs import trace
from repro_torch.obs.trace import PHASES

#: phase bucket for work done outside every phase of the vocabulary
OTHER = "other"

#: default phase vocabulary: the engine phases plus serve's fused step
DEFAULT_PHASES: Tuple[str, ...] = PHASES + ("serve_step",)

_aten = torch.ops.aten

#: matmul-class operators: their FLOPs are 2 x output x contracted
_MATMUL = {_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm, _aten.dot, _aten.vdot, _aten.mv,
           _aten.addmv, _aten.convolution, _aten.convolution_backward}

#: reductions: their input elements
_REDUCE = {_aten.sum, _aten.mean, _aten.amax, _aten.amin, _aten.max, _aten.min, _aten.prod,
           _aten.any, _aten.all, _aten.argmax, _aten.argmin, _aten.logsumexp, _aten.norm,
           _aten.linalg_vector_norm, _aten.var, _aten.std, _aten.var_mean, _aten.std_mean,
           _aten.cumsum, _aten.nansum}

#: fused operators: elementwise passes and reductions over their input,
#: as XLA would split them
_FUSED = {_aten._softmax: 5, _aten._log_softmax: 5, _aten._softmax_backward_data: 4,
          _aten._log_softmax_backward_data: 4, _aten.native_layer_norm: 8,
          _aten.native_layer_norm_backward: 14}

#: operators that move no bytes: allocations and aliases
_NO_TRAFFIC = {_aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
               _aten.new_empty_strided, _aten.detach, _aten.alias, _aten.lift_fresh,
               _aten._local_scalar_dense, _aten.set_}

_MODELS = os.sep + os.path.join("repro_torch", "models") + os.sep


def _numel(x: torch.Tensor) -> int:
    return math.prod(x.shape)


def _tensors(tree) -> List[torch.Tensor]:
    out = []
    for x in tree if isinstance(tree, (list, tuple)) else (tree,):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(_tensors(x))
    return out


def op_flops(func, args, kwargs, out) -> Tuple[float, float]:
    """(FLOPs, matmul-class FLOPs) of one aten operation by the JAX
    package's ``instr_flops`` rules."""

    packet = func.overloadpacket
    outs = _tensors(out)
    out_n = sum(_numel(x) for x in outs)
    if packet in _MATMUL:
        if packet is _aten.convolution:  # (input, weight, ...)
            w = args[1]
            mm = 2.0 * _numel(outs[0]) * _numel(w) / max(w.shape[0], 1)
            return mm, mm
        if packet is _aten.convolution_backward:  # (grad_out, input, weight, ...)
            w = args[2]
            mm = 2.0 * 2.0 * _numel(args[0]) * _numel(w) / max(w.shape[0], 1)
            return mm, mm
        lhs = args[1] if packet in (_aten.addmm, _aten.baddbmm, _aten.addmv) else args[0]
        k = lhs.shape[-1] if lhs.dim() else 1
        mm = 2.0 * _numel(outs[0]) * k
        extra = float(_numel(outs[0])) if packet in (_aten.addmm, _aten.baddbmm, _aten.addmv) \
            else 0.0
        return mm + extra, mm
    if packet in _REDUCE:
        ins = _tensors(args[:1])
        return float(_numel(ins[0])) if ins else 0.0, 0.0
    if packet in _FUSED:
        ins = _tensors(args[:1])
        return float(_FUSED[packet] * (_numel(ins[0]) if ins else out_n)), 0.0
    if torch.Tag.pointwise in func.tags:
        return float(out_n), 0.0
    return 0.0, 0.0


def op_bytes(func, args, kwargs, out) -> float:
    """Operand plus result bytes of one aten operation; 0 for views and
    allocations."""
    if func.is_view or func.overloadpacket in _NO_TRAFFIC:
        return 0.0
    total = 0
    for x in _tensors(list(args) + list(kwargs.values())) + _tensors(out):
        total += _numel(x) * x.element_size()
    return float(total)


def _frame_module() -> Optional[str]:
    """Basename of the innermost frame's file under ``repro_torch/models/``."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if _MODELS in fn:
            return os.path.basename(fn)
        f = f.f_back
    return None


def _node_meta() -> Optional[dict]:
    node = torch._C._current_autograd_node()
    return None if node is None else node.metadata


class _Counts:
    """The running totals of one attribution."""

    def __init__(self, phases: Sequence[str]):
        self.phases = tuple(phases)
        zero = lambda: {"flops": 0.0, "bytes": 0.0, "collective_bytes": 0.0,
                        "collective_count": 0.0, "matmul_flops": 0.0}
        self.per_phase: Dict[str, Dict[str, float]] = collections.defaultdict(zero)
        self.per_module: Dict[str, float] = collections.defaultdict(float)
        self.kernels: Dict[str, Dict[str, Any]] = collections.defaultdict(
            lambda: {"calls": 0, "flops": 0.0, "bytes": 0.0,
                     "phases": collections.defaultdict(float)})
        self.dtype_flops: Dict[str, float] = collections.defaultdict(float)
        self.peaks: Dict[str, int] = {}

    def phase(self) -> str:
        for name in reversed(trace.PHASE_STACK):
            if name in self.phases:
                return name
        return OTHER

    def add(self, flops, nbytes, mm, module):
        b = self.per_phase[self.phase()]
        b["flops"] += flops
        b["bytes"] += nbytes
        b["matmul_flops"] += mm
        if flops and module:
            self.per_module[module] += flops

    def boundary(self):
        """At a phase boundary: the peak since the last one, charged to the
        phase that was innermost, then reset."""
        ph = self.phase()
        self.peaks[ph] = max(self.peaks.get(ph, 0), torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()


class _CountingMode(TorchDispatchMode):
    """Charges each aten operation outside ``dispatch.uncounted`` and off
    the nodes a plain kernel version built."""

    def __init__(self, counts: _Counts):
        super().__init__()
        self.counts = counts

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if dispatch.uncounted_depth():
            return out
        meta = _node_meta()
        if meta is not None and meta.get("repro_uncounted"):
            return out
        module = _frame_module() or (meta.get("repro_module") if meta is not None else None)
        flops, mm = op_flops(func, args, kwargs, out)
        if mm:
            self.counts.dtype_flops[str(_tensors(args[:2])[-1].dtype)] += mm
        self.counts.add(flops, op_bytes(func, args, kwargs, out), mm, module)
        return out


class _TaggingMode(TorchFunctionMode):
    """Tags each autograd node made in the forward with the module of the
    code that made it (``metadata["repro_module"]``), so the backward's
    operations can be charged to it."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        todo = [x.grad_fn for x in _tensors(out) if x.grad_fn is not None]
        if todo:
            module = _frame_module()
            while todo:
                node = todo.pop()
                if node is None:
                    continue
                meta = node.metadata
                if "repro_module" in meta:
                    continue
                meta["repro_module"] = module
                todo.extend(nxt for nxt, _ in node.next_functions)
        return out


def _kernel_sink(counts: _Counts):
    def sink(name: str, w) -> None:
        meta = _node_meta()
        module = (_frame_module() or (meta.get("repro_module") if meta is not None else None)
                  or "kernels/" + _kernel_file(name))
        counts.add(w.flops, w.bytes, w.matmul_flops, module)
        k = counts.kernels[name]
        k["calls"] += 1
        k["flops"] += w.flops
        k["bytes"] += w.bytes
        k["phases"][counts.phase()] += w.flops
    return sink


def _kernel_file(name: str) -> str:
    for prefix, fname in (("flash_", "flash_attn.py"), ("weighted_ce", "weighted_ce.py")):
        if name.startswith(prefix):
            return fname
    return f"{name}.py"


def _phase_collectives(counts: _Counts):
    """A ``CollectiveCounter`` that also charges each collective's calls and
    bytes to the open phase, entered for the attributed call."""
    from repro_torch.launch import distributed

    class Counter(distributed.CollectiveCounter):
        def add(self, kind, nbytes, over="data"):
            super().add(kind, nbytes, over)
            if kind != "barrier":
                b = counts.per_phase[counts.phase()]
                b["collective_bytes"] += nbytes
                b["collective_count"] += 1

    return Counter()


def _wall_by_phase(spans) -> Dict[str, float]:
    out: Dict[str, float] = collections.defaultdict(float)
    for s in spans:
        if getattr(s, "traced", False) or (isinstance(s, dict) and s.get("traced")):
            continue
        dur = s.dur_us if hasattr(s, "dur_us") else float(s.get("dur_us", 0.0))
        name = s.name if hasattr(s, "name") else s.get("name")
        out[name] += dur
    return dict(out)


def _device_type(tree) -> str:
    """"cuda" if a tensor of ``tree`` lies on the card, else "meta" if one
    lies on meta, else "cpu"."""
    kinds = {x.device.type for x in tu.flatten_with_keys(tree)[1] if isinstance(x, torch.Tensor)}
    return "cuda" if "cuda" in kinds else "meta" if "meta" in kinds else "cpu"


def attribute(fn: Callable, *args, phases: Optional[Sequence[str]] = None,
              spans: Optional[Sequence[Any]] = None, peak_flops: Optional[float] = None,
              n_devices: int = 1, device=None, **kwargs) -> Dict[str, Any]:
    """Run ``fn(*args, **kwargs)`` once and partition its work by engine
    phase: the ``attribution`` section. ``spans`` (measured spans, from
    ``MetaLearner.phase_profile``) add ``wall_us``,
    ``achieved_flops_per_s`` and ``utilization`` per phase against
    ``peak_flops`` x ``n_devices`` (default: the H100 peak of the step's
    compute dtype). ``device`` says where ``fn`` runs when no argument
    holds a tensor (default: the arguments' device)."""
    from repro_torch.roofline import analysis

    phases = tuple(phases) if phases is not None else DEFAULT_PHASES
    kind = torch.device(device).type if device is not None else _device_type((args, kwargs))
    on_card = kind == "cuda"
    counts = _Counts(phases)
    collectives = _phase_collectives(counts)
    prev_sink = dispatch.set_work_sink(_kernel_sink(counts))
    prev_boundary = trace.set_boundary(counts.boundary if on_card else None)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    try:
        with collectives, _TaggingMode(), _CountingMode(counts):
            fn(*args, **kwargs)
        if on_card:
            torch.cuda.synchronize()
            counts.boundary()
    finally:
        dispatch.set_work_sink(prev_sink)
        trace.set_boundary(prev_boundary)

    per_phase = counts.per_phase
    keys = ("flops", "bytes", "collective_bytes", "collective_count", "matmul_flops")
    total = {k: sum(b[k] for b in per_phase.values()) for k in keys}
    total_flops = total["flops"]
    for b in per_phase.values():
        b["flop_frac"] = b["flops"] / total_flops if total_flops else 0.0
    coverage = (1.0 - per_phase[OTHER]["flops"] / total_flops
                if total_flops and OTHER in per_phase else (1.0 if total_flops else 0.0))
    for ph, b in per_phase.items():
        b["peak_live_bytes"] = counts.peaks.get(ph) if on_card else None

    compute_dtype = (max(counts.dtype_flops, key=counts.dtype_flops.get)
                     if counts.dtype_flops else "torch.bfloat16")
    if peak_flops is None:
        peak_flops = analysis.peak_flops(compute_dtype)
    wall_source = None
    if spans is not None:
        wall = _wall_by_phase(spans)
        wall_source = "tracer_runtime_spans"
        device_peak = peak_flops * max(1, n_devices)
        for ph, b in per_phase.items():
            us = wall.get(ph)
            if us is None or us <= 0:
                continue
            b["wall_us"] = us
            b["achieved_flops_per_s"] = b["flops"] / (us * 1e-6)
            b["utilization"] = b["achieved_flops_per_s"] / device_peak

    modules = {}
    for mod, fl in sorted(counts.per_module.items(), key=lambda kv: -kv[1]):
        modules[mod] = {"flops": fl, "flop_frac": fl / total_flops if total_flops else 0.0}
    return {
        "phases": {ph: dict(b) for ph, b in sorted(per_phase.items(),
                                                    key=lambda kv: -kv[1]["flops"])},
        "total": total,
        "coverage": coverage,
        "modules": modules,
        "top_module": next(iter(modules), None),
        "kernels": {k: dict(v, phases=dict(v["phases"]))
                    for k, v in sorted(counts.kernels.items())},
        "wall_source": wall_source,
        "memory_source": "cuda_max_allocated" if on_card else f"none: {kind}",
        "peak_flops": peak_flops,
        "compute_dtype": compute_dtype,
        "n_devices": int(n_devices),
    }


def to_meta(tree):
    """``tree`` with every tensor replaced by an empty one on ``meta`` of
    its shape and dtype (the dry run of a step built on the card)."""
    return tu.tree_map(lambda x: x.to("meta") if isinstance(x, torch.Tensor) else x, tree)


def render(attr: Dict[str, Any]) -> str:
    """Human-readable attribution table."""

    lines: List[str] = []
    add = lines.append
    add("== cost attribution ==")
    add(f"coverage: {attr['coverage']:.1%} of "
        f"{attr['total']['flops']:.3e} FLOPs attributed to a phase")
    add(f"{'phase':<16} {'flops':>12} {'frac':>7} {'bytes':>12} "
        f"{'coll':>5} {'peak_live':>12} {'wall':>10} {'util':>8}")
    for ph, b in attr["phases"].items():
        wall = f"{b['wall_us'] / 1e3:.1f}ms" if b.get("wall_us") else "-"
        util = f"{b['utilization']:.2e}" if b.get("utilization") else "-"
        peak = (f"{b['peak_live_bytes'] / 2**20:.1f}MB"
                if b.get("peak_live_bytes") else "-")
        add(f"{ph:<16} {b['flops']:>12.3e} {b['flop_frac']:>7.3f} "
            f"{b['bytes']:>12.3e} {b['collective_count']:>5.0f} "
            f"{peak:>12} {wall:>10} {util:>8}")
    if attr.get("modules"):
        add("")
        add(f"{'module':<28} {'flops':>12} {'frac':>7}")
        for mod, b in list(attr["modules"].items())[:10]:
            add(f"{mod:<28} {b['flops']:>12.3e} {b['flop_frac']:>7.3f}")
        add(f"top FLOP sink: {attr['top_module']}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# CLI: attribute one smoke step / validate attribution sections in a JSON
# ---------------------------------------------------------------------------


def _smoke_attribution(arch: str, *, unroll: int = 2, batch: int = 4, seq: int = 32,
                       device="cuda") -> Dict[str, Any]:
    """One smoke-config SAMA step of ``arch`` on ``device``, attributed."""

    import numpy as np

    from repro_torch import configs, data, optim
    from repro_torch.core import EngineConfig, init_state, make_meta_step, problems
    from repro_torch.device import resolve_device
    from repro_torch.models import Model

    dev = resolve_device(device)
    cfg = configs.get_smoke_config(arch)
    model = Model(cfg, device=dev)
    spec = problems.make_data_optimization_spec(
        model.classifier_per_example if cfg.family == "encoder" else model.per_example,
        reweight=True)
    theta = model.init(0)
    lam = problems.init_data_optimization_lam(1, reweight=True, device=dev)
    base_opt, meta_opt = optim.adam(1e-3), optim.adam(1e-3)
    ecfg = EngineConfig(method="sama", unroll_steps=unroll)
    state = init_state(theta, lam, base_opt, meta_opt, scale=ecfg.scale)
    step = make_meta_step(spec, base_opt, meta_opt, ecfg)

    lm = data.LMStreamConfig(vocab_size=cfg.vocab_size, seq_len=seq)
    rng = np.random.default_rng(0)

    def batch_of(b, k=None):
        lead = (k, b) if k else (b,)
        toks = data.lm_batch(lm, rng, b * (k or 1))["tokens"].reshape(lead + (seq,))
        out = {"tokens": torch.as_tensor(toks, device=dev)}
        if cfg.family == "vlm":
            out["patches"] = torch.zeros(lead + (cfg.vision_tokens, cfg.vision_dim), device=dev)
        if cfg.family == "audio":
            out["frames"] = torch.zeros(lead + (cfg.encoder_seq, cfg.d_model), device=dev)
        if cfg.family == "encoder":
            out["y"] = torch.as_tensor(rng.integers(0, cfg.num_labels, size=lead), device=dev)
        return out

    attr = attribute(step, state, batch_of(batch, unroll), batch_of(max(batch // 2, 1)))
    return {"attribution": attr,
            "extra": {"arch": cfg.name, "unroll": unroll, "batch": batch, "seq": seq,
                      "device": str(dev)}}


def _validate_file(path: str) -> List[str]:
    """Validate every attribution section in ``path`` (a BENCH payload, a
    PerfRecord dict or a bare attribution dict)."""

    from repro_torch.perf.record import validate_attribution

    with open(path) as f:
        payload = json.load(f)
    found = []
    if "records" in payload:
        found = [(r.get("name", "?"), r["attribution"])
                 for r in payload["records"] if r.get("attribution")]
    elif "attribution" in payload:
        found = [(payload.get("name", "record"), payload["attribution"])]
    elif "phases" in payload:
        found = [("attribution", payload)]
    if not found:
        return [f"{path}: no attribution section found"]
    errors: List[str] = []
    for name, attr in found:
        errors.extend(f"{path}:{name}: {e}" for e in validate_attribution(attr))
    return errors


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs.profile",
                                 description="Attribute one step's cost to engine phases.")
    ap.add_argument("--smoke-arch", default=None, metavar="ARCH",
                    help="run one smoke SAMA step for ARCH and print its attribution table")
    ap.add_argument("--unroll", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default="cuda", help="cuda (default), cpu or meta")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="also write the attribution (under an 'attribution' key) as JSON")
    ap.add_argument("--validate", default=None, metavar="PATH",
                    help="validate attribution sections in a record/BENCH JSON and exit")
    args = ap.parse_args(argv)

    if args.validate:
        errors = _validate_file(args.validate)
        for e in errors:
            print(e, file=sys.stderr)
        print(f"{args.validate}: attribution " + ("INVALID" if errors else "valid"))
        return 1 if errors else 0

    if not args.smoke_arch:
        ap.error("one of --smoke-arch or --validate is required")
    probe = _smoke_attribution(args.smoke_arch, unroll=args.unroll, batch=args.batch,
                               device=args.device)
    print(render(probe["attribution"]))
    if args.out:
        from repro_torch.perf.record import validate_attribution

        errors = validate_attribution(probe["attribution"])
        if errors:
            for e in errors:
                print(e, file=sys.stderr)
            return 1
        with open(args.out, "w") as f:
            json.dump(probe, f, indent=1)
        print(f"# wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
