"""The port's per-phase attribution (``repro_torch.obs.profile``) against
the JAX package's, and on its own terms.

On the reference's mini-BERT SAMA step (the ``sama_attr`` problem of
tests/test_attribution.py: 2 layers, d_model 128, K 2, B 16, S 32, meta
batch 8) the port's matmul-class FLOPs per phase are held against the
``dot``/``convolution`` FLOPs of the same step's compiled HLO, counted by
``repro.obs.profile.parse_instructions`` and ``instr_flops``. Two things
part them, both stated:

* the port's attention backward is the kernels' recompute: dq takes three
  products and dk/dv four where autodiff of the reference's plain
  attention takes four in all, so each backward pass carries exactly one
  dq call's charge more (6 x pairs x Dh);
* XLA rewrites the weight net's products with a unit dimension into
  multiplies and reductions, which are not dots: the rest is within 1e-4
  relative.

The HLO that jax prints no longer carries operand shapes on ``dot``
lines, so each dot's operands are read from their defining instructions
before ``instr_flops`` sees them (``_dot_flops_by_phase``). Total FLOPs per
phase are printed side by side, not held: the reference's bytes and
elementwise counts stop at XLA's fusion boundaries.
"""

import collections
import dataclasses
import json
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.core import EngineConfig as JEngineConfig  # noqa: E402
from repro.core import init_state as jinit_state  # noqa: E402
from repro.core import make_meta_step as jmake_meta_step  # noqa: E402
from repro.core import problems as jproblems  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.obs import profile as jprofile  # noqa: E402
from repro.perf.record import validate_attribution as jvalidate  # noqa: E402
from repro.roofline import hlo_parse  # noqa: E402

from repro_torch import configs, optim  # noqa: E402
from repro_torch.core import EngineConfig, init_state, make_meta_step, problems  # noqa: E402
from repro_torch.kernels import adam_adapt, dispatch, flash_attn  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.obs import diff as tdiff  # noqa: E402
from repro_torch.obs import profile  # noqa: E402
from repro_torch.obs.trace import phase  # noqa: E402
from repro_torch.perf import gate  # noqa: E402
from repro_torch.perf.record import validate_attribution  # noqa: E402

K, B, S, MB = 2, 16, 32, 8
MINI = dict(d_model=128, num_layers=2, num_labels=4, num_heads=2, num_kv_heads=2, head_dim=64,
            d_ff=256, remat=False)
HELD = ("base_unroll", "meta_pass", "cd_passes")
#: the weight net's unit-dimension products, which XLA makes reductions
MATMUL_RTOL = 1e-4


def _dot_flops_by_phase(text):
    comps = hlo_parse.split_computations(text)
    mult = hlo_parse.computation_multipliers(comps, follow_calls=True)
    per = collections.defaultdict(float)
    for name, lines in comps.items():
        if name == "__entry__":
            continue
        instrs = jprofile.parse_instructions(lines)
        types = {i.name: i.type_text for i in instrs}
        for ins in instrs:
            if ins.opcode not in ("dot", "convolution"):
                continue
            if not hlo_parse._SHAPE_RE.search(ins.operand_text):
                refs = re.findall(r"%([\w.\-]+)", ins.operand_text)
                ins = dataclasses.replace(
                    ins, operand_text=", ".join(f"{types.get(r, '')} %{r}" for r in refs))
            per[jprofile.phase_of(ins.op_name, jprofile.DEFAULT_PHASES)] += (
                jprofile.instr_flops(ins) * mult.get(name, 1.0))
    return dict(per)


def _batches(cfg, k, b, s, mb, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab_size, (k, b, s)), rng.integers(0, cfg.vocab_size, (mb, s)))


def _port_step(b=B, s=S, mb=MB, device="cpu"):
    cfg = configs.get_smoke_config("bert-base").replace(**MINI)
    model = Model(cfg, device=device)
    spec = problems.make_data_optimization_spec(model.classifier_per_example, reweight=True)
    bo, mo = optim.adam(1e-3), optim.adam(1e-3)
    ecfg = EngineConfig(method="sama", unroll_steps=K)
    state = init_state(model.init(0), problems.init_data_optimization_lam(1, device=device),
                       bo, mo, scale=ecfg.scale)
    tok, mtok = _batches(cfg, K, b, s, mb)
    bb = {"tokens": torch.as_tensor(tok, dtype=torch.int32, device=device),
          "y": torch.zeros((K, b), dtype=torch.int32, device=device)}
    mbat = {"tokens": torch.as_tensor(mtok, dtype=torch.int32, device=device),
            "y": torch.zeros((mb,), dtype=torch.int32, device=device)}
    return make_meta_step(spec, bo, mo, ecfg), state, bb, mbat


@pytest.fixture(scope="module")
def pair():
    cfg = jconfigs.get_smoke_config("bert-base").replace(**MINI)
    model = JModel(cfg)
    spec = jproblems.make_data_optimization_spec(model.classifier_per_example, reweight=True)
    theta = model.init(jax.random.PRNGKey(0))
    lam = jproblems.init_data_optimization_lam(jax.random.PRNGKey(1), reweight=True)
    tok, mtok = _batches(cfg, K, B, S, MB)
    bb = {"tokens": jnp.asarray(tok, jnp.int32), "y": jnp.zeros((K, B), jnp.int32)}
    mb = {"tokens": jnp.asarray(mtok, jnp.int32), "y": jnp.zeros((MB,), jnp.int32)}
    bo, mo = joptim.adam(1e-3), joptim.adam(1e-3)
    ecfg = JEngineConfig(method="sama", unroll_steps=K)
    state = jinit_state(theta, lam, bo, mo, scale=ecfg.scale)
    compiled = jax.jit(jmake_meta_step(spec, bo, mo, ecfg)).lower(state, bb, mb).compile()
    jattr = jprofile.attribute(compiled)
    jdots = _dot_flops_by_phase(compiled.as_text())
    attr = profile.attribute(*_port_step())
    return attr, jattr, jdots


def test_matmul_flops_per_phase_match_the_jax_hlo(pair):
    attr, jattr, jdots = pair
    dq = attr["kernels"]["flash_attention_dq"]["phases"]
    for ph in HELD:
        got = attr["phases"][ph]["matmul_flops"]
        recompute = dq.get(ph, 0.0)
        print(f"{ph}: port matmul {got:.6e} (of which dq recompute {recompute:.6e}), "
              f"JAX dots {jdots[ph]:.6e}; total FLOPs port {attr['phases'][ph]['flops']:.6e}, "
              f"JAX {jattr['phases'][ph]['flops']:.6e}")
        assert jdots[ph] > 0
        assert got - recompute == pytest.approx(jdots[ph], rel=MATMUL_RTOL)
    # cd_passes take no theta backward: no recompute there
    assert dq.get("cd_passes", 0.0) == 0.0 and dq["base_unroll"] > 0


def test_coverage_in_both_packages(pair):
    attr, jattr, _ = pair
    assert attr["coverage"] >= 0.90 and jattr["coverage"] >= 0.90
    assert attr["top_module"] == "attention.py"
    assert sum(b["flop_frac"] for b in attr["phases"].values()) == pytest.approx(1.0)


def test_phase_order_matches_jax(pair):
    attr, _, jdots = pair
    mm = {ph: attr["phases"][ph]["matmul_flops"] for ph in HELD}
    assert sorted(HELD, key=lambda p: -mm[p]) == sorted(HELD, key=lambda p: -jdots[p])
    named = [p for p in attr["phases"] if p in HELD]
    assert named == sorted(HELD, key=lambda p: -jdots[p])


def test_attribution_validates_in_both_packages(pair):
    attr, _, _ = pair
    assert validate_attribution(attr) == [] == jvalidate(attr)
    assert attr["memory_source"] == "none: cpu"
    assert all(b["peak_live_bytes"] is None for b in attr["phases"].values())


def test_kernel_charge_equal_on_plain_and_meta_routes():
    step, state, bb, mb = _port_step(b=4, s=16, mb=4)
    plain = profile.attribute(step, state, bb, mb)
    meta = profile.attribute(step, profile.to_meta(state), profile.to_meta(bb),
                             profile.to_meta(mb))
    assert plain["kernels"] == meta["kernels"]
    assert set(plain["kernels"]) == {"adam_adapt", "flash_attention_fwd", "flash_attention_dq",
                                     "flash_attention_dkv"}
    assert meta["memory_source"] == "none: meta"


def _stub_cuda_route(monkeypatch):
    """The CUDA route on CPU tensors, its kernels stubbed by the plain
    versions (contiguous, as the kernels write them)."""
    monkeypatch.setattr(dispatch, "route", lambda name, x, backend=None:
                        dispatch.META if x.is_meta else dispatch.CUDA)

    def fwd(q, k, v, q_pos, kv_pos, *, softcap, window, causal):
        out, lse = flash_attn.flash_attention_fwd_plain(q, k, v, q_pos, kv_pos, softcap=softcap,
                                                        window=window, causal=causal)
        return out.contiguous(), lse.contiguous()

    def bwd(q, k, v, q_pos, kv_pos, lse, delta, g_out, **kw):
        return tuple(x.contiguous() for x in flash_attn.flash_attention_bwd_plain(
            q, k, v, q_pos, kv_pos, lse, delta, g_out, **kw))

    monkeypatch.setattr(flash_attn, "_fwd_cuda", fwd)
    monkeypatch.setattr(flash_attn, "_bwd_cuda", bwd)
    monkeypatch.setattr(adam_adapt, "_adam_adapt_cuda",
                        lambda *a, **kw: adam_adapt.adam_adapt_plain(*a, **kw))


def test_cuda_route_counts_what_the_meta_trace_counts(monkeypatch):
    """The card's route and the meta route charge the same work, number
    for number, phase by phase (the CUDA route here with its kernels
    stubbed by the plain versions: what phase 25 of chip_smoke.py holds
    on the card)."""
    step, state, bb, mb = _port_step(b=4, s=16, mb=4)
    _stub_cuda_route(monkeypatch)
    card = profile.attribute(step, state, bb, mb)
    meta = profile.attribute(step, profile.to_meta(state), profile.to_meta(bb),
                             profile.to_meta(mb))
    assert set(card["phases"]) == set(meta["phases"])
    for ph in card["phases"]:
        for key in ("flops", "bytes", "matmul_flops"):
            assert card["phases"][ph][key] == meta["phases"][ph][key], (ph, key)
    assert card["kernels"] == meta["kernels"] and card["modules"] == meta["modules"]


def test_backward_is_charged_to_the_phase_that_called_it():
    x = torch.randn(8, 16, requires_grad=True)
    w = torch.randn(16, 4)

    def fn():
        with phase("meta_pass"):
            y = (x @ w).sum()
        with phase("finalize"):
            return torch.autograd.grad(y, x)

    attr = profile.attribute(fn, device="cpu")
    assert attr["phases"]["meta_pass"]["matmul_flops"] == 2 * 8 * 16 * 4
    assert attr["phases"]["finalize"]["matmul_flops"] == 2 * 8 * 4 * 16


def test_kernel_module_is_the_model_file_that_called_it():
    step, state, bb, mb = _port_step(b=4, s=16, mb=4)
    attr = profile.attribute(step, state, bb, mb)
    assert "kernels/adam_adapt.py" in attr["modules"]
    assert "kernels/flash_attn.py" not in attr["modules"]  # charged to attention.py


def _record(attr, name="sama"):
    return {"name": name, "attribution": attr}


def test_diff_of_two_records_and_unit_mismatch(pair, tmp_path):
    attr, _, _ = pair
    worse = json.loads(json.dumps(attr))
    worse["phases"]["meta_pass"]["flops"] *= 1.5
    base, cur = tmp_path / "base.json", tmp_path / "cur.json"
    base.write_text(json.dumps(_record(attr)))
    cur.write_text(json.dumps(_record(worse)))
    rows, unit = tdiff.diff_paths_unit(str(base), str(cur))
    assert unit == "flops" and tdiff.top_regressor(rows).phase == "meta_pass"
    assert "top regressor is meta_pass" in tdiff.render_diff(rows, unit)
    timed = json.loads(json.dumps(attr))
    for b in timed["phases"].values():
        b["wall_us"] = 10.0
    walls = tmp_path / "walls.json"
    walls.write_text(json.dumps(_record(timed)))
    with pytest.raises(ValueError, match="one side has measured wall"):
        tdiff.diff_paths_unit(str(base), str(walls))
    assert tdiff.main([str(base), str(walls)]) == 2
    assert tdiff.main([str(base), str(cur), "--fail-over", "20"]) == 1


def test_gate_attribution_bands_trip(pair):
    attr, _, _ = pair
    base = _record(json.loads(json.dumps(attr)))
    cur = _record(json.loads(json.dumps(attr)))
    assert gate.compare_record("b", cur, base, gate.Tolerance()) == []
    cur["attribution"]["phases"]["cd_passes"]["flops"] *= 1.2
    for rec in (base, cur):
        rec["attribution"]["phases"]["base_unroll"]["wall_us"] = 100.0
    cur["attribution"]["phases"]["base_unroll"]["wall_us"] = 300.0
    got = {v.metric for v in gate.compare_record("b", cur, base, gate.Tolerance())}
    assert got == {"attribution.cd_passes.flops", "attribution.base_unroll.wall_us"}


def test_learner_profile_carries_the_attribution_with_phase_walls():
    from repro_torch import api

    cfg = configs.get_smoke_config("bert-base").replace(**MINI)
    model = Model(cfg, device="cpu")
    spec = problems.make_data_optimization_spec(model.classifier_per_example, reweight=True)
    learner = api.MetaLearner(spec, method="sama", unroll_steps=K)
    learner.init(model.init(0), problems.init_data_optimization_lam(1, device="cpu"))
    _, _, bb, mb = _port_step(b=4, s=16, mb=4)
    spans = learner.phase_profile(bb, mb)
    rec = learner.profile(bb, mb, warmup=1, repeats=1, attribution=True,
                          attribution_spans=spans)
    attr = rec.attribution
    assert validate_attribution(attr) == [] and attr["wall_source"] == "tracer_runtime_spans"
    assert attr["phases"]["base_unroll"]["wall_us"] > 0
    assert attr["phases"]["base_unroll"]["utilization"] > 0
    assert attr["compute_dtype"] == "torch.float32" and attr["peak_flops"] == 67e12
