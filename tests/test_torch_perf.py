"""The port's ``perf`` package against the JAX package's: the timing
statistics, ``time_callable`` / ``measure``, PerfRecords that validate in
both packages, atomic bench writes, both regression gates giving the same
verdicts on the same record directories, ``profile_step`` and
``MetaLearner.profile`` on the CPU, and the Table 2 bench at a smoke size.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import perf as jperf  # noqa: E402
from repro_torch import api, perf  # noqa: E402
from repro_torch.core import problems  # noqa: E402

SAMPLES = [0.004, 0.001, 0.003, 0.010, 0.002]


def test_timing_stats_match_jax():
    got = perf.TimingStats.from_samples(SAMPLES, warmup=2).as_dict()
    assert got == jperf.TimingStats.from_samples(SAMPLES, warmup=2).as_dict()
    assert got["median_us"] == pytest.approx(3000.0)
    assert got["iqr_us"] == pytest.approx(2000.0)
    assert (got["min_us"], got["max_us"], got["repeats"]) == (pytest.approx(1000.0),
                                                              pytest.approx(10000.0), 5)


def test_time_callable_rejects_zero_repeats():
    with pytest.raises(ValueError, match="repeats must be >= 1"):
        perf.time_callable(lambda: None, repeats=0)


def test_measure_times_the_first_call_apart():
    calls = []
    m = perf.measure(lambda x: calls.append(x) or torch.ones(3) * x, 2.0, warmup=2, repeats=3)
    assert len(calls) == 5 and m.timing.repeats == 3 and m.timing.warmup == 2
    assert m.first_call_s > 0 and m.lower_s is None and m.compile_s is None
    assert m.samples_per_s(10) == pytest.approx(10 / (m.timing.median_us / 1e6))
    assert perf.compile_split(lambda: None)[:2] == (None, None)


def _port_record():
    m = perf.measure(lambda: torch.zeros(4), warmup=1, repeats=2)
    mem = perf.memory_report(example_args=({"a": torch.zeros((2, 3))},))
    return perf.PerfRecord.from_measurement("probe", m, samples_per_step=8, memory=mem,
                                            extra={"method": "sama"})


def test_records_validate_in_both_packages():
    rec = _port_record().as_dict()
    assert rec["extra"]["first_call_s"] > 0 and "compile_s" not in rec
    assert rec["memory"]["per_device"] == {
        "argument_bytes": 24, "output_bytes": 0, "temp_bytes": None,
        "generated_code_bytes": None, "alias_bytes": None, "peak_bytes": None,
        "source": "tree_bytes"}
    assert perf.validate_record(rec) == [] == jperf.validate_record(rec)
    jrec = jperf.PerfRecord(
        name="jax_probe", us_per_step=jperf.TimingStats.from_samples(SAMPLES, 1).as_dict(),
        collectives={"total_count": 3, "all-reduce_count": 3},
        latency={"p50_us": 1.0, "p90_us": 2.0, "p99_us": 3.0, "mean_us": 1.5, "max_us": 3.0,
                 "n": 4},
        attribution={"phases": {"a": {"flops": 2.0, "flop_frac": 1.0}},
                     "total": {"flops": 2.0}, "coverage": 1.0}).as_dict()
    assert perf.validate_record(jrec) == [] == jperf.validate_record(jrec)
    bad = dict(rec, schema_version=2, us_per_step=dict(rec["us_per_step"], median_us=0))
    assert perf.validate_record(bad) == jperf.validate_record(bad) != []


def test_env_info_names_torch_and_the_device():
    env = perf.env_info()
    assert env["torch_version"] == torch.__version__
    assert env["backend"] in ("cpu", "cuda") and env["device_count"] >= 1
    assert "jax_version" not in env


def test_write_bench_is_atomic(tmp_path):
    payload = perf.bench_payload("torch_probe", fast=True, elapsed_s=1.0,
                                 rows=[{"name": "probe", "us_per_call": 1.0, "derived": ""}],
                                 records=[_port_record()])
    path = str(tmp_path / "BENCH_torch_probe.json")
    perf.write_bench(path, payload)
    assert os.listdir(tmp_path) == ["BENCH_torch_probe.json"]
    assert jperf.load_bench(path)["records"][0]["name"] == "probe"
    with pytest.raises(ValueError, match="invalid bench payload"):
        perf.write_bench(str(tmp_path / "BENCH_bad.json"), dict(payload, bench=""))
    with pytest.raises(TypeError):  # fails mid-dump: neither the file nor its tmp remains
        perf.write_json_atomic(str(tmp_path / "BENCH_torn.json"), dict(payload, rows=[object()]))
    assert os.listdir(tmp_path) == ["BENCH_torch_probe.json"]


def _bench(name, records):
    return perf.bench_payload(name, fast=True, elapsed_s=1.0, rows=[], records=records)


def _rec(name, median_us, peak=None, sps=None):
    rec = {"name": name, "schema_version": 1,
           "us_per_step": perf.TimingStats.from_samples([median_us / 1e6], 0).as_dict()}
    if peak is not None:
        rec["memory"] = {"per_device": {"argument_bytes": 1, "peak_bytes": peak,
                                        "source": "cuda_peak"}, "n_devices": 1}
    if sps is not None:
        rec["samples_per_s"] = sps
    return rec


def test_both_gates_give_the_same_verdicts(tmp_path):
    base, cur = tmp_path / "base", tmp_path / "cur"
    base.mkdir()
    cur.mkdir()
    perf.write_bench(str(base / "BENCH_torch_table2.json"), _bench("torch_table2", [
        _rec("sama", 1000.0, peak=100, sps=50.0), _rec("cg", 1000.0, peak=100),
        _rec("t1t2", 1000.0), _rec("gone", 10.0)]))
    perf.write_bench(str(base / "BENCH_other.json"), _bench("other", [_rec("x", 1.0)]))
    perf.write_bench(str(cur / "BENCH_torch_table2.json"), _bench("torch_table2", [
        _rec("sama", 3000.0, peak=100, sps=10.0),  # time and throughput regress
        _rec("cg", 900.0, peak=120),  # memory regresses
        _rec("t1t2", 2000.0),  # within the 2.5x band
        _rec("new", 1.0)]))
    mine = perf.compare_dirs(str(cur), str(base))
    theirs = jperf.compare_dirs(str(cur), str(base))
    assert [str(v) for v in mine.violations] == [str(v) for v in theirs.violations]
    assert sorted(v.metric for v in mine.violations) == [
        "memory.peak_bytes", "samples_per_s", "us_per_step.median_us"]
    for field in ("compared", "new_records", "missing_records", "missing_benches"):
        assert getattr(mine, field) == getattr(theirs, field), field
    assert mine.missing_records == ["torch_table2/gone"] and mine.missing_benches == ["other"]
    for kw in ({}, {"strict_missing": True}, {"strict_missing_records": True}):
        assert mine.ok(**kw) is theirs.ok(**kw) is False
    perf.write_bench(str(cur / "BENCH_torch_table2.json"), _bench("torch_table2", [
        _rec("sama", 900.0, peak=90, sps=60.0), _rec("cg", 1000.0, peak=100),
        _rec("t1t2", 1000.0), _rec("gone", 10.0)]))
    mine = perf.compare_dirs(str(cur), str(base))
    theirs = jperf.compare_dirs(str(cur), str(base))
    for kw in ({}, {"strict_missing": True}, {"strict_missing_records": True}):
        assert mine.ok(**kw) is theirs.ok(**kw)
    assert mine.ok() and not mine.ok(strict_missing=True)
    from repro_torch.perf import gate

    assert gate.main(["--records", str(cur), "--baselines", str(base)]) == 0


def _quickstart_learner(method):
    spec = problems.make_data_optimization_spec(
        problems.softmax_per_example(lambda th, x: x @ th["w"] + th["b"]), reweight=True)
    learner = api.MetaLearner(spec, base_opt="adam", base_lr=1e-2, meta_opt="adam",
                              meta_lr=1e-2, method=method, unroll_steps=2)
    learner.init({"w": torch.zeros((4, 2)), "b": torch.zeros(2)},
                 problems.init_data_optimization_lam(0, device="cpu"))
    rng = np.random.default_rng(0)
    base = {"x": torch.from_numpy(rng.standard_normal((2, 8, 4)).astype(np.float32)),
            "y": torch.from_numpy(rng.integers(0, 2, (2, 8)).astype(np.int32))}
    meta = {"x": base["x"][0], "y": base["y"][0]}
    return learner, base, meta


def test_meta_learner_profile_on_the_cpu():
    learner, base, meta = _quickstart_learner("neumann")
    state = learner.state
    rec = learner.profile(base, meta, warmup=1, repeats=2, samples_per_step=16)
    assert learner.state is state and int(state.step) == 0
    d = rec.as_dict()
    assert jperf.validate_record(d) == [] == perf.validate_record(d)
    assert d["name"] == "neumann" and d["extra"]["method"] == "neumann"
    assert d["memory"]["per_device"]["source"] == "tree_bytes"
    assert d["memory"]["per_device"]["argument_bytes"] == perf.tree_bytes((state, base, meta))
    assert d["samples_per_s"] > 0 and d["us_per_step"]["repeats"] == 2


def test_table2_bench_at_smoke_size_on_the_cpu(tmp_path):
    from repro_torch import configs
    from repro_torch.kernels import dispatch
    from repro_torch.perf import bench_throughput_memory as bench

    records = bench.run(configs.get_smoke_config("bert-base"), batch=2, seq=8, warmup=1,
                        repeats=1, methods=("sama", "iterdiff"), device="cpu")
    routes = {r.extra["method"]: {(a, b): n for a, b, n in r.extra["routes"]} for r in records}
    assert (dispatch.PLAIN, dispatch.SECOND_ORDER) not in routes["sama"]
    assert routes["iterdiff"][(dispatch.PLAIN, dispatch.SECOND_ORDER)] > 0
    for rec in records:
        assert rec.extra["lam_finite"] and rec.extra["device_ms"] is None
        assert rec.extra["steps_counted"] == 2 and rec.samples_per_s > 0
    path = bench.write(str(tmp_path), records, elapsed_s=1.0)
    payload = jperf.load_bench(path)
    assert [r["name"] for r in payload["records"]] == ["table2_sama", "table2_iterdiff"]
    assert payload["env"]["torch_version"] == torch.__version__
    with open(path) as f:
        assert json.load(f)["rows"][0]["derived"]["peak_mb"] is None
