"""Smoke tests of the port's kernel, attention and attribution bench twins
(``repro_torch.perf.bench_kernels``, ``bench_attention``,
``bench_attribution``) and of the runner over the twins
(``repro_torch.perf.run --only``), on the CPU at the JAX benches' fast
sizes: each twin asserts its parity gates before its records, and writes
a bench file that validates in both packages.
"""

import json

import pytest

torch = pytest.importorskip("torch")

from repro import perf as jperf  # noqa: E402

from repro_torch import perf  # noqa: E402
from repro_torch.perf import bench_attention, bench_attribution, bench_kernels  # noqa: E402
from repro_torch.perf import run as run_mod  # noqa: E402


@pytest.fixture(autouse=True)
def _few_threads():
    """Two intra-op threads: the twins' timed calls are small, and under
    several test workers a thread per core oversubscribes the host."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def _written(bench, tmp_path):
    path = bench.write(str(tmp_path), fast=True, elapsed_s=0.0)
    payload = perf.load_bench(path)
    assert jperf.validate_bench(payload) == []
    return payload


def test_kernels_twin(tmp_path):
    payload = _written(bench_kernels.run(device="cpu"), tmp_path)
    names = {r["name"] for r in payload["records"]}
    assert names == {"adam_adapt_naive_n65536", "adam_adapt_fused_plain_n65536",
                     "weighted_ce_naive_r32_v8192", "weighted_ce_fused_plain_r32_v8192"}
    assert payload["notes"]["routes"] == ["plain"]


def test_attention_twin(tmp_path):
    payload = _written(bench_attention.run(device="cpu"), tmp_path)
    rows = {r["name"]: r for r in payload["rows"]}
    assert rows["attention_parity"]["derived"]["fwd_err"] <= bench_attention.PARITY_TOL
    assert rows["attention_parity"]["derived"]["grad_err"] <= bench_attention.GRAD_TOL
    assert {"attention_train_plain", "attention_decode_plain",
            "attention_step_attribution"} <= set(rows)
    share = rows["attention_step_attribution"]["derived"]["attention_flop_share"]
    assert 0.3 < share < 1.0


def test_attribution_twin(tmp_path):
    payload = _written(bench_attribution.run(device="cpu"), tmp_path)
    recs = {r["name"]: r for r in payload["records"]}
    sama = recs["attribution_sama"]["attribution"]
    assert sama["coverage"] >= 0.90 and sama["top_module"] == "attention.py"
    assert all(b.get("wall_us", 1.0) > 0 for b in sama["phases"].values())
    assert sama["phases"]["base_unroll"]["utilization"] > 0
    manual = recs["attribution_manual"]["attribution"]
    assert manual["total"]["collective_count"] == bench_attribution.UNROLL + 1
    assert manual["phases"]["allreduce_flat"]["collective_count"] == 1


def test_runner_only_writes_the_chosen_twins(tmp_path, capsys):
    run_mod.main(["--only", "kernels", "--json-dir", str(tmp_path), "--device", "cpu"])
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == ["BENCH_torch_kernels.json"]
    payload = json.loads((tmp_path / files[0]).read_text())
    assert perf.validate_bench(payload) == [] and payload["fast"] is True
    out = capsys.readouterr().out
    assert out.splitlines()[0] == "name,us_per_call,derived"
    assert "bench_kernels done" in out
