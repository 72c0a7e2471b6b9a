"""The port's roofline (``repro_torch.roofline``) and meta-tensor dry run
(``repro_torch.launch.specs``, ``launch.dryrun``) against the JAX
package's.

* ``param_counts``, ``step_flops`` and ``step_bytes`` exactly equal to
  JAX's on every config and input shape: pure arithmetic, with JAX's
  parameter and cache shapes from ``jax.eval_shape`` and the port's from
  ``device="meta"``;
* ``run_job`` on meta: ``ok`` for gemma3-1b ``decode_32k`` and ``train_4k``
  and zamba2-7b ``long_500k`` (the jobs of the reference's slow-marked
  ``test_dryrun_smoke_production_mesh``, and the train job), and the
  reference's ``skipped``, its reason word for word, for an attention
  architecture at ``long_500k``; the table rendered from their files;
* per-rank bytes equal to the layout's arithmetic.
"""

import math
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.roofline import analysis as janalysis  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.perf import make_roofline_table  # noqa: E402
from repro_torch.roofline import analysis  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_bytes(tree) -> int:
    return sum(math.prod(x.shape) * x.dtype.itemsize for x in jax.tree_util.tree_leaves(tree))


@pytest.fixture(scope="module")
def shapes():
    """Per arch: (JAX params, port params), from shapes alone."""
    out = {}
    for arch in configs.list_archs():
        jcfg = jconfigs.get_config(arch)
        jp = jax.eval_shape(lambda c=jcfg: jtf.init_params(c, jax.random.PRNGKey(0)))
        out[arch] = (jcfg, jp, configs.get_config(arch), Model(configs.get_config(arch),
                                                              device="meta").init(0))
    return out


def test_config_surfaces_match_jax():
    assert configs.ASSIGNED_ARCHS == jconfigs.ASSIGNED_ARCHS
    assert {k: tuple(vars(v).values()) for k, v in configs.INPUT_SHAPES.items()} == {
        k: tuple(vars(v).values()) for k, v in jconfigs.INPUT_SHAPES.items()}


@pytest.mark.parametrize("arch", configs.list_archs())
def test_param_counts_step_flops_and_bytes_equal_jax(shapes, arch):
    jcfg, jp, cfg, tp = shapes[arch]
    counts = analysis.param_counts(tp)
    assert counts == janalysis.param_counts(jp)
    for name, shape in configs.INPUT_SHAPES.items():
        jshape = jconfigs.INPUT_SHAPES[name]
        assert analysis.step_flops(cfg, counts, shape, shape.kind) == \
            janalysis.step_flops(jcfg, counts, jshape, jshape.kind)
        cache = 0
        if shape.kind == "decode":
            if cfg.family == "encoder" or (name == "long_500k"
                                           and not cfg.supports_long_context):
                continue  # no decode cache: bert-base is an encoder
            jc = jax.eval_shape(lambda c=jcfg, s=jshape: jtf.init_cache(
                c, s.global_batch, s.seq_len, jnp.bfloat16))
            tc = Model(cfg, device="meta").init_cache(shape.global_batch, shape.seq_len,
                                                      torch.bfloat16)
            cache = _jax_bytes(jc)
            assert sum(x.numel() * x.element_size()
                       for x in jax.tree_util.tree_leaves(tc)) == cache
        assert analysis.step_bytes(cfg, counts, shape, shape.kind, cache) == \
            janalysis.step_bytes(jcfg, counts, jshape, jshape.kind, cache)


def test_h100_constants_and_no_tpu_number():
    assert (analysis.PEAK_FLOPS, analysis.PEAK_FLOPS_F32, analysis.HBM_BW) == (
        989e12, 67e12, 3.35e12)
    assert analysis.HBM_BYTES == 80 * 10**9
    assert analysis.peak_flops(torch.bfloat16) == 989e12
    assert analysis.peak_flops("torch.float32") == 67e12
    # the reference's chip peaks and memory appear nowhere (its link rate,
    # 50 GB/s, happens to equal one 400 Gb/s NDR port, the port's network)
    for value in (janalysis.PEAK_FLOPS, janalysis.HBM_BW, janalysis.HBM_BYTES):
        assert value not in vars(analysis).values()
    assert analysis.NETWORK_BW == 400e9 / 8


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    got = {(a, s): dryrun.run_job(a, s, out_dir=str(out))
           for a, s in (("gemma3-1b", "decode_32k"), ("gemma3-1b", "train_4k"),
                        ("zamba2-7b", "long_500k"), ("qwen2-moe-a2.7b", "long_500k"))}
    return got, str(out)


@pytest.mark.parametrize("arch,shape", [("gemma3-1b", "decode_32k"), ("gemma3-1b", "train_4k"),
                                        ("zamba2-7b", "long_500k")])
def test_run_job_on_meta_is_ok(jobs, arch, shape):
    r = jobs[0][(arch, shape)]
    assert r["status"] == "ok", r.get("traceback")
    assert r["ranks"] == 256 and r["dominant"] in ("compute", "memory", "collective")
    assert r["traced_flops"] > 0 and r["flops_global"] > 0
    assert r["compute_s"] == pytest.approx(r["flops_global"] / (256 * 989e12))
    assert r["memory_s"] == pytest.approx(r["bytes_global"] / (256 * 3.35e12))
    assert 0 < r["useful_ratio"] <= 1.5
    if shape == "train_4k":
        assert r["traced_coverage"] >= 0.90
        assert r["per_rank_bytes"]["moments"] == 2 * r["per_rank_bytes"]["params"]
        assert r["collective_bytes_per_device"] > 0
    else:
        assert r["per_rank_bytes"]["cache"] > 0 and r["collective_s"] == 0.0
        assert set(r["traced_kernels"]) >= {"flash_decode"}


def test_run_job_skips_an_attention_arch_at_long_context(jobs):
    r = jobs[0][("qwen2-moe-a2.7b", "long_500k")]
    assert r["status"] == "skipped"
    with open(os.path.join(ROOT, "src", "repro", "launch", "dryrun.py"), encoding="utf-8") as f:
        assert f'"reason": "{r["reason"]}"' in f.read()


def test_roofline_table_renders_the_jobs(jobs, tmp_path):
    make_roofline_table.main(["--dir", jobs[1], "--out", str(tmp_path),
                              "--arch", "gemma3-1b,zamba2-7b,qwen2-moe-a2.7b"])
    text = (tmp_path / "roofline_pod16x16.md").read_text()
    assert "not measurements" in text
    assert "| gemma3-1b | train_4k |" in text and "| zamba2-7b | long_500k |" in text
    assert "| qwen2-moe-a2.7b | long_500k | - | - | - | skipped" in text
    assert "| gemma3-1b | prefill_32k | - | - | - | MISSING" in text


def test_per_rank_bytes_are_the_layouts_arithmetic():
    """theta's column-parallel projection split 16 ways on its last dim, its
    row-parallel one on its first, the norm whole; the cache's batch over
    the data axis and its KV heads over the model axis."""
    meta = torch.device("meta")
    params = {"layers": {"attn": {"wq": torch.empty(2, 64, 128, device=meta),
                                  "wo": torch.empty(2, 128, 64, device=meta)},
                         "ln1": {"scale": torch.empty(2, 64, device=meta)}}}
    cache = {"kv": {"k": torch.empty(2, 32, 8, 16, 4, dtype=torch.bfloat16, device=meta)}}
    job = specs.Job(name="probe", step_fn=None, args=(), kind="decode", cfg=None,
                    params=params, cache=cache)
    mesh = {"data": 16, "model": 16}
    got = specs.per_rank_bytes(job, mesh)
    want_params = (2 * 64 * 128 * 4) / 16 + (2 * 128 * 64 * 4) / 16 + 2 * 64 * 4
    assert got["params"] == want_params
    assert got["cache"] == 2 * 32 * 8 * 16 * 4 * 2 / (16 * 16)
    assert got["total"] == got["params"] + got["cache"]
