"""The port's partition rules (``repro_torch.launch.sharding``) against the
JAX package's ``repro.launch.sharding``: ``param_spec`` and
``tree_param_specs`` on every registered config's ``SMOKE`` tree (the
port's own tree, so the leaf names are the port's rendering) at model
extents 1, 2 and 4, with and without the config's head alignment; the
reference's full-size cases of tests/test_launch.py with its fake mesh and
literal shapes; ``cache_spec``, ``batch_spec`` and ``dp_size`` on the
reference's cases; a leaf's block under a spec (``shard``) against the
block a ``NamedSharding`` places on each device; and the meshes
(``launch.mesh``) with a model axis: their groups, ranks, coordinates and
the rows each rank takes.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import sharding as jsh  # noqa: E402
from repro_torch import configs, tree  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import sharding as sh  # noqa: E402
from repro_torch.models import Model  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


MESH = _FakeMesh({"data": 16, "model": 16})


def _p(spec):
    """A PartitionSpec as the port's tuple."""
    return tuple(spec)


@pytest.fixture(scope="module")
def smoke_trees():
    return {name: Model(configs.get_smoke_config(name), device="cpu").init(0)
            for name in configs.list_archs()}


def test_the_port_registers_the_reference_configs():
    assert sorted(configs.list_archs()) == sorted(jconfigs.list_archs())


@pytest.mark.parametrize("with_cfg", [False, True])
@pytest.mark.parametrize("model", [1, 2, 4])
def test_tree_param_specs_equal_the_reference_on_every_smoke_tree(smoke_trees, model,
                                                                  with_cfg):
    mesh = _FakeMesh({"data": 2, "model": model})
    seen_sharded = 0
    for name, params in smoke_trees.items():
        tcfg = configs.get_smoke_config(name) if with_cfg else None
        jcfg = jconfigs.get_smoke_config(name) if with_cfg else None
        names, specs = sh.param_specs(params, mesh, tcfg)
        leaves = tree.flatten_with_keys(params)[1]
        for n, x, got in zip(names, leaves, specs):
            want = jsh.param_spec(n, tuple(x.shape), mesh, jcfg)
            assert got == _p(want), (name, n, got, want)
            seen_sharded += "model" in got
        # the tree form carries the same specs at the same leaves
        specs_tree = sh.tree_param_specs(params, mesh, tcfg)
        assert tree.tree_flatten(specs_tree)[0] == specs
    # at extent 1 the rules still name "model" (a block of the whole), as JAX's do
    assert seen_sharded > 0


def test_leaf_names_render_as_jax_keystr(smoke_trees):
    """The rules match on the path's text: the port's names must be
    ``jax.tree_util.keystr`` of JAX's paths for the same tree."""
    for name in ("gemma3-1b", "qwen2-moe-a2.7b", "zamba2-7b", "whisper-small"):
        from repro.models import Model as JaxModel

        jm = JaxModel(jconfigs.get_smoke_config(name))
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
        jnames = [jax.tree_util.keystr(p) for p, _ in
                  jax.tree_util.tree_flatten_with_path(shapes)[0]]
        assert tree.flatten_with_keys(smoke_trees[name])[0] == jnames, name


@pytest.mark.parametrize(
    "path,shape,expect",
    [
        ("['layers']['attn']['wq']", (26, 1152, 1024), P(None, None, "model")),
        ("['layers']['attn']['wo']", (26, 1024, 1152), P(None, "model", None)),
        ("['layers']['mlp']['down']", (26, 6912, 1152), P(None, "model", None)),
        ("['embed']", (262144, 1152), P("model", None)),
        ("['embed']", (51865, 768), P(None, None)),
        ("['layers']['moe']['experts']['up']", (60, 384, 7168, 2048),
         P(None, "model", None, None)),
        ("['layers']['moe']['experts']['up']", (24, 60, 2048, 1408),
         P(None, None, None, "model")),
        ("['layers']['moe']['router']", (24, 2048, 60), P(None, None, None)),
        ("['layers']['ln1']['scale']", (26, 1152), P()),
        ("['layers']['tmix']['wv']", (24, 2048, 2048), P(None, None, "model")),
        ("['layers']['cmix']['wv']", (24, 7168, 2048), P(None, "model", None)),
    ],
)
def test_param_spec_full_size_cases(path, shape, expect):
    assert sh.param_spec(path, shape, MESH) == _p(expect)
    assert sh.param_spec(path, shape, MESH) == _p(jsh.param_spec(path, shape, MESH))


def test_head_alignment_replicates_unaligned_attention():
    cfg = configs.get_config("gemma3-1b")  # 4 heads, kv 1: neither divides 16
    assert sh.param_spec("['layers']['attn']['wq']", (26, 1152, 1024), MESH, cfg) == ()
    assert sh.param_spec("['layers']['attn']['wk']", (26, 1152, 256), MESH, cfg) == ()
    cfg2 = configs.get_config("kimi-k2-1t-a32b")  # 64 heads: aligned
    assert sh.param_spec("['layers']['attn']['wq']", (60, 7168, 8192), MESH, cfg2) == (
        None, None, "model")


@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen2-moe-a2.7b", "minicpm3-4b", "rwkv6-1.6b",
                                  "zamba2-7b", "whisper-small", "kimi-k2-1t-a32b"])
def test_full_size_trees_on_the_production_mesh_equal_the_reference(arch):
    """Every leaf of the full-size model, by shape alone (no weights), on
    the reference's (16, 16) and (2, 16, 16) meshes."""
    from repro.models import Model as JaxModel

    jcfg, tcfg = jconfigs.get_config(arch), configs.get_config(arch)
    shapes = jax.eval_shape(JaxModel(jcfg).init, jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    for mesh in (MESH, _FakeMesh({"pod": 2, "data": 16, "model": 16})):
        for path, leaf in flat:
            n = jax.tree_util.keystr(path)
            assert sh.param_spec(n, leaf.shape, mesh, tcfg) == _p(
                jsh.param_spec(n, leaf.shape, mesh, jcfg)), (arch, n)


CACHE_CASES = [
    ("['kv']['k']", (62, 1, 524288, 16, 128)),  # B 1, long context: T over data
    ("['kv']['k']", (62, 128, 32768, 16, 128)),  # batch-shardable decode
    ("['kv']['v']", (26, 4, 1024, 1, 256)),  # gemma3-1b, 4 slots, KV 1
    ("['kv']['v']", (26, 3, 1000, 4, 64)),  # neither B nor T divides
    ("['ckv']", (62, 8, 4096, 256)),  # MLA latent
    ("['krope']", (62, 1, 4096, 32)),
    ("['ssm']['state']", (81, 4, 112, 64, 64)),  # mamba state
    ("['ssm']['conv']", (81, 3, 4, 7296)),  # conv state: B 3 does not divide
    ("['wkv']", (24, 1, 32, 64, 64)),
    ("['shift']", (24, 5, 2048)),
]


@pytest.mark.parametrize("shape_mesh", [{"data": 16, "model": 16}, {"data": 4, "model": 2},
                                        {"pod": 2, "data": 16, "model": 16},
                                        {"data": 1, "model": 1}])
def test_cache_spec_equals_the_reference(shape_mesh):
    mesh = _FakeMesh(shape_mesh)
    for path, shape in CACHE_CASES:
        assert sh.cache_spec(path, shape, mesh) == _p(jsh.cache_spec(path, shape, mesh)), path
    # the reference's own two cases
    assert sh.cache_spec("['kv']['k']", (62, 1, 524288, 16, 128), MESH) == (
        None, None, "data", "model", None)
    assert sh.cache_spec("['kv']['k']", (62, 128, 32768, 16, 128), MESH)[1] == "data"


def test_tree_cache_specs_of_a_served_cache():
    """The port's cache trees, leaf by leaf against the reference's specs
    of its own cache trees (same names, same shapes)."""
    from repro.models import Model as JaxModel

    mesh = _FakeMesh({"data": 2, "model": 2})
    for arch in ("gemma3-1b", "zamba2-7b", "minicpm3-4b"):
        cache = Model(configs.get_smoke_config(arch), device="cpu").init_cache(
            4, 32, dtype=torch.float32)
        jcache = jax.eval_shape(lambda: JaxModel(jconfigs.get_smoke_config(arch)).init_cache(
            4, 32, dtype=jax.numpy.float32))
        want = {jax.tree_util.keystr(p): _p(jsh.cache_spec(jax.tree_util.keystr(p), x.shape,
                                                           mesh))
                for p, x in jax.tree_util.tree_flatten_with_path(jcache)[0]}
        names, leaves = tree.flatten_with_keys(cache)
        assert sorted(names) == sorted(want), arch
        for n, x in zip(names, leaves):
            assert sh.cache_spec(n, tuple(x.shape), mesh) == want[n], (arch, n)
        # the tree form: the cache's structure with each leaf's spec in its place
        specs = sh.tree_cache_specs(cache, mesh)
        assert type(specs) is type(cache)


@pytest.mark.parametrize("axes,shape", [(("data", "model"), {"data": 16, "model": 16}),
                                        (("pod", "data", "model"),
                                         {"pod": 2, "data": 16, "model": 16}),
                                        (("data", "model"), {"data": 1, "model": 1})])
def test_batch_spec_and_dp_size_equal_the_reference(axes, shape):
    mesh = _FakeMesh(shape)
    for lead in (False, True):
        got, want = sh.batch_spec(mesh, leading_unroll=lead), jsh.batch_spec(
            mesh, leading_unroll=lead)
        assert got == _p(want)
    assert sh.dp_size(mesh) == int(jsh.dp_size(mesh))


def test_model_dim_refuses_what_fsdp_cannot_store():
    assert sh.model_dim((None, "model")) == 1 and sh.model_dim(()) is None
    for bad in (("model", "model"), (("data", "model"), None), ("data", None)):
        with pytest.raises(NotImplementedError, match="model axis alone"):
            sh.model_dim(bad)


# ---------------------------------------------------------------------------
# a rank's block against NamedSharding's
# ---------------------------------------------------------------------------

BLOCK_SCRIPT = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np, jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.launch.mesh import AxisType, make_mesh
x = np.arange(4 * 8 * 12, dtype=np.float32).reshape(4, 8, 12)
out = {}
for shape, names in (((2, 4), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))):
    mesh = make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(names))
    for spec in (P(None, "model", None), P(None, None, "model"), P("model", None, None),
                 P(("pod", "data") if "pod" in names else "data", "model", None)):
        arr = jax.device_put(x, NamedSharding(mesh, spec))
        ids = {d.id: i for i, d in enumerate(mesh.devices.reshape(-1))}
        blocks = {ids[s.device.id]: np.asarray(s.data).tolist() for s in arr.addressable_shards}
        out[f"{names}|{tuple(spec)}"] = [blocks[i] for i in range(len(ids))]
print(json.dumps(out))
"""


def test_shard_takes_the_block_named_sharding_places():
    """Device i of a JAX mesh (row-major over its axes) holds the block the
    port's rank i takes: ``Mesh.coords`` lays the world out the same way."""
    import json

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", BLOCK_SCRIPT], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    want = json.loads(res.stdout.strip().splitlines()[-1])
    x = torch.arange(4 * 8 * 12, dtype=torch.float32).reshape(4, 8, 12)
    for shape, names in (((2, 4), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))):
        n = int(np.prod(shape))
        m = shape[-1]
        for spec in ((None, "model", None), (None, None, "model"), ("model", None, None),
                     (("pod", "data") if "pod" in names else "data", "model", None)):
            key = f"{names}|{tuple(P(*spec))}"
            for r in range(n):
                mesh = _RankMesh(dict(zip(names, shape)), r, m)
                assert sh.shard(x, spec, mesh).tolist() == want[key][r], (key, r)


class _RankMesh:
    """The fields of ``launch.mesh.Mesh`` that ``shard`` reads, for world
    rank ``r`` without a process group."""

    def __init__(self, shape, r, m):
        self.shape, self.axis_names = shape, tuple(shape)
        self.world_rank = r
        self.coords = lambda: M.Mesh.coords(self)


def test_shard_is_a_fresh_tensor():
    x = torch.arange(16.0).reshape(4, 4)
    mesh = _RankMesh({"data": 1, "model": 2}, 1, 2)
    b = sh.shard(x, ("model", None), mesh)
    assert b.tolist() == x[2:].tolist() and b.is_contiguous()
    assert b.untyped_storage().data_ptr() != x.untyped_storage().data_ptr()


# ---------------------------------------------------------------------------
# the meshes
# ---------------------------------------------------------------------------


def _mesh_facts(rank, out_dir):
    import json

    from repro_torch.launch import distributed as D

    facts = {}
    for shape, names in (((1, 2, 2), ("pod", "data", "model")), ((2, 2), ("data", "model")),
                         ((1, 4), ("data", "model")), ((1, 1, 4), ("pod", "data", "model")),
                         ((4, 1), ("data", "model"))):
        mesh = M.make_mesh(shape, names, device="cpu")
        x = torch.full((1,), float(mesh.world_rank))
        facts[str(shape)] = {
            "rank": mesh.rank, "size": mesh.size, "model_rank": mesh.model_rank,
            "world_rank": mesh.world_rank, "coords": mesh.coords(),
            "data_axes": list(M.data_axes(mesh)),
            "sums": {g: float(D.collective("all-reduce", x.clone(), mesh, over=g))
                     for g in M.GROUPS},
            "rows": mesh.local({"x": torch.arange(16)}, 0)["x"].tolist(),
            "local_rows": mesh.local(M.LocalBatch(x=torch.arange(8)), 0)["x"].tolist(),
            "gathered": D.collective("all-gather", torch.full((1, 2), float(mesh.world_rank)),
                                     mesh, over="model", dim=1).tolist(),
            "scattered": D.collective("reduce-scatter", torch.arange(4.0).reshape(1, 4), mesh,
                                      over="model", dim=1).tolist(),
            "model_mean": D.tree_pmean({"x": x}, mesh, over="model")["x"].tolist()}
        try:
            mesh.local({"x": torch.arange(6)}, 0)
        except ValueError as e:
            facts[str(shape)]["uneven"] = str(e)
    with open(os.path.join(out_dir, f"mesh{rank}.json"), "w") as f:
        json.dump(facts, f)


def test_meshes_with_a_model_axis_lay_ranks_out_model_innermost(tmp_path):
    """Four gloo ranks: (pod 1, data 2, model 2), (2, 2), (1, 4), the pod
    mesh (1, 1, 4) and (4, 1): each rank's data and model coordinates,
    the groups' sums of the world ranks (data: ranks with this model
    coordinate; model: adjacent ranks), the rows of a global batch each
    rank takes (its block of the world), a LocalBatch split over the model
    group only, the model group's all-gather and reduce-scatter along a
    dim, and the ValueError for rows that do not split evenly."""
    import json

    from repro_torch.launch import distributed as D

    D.spawn(_mesh_facts, 4, (str(tmp_path),), store_dir=str(tmp_path), timeout_s=120)
    facts = [json.load(open(tmp_path / f"mesh{r}.json")) for r in range(4)]
    for r, f in enumerate(facts):
        two = f["(2, 2)"]
        assert (two["rank"], two["model_rank"], two["world_rank"]) == (r // 2, r % 2, r)
        assert two["coords"] == {"data": r // 2, "model": r % 2}
        assert two["data_axes"] == ["data"]
        assert two["sums"] == {"data": float((r % 2) + (r % 2 + 2)),
                               "model": float(2 * (r // 2) * 2 + 1), "world": 6.0}
        assert two["rows"] == list(range(4 * r, 4 * r + 4))
        assert two["local_rows"] == list(range(4 * (r % 2), 4 * (r % 2) + 4))
        assert two["gathered"] == [[float(r - r % 2)] * 2 + [float(r - r % 2 + 1)] * 2]
        assert two["scattered"] == [[2.0 * (2 * (r % 2)), 2.0 * (2 * (r % 2) + 1)]]
        assert two["model_mean"] == [two["sums"]["model"] / 2]
        pod = f["(1, 2, 2)"]
        assert pod["coords"] == {"pod": 0, "data": r // 2, "model": r % 2}
        assert pod["data_axes"] == ["pod", "data"] and pod["sums"] == two["sums"]
        four = f["(1, 1, 4)"]
        assert (four["rank"], four["size"], four["model_rank"]) == (0, 1, r)
        assert four["data_axes"] == ["pod", "data"]
        assert four["sums"] == {"data": float(r), "model": 6.0, "world": 6.0}
        assert four["rows"] == list(range(4 * r, 4 * r + 4))
        assert four["scattered"] == [[4.0 * r]]
        assert f["(1, 4)"]["coords"] == {"data": 0, "model": r}
        flat = f["(4, 1)"]
        assert (flat["rank"], flat["size"], flat["model_rank"]) == (r, 4, 0)
        assert flat["sums"] == {"data": 6.0, "model": float(r), "world": 6.0}
        # 6 rows: 3 per data rank at (2, 2), which do not split over 2
        # model ranks; the message names the rows and both extents
        assert "6 rows over 2 data ranks" in two["uneven"]
        assert "3 rows" in two["uneven"] and "2 model ranks" in two["uneven"]
        assert "over 4 model ranks" in four["uneven"]


def test_mesh_validates_its_groups():
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="needs a model group"):
        M.Mesh(("data", "model"), {"data": 1, "model": 2}, None, 0, 1, cpu)
    with pytest.raises(ValueError, match="none of"):
        M.Mesh(("data", "tensor"), {"data": 1, "tensor": 2}, None, 0, 1, cpu)
    host = M.make_host_mesh(device="cpu")
    assert host.world_size == 1 and host.model_size == 1 and host.world_group is None
    assert host.coords() == {"data": 0, "model": 0}
    with pytest.raises(RuntimeError, match="initialised process group"):
        M.make_mesh((1, 2), ("data", "model"), device="cpu")
    assert M.PRODUCTION == {False: ((16, 16), ("data", "model")),
                            True: ((2, 16, 16), ("pod", "data", "model"))}
