"""The port's checkpoints (``repro_torch.checkpoint``, ``MetaLearner.save``
/ ``load``, ``fit(save_every=)``, the train CLI's ``--ckpt``) in the JAX
package's format: a JAX-written ``EngineState`` restores into the port and
a port-written one into ``repro.checkpoint.restore``, every leaf exactly
equal, for the quickstart problem with Adam and with Adafactor at the base
level (factored ``nu`` nested one level below the parameters, ``mu`` None).
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro import checkpoint as jcheckpoint  # noqa: E402
from repro.core import problems as jproblems  # noqa: E402
from repro_torch import api, checkpoint, convert, tree  # noqa: E402
from repro_torch.core import problems  # noqa: E402

from test_torch_sama import _np_tree, _quickstart_data  # noqa: E402


def _linear(th, x):
    return x @ th["w"] + th["b"]


def _batches():
    d, batches = _quickstart_data()

    def it(torch_side):
        i = 0
        while True:
            base, meta = batches(i)
            i += 1
            if torch_side:
                yield tree.tree_map(torch.from_numpy, base), tree.tree_map(torch.from_numpy, meta)
            else:
                yield (jax.tree_util.tree_map(jnp.asarray, base),
                       jax.tree_util.tree_map(jnp.asarray, meta))

    return d, it


def _pair(base_opt, method="sama", unroll=2, checkpoint_dir=None):
    """A JAX and a port learner on the quickstart problem, each initialized
    on its own, the JAX one after two meta steps."""
    d, it = _batches()
    kw = dict(base_opt=base_opt, base_lr=1e-2, meta_opt="adam", meta_lr=1e-2, method=method,
              unroll_steps=unroll)
    jlearner = japi.MetaLearner(jproblems.make_data_optimization_spec(
        jproblems.softmax_per_example(_linear), reweight=True), **kw)
    jlearner.init({"w": jnp.zeros((d, 2)), "b": jnp.zeros((2,))},
                  jproblems.init_data_optimization_lam(jax.random.PRNGKey(3), reweight=True))
    jlearner.fit(it(False), steps=2)
    tlearner = api.MetaLearner(problems.make_data_optimization_spec(
        problems.softmax_per_example(_linear), reweight=True), checkpoint_dir=checkpoint_dir,
        **kw)
    tlearner.init({"w": torch.zeros((d, 2)), "b": torch.zeros(2)},
                  problems.init_data_optimization_lam(3, reweight=True, device="cpu"))
    return jlearner, tlearner, it


def _assert_equal_states(tstate, jstate):
    jflat = jax.tree_util.tree_flatten_with_path(_np_tree(jstate))[0]
    names, leaves = tree.flatten_with_keys(convert.state_to_numpy(tstate))
    assert names == [jax.tree_util.keystr(p) for p, _ in jflat]
    for name, got, (_, want) in zip(names, leaves, jflat):
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("base_opt", ["adam", "adafactor"])
def test_leaf_names_are_jax_keystr_paths(base_opt):
    jlearner, tlearner, _ = _pair(base_opt)
    names, _ = tree.flatten_with_keys(tlearner.state)
    jflat = jax.tree_util.tree_flatten_with_path(jlearner.state)[0]
    assert names == [jax.tree_util.keystr(p) for p, _ in jflat]
    assert ".base_opt_state.count" in names and ".step" in names
    if base_opt == "adafactor":
        assert tlearner.state.base_opt_state.mu is None
        assert ".base_opt_state.nu['w']['r']" in names and ".base_opt_state.nu['b']['v']" in names


@pytest.mark.parametrize("base_opt", ["adam", "adafactor"])
def test_jax_checkpoint_restores_into_the_port(base_opt, tmp_path):
    jlearner, tlearner, _ = _pair(base_opt)
    path = jlearner.save(str(tmp_path / "jax_ck"))
    state = tlearner.load(path)
    _assert_equal_states(state, jlearner.state)
    assert int(state.step) == 2 and state.step.dtype == torch.int32


@pytest.mark.parametrize("base_opt", ["adam", "adafactor"])
def test_port_checkpoint_restores_into_jax(base_opt, tmp_path):
    jlearner, tlearner, it = _pair(base_opt)
    tlearner.fit(it(True), steps=3)
    path = tlearner.save(str(tmp_path / "torch_ck"), meta={"note": "port"})
    state = jlearner.load(path)
    _assert_equal_states(tlearner.state, state)
    _, manifest = jcheckpoint.restore(path, jlearner.state)
    assert manifest["step"] == 3 and manifest["meta"] == {"method": "sama", "unroll_steps": 2,
                                                         "note": "port"}


@pytest.mark.parametrize("base_opt", ["adam", "adafactor"])
def test_port_round_trip_is_exact(base_opt, tmp_path):
    _, tlearner, it = _pair(base_opt)
    tlearner.fit(it(True), steps=2)
    before = tlearner.state
    path = str(tmp_path / "ck")
    checkpoint.save(path, before, step=2)
    after, manifest = checkpoint.restore(path, before)
    with open(os.path.join(path, checkpoint.checkpoint.MANIFEST)) as f:
        assert json.load(f) == manifest
    assert manifest["dtypes"][-1] == "int32" and manifest["shapes"][-1] == []
    b_names, b_leaves = tree.flatten_with_keys(before)
    a_names, a_leaves = tree.flatten_with_keys(after)
    assert a_names == b_names and type(after) is type(before)
    for name, x, y in zip(a_names, a_leaves, b_leaves):
        assert x.dtype == y.dtype and torch.equal(x, y), name


def test_restore_takes_the_like_trees_dtype(tmp_path):
    tree_ = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3) / 7,
             "h": torch.tensor([1.5, -2.25], dtype=torch.bfloat16)}
    checkpoint.save(str(tmp_path), tree_)
    got, manifest = checkpoint.restore(str(tmp_path), tree_)
    assert manifest["dtypes"] == ["float32", "float32"]  # bf16 saved as f32, exactly
    assert got["h"].dtype == torch.bfloat16 and torch.equal(got["h"], tree_["h"])
    assert torch.equal(got["a"], tree_["a"])


def test_shape_and_name_mismatches_raise(tmp_path):
    theta = {"w": torch.zeros((3, 2)), "b": torch.zeros(2)}
    checkpoint.save(str(tmp_path), theta)
    with pytest.raises(ValueError, match=r"\['w'\]: shape"):
        checkpoint.restore(str(tmp_path), {"w": torch.zeros((2, 3)), "b": torch.zeros(2)})
    with pytest.raises(ValueError, match="structure mismatch"):
        checkpoint.restore(str(tmp_path), {"w": torch.zeros((3, 2)), "c": torch.zeros(2)})


def test_load_cross_checks_method_and_unroll(tmp_path):
    _, tlearner, _ = _pair("adam", checkpoint_dir=str(tmp_path))
    path = tlearner.save()
    assert path == str(tmp_path / "step_000000")
    for kw, key in (({"method": "sama_na"}, "method"), ({"unroll": 3}, "unroll_steps")):
        _, other, _ = _pair("adam", **kw)
        with pytest.raises(ValueError, match=f"saved with {key}="):
            other.load(path)
    _, empty, _ = _pair("adam", checkpoint_dir=str(tmp_path / "none"))
    with pytest.raises(FileNotFoundError):
        empty.load()


def test_fit_save_every_writes_step_dirs_and_latest_step(tmp_path):
    _, tlearner, it = _pair("adam", checkpoint_dir=str(tmp_path))
    tlearner.fit(it(True), steps=5, save_every=2)
    assert sorted(os.listdir(tmp_path)) == ["step_000002", "step_000004"]
    assert checkpoint.latest_step(str(tmp_path)) == str(tmp_path / "step_000004")
    assert checkpoint.latest_step(str(tmp_path / "missing")) is None
    state_5 = tlearner.state
    tlearner.load()  # the newest: step 4
    assert int(tlearner.state.step) == 4 and int(state_5.step) == 5
    with pytest.raises(ValueError, match="needs a checkpoint_dir"):
        _pair("adam")[1].fit(it(True), steps=1, save_every=1)


def test_train_cli_ckpt_smoke_on_cpu(tmp_path, capsys):
    from repro_torch.launch import train

    ck = str(tmp_path / "ck")
    train.main(["--arch", "bert-base", "--smoke", "--device", "cpu", "--steps", "2",
                "--log-every", "1", "--batch", "4", "--seq", "16", "--ckpt", ck])
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r.get("step") for r in rows[:2]] == [0, 1]
    assert rows[2] == {"checkpoint": os.path.join(ck, "step_000002")}
    with open(os.path.join(ck, "step_000002", "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["step"] == 2
    assert manifest["meta"] == {"method": "sama", "unroll_steps": 2, "arch": "bert-base"}
    assert manifest["names"][0].startswith(".theta[")
