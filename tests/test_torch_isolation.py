"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package; the package imports with
``jax`` unavailable; and its entry points refuse to run on a missing card
instead of carrying on on the CPU.
"""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_no_jax_or_reference_import_anywhere_in_the_port():
    files = _port_files()
    assert len(files) > 15
    bad = [(str(p.relative_to(ROOT)), mod) for p in files for mod in _imports(p)
           if mod.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_package_imports_with_jax_unavailable():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import repro_torch, repro_torch.serve, repro_torch.convert\n"
            "import repro_torch.launch.serve, repro_torch.kernels.build\n"
            "import repro_torch.api, repro_torch.core, repro_torch.data\n"
            "import repro_torch.launch.train, repro_torch.optim\n"
            "from repro_torch.models import Model\n"
            "from repro_torch import configs\n"
            "m = Model(configs.get_smoke_config('gemma3-1b'), device='cpu')\n"
            "assert not any(k == 'jax' or k.startswith('jax.') for k in sys.modules\n"
            "               if sys.modules[k] is not None)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_model_without_device_raises_without_a_card(monkeypatch):
    from repro_torch import configs
    from repro_torch.models import Model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(configs.get_smoke_config("gemma3-1b"))
    assert Model(configs.get_smoke_config("gemma3-1b"), device="cpu").device.type == "cpu"


def _batch_iterator(**kw):
    from repro_torch import data

    arrays = {"tokens": np.zeros((4, 3), np.int32), "y": np.zeros(4, np.int32)}
    base, meta = next(data.BatchIterator(arrays, arrays, batch_size=2, meta_batch_size=2,
                                         unroll=1, **kw))
    return {"base": base, "meta": meta}


@pytest.mark.parametrize("entry", ["init_params", "init_cache", "params_from_jax",
                                   "bert_init_params", "Model.init", "init_data_optimization_lam",
                                   "BatchIterator"])
def test_lower_entry_points_default_to_cuda_and_raise_without_a_card(monkeypatch, entry):
    from repro_torch import configs, convert
    from repro_torch.core import problems
    from repro_torch.models import Model
    from repro_torch.models import common as cm
    from repro_torch.models import transformer as tf

    cfg = configs.get_smoke_config("gemma3-1b")
    bert = configs.get_smoke_config("bert-base")
    call = {"init_params": lambda **kw: tf.init_params(cfg, 0, **kw),
            "init_cache": lambda **kw: tf.init_cache(cfg, 1, 8, **kw),
            "params_from_jax": lambda **kw: convert.params_from_jax(
                {"w": np.zeros((2, 3), np.float32)}, **kw),
            "bert_init_params": lambda **kw: tf.init_params(bert, 0, **kw),
            "Model.init": lambda **kw: Model(bert, **kw).init(0),
            "init_data_optimization_lam": lambda **kw: problems.init_data_optimization_lam(
                0, **kw),
            "BatchIterator": _batch_iterator}[entry]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
    leaves = cm.tree_flatten(call(device="cpu"))[0]
    assert leaves and all(x.device.type == "cpu" for x in leaves)


def test_train_cli_without_device_raises_without_a_card(monkeypatch):
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        train.main(["--arch", "bert-base", "--smoke", "--steps", "1"])


def test_cli_without_device_raises_without_a_card(monkeypatch, capsys):
    from repro_torch.launch import serve as cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        cli.main(["--smoke", "--requests", "1"])
    cli.main(["--smoke", "--device", "cpu", "--requests", "2", "--prompt-len", "6",
              "--gen", "3", "--slots", "2", "--page-size", "4"])
    out = capsys.readouterr().out
    assert '"statuses": {"ok": 2}' in out and '"device": "cpu"' in out


def test_kernel_build_names_by_content_and_needs_nvcc(monkeypatch, tmp_path):
    from repro_torch.kernels import build

    assert sorted(build.SOURCES) == ["adafactor_adapt", "adam_adapt", "flash_attn_bwd",
                                     "flash_attn_fwd", "flash_decode", "lion_adapt",
                                     "weighted_ce"]
    source = build.SOURCES["flash_decode"]
    first = build._target(source)
    assert first.parent == build.BUILD_DIR and first.name.startswith("libflash_decode-")
    edited = tmp_path / "flash_decode.cu"
    edited.write_text(source.read_text() + "\n// edit\n")
    assert build._target(edited) != first  # an edit never reuses a stale build
    # a shared header is part of every source's hash
    header = build.CSRC / "attn_common.cuh"
    monkeypatch.setattr(build.CSRC.__class__, "glob",
                        lambda self, pat: [tmp_path / "h.cuh"] if pat == "*.cuh" else [])
    (tmp_path / "h.cuh").write_text(header.read_text() + "// edit\n")
    assert build._target(source) != first
    monkeypatch.undo()
    with pytest.raises(ValueError, match="no kernel source"):
        build.build("no_such_kernel")
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card_and_prints_no_result(tmp_path, alone):
    """Without CUDA, and in a directory holding nothing else of the repo,
    chip_smoke.py exits non-zero and prints no result line."""
    script = ROOT / "chip_smoke.py"
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script = tmp_path / "chip_smoke.py"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, str(script)], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
