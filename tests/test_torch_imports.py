"""The PyTorch port stands alone: neither the package nor ``chip_smoke.py``
(nor the sharding tests' rank helpers) imports JAX or the JAX package,
importing the package loads neither and builds no kernel, a spawned rank
of ``parallel.run_ranks`` loads neither, and ``chip_smoke.py`` refuses to
run without a card. The top level exports what the JAX package's does,
the covariance functions included."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "graphite_tpu_torch"
FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|graphite_tpu)(\.|\s|$)", re.M)


def _sources():
    return sorted(PACKAGE.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tests" / "torch_sharding_helpers.py"]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_jax_import_in_source(path):
    text = path.read_text()
    assert not FORBIDDEN.search(text), f"{path} imports JAX"
    assert "import_module(\"jax" not in text


def _run(code, cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_import_loads_no_jax_and_builds_nothing():
    code = (
        "import sys, pkgutil, importlib\n"
        "import graphite_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from graphite_tpu_torch.ops.cuda import build\n"
        "assert not build._LOADED\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'graphite_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = _run(code, ROOT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_chip_smoke_refuses_without_cuda():
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), capture_output=True,
        text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_top_level_exports_covariance():
    import graphite_tpu_torch as p
    from graphite_tpu_torch import covariance, joint_covariance, \
        marginal_covariances

    assert joint_covariance is covariance.joint_covariance
    assert marginal_covariances is covariance.marginal_covariances
    assert {"joint_covariance", "marginal_covariances"} <= set(p.__all__)


def test_spawned_rank_loads_no_jax():
    import torch_sharding_helpers as helpers

    from graphite_tpu_torch.parallel import run_ranks

    assert run_ranks(helpers.loaded_jax_modules, 1, "gloo",
                     device="cpu") == [[]]



def test_native_builds_from_its_own_sources():
    """The host library is built from ``graphite_tpu_torch/native/*.cpp``
    into ``build/graphite_tpu_torch/`` on first use (not at import), and
    using it loads no JAX, no JAX package module and no file under
    ``graphite_tpu/``."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from graphite_tpu_torch import native\n"
        "from graphite_tpu_torch.native import bal_loader, structure\n"
        "assert not native._LOADED\n"
        "assert structure.sort_unique(np.array([3, 1, 3])).tolist() "
        "== [1, 3]\n"
        "assert bal_loader.load('tests/fixtures/bal_head_real_format.txt')"
        " is not None\n"
        "for name, lib in sorted(native._LOADED.items()):\n"
        "    print(name, lib.path)\n"
        "print('SOURCES', native.NATIVE_DIR)\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert '/graphite_tpu/' not in maps\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'graphite_tpu')]\n"
        "assert not bad, bad\n")
    proc = _run(code, ROOT)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.split("\n")
    built = dict(line.split(" ", 1) for line in lines[:2])
    assert sorted(built) == ["bal_loader", "structure"]
    build_dir = ROOT / "build" / "graphite_tpu_torch"
    for name, path in built.items():
        path = Path(path)
        assert path.parent == build_dir and path.name.startswith(
            f"lib{name}-"), path
    assert lines[2] == f"SOURCES {PACKAGE / 'native'}"
    for src in (PACKAGE / "native").glob("*.cpp"):
        assert "graphite_tpu/" not in src.read_text(), src


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A source g++ refuses raises with g++'s output: no fallback."""
    from graphite_tpu_torch import native

    (tmp_path / "broken.cpp").write_text("int broken( {\n")
    monkeypatch.setattr(native, "NATIVE_DIR", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        native.load_library("broken")
    assert "error" in str(err.value)
    assert "broken" not in native._LOADED
    assert not list((tmp_path / "build").glob("*.so"))
