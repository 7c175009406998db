"""The PyTorch port stands alone: neither the package nor ``chip_smoke.py``
imports JAX or the JAX package, importing the package loads neither and
builds no kernel, and ``chip_smoke.py`` refuses to run without a card."""

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
    return sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]


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
