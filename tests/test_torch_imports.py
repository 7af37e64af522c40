"""The port's import rule: the PyTorch package, ``chip_smoke.py`` and
``profile_train_step.py`` import neither ``jax`` nor the JAX package
(``tf_1d_2d_segmentation_end2endpipelines_tpu``), whose ``__init__``
imports jax, so the port runs where JAX is not installed.

- every module of the port, imported in a fresh interpreter
  (``pkgutil.walk_packages``), leaves neither in ``sys.modules``;
- every ``import`` statement of the two scripts, at any depth (their
  phases import inside functions), names neither."""
import ast
import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "tf_1d_2d_segmentation_end2endpipelines_torch"
FORBIDDEN = ("jax", "tf_1d_2d_segmentation_end2endpipelines_tpu")

_IMPORT_ALL = f"""
import importlib, json, pkgutil, sys
import {PORT} as port
names = [port.__name__] + [m.name for m in pkgutil.walk_packages(
    port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
print(json.dumps({{"modules": names, "loaded": sorted(
    k for k in sys.modules if k.split(".")[0] in {FORBIDDEN!r})}}))
"""


def _top(name: str) -> str:
    return name.split(".")[0]


def test_every_module_of_the_port_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    got = json.loads(out.strip().splitlines()[-1])
    assert f"{PORT}.ops.onn" in got["modules"]
    assert len(got["modules"]) > 30
    assert got["loaded"] == []


def _imports(path: str):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("script", ["chip_smoke.py", "profile_train_step.py"])
def test_the_scripts_import_no_jax(script):
    names = list(_imports(os.path.join(ROOT, script)))
    assert any(_top(n) == PORT for n in names)
    assert [n for n in names if _top(n) in FORBIDDEN] == []
