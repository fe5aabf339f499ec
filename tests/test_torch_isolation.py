"""The port imports neither JAX nor the JAX package (``repro``).

Only the parity tests import both.  ``repro_torch`` starts with ``repro``,
so the checks compare whole module names, not prefixes.
"""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = """
import importlib, pkgutil, sys
sys.path.insert(0, %r)
sys.path.insert(0, %r)
import repro_torch
for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(mod.name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print("ok", len([m for m in sys.modules if m.startswith("repro_torch")]))
""" % (str(ROOT / "src"), str(ROOT))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
