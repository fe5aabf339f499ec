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
    return (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "examples").glob("torch_*.py")))


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
import glob, importlib.util
for path in sorted(glob.glob(%r)):
    spec = importlib.util.spec_from_file_location("example", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print("ok", len([m for m in sys.modules if m.startswith("repro_torch")]))
""" % (str(ROOT / "src"), str(ROOT), str(ROOT / "examples" / "torch_*.py"))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("module", ["models/ssd.py", "models/transformer.py",
                                    "models/decoding.py", "models/model.py",
                                    "models/blocks.py", "convert.py",
                                    "launch/cost.py", "launch/dryrun.py",
                                    "hw/energy.py"])
def test_the_family_modules_are_checked(module):
    """The modules of the SSM, hybrid, encoder-decoder and VLM families and
    the tools are among the files the source check walks."""
    assert PORT / module in _port_files()


@pytest.mark.parametrize("example", ["torch_quickstart.py",
                                     "torch_serve_decode.py",
                                     "torch_train_lm.py",
                                     "torch_directcast_inference.py"])
def test_the_examples_are_checked(example):
    """The port's examples are among the files the source check walks."""
    assert ROOT / "examples" / example in _port_files()


@pytest.mark.parametrize("module", ["launch/mesh.py", "core/sharding.py",
                                    "runtime/compress.py",
                                    "runtime/pipeline_par.py",
                                    "train/step.py", "optim/adamw.py",
                                    "models/blocks.py",
                                    "models/transformer.py"])
def test_the_multi_gpu_modules_are_checked(module):
    """The sharding modules are among the files the source check walks,
    and importing each (with the rest of the port) loads no JAX."""
    assert PORT / module in _port_files()
    name = "repro_torch." + module[:-3].replace("/", ".")
    code = (f"import sys; sys.path.insert(0, {str(ROOT / 'src')!r}); "
            f"import {name}; "
            "bad = [m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]; "
            "assert not bad, bad; print('ok')")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("helper", ["torch_dist", "torch_sharded_ranks",
                                    "torch_moe_ranks", "torch_family_ranks",
                                    "torch_train_ranks",
                                    "torch_moe_train_ranks",
                                    "torch_family_train_ranks"])
def test_the_rank_helpers_load_no_jax(helper):
    """What a gloo rank of the sharding tests imports (``tests/<helper>``)
    loads neither JAX nor the JAX package, so the ranks start fast and
    run the port alone."""
    code = (f"import sys; sys.path.insert(0, {str(ROOT / 'src')!r}); "
            f"sys.path.insert(0, {str(ROOT / 'tests')!r}); "
            f"import {helper}; "
            "bad = [m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]; "
            "assert not bad, bad; print('ok')")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
