"""Build the CUDA sources under ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` into
``build/kernels/<name>-<hash>.so`` at the repository root (gitignored),
with a plain C interface (``extern "C"`` functions returning
``cudaError_t``) loaded through ``ctypes``.  The hash covers the source,
every ``.cuh`` header and the flags, so an edit rebuilds and an unchanged
tree reuses the library.  ``build_all()`` starts one ``nvcc`` per source at
once and waits for all of them.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``-Xptxas -v`` so each kernel's
registers, shared memory and spills are on record.  No ``--use_fast_math``:
its flush-to-zero breaks ``flog2`` on subnormals and its approximate
division breaks the E3M2 step of ``encode_mxsf``.  Nothing here runs at
import time.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

__all__ = ["SOURCES", "BuildResult", "build_all", "library", "check"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("mxsf_fused_matmul", "mxsf_attention", "mxsf_quant", "mx_matmul")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass
class BuildResult:
    name: str
    path: Path
    seconds: float      # 0.0 when an earlier build was reused
    ptxas: str          # nvcc's -Xptxas -v report ("" when reused)


_LIBS: Dict[str, ctypes.CDLL] = {}
_RESULTS: Dict[str, BuildResult] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "build only on a machine with the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, BuildResult]:
    """Compile every source that has no up-to-date library, in parallel."""
    todo = {n: _target(n) for n in SOURCES
            if n not in _RESULTS and not _target(n).exists()}
    for n in SOURCES:
        if n not in _RESULTS and n not in todo:
            _RESULTS[n] = BuildResult(n, _target(n), 0.0, "")
    if not todo:
        return dict(_RESULTS)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n, out in todo.items():
        tmp = out.parent / f".{out.stem}.{os.getpid()}.so"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    failed = []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {n} (exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
        _RESULTS[n] = BuildResult(n, out, time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return dict(_RESULTS)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built at first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(_RESULTS[name].path))
        lib.mxsf_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mxsf_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str):
    """Raise if a launch returned an error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err != 0:
        msg = lib.mxsf_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")
