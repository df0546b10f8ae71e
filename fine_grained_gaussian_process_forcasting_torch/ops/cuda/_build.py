"""Build the hand-written CUDA kernels on first use and bind them with ctypes.

Each ``csrc/<name>.cu`` exposes plain ``extern "C"`` launchers that return
the launch's ``cudaError_t``.  It is compiled by ``nvcc`` for ``sm_90a`` into
``build/torch_kernels/<name>-<source hash>.so`` at the root of the checkout,
once per hash of the source and the shared ``csrc/*.cuh``; ``ptxas -v`` (registers, shared memory, spills) goes to
the ``.log`` beside it.  Nothing here includes PyTorch's headers, so a build
takes seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
SOURCES = ("fused_gp", "head_folded_attention", "flash_attention", "rbf",
           "cholesky", "small_head_attention")

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[str, object] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest = digest.hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names=SOURCES) -> dict[str, Path]:
    """Compile every source of ``names`` whose library is missing, one
    ``nvcc`` each, all started together.  Raises with the compiler's output
    if any fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: library_path(name) for name in names}
    procs = {}
    for name, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        paths[name].with_suffix(".log").write_bytes(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log.decode(errors='replace')}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def function(name: str, symbol: str, argtypes, restype=ctypes.c_int):
    """``symbol`` of the library built from ``csrc/<name>.cu`` (built first
    if missing), with its ctypes signature set."""
    key = f"{name}:{symbol}"
    fn = _fns.get(key)
    if fn is None:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build((name,))[name]))
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _fns[key] = fn
    return fn
