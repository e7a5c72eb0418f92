"""Build and load the port's CUDA sources (``csrc/<name>.cu``).

Each source has a plain C interface.  It is compiled with ``nvcc`` for
``sm_90a`` at first use into ``_build/lib<name>_<hash>.so`` (named by a hash
of the source, so an edit rebuilds) and loaded with ``ctypes``: a file
without PyTorch's headers builds in seconds rather than minutes.
:func:`build` starts one ``nvcc`` per source, all at once, and waits for
them together.  Every entry point launches on the caller's stream and
returns ``cudaGetLastError()``; :func:`raise_on` turns that into an error.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

PTR, I64, I32, F32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                      ctypes.c_float)
SMS = 132  # streaming multiprocessors of an H100 SXM: launch plans cover them

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    for home in (os.environ.get("CUDA_HOME"), CUDA_HOME):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built with the CUDA toolkit at first use")
    return found


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build(*names: str) -> Dict[str, dict]:
    """Compile each named source that has not been built yet, all ``nvcc``
    processes at once.  Returns ``{name: {"path", "seconds", "log"}}``
    (``log`` holds ptxas' register and shared-memory report; empty and 0 s
    when the library was already built)."""
    out, running = {}, {}
    for name in names:
        path = _lib_path(name)
        if path.exists():
            out[name] = {"path": path, "seconds": 0.0, "log": ""}
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, cmd, tmp, path, time.perf_counter())
    failed = []
    for name, (proc, cmd, tmp, path, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{log}")
            continue
        os.replace(tmp, path)
        out[name] = {"path": path, "seconds": seconds, "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` with ``argtypes`` set from
    ``signatures`` (every entry point returns an int CUDA error)."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)[name]["path"]))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed with CUDA error {err}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_no_grad(kernel: str, *tensors) -> None:
    """The kernels have no backward: refuse an operand that would need one,
    rather than return a result with no ``grad_fn``."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel} has no backward; differentiate the plain version "
            "(kernels/ref.py) instead")
