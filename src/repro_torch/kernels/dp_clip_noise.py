"""Fused DP clip+noise as hand-written CUDA kernels for Hopper.

Replaces the two Pallas TPU kernels of ``repro/kernels/dp_clip_noise.py``:

* :func:`sumsq_rows` — Σx² per row of the stacked client updates
  ``x [R, P]`` (counterpart of ``sumsq``, ``_sumsq_kernel``);
* :func:`scale_noise_rows` — ``o = x·scale[r] + σ·n`` (counterpart of
  ``scale_noise``, ``_scale_noise_kernel``).

The source is ``csrc/dp_clip_noise.cu``.  It has a plain C interface, is
compiled with ``nvcc`` for ``sm_90a`` at first use into ``_build/`` (named
by a hash of the source, so an edit rebuilds) and is loaded with
``ctypes``: a file without PyTorch's headers builds in seconds rather than
minutes.  Both kernels are memory-bound; the source says how they are laid
out.

A wrapper given a CPU tensor runs the plain version in ``kernels/ref.py``;
given a CUDA tensor it launches its kernel or raises.  Nothing falls back.
``LAUNCHES`` counts launches per kernel, so a run can show it went through
them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "dp_clip_noise.cu"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_ROWS = 65535  # gridDim.y of the scale_noise launch

LAUNCHES = {"sumsq_rows": 0, "scale_noise_rows": 0}

_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    for home in (os.environ.get("CUDA_HOME"), CUDA_HOME):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the dp_clip_noise kernels are "
                           "built with the CUDA toolkit at first use")
    return found


def build() -> dict:
    """Compile the kernels if this source has not been built yet.
    Returns ``{"path", "seconds", "log"}`` (``log`` holds ptxas' register
    and shared-memory report; empty when the library was already built)."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"libdp_clip_noise_{digest}.so"
    if lib_path.exists():
        return {"path": lib_path, "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path)
    return {"path": lib_path, "seconds": seconds,
            "log": proc.stdout + proc.stderr}


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()["path"]))
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.dpcn_sumsq_rows.argtypes = [ptr, ptr, i64, i64, ptr]
        lib.dpcn_sumsq_rows.restype = ctypes.c_int
        lib.dpcn_scale_noise_rows.argtypes = [ptr, ptr, ptr, ctypes.c_float,
                                              ptr, i64, i64, ptr]
        lib.dpcn_scale_noise_rows.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_rows(name: str, t: torch.Tensor, device: torch.device,
                shape=None) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed with CUDA error {err}")


def _require_cuda(x: torch.Tensor, kernel: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{kernel} takes CPU or CUDA tensors, got {x.device}")
    if x.dim() != 2:
        raise ValueError(f"{kernel} takes x [R, P], got {tuple(x.shape)}")
    if not 1 <= x.shape[0] <= MAX_ROWS:
        raise ValueError(f"{kernel} takes 1..{MAX_ROWS} rows, "
                         f"got {x.shape[0]}")


def sumsq_rows(x: torch.Tensor) -> torch.Tensor:
    """Σ x² over each row of ``x [R, P]`` f32 -> ``[R]`` f32.  Fixed
    reduction order: the same input gives the same bits every run."""
    if x.device.type == "cpu":
        return ref.sumsq_rows_ref(x)
    _require_cuda(x, "sumsq_rows")
    _check_rows("x", x, x.device)
    lib = _load()
    r, p = x.shape
    out = torch.empty(r, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _raise_on(lib.dpcn_sumsq_rows(x.data_ptr(), out.data_ptr(), r, p, stream),
              "sumsq_rows")
    LAUNCHES["sumsq_rows"] += 1
    return out


def scale_noise_rows(x: torch.Tensor, noise: torch.Tensor,
                     scale: torch.Tensor, sigma: float) -> torch.Tensor:
    """``o = x·scale[r] + σ·noise`` over ``[R, P]`` f32; ``scale [R]``."""
    if x.device.type == "cpu":
        return ref.scale_noise_rows_ref(x, noise, scale, sigma)
    _require_cuda(x, "scale_noise_rows")
    r, p = x.shape
    _check_rows("x", x, x.device)
    _check_rows("noise", noise, x.device, (r, p))
    _check_rows("scale", scale, x.device, (r,))
    lib = _load()
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _raise_on(lib.dpcn_scale_noise_rows(
        x.data_ptr(), noise.data_ptr(), scale.data_ptr(), float(sigma),
        out.data_ptr(), r, p, stream), "scale_noise_rows")
    LAUNCHES["scale_noise_rows"] += 1
    return out
