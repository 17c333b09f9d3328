"""Build and load the port's CUDA kernels (``csrc/*.cu``), and check their
arguments around a launch.

The sources are compiled for Hopper (``sm_90a``) by ``nvcc`` into one
shared library with a plain C interface, bound with ``ctypes``: one ``nvcc``
per source, all started together, then one link.  The library lands in
``build/kernels/<hash>/`` at the repo root, where the hash covers the
sources and the flags, so an edited source is rebuilt and an unchanged one
is reused.  Nothing is built at import time: the first kernel call (or an
explicit ``library()``) builds.  A missing ``nvcc`` or a failed build
raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("gp_score.cu", "gp_grad.cu", "rff_features.cu", "rff_grad.cu", "sqexp.cu")
HEADERS = ("common.cuh", "proj.cuh")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
#: -fno-gnu-unique keeps each library's template statics (the kernels'
#: one-time shared-memory opt-ins) its own when two builds of the library
#: are loaded in one process, as scripts/kernel_bits.py loads another tree's.
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xcompiler", "-fno-gnu-unique",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double
SIGNATURES = {
    "fz_score_resident": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F, _P),
    "fz_score_tiled": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _D, _D, _D, _P),
    "fz_grad_resident": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _P),
    "fz_grad_tiled": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P),
    "fz_score_single_resident": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _P),
    "fz_score_single_tiled": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _D, _D, _D, _P),
    "fz_grad_single_resident": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P),
    "fz_grad_single_tiled": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _P),
    "fz_rff_features": (_P, _P, _P, _P, _I, _I, _I, _F, _P),
    "fz_rff_grad": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    "fz_sqexp": (_P, _P, _P, _I, _I, _I, _I, _F, _P),
}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch need the CUDA toolkit")
    return found


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (if needed) and return the path of the shared library."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / "libfzoos_kernels.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs, procs = [], []
        for name in SOURCES:
            obj = Path(tmp) / (Path(name).stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
            procs.append((name, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
            objs.append(str(obj))
        failed = []
        for name, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}:\n{log}")
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        tmp_lib = Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with typed entry points."""
    lib = ctypes.CDLL(str(build()))
    for fn, argtypes in SIGNATURES.items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    lib.fz_error_string.argtypes = [ctypes.c_int]
    lib.fz_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = library().fz_error_string(err).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err} ({msg})")

def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the plain-version path);
    False when all lie on one CUDA device; raises otherwise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"kernel inputs lie on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"kernel inputs must lie on the CPU or a CUDA device, not {dev}")
    return False


def check_inputs(name: str, shapes: dict[str, tuple[torch.Tensor, tuple[int, ...]]]) -> None:
    """Each tensor must be f32, contiguous and of its expected shape."""
    for arg, (t, shape) in shapes.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def stream() -> int:
    """The current CUDA stream: under a graph capture the capture stream,
    so the launch is recorded into the graph."""
    return torch.cuda.current_stream().cuda_stream
