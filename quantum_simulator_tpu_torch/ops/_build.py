"""Build and load the port's CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles every ``.cu`` file of ``quantum_simulator_tpu_torch/csrc``
into one shared library with a plain C interface, for ``sm_90a``, on first
use; ``ctypes`` loads it. The library lands in
``build/torch_kernels/<hash of the sources>/`` at the root of the checkout,
so an edit to any source rebuilds and an unchanged tree reuses the build.
The ``nvcc`` log (``-Xptxas -v``: registers, shared memory and spills per
kernel) is kept beside it as ``nvcc.log``.

Nothing here runs at import: the CPU tests import every module, and this
host has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "torch_kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C entry points: (x, y, op, K, complex, n_outer, so, n_mid, sm, n_inner,
# S, op_stride, bit_stride, plane_stride, stream) -> cudaError_t.
_ENTRY_POINTS = ("qs_dense_axis", "qs_cross_bit_axis")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def build() -> Path:
    """Compile the kernels if this source hash has no library yet."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / "libqs_kernels.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libqs_kernels.{os.getpid()}.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(p) for p in sorted(CSRC.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out_dir / "nvcc.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                           + proc.stderr[-6000:])
    os.replace(tmp, lib)  # atomic: concurrent builders never see half a file
    return lib


def build_log() -> str:
    """The ``nvcc`` output of the current build (after ``build()``)."""
    return (BUILD_ROOT / source_hash() / "nvcc.log").read_text()


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    for name in _ENTRY_POINTS:
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                       + [ctypes.c_longlong] * 9 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.qs_error_string.argtypes = [ctypes.c_int]
    lib.qs_error_string.restype = ctypes.c_char_p
    lib.qs_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.qs_smem_bytes.restype = ctypes.c_longlong
    return lib


def error_string(code: int) -> str:
    return library().qs_error_string(code).decode()
