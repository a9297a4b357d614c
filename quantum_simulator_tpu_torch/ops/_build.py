"""Build and load the port's CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles every ``.cu`` file of ``quantum_simulator_tpu_torch/csrc``
for ``sm_90a`` on first use, one process per source, all started together,
and links the objects into one shared library with a plain C interface;
``ctypes`` loads it. The library lands in
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
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "torch_kernels"

ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# C entry points: (x, op, K, complex, rows, vec, n_outer, so, n_mid, sm,
# n_inner, S, op_stride, bit_stride, plane_stride, n_batch, x_batch_stride,
# op_batch_stride, stream) -> cudaError_t; the kernel writes its result
# over x. The ``_f64`` ones take float64 state and operator.
_ENTRY_POINTS = ("qs_dense_axis", "qs_cross_bit_axis", "qs_dense_axis_f64",
                 "qs_cross_bit_axis_f64")
# ``qs_diag_pair`` (``csrc/diag_pair.cu``): (x, d, f64, form, vec, n_plane,
# shift_a, size_a, shift_b, size_b, n_batch, x_batch_stride,
# d_batch_stride, stream) -> cudaError_t, the table multiplied into x.
DIAG_PAIR_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                      + [ctypes.c_longlong] * 8 + [ctypes.c_void_p])
# ``qs_swap_bits`` (``csrc/swap_bits.cu``): (x, f64, mode, geometry words,
# their count, stream) -> cudaError_t, the run of swaps applied to x.
SWAP_BITS_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                      ctypes.c_void_p]


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
    nvcc, pid = _nvcc(), os.getpid()
    tmp = out_dir / f"libqs_kernels.{pid}.so"
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [out_dir / f"{src.stem}.{pid}.o" for src in srcs]
    procs = [subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(srcs, objs)]
    logs = [p.communicate()[0] for p in procs]
    link = None
    if all(p.returncode == 0 for p in procs):
        link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                               *map(str, objs)],
                              capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
    for obj in objs:
        obj.unlink(missing_ok=True)
    (out_dir / "nvcc.log").write_text("".join(logs))
    if link is None or link.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + "".join(logs)[-6000:])
    os.replace(tmp, lib)  # atomic: concurrent builders never see half a file
    return lib


def build_log() -> str:
    """The ``nvcc`` output of the current build (after ``build()``)."""
    return (BUILD_ROOT / source_hash() / "nvcc.log").read_text()


_LOAD_LOCK = threading.Lock()


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call. Threads that launch
    at once (the bridge's loop, a controller's worker) wait for one build:
    two in one process would write the same pid-named files."""
    with _LOAD_LOCK:
        return _load()


@functools.cache
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name in _ENTRY_POINTS:
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * 12 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.qs_diag_pair.argtypes = DIAG_PAIR_ARGTYPES
    lib.qs_diag_pair.restype = ctypes.c_int
    lib.qs_swap_bits.argtypes = SWAP_BITS_ARGTYPES
    lib.qs_swap_bits.restype = ctypes.c_int
    lib.qs_error_string.argtypes = [ctypes.c_int]
    lib.qs_error_string.restype = ctypes.c_char_p
    lib.qs_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.qs_smem_bytes.restype = ctypes.c_longlong
    lib.qs_tile_fibers.argtypes = [ctypes.c_int] * 2
    lib.qs_tile_fibers.restype = ctypes.c_int
    lib.qs_tile_fibers_f64.argtypes = [ctypes.c_int] * 2
    lib.qs_tile_fibers_f64.restype = ctypes.c_int
    lib.qs_smem_bytes_f64.argtypes = [ctypes.c_int] * 2
    lib.qs_smem_bytes_f64.restype = ctypes.c_longlong
    lib.qs_cross_path.argtypes = [ctypes.c_int] * 2 + [ctypes.c_longlong,
                                                        ctypes.c_int]
    lib.qs_cross_path.restype = ctypes.c_int
    lib.qs_cluster_tile_fibers.argtypes = []
    lib.qs_cluster_tile_fibers.restype = ctypes.c_int
    lib.qs_cluster_wave.argtypes = [ctypes.c_int]
    lib.qs_cluster_wave.restype = ctypes.c_int
    lib.qs_cluster_smem_bytes.argtypes = [ctypes.c_int]
    lib.qs_cluster_smem_bytes.restype = ctypes.c_longlong
    return lib


def error_string(code: int) -> str:
    return library().qs_error_string(code).decode()
