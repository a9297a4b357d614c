"""The port's host C: the union-find decoder (and the C module's counts
dicts and bit packing, which the port's Python does without).

Counterpart of ``quantum_simulator_tpu/native/__init__.py``. The source
here, ``qsim_native.c``, is a copy of the JAX package's (a CPython
extension over the buffer protocol, no NumPy C API). It is compiled with
the system C compiler (``$CC``, default ``gcc``) against this Python's
headers at first use, never at import, into
``build/native/<hash of the source, flags and Python>/`` at the root of
the checkout; the compiler writes a file named after its process and an
atomic rename publishes it, so concurrent first builds (test workers)
never load half a file.

``native_module()`` returns the loaded module, or ``None`` when it cannot
be built (callers then take their pure-Python twins);
``native_module(required=True)`` raises instead, for the places where a
silent fallback would hide the host hot loop (the card's check in
``tests/test_torch_gpu.py``).
"""

from __future__ import annotations

import functools
import hashlib
import importlib.util
import logging
import os
import subprocess
import sys
import sysconfig
from pathlib import Path

logger = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parent / "qsim_native.c"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
CFLAGS = ("-O2", "-shared", "-fPIC")
_SUFFIX = sysconfig.get_config_var("EXT_SUFFIX") or ".so"


def _include() -> str:
    return sysconfig.get_paths()["include"]


def build_dir() -> Path:
    """Where this source, these flags and this Python build to."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join((*CFLAGS, _include(), _SUFFIX,
                       sys.version)).encode())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compile ``qsim_native.c`` unless this build exists; -> the .so."""
    out_dir = build_dir()
    lib = out_dir / f"_qsim_native{_SUFFIX}"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"_qsim_native.{os.getpid()}{_SUFFIX}"
    cmd = [os.environ.get("CC", "gcc"), *CFLAGS, f"-I{_include()}",
           str(SOURCE), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True,
                       timeout=120)
    except subprocess.CalledProcessError as e:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native build failed: {' '.join(cmd)}\n"
                           f"{e.stdout}{e.stderr}") from e
    os.replace(tmp, lib)
    return lib


@functools.cache
def _load():
    """(module, None) or (None, the error), built and loaded once."""
    try:
        lib = build()
        spec = importlib.util.spec_from_file_location("_qsim_native", lib)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module, None
    except (OSError, ImportError, RuntimeError,
            subprocess.SubprocessError) as e:
        logger.info("native module unavailable: %s", e)
        return None, e


def native_module(required: bool = False):
    """The loaded C extension, built on first call. ``None`` when it
    cannot be built or loaded, unless ``required`` (then it raises)."""
    module, error = _load()
    if module is None and required:
        raise RuntimeError(f"the native module is unavailable: {error}")
    return module
