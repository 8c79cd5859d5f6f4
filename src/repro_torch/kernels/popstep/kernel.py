"""Build and bind the CUDA popstep kernel (``csrc/popstep.cu``).

The sources are compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``.  The
library lands in ``build/repro_torch/`` at the repository root under a
name keyed by a hash of the sources and flags, so an edited source builds
anew and an unchanged one is loaded as it is.  Nothing here runs at
import time: the CPU tests import this module on machines without
``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

from repro_torch.core.cache import get_cache

CSRC = Path(__file__).resolve().with_name("csrc")
SOURCES = ("popstep.cu", "objectives.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch"

_LIBS = get_cache("popstep.library", maxsize=4)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "popstep_partials": (_P, _P, _P, _P, _I, _I, _I, _F, _F, _I, _P, _P,
                         _I, _F, _I, _I, _I, _I, _P, _P, _P),
    "popstep_fold": (_P, _P, _P, _I, _I, _I, _P, _P, _P),
}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, else ``/usr/local/cuda/bin``,
    else the ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the popstep "
                           "kernel is built from source at first use")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libpopstep_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile the library unless it is already built; returns its path
    and the compiler's ``-Xptxas -v`` report ("" when it was built
    before).  Raises ``RuntimeError`` with the compiler output on
    failure."""
    out = library_path()
    if out.is_file():
        return out, ""
    out.parent.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: concurrent builders never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / "popstep.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


def load() -> ctypes.CDLL:
    """The built library with every entry point's argument types set."""
    path, _ = build()

    def open_lib() -> ctypes.CDLL:
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        return lib

    return _LIBS.get(str(path), open_lib)
