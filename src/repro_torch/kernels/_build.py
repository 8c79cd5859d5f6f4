"""Build the port's CUDA sources with ``nvcc`` and bind them with ``ctypes``.

Each kernel package names its library here as a :class:`Library`: the
``.cu`` file that is compiled, the headers it includes, and the argument
types of its C entry points.  A library is compiled at first use for
``sm_90a`` into a shared object with a plain C interface, in
``build/repro_torch/`` at the repository root, under a name keyed by a
hash of its sources, the shared headers of ``kernels/csrc/``, the
common flags and its own (a library, an include path), so an edited source builds anew and an unchanged one is loaded as
it is.  Nothing here runs at import time: the CPU tests import the
kernel modules on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from repro_torch.core.cache import get_cache

SHARED = Path(__file__).resolve().with_name("csrc")   # dgo_device.cuh
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

_LIBS = get_cache("kernels.library", maxsize=16)


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, else ``/usr/local/cuda/bin``,
    else the ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's "
                           "kernels are built from source at first use")
    return found


@dataclasses.dataclass(frozen=True)
class Library:
    """One kernel package's shared library.

    ``sources[0]`` is the file handed to ``nvcc``; the rest are the
    package's headers, hashed with it.  ``signatures`` maps each C entry
    point to its ``ctypes`` argument types (every entry point returns a
    ``cudaError_t`` as ``int``).  ``flags`` are this library's extra
    ``nvcc`` flags, after the common ones (e.g. ``-lcuda``)."""

    name: str
    csrc: Path
    sources: tuple[str, ...]
    signatures: dict = dataclasses.field(hash=False, compare=False)
    flags: tuple[str, ...] = ()

    def path(self) -> Path:
        h = hashlib.sha256(" ".join(NVCC_FLAGS + self.flags).encode())
        files = [self.csrc / s for s in self.sources] + sorted(
            SHARED.glob("*.cuh"))
        for f in files:
            h.update(f.name.encode())
            h.update(f.read_bytes())
        return BUILD_DIR / f"lib{self.name}_{h.hexdigest()[:16]}.so"

    def build(self) -> tuple[Path, str]:
        """Compile the library unless it is already built; returns its
        path and the compiler's ``-Xptxas -v`` report ("" when it was
        built before).  Raises ``RuntimeError`` with the compiler output
        on failure."""
        out = self.path()
        if out.is_file():
            return out, ""
        out.parent.mkdir(parents=True, exist_ok=True)
        # compile to a private name, then rename: concurrent builds
        # never load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(SHARED), "-o", tmp,
               str(self.csrc / self.sources[0]), *self.flags]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, out)
        return out, proc.stdout + proc.stderr

    def load(self) -> ctypes.CDLL:
        """The built library with every entry point's argument types set.
        The first call of a process hashes the sources (and builds them
        if needed); later calls return the same handle."""

        def open_lib() -> ctypes.CDLL:
            path, _ = self.build()
            lib = ctypes.CDLL(str(path))
            for fn_name, argtypes in self.signatures.items():
                fn = getattr(lib, fn_name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            return lib

        return _LIBS.get(self.name, open_lib)


def build_all(libraries) -> list[tuple[Path, str]]:
    """Build several libraries at once, one ``nvcc`` process each, all
    started together; returns each one's ``(path, report)`` in order."""
    libraries = list(libraries)
    with ThreadPoolExecutor(max_workers=max(len(libraries), 1)) as pool:
        return list(pool.map(lambda lib: lib.build(), libraries))
