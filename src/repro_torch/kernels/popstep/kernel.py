"""Build and bind the CUDA popstep kernel (``csrc/popstep.cu``) through
the port's shared build module (:mod:`repro_torch.kernels._build`).  Nothing
here runs at import time."""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels._build import Library

CSRC = Path(__file__).resolve().with_name("csrc")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

LIBRARY = Library("popstep", CSRC, ("popstep.cu", "objectives.cuh"), {
    "popstep_grid": (_I, _I, ctypes.POINTER(_I)),
    "popstep_step": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F,
                     _F, _I, _P, _P, _I, _F, _I, _I, _I, _I, _I, _P, _P, _I,
                     _P, _I, _I, _P),
    "popstep_fold": (_P, _P, _P, _I, _I, _I, _P, _P, _P),
})

