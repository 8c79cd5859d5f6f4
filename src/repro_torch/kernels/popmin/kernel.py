"""Build and bind the CUDA popmin kernels (``csrc/popmin.cu``) through the
port's shared build module (:mod:`repro_torch.kernels._build`).  Nothing here
runs at import time."""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels._build import Library

_P = ctypes.c_void_p
_I = ctypes.c_int

SIGNATURES = {
    "popmin_launch": (_P, _I, _I, _P, _P, _P, _P),
    "popmin_grid": (_P,),
    "popmin_fold": (_P, _P, _I, _P, _P, _P),
}
LIBRARY = Library("popmin", Path(__file__).resolve().with_name("csrc"),
                  ("popmin.cu",), SIGNATURES)
