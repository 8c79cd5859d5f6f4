"""Build and bind the CUDA fixedpoint kernel (``csrc/fixedpoint.cu``)
through the port's shared build module (:mod:`repro_torch.kernels._build`).
Nothing here runs at import time."""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels._build import Library

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

LIBRARY = Library("fixedpoint", Path(__file__).resolve().with_name("csrc"),
                  ("fixedpoint.cu",), {
                      "fixedpoint_decode": (_P, _I, _I, _I, _I, _F, _F, _I,
                                            _P, _P),
                  })

