"""Build and bind the CUDA flash-attention kernels
(``csrc/flash_attention.cu``) through the port's shared build module
(:mod:`repro_torch.kernels._build`), linked with ``libcuda`` for
``cuTensorMapEncodeTiled`` (the bf16 kernel's TMA tensor maps).  Nothing
here runs at import time."""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels._build import Library

_P = ctypes.c_void_p
_I = ctypes.c_int

LIBRARY = Library("flash_attention", Path(__file__).resolve().with_name("csrc"),
                  ("flash_attention.cu",), {
                      "flash_attention_fwd": (_P, _P, _P, _P, _I, _I, _I, _I,
                                              _I, _I, ctypes.c_float, _I, _I,
                                              _P),
                  }, flags=("-lcuda",))
