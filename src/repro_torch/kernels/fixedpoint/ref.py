"""Plain PyTorch oracle for the fixedpoint kernel: unpack the words to a
bit array and decode it with ``core.encoding``."""
from __future__ import annotations

import torch

from repro_torch.core.encoding import Encoding, decode, unpack_bits


def fixedpoint_decode_ref(words: torch.Tensor, enc: Encoding) -> torch.Tensor:
    """(P, W) packed words -> (P, n_vars) float32."""
    return decode(unpack_bits(words, enc.n_bits), enc)
