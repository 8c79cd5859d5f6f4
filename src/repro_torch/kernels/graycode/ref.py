"""Plain PyTorch oracle for the graycode kernel: generate children by the
unpacked bit-array path (``core.population``) and pack the result."""
from __future__ import annotations

import torch

from repro_torch.core.encoding import pack_bits
from repro_torch.core.population import generate_children


def graycode_children_ref(parent_bits: torch.Tensor, child_ids: torch.Tensor,
                          n_words: int) -> torch.Tensor:
    """parent_bits: (N,) int8 0/1; child_ids: (P,) -> (P, W) packed words."""
    return pack_bits(generate_children(parent_bits, child_ids), n_words)
