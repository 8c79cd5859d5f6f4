"""Public wrapper: packed children -> float32 search points.

``decode_packed(words, enc)`` takes (P, W) words in the layout of
``core.encoding.pack_bits`` (what ``graycode.ops.generate_population_packed``
returns) and returns (P, n_vars) float32 points, ``lo + level * scale``
with the multiply and the add rounded separately (``core.encoding.decode``
bit for bit).

Where the words live decides how it runs.  On a CUDA tensor the wrapper
launches ``fixedpoint_kernel`` (``csrc/fixedpoint.cu``) or raises; on a CPU
tensor it runs :func:`decode_words_plain`, the kernel's arithmetic with
tensor operations.  No path falls back from one to the other.
``launches`` counts the kernel's launches.
"""
from __future__ import annotations

import torch

from repro_torch.core.encoding import Encoding, decode_levels

launches = 0


def decode_words_plain(words: torch.Tensor, enc: Encoding) -> torch.Tensor:
    """(P, W) words -> (P, n_vars) float32 by the kernel's field
    arithmetic: the word-0 part of each field shifted into place, OR the
    spill from word 1 (zero when the field does not straddle: the int64
    shift by 64 - need >= 32 empties a 32-bit word)."""
    dev = words.device
    b = enc.bits
    s0 = torch.arange(enc.n_vars, device=dev) * b
    w0 = s0 // 32
    need = s0 % 32 + b
    w = words.to(torch.int64) & 0xFFFFFFFF
    part0 = ((w[:, w0] << (s0 % 32)) & 0xFFFFFFFF) >> (32 - b)
    part1 = w[:, (w0 + 1).clamp(max=w.shape[1] - 1)] >> (64 - need)
    return decode_levels(part0 | part1, enc)


def _launch(words: torch.Tensor, enc: Encoding) -> torch.Tensor:
    global launches
    from repro_torch.kernels.fixedpoint.kernel import LIBRARY

    dev = words.device
    p, w = words.shape
    src = words.to(torch.int64).contiguous()
    out = torch.empty((p, enc.n_vars), dtype=torch.float32, device=dev)
    scale = float(torch.tensor(enc.scale, dtype=torch.float32))
    lo = float(torch.tensor(enc.lo, dtype=torch.float32))
    err = LIBRARY.load().fixedpoint_decode(
        src.data_ptr(), p, w, enc.n_vars, enc.bits, lo, scale,
        torch.cuda.get_device_properties(dev).multi_processor_count,
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"fixedpoint launch failed: CUDA error {err}")
    launches += 1
    return out


def decode_packed(words: torch.Tensor, enc: Encoding) -> torch.Tensor:
    """(P, W) packed words -> (P, n_vars) float32."""
    if words.dim() != 2 or words.dtype.is_floating_point:
        raise ValueError(f"words must be a (P, W) integer tensor, got "
                         f"{tuple(words.shape)} {words.dtype}")
    if not 1 <= enc.bits <= 32:
        raise ValueError(f"decode takes 1..32 bits per variable, got "
                         f"{enc.bits}")
    if words.shape[1] * 32 < enc.n_bits:
        raise ValueError(f"{words.shape[1]} words hold fewer than the "
                         f"{enc.n_bits} bits of {enc}")
    if words.is_cuda:
        return _launch(words, enc)
    if words.device.type != "cpu":
        raise ValueError(f"fixedpoint runs on CUDA or CPU tensors, got "
                         f"{words.device}")
    return decode_words_plain(words, enc)
