"""Fixed-point / Gray-code encoding used by DGO (PyTorch).

Each variable is an offset-binary fixed-point string over [lo, hi]; the
variables are concatenated MSB-first into one string of
N = n_vars * bits bits (the layout of ``repro.core.encoding``).  Bit
arrays are int8 tensors of 0/1 with trailing axis N.

Rounding is part of the contract, because the engines compare decoded
points and objective values against the JAX package bit for bit:

* ``encode`` computes ``round((x - lo) / span * max_level)`` in float32,
  rounding half to even, then clips;
* ``decode`` computes ``lo + level * scale`` with the multiply and the
  add rounded separately (no fused multiply-add), where ``scale`` is the
  double ``(hi - lo) / (levels - 1)`` rounded once to float32.

Python scalars are turned into float32 tensors on the operand's device
before they meet a tensor: PyTorch's CUDA division by a host scalar is a
multiply by its reciprocal, which rounds differently from a division.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Encoding:
    """Fixed-point encoding spec for an n_vars-dimensional box [lo, hi]^n."""

    n_vars: int
    bits: int
    lo: float = -10.0
    hi: float = 10.0

    @property
    def n_bits(self) -> int:
        return self.n_vars * self.bits

    @property
    def population(self) -> int:
        """Paper's population size: 2N - 1 children for an N-bit string."""
        return 2 * self.n_bits - 1

    @property
    def levels(self) -> int:
        return 2**self.bits

    @property
    def scale(self) -> float:
        """Lattice step ``(hi - lo) / (levels - 1)`` in double precision;
        every decode rounds it once to float32."""
        return (self.hi - self.lo) / (self.levels - 1)

    def with_bits(self, bits: int) -> "Encoding":
        return dataclasses.replace(self, bits=bits)


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` rounded to a float32 0-d tensor on ``like``'s device."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def _msb_weights(bits: int, device) -> torch.Tensor:
    return torch.ones((), dtype=torch.int64, device=device) << torch.arange(
        bits - 1, -1, -1, device=device)


# ---------------------------------------------------------------------------
# float <-> bit-array
# ---------------------------------------------------------------------------

def encode(x, enc: Encoding) -> torch.Tensor:
    """Float vector (..., n_vars) -> bit string (..., n_vars * bits) int8."""
    x = torch.as_tensor(x, dtype=torch.float32)
    max_level = enc.levels - 1
    level = torch.round((x - _f32(enc.lo, x)) / _f32(enc.hi - enc.lo, x)
                        * _f32(max_level, x))
    level = level.clamp(0, max_level).to(torch.int64)
    shifts = torch.arange(enc.bits - 1, -1, -1, device=x.device)
    bits = (level[..., None] >> shifts) & 1
    return bits.reshape(*x.shape[:-1], enc.n_bits).to(torch.int8)


def levels_of(bits: torch.Tensor, enc: Encoding) -> torch.Tensor:
    """Bit string (..., N) -> per-variable lattice levels (..., n_vars)
    as int64."""
    b = bits.reshape(*bits.shape[:-1], enc.n_vars, enc.bits).to(torch.int64)
    return (b * _msb_weights(enc.bits, bits.device)).sum(-1)


def decode_levels(level: torch.Tensor, enc: Encoding) -> torch.Tensor:
    """Lattice levels (..., n_vars) -> floats: ``lo + level * scale`` with
    two separately rounded float32 operations."""
    lv = level.to(torch.float32)
    return lv * _f32(enc.scale, lv) + _f32(enc.lo, lv)


def decode(bits: torch.Tensor, enc: Encoding) -> torch.Tensor:
    """Bit string (..., n_vars * bits) -> float vector (..., n_vars)."""
    return decode_levels(levels_of(bits, enc), enc)


def decode_np(bits, enc: Encoding) -> np.ndarray:
    """Numpy twin of :func:`decode` for host-side result assembly."""
    b = np.asarray(bits)
    b = b.reshape(*b.shape[:-1], enc.n_vars, enc.bits).astype(np.uint32)
    weights = (np.uint32(1) << np.arange(enc.bits - 1, -1, -1)).astype(np.uint32)
    level = (b * weights).sum(axis=-1).astype(np.float32)
    return np.float32(enc.lo) + level * np.float32(enc.scale)


def reencode(bits: torch.Tensor, enc_from: Encoding,
             enc_to: Encoding) -> torch.Tensor:
    """Re-encode a parent at a new resolution (paper step 5)."""
    return encode(decode(bits, enc_from), enc_to)


# ---------------------------------------------------------------------------
# binary <-> Gray on bit arrays (whole-string transform, per the paper)
# ---------------------------------------------------------------------------

def binary_to_gray(bits: torch.Tensor) -> torch.Tensor:
    """g[0] = b[0]; g[i] = b[i-1] XOR b[i]  (MSB-first)."""
    shifted = torch.nn.functional.pad(bits[..., :-1], (1, 0))
    return torch.bitwise_xor(bits, shifted)


def gray_to_binary(bits: torch.Tensor) -> torch.Tensor:
    """b[i] = XOR of g[0..i] — prefix-XOR == cumsum mod 2."""
    return (torch.cumsum(bits.to(torch.int32), dim=-1) % 2).to(torch.int8)


# ---------------------------------------------------------------------------
# packed words (uint32 values held in int64, MSB-first within a word)
# ---------------------------------------------------------------------------

def pack_bits(bits: torch.Tensor, n_words: int | None = None) -> torch.Tensor:
    """(..., N) 0/1 -> (..., W) words: bit i of the string lands in word
    i // 32 at bit position 31 - i % 32.  Words are uint32 values held in
    int64 (PyTorch's uint32 supports too few operations)."""
    n = bits.shape[-1]
    w = n_words if n_words is not None else (n + 31) // 32
    b = torch.nn.functional.pad(bits.to(torch.int64), (0, w * 32 - n))
    b = b.reshape(*bits.shape[:-1], w, 32)
    shifts = torch.arange(31, -1, -1, device=bits.device)
    return (b << shifts).sum(-1)


def unpack_bits(words: torch.Tensor, n: int) -> torch.Tensor:
    """(..., W) words -> (..., N) int8 of 0/1."""
    shifts = torch.arange(31, -1, -1, device=words.device)
    bits = (words.to(torch.int64)[..., None] >> shifts) & 1
    bits = bits.reshape(*words.shape[:-1], words.shape[-1] * 32)
    return bits[..., :n].to(torch.int8)
