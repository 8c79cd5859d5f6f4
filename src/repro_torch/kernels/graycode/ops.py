"""Public wrapper: a parent bit string -> its whole population as packed
words.

``generate_population_packed(parent_bits)`` takes the (N,) int8 0/1
parent and returns its 2N-1 children as (2N-1, W) words, W = ceil(N/32),
in the layout of ``core.encoding.pack_bits`` (uint32 values held in
int64, MSB-first, pad bits zero).

``graycode_children(parent_bits, starts, ends)`` is the kernel's own
interface, as the TPU kernel's: the children of any (K,) Gray segments
[start, end), e.g. a subset of the population's.

Where the parent lives decides how they run.  On a CUDA tensor the wrapper
launches ``graycode_kernel`` (``csrc/graycode.cu``) or raises; on a CPU
tensor it runs :func:`graycode_children_plain`, the kernel's arithmetic
with tensor operations.  No path falls back from one to the other.
``launches`` counts the kernel's launches.
"""
from __future__ import annotations

import torch

from repro_torch.core.cache import get_cache
from repro_torch.core.encoding import Encoding, pack_bits
from repro_torch.core.population import table_on
from repro_torch.kernels._plain import child_levels

launches = 0

MAX_SMEM = 48 * 1024      # shared memory for the parent's words, no opt-in

# the segment bounds as int32 on each device, per string length
_BOUNDS = get_cache("graycode.bounds", maxsize=32)


def graycode_children_plain(parent_bits: torch.Tensor, starts: torch.Tensor,
                            ends: torch.Tensor) -> torch.Tensor:
    """(N,) parent + (K,) Gray segments [start, end) -> (K, W) children
    words: the parent's binary words XOR each word's slice of the segment
    pattern (``_plain.child_levels`` with one 32-bit field per word),
    pad bits zeroed."""
    n = parent_bits.shape[-1]
    words = pack_bits(parent_bits)                              # (W,)
    w = words.shape[-1]
    out = child_levels(words, starts, ends, Encoding(w, 32))
    valid = (n - 32 * torch.arange(w, device=words.device)).clamp(0, 32)
    one = torch.ones((), dtype=torch.int64, device=words.device)
    return out & (0xFFFFFFFF ^ ((one << (32 - valid)) - 1))


def _bounds_on(n_bits: int, device: torch.device):
    def build():
        table = table_on("table", n_bits, device)
        return (table[:, 0].to(torch.int32).contiguous(),
                table[:, 1].to(torch.int32).contiguous())

    return _BOUNDS.get((n_bits, str(device)), build)


def _launch(parent_bits: torch.Tensor, starts: torch.Tensor,
            ends: torch.Tensor) -> torch.Tensor:
    global launches
    from repro_torch.kernels.graycode.kernel import LIBRARY

    n = parent_bits.shape[0]
    w = (n + 31) // 32
    if w * 4 > MAX_SMEM:
        raise ValueError(f"N={n} exceeds the kernel's shared-memory budget")
    dev = parent_bits.device
    parent = parent_bits.to(torch.int8).contiguous()
    if parent.data_ptr() % 16:      # the kernel loads 16 bytes at a time
        parent = parent.clone()
    starts = starts.to(device=dev, dtype=torch.int32).contiguous()
    ends = ends.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty((starts.shape[0], w), dtype=torch.int64, device=dev)
    err = LIBRARY.load().graycode_children(
        parent.data_ptr(), n, w, starts.data_ptr(), ends.data_ptr(),
        starts.shape[0], out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"graycode launch failed: CUDA error {err}")
    launches += 1
    return out


def graycode_children(parent_bits: torch.Tensor, starts: torch.Tensor,
                      ends: torch.Tensor) -> torch.Tensor:
    """(N,) int8 parent + (K,) Gray segments [start, end), K >= 1 ->
    (K, W) int64 packed children."""
    if parent_bits.dim() != 1 or parent_bits.shape[0] < 1:
        raise ValueError(f"parent_bits must be (N,) with N >= 1, got "
                         f"{tuple(parent_bits.shape)}")
    if starts.dim() != 1 or starts.shape != ends.shape or not starts.numel():
        raise ValueError(f"starts and ends must be (K,) with K >= 1, got "
                         f"{tuple(starts.shape)} and {tuple(ends.shape)}")
    if parent_bits.is_cuda:
        return _launch(parent_bits, starts, ends)
    if parent_bits.device.type != "cpu":
        raise ValueError(f"graycode runs on CUDA or CPU tensors, got "
                         f"{parent_bits.device}")
    return graycode_children_plain(parent_bits, starts, ends)


def generate_population_packed(parent_bits: torch.Tensor) -> torch.Tensor:
    """(N,) int8 parent -> (2N-1, W) int64 packed children."""
    if parent_bits.dim() != 1 or parent_bits.shape[0] < 1:
        raise ValueError(f"parent_bits must be (N,) with N >= 1, got "
                         f"{tuple(parent_bits.shape)}")
    return graycode_children(
        parent_bits, *_bounds_on(parent_bits.shape[0], parent_bits.device))
