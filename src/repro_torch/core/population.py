"""Population generation: 2N-1 deterministic children of an N-bit parent.

Paper step 2, per child: binary -> Gray code (whole string), invert one
bit segment (segment id = child id), inverse Gray -> binary.  The
segments are the nodes of a binary segment tree over the N bit
positions, in preorder: exactly 2N-1 of them for every N.  The layout
and the tables are those of ``repro.core.population``; the stacked
multi-resolution ``ScheduleTables`` wait for the port of the folded
engine.

The (start, end) table is a host constant, so any chunk of the
population can be generated from child ids alone (the paper's "virtual
processing", and what the popstep kernel walks over).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.cache import get_cache
from repro_torch.core.encoding import binary_to_gray, gray_to_binary

# host tables and their per-device tensor copies (bounded, instrumented)
_TABLES = get_cache("population.tables", maxsize=128)


def segment_table(n_bits: int) -> np.ndarray:
    """(2N-1, 2) int32 array of [start, end) Gray segments, preorder."""
    n_bits = int(n_bits)
    return _TABLES.get(("segment_table", n_bits),
                       lambda: _build_segment_table(n_bits))


def _build_segment_table(n_bits: int) -> np.ndarray:
    segs: list[tuple[int, int]] = []

    def build(lo: int, hi: int) -> None:
        segs.append((lo, hi))
        if hi - lo > 1:
            mid = (lo + hi + 1) // 2
            build(lo, mid)
            build(mid, hi)

    build(0, n_bits)
    table = np.asarray(segs, dtype=np.int32)
    assert table.shape[0] == 2 * n_bits - 1
    return table


def segment_patterns(n_bits: int) -> np.ndarray:
    """(2N-1, N) int8: child c as a *binary-space* XOR pattern.

    Flipping Gray bit i toggles every binary bit j >= i, so inverting the
    Gray segment [s, e) toggles binary bit j by the parity of
    |{i in [s, e): i <= j}|:

        j <  s : unchanged
        j in [s,e): flipped iff (j - s) even   (alternating 1010...)
        j >= e : flipped iff (e - s) odd       (constant parity tail)

    Hence ``child = parent ^ segment_patterns(N)[c]``.
    """
    n_bits = int(n_bits)
    return _TABLES.get(("segment_patterns", n_bits),
                       lambda: _build_segment_patterns(n_bits))


def _build_segment_patterns(n_bits: int) -> np.ndarray:
    # the raw builder, NOT the memoized wrapper: _TABLES.get holds the
    # registry lock across build, so a nested get would self-deadlock
    table = _build_segment_table(n_bits)
    j = np.arange(n_bits)
    s, e = table[:, :1], table[:, 1:]
    inside = (j >= s) & (j < e)
    pat = (inside & ((j - s) % 2 == 0)) | ((j >= e) & (((e - s) % 2) == 1))
    return pat.astype(np.int8)


def table_on(name: str, n_bits: int, device) -> torch.Tensor:
    """A memoized copy on ``device`` of ``segment_table`` (``name="table"``,
    int64) or ``segment_patterns`` (``name="patterns"``, int8).  The
    patterns are computed on the device itself from the segment table
    (the rule of :func:`segment_patterns`), so a large table costs a few
    elementwise kernels, not a host build and a copy."""
    device = torch.device(device)
    n_bits = int(n_bits)
    build = {"table": lambda: _segments_on(n_bits, device),
             "patterns": lambda: _patterns_on(n_bits, device)}[name]
    return _TABLES.get((name, n_bits, str(device)), build)


def _segments_on(n_bits: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_build_segment_table(n_bits),
                           dtype=torch.int64).to(device)


def _patterns_on(n_bits: int, device: torch.device) -> torch.Tensor:
    # the raw builders, not table_on: the registry lock is held here
    table = _segments_on(n_bits, device)
    s, e = table[:, :1], table[:, 1:]
    j = torch.arange(n_bits, device=device)
    inside = (j >= s) & (j < e) & ((j - s) % 2 == 0)
    tail = (j >= e) & ((e - s) % 2 == 1)
    return (inside | tail).to(torch.int8)


def segment_mask(child_ids: torch.Tensor, n_bits: int) -> torch.Tensor:
    """(P,) child ids -> (P, N) int8 inversion masks via the segment tree."""
    table = table_on("table", n_bits, child_ids.device)
    ids = child_ids.to(torch.int64).clamp(0, 2 * n_bits - 2)
    start = table[ids, 0][:, None]
    end = table[ids, 1][:, None]
    i = torch.arange(n_bits, device=child_ids.device)[None, :]
    return ((i >= start) & (i < end)).to(torch.int8)


def generate_children(parent_bits: torch.Tensor,
                      child_ids: torch.Tensor) -> torch.Tensor:
    """Children for an arbitrary subset of ids, by the literal three-step
    transformation.  parent_bits: (N,), child_ids: (P,) -> (P, N) int8."""
    n = parent_bits.shape[-1]
    gray = binary_to_gray(parent_bits.to(torch.int8))
    masks = segment_mask(child_ids, n)
    return gray_to_binary(torch.bitwise_xor(gray[None, :], masks))


def generate_population(parent_bits: torch.Tensor) -> torch.Tensor:
    """All 2N-1 children. (N,) -> (2N-1, N) int8."""
    n = parent_bits.shape[-1]
    return generate_children(
        parent_bits, torch.arange(2 * n - 1, device=parent_bits.device))


def population_size(n_bits: int) -> int:
    return 2 * n_bits - 1
