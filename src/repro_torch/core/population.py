"""Population generation: 2N-1 deterministic children of an N-bit parent.

Paper step 2, per child: binary -> Gray code (whole string), invert one
bit segment (segment id = child id), inverse Gray -> binary.  The
segments are the nodes of a binary segment tree over the N bit
positions, in preorder: exactly 2N-1 of them for every N.  The layout
and the tables are those of ``repro.core.population``, the stacked
multi-resolution :class:`ScheduleTables` of the schedule engines
included.

The (start, end) table is a host constant, so any chunk of the
population can be generated from child ids alone (the paper's "virtual
processing", and what the popstep kernel walks over).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.cache import get_cache
from repro_torch.core.encoding import (
    Encoding, binary_to_gray, decode, encode, gray_to_binary)

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


# ---------------------------------------------------------------------------
# stacked multi-resolution tables: the paper's step-5 escalation as data
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ResolutionEncoding(Encoding):
    """One resolution of a schedule: an :class:`Encoding` whose lattice
    step is the schedule table's float32 ``(hi - lo) / max_level``, a
    float32 division (the reference's tables round it so), in place of the
    double quotient rounded once.  The two differ by an ulp at some
    (box, bits) pairs, e.g. [-5.12, 5.12] at 14 bits."""

    step: float = 0.0

    @property
    def scale(self) -> float:
        return self.step

    def with_bits(self, bits: int) -> Encoding:
        return Encoding(self.n_vars, bits, self.lo, self.hi)


class ScheduleTables(NamedTuple):
    """The whole resolution schedule (``repro.core.population.
    ScheduleTables``): one :class:`ResolutionEncoding` a resolution and the
    small per-resolution constants, stacked along a leading schedule axis.

    At resolution ``res_bits[r]`` the live string is the first
    ``n_vars * res_bits[r]`` positions of an ``n_max``-wide bit buffer
    (position ``i`` belongs to variable ``i // res_bits[r]``, MSB-first);
    the rest is zero.

    ``r`` is a host int here: the port's engines keep the resolution index
    on the host and bind each resolution's step at its own width, so
    ``decode`` and ``encode`` are those of :mod:`~repro_torch.core.encoding`
    at ``encodings[r]`` (FMA-free, with the table's float32 step).  The
    reference stacks its decode weights, encode layout and XOR patterns
    because its ``r`` is traced; here they are built only on request, for
    the parity tests (:meth:`stacked_layout`, :meth:`stacked_patterns`):
    at the remote-sensing MLP's 4 -> 16 bit schedule the weights alone
    take 207 MB and the patterns 1.66 GB."""

    n_vars: int
    lo: float
    hi: float
    res_bits: tuple
    n_max: int               # bit-buffer width: n_vars * max(res_bits)
    p_max: int               # stacked population axis: 2 * n_max - 1
    pop: torch.Tensor        # (R,) int64 live population 2*n_vars*bits - 1
    scale: torch.Tensor      # (R,) f32 lattice step (hi - lo) / max_level
    max_level: torch.Tensor  # (R,) f32 2^bits - 1
    encodings: tuple         # (R,) ResolutionEncoding, one per resolution

    @property
    def n_res(self) -> int:
        return len(self.res_bits)

    def decode(self, bits: torch.Tensor, r: int) -> torch.Tensor:
        """(..., n_max) bit buffer (or its live prefix) -> (..., n_vars)
        floats at resolution ``r``."""
        enc = self.encodings[r]
        return decode(bits[..., :enc.n_bits], enc)

    def encode(self, x: torch.Tensor, r: int) -> torch.Tensor:
        """(..., n_vars) floats -> (..., n_max) int8 bit buffer at
        resolution ``r`` (zero past the live prefix)."""
        bits = encode(x, self.encodings[r])
        return torch.nn.functional.pad(bits, (0, self.n_max - bits.shape[-1]))

    def reencode(self, bits: torch.Tensor, r: int,
                 nxt: int) -> torch.Tensor:
        """Paper step 5: carry a parent to resolution ``nxt``'s lattice."""
        return self.encode(self.decode(bits, r), nxt)

    def children(self, bits: torch.Tensor, ids: torch.Tensor,
                 r: int) -> torch.Tensor:
        """Children ``ids`` (< p_max) of an (n_max,) parent at resolution
        ``r``: the parent XOR the resolution's pattern row, padded; a pad
        id (``>= pop[r]``) gives the parent itself."""
        n = self.encodings[r].n_bits
        pop = 2 * n - 1
        pat = table_on("patterns", n, bits.device)
        rows = pat.index_select(0, ids.clamp(max=pop - 1))
        rows = torch.where((ids < pop)[:, None], rows, 0)
        rows = torch.nn.functional.pad(rows, (0, self.n_max - n))
        return torch.bitwise_xor(bits[None, :], rows)

    def stacked_patterns(self) -> torch.Tensor:
        """(R, p_max, n_max) int8: every resolution's binary-space XOR
        patterns, zero-padded (the reference's ``patterns`` table)."""
        ids = torch.arange(self.p_max, device=self.pop.device)
        zero = torch.zeros(self.n_max, dtype=torch.int8,
                           device=self.pop.device)
        return torch.stack([self.children(zero, ids, r)
                            for r in range(self.n_res)])

    def stacked_layout(self) -> dict:
        """The reference's stacked decode weights and encode layout, as
        numpy arrays: ``wmat`` (R, n_max, n_vars) f32 MSB-first bit
        weights, ``var`` and ``shift`` (R, n_max) int64 variable id and bit
        shift per position, ``active`` (R, n_max) bool live prefix."""
        n_max, n_vars = self.n_max, self.n_vars
        out = {"wmat": np.zeros((self.n_res, n_max, n_vars), np.float32),
               "var": np.zeros((self.n_res, n_max), np.int64),
               "shift": np.zeros((self.n_res, n_max), np.int64),
               "active": np.zeros((self.n_res, n_max), bool)}
        i = np.arange(n_max)
        for r, b in enumerate(self.res_bits):
            weights = 2.0 ** np.arange(b - 1, -1, -1)
            for v in range(n_vars):
                out["wmat"][r, v * b: (v + 1) * b, v] = weights
            out["var"][r] = np.minimum(i // b, n_vars - 1)
            out["shift"][r] = np.clip(b - 1 - i % b, 0, 31)
            out["active"][r] = i < n_vars * b
        return out


def schedule_tables(n_vars: int, res_bits: tuple, lo: float, hi: float,
                    device="cpu") -> ScheduleTables:
    """Build (and memoize, one copy per schedule signature and device) the
    stacked tables for a resolution schedule ``res_bits``."""
    n_vars, lo, hi = int(n_vars), float(lo), float(hi)
    res_bits = tuple(int(b) for b in res_bits)
    device = torch.device(device)
    return _TABLES.get(("schedule_tables", n_vars, res_bits, lo, hi,
                        str(device)),
                       lambda: _build_schedule_tables(n_vars, res_bits, lo,
                                                      hi, device))


def _build_schedule_tables(n_vars: int, res_bits: tuple, lo: float,
                           hi: float, device: torch.device) -> ScheduleTables:
    if not res_bits:
        raise ValueError("res_bits must name at least one resolution")
    n_max = n_vars * max(res_bits)
    bits = np.asarray(res_bits, np.int64)
    max_level = (2.0**bits - 1.0).astype(np.float32)
    scale = np.zeros((len(res_bits),), np.float32)
    for r in range(len(res_bits)):
        # a float32 division, as numpy rounds the reference's table
        scale[r] = (hi - lo) / max_level[r]
    encodings = tuple(ResolutionEncoding(n_vars, b, lo, hi,
                                         step=float(scale[r]))
                      for r, b in enumerate(res_bits))

    def on(a):
        return torch.as_tensor(a).to(device)

    return ScheduleTables(
        n_vars=n_vars, lo=lo, hi=hi, res_bits=res_bits, n_max=n_max,
        p_max=2 * n_max - 1, pop=on(2 * n_vars * bits - 1), scale=on(scale),
        max_level=on(max_level), encodings=encodings)
