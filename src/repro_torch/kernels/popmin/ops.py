"""Public wrapper for the population (min, argmin).

``population_min(vals)`` casts (P,) values to float32 and returns
``(min, argmin)`` as 0-d tensors on their device, with the semantics of
``jnp.min``/``jnp.argmin`` (``ref.py``): a NaN wins at its first index,
else the smallest value, ties to the smallest index.

Where the values live decides how it runs.  On a CUDA tensor the wrapper
makes one launch of ``popmin_kernel`` or raises: one block for
P <= ``ONE_BLOCK_MAX``, else a grid of at most the blocks the card holds
at once, whose last block folds the blocks' winners in the same launch.
The grid's ticket and partial slots live in one small device buffer per
(device, stream), zeroed when it is made and left reset by every launch,
so calls on one stream share it and calls on two streams never do.  On a
CPU tensor it runs :func:`population_min_plain`, the reference kernel's
two stages (per-tile winners, then their fold) with tensor operations.
No path falls back from one to the other.  ``launches`` counts the
launches :func:`population_min` makes; ``fold_launches`` counts launches
of the fold alone (``popmin_fold_kernel``), which only
:func:`fold_partials` (for checks) makes, so around a run of
:func:`population_min` it reads 0.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.cache import get_cache
from repro_torch.kernels._plain import nan_first_rows

launches = 0
fold_launches = 0

# the most values the one-block launch takes; above, the grid (chosen from
# probe_packed.py's sweep of both shapes on an H100, PERF.md)
ONE_BLOCK_MAX = 16384

_INT_MAX = 2**31 - 1
_GRIDS = get_cache("popmin.grids", maxsize=16)
_STATES = get_cache("popmin.states", maxsize=64)


def population_min_plain(vals: torch.Tensor, tile: int = 1024
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference kernel's two stages in PyTorch: each tile's NaN-first
    winner, then the winner of the tiles.  The last tile is padded with
    +inf at indices past the end, which lose every tie to a real index."""
    n = vals.shape[0]
    n_parts = -(-n // tile)
    v = torch.nn.functional.pad(vals, (0, n_parts * tile - n),
                                value=float("inf")).reshape(n_parts, tile)
    rows = torch.arange(n_parts * tile, device=vals.device).reshape(
        n_parts, tile)
    part_val, part_row = nan_first_rows(v, rows)
    best, row = nan_first_rows(part_val[None], part_row[None])
    return best[0], row[0].to(torch.int32)


def _resident_blocks(lib, dev) -> int:
    """Blocks of the grid launch the card holds at once, asked of the CUDA
    runtime once per device."""
    def ask() -> int:
        blocks = ctypes.c_int(0)
        err = lib.popmin_grid(ctypes.byref(blocks))
        if err or blocks.value < 2:
            raise RuntimeError(f"popmin: the card holds {blocks.value} "
                               f"blocks of the grid launch (CUDA error "
                               f"{err})")
        return blocks.value

    return _GRIDS.get(dev.index, ask)


def _grid_state(lib, dev, stream: int) -> tuple[int, torch.Tensor]:
    """(blocks, state) of the grid launch on ``stream``: the ticket, a pad
    and a 64-bit slot per block, made with zeros on that stream once."""
    blocks = _resident_blocks(lib, dev)
    state = _STATES.get((dev.index, stream), lambda: torch.zeros(
        2 + 2 * blocks, dtype=torch.int32, device=dev))
    return blocks, state


def _launch(vals: torch.Tensor):
    global launches
    from repro_torch.kernels.popmin.kernel import LIBRARY

    lib = LIBRARY.load()
    dev = vals.device
    n = vals.shape[0]
    stream = torch.cuda.current_stream(dev).cuda_stream
    blocks, state = 1, None
    if n > ONE_BLOCK_MAX:
        blocks, state = _grid_state(lib, dev, stream)
    out = torch.empty(2, dtype=torch.float32, device=dev)
    ptr = out.data_ptr()
    err = lib.popmin_launch(vals.data_ptr(), n, blocks,
                            None if state is None else state.data_ptr(),
                            ptr, ptr + 4, stream)
    if err:
        raise RuntimeError(f"popmin launch failed: CUDA error {err}")
    launches += 1
    return out[0], out[1:].view(torch.int32)[0]


def fold_partials(part_val: torch.Tensor, part_row: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold (K,) float32 partial values with their distinct (K,) int32
    indices into the NaN-first (value, index), as 0-d tensors: on CUDA
    tensors ``popmin_fold_kernel``, which runs the grid launch's own fold
    (``fold_parts``) over them, counted in ``fold_launches``;
    :func:`~repro_torch.kernels._plain.nan_first_rows` on CPU tensors."""
    global fold_launches
    if part_val.dim() != 1 or part_row.shape != part_val.shape \
            or not 1 <= part_val.shape[0] < _INT_MAX:
        raise ValueError(f"partials must be two (K,) tensors with K >= 1, "
                         f"got {tuple(part_val.shape)} and "
                         f"{tuple(part_row.shape)}")
    if part_val.dtype != torch.float32 or part_row.dtype != torch.int32:
        raise ValueError("partials are (float32 values, int32 indices)")
    if not part_val.is_cuda:
        best, row = nan_first_rows(part_val[None], part_row.long()[None])
        return best[0], row[0].to(torch.int32)
    from repro_torch.kernels.popmin.kernel import LIBRARY

    dev = part_val.device
    pv, pr = part_val.contiguous(), part_row.to(dev).contiguous()
    out_val = torch.empty(1, dtype=torch.float32, device=dev)
    out_idx = torch.empty(1, dtype=torch.int32, device=dev)
    err = LIBRARY.load().popmin_fold(
        pv.data_ptr(), pr.data_ptr(), pv.shape[0], out_val.data_ptr(),
        out_idx.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"popmin fold launch failed: CUDA error {err}")
    fold_launches += 1
    return out_val[0], out_idx[0]


def population_min(vals: torch.Tensor, *, tile: int = 1024
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(P,) values -> (min float32, argmin int32), 0-d tensors on the
    values' device with no host synchronisation.  ``tile`` is the number
    of values per tile of the plain version (the reference's keyword);
    the CUDA launch does not read it, its shape follows from P."""
    if vals.dim() != 1 or not 1 <= vals.shape[0] < _INT_MAX:
        raise ValueError(f"vals must be (P,) with 1 <= P < 2^31, got "
                         f"{tuple(vals.shape)}")
    if tile < 1:
        raise ValueError(f"tile must be >= 1, got {tile}")
    vals = vals.to(torch.float32).contiguous()
    if vals.is_cuda:
        return _launch(vals)
    if vals.device.type != "cpu":
        raise ValueError(f"popmin runs on CUDA or CPU tensors, got "
                         f"{vals.device}")
    return population_min_plain(vals, tile)
