"""Public wrapper for the population (min, argmin).

``population_min(vals)`` casts (P,) values to float32 and returns
``(min, argmin)`` as 0-d tensors on their device, with the semantics of
``jnp.min``/``jnp.argmin`` (``ref.py``): a NaN wins at its first index,
else the smallest value, ties to the smallest index.

Where the values live decides how it runs.  On a CUDA tensor the wrapper
launches ``popmin_partials_kernel`` (one partial per tile of ``tile``
values) and ``popmin_fold_kernel`` (the fold of the partials) or raises;
on a CPU tensor it runs :func:`population_min_plain`, the same two stages
with tensor operations.  No path falls back from one to the other.
``launches`` counts the partials launches and ``fold_launches`` the fold
launches, each where :func:`population_min` launches it;
:func:`fold_partials` (the fold alone, for checks) is not counted.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._plain import nan_first_rows

launches = 0
fold_launches = 0

_INT_MAX = 2**31 - 1


def population_min_plain(vals: torch.Tensor, tile: int = 1024
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's two stages in PyTorch: each tile's NaN-first winner,
    then the winner of the tiles.  The last tile is padded with +inf at
    indices past the end, which lose every tie to a real index."""
    n = vals.shape[0]
    n_parts = -(-n // tile)
    v = torch.nn.functional.pad(vals, (0, n_parts * tile - n),
                                value=float("inf")).reshape(n_parts, tile)
    rows = torch.arange(n_parts * tile, device=vals.device).reshape(
        n_parts, tile)
    part_val, part_row = nan_first_rows(v, rows)
    best, row = nan_first_rows(part_val[None], part_row[None])
    return best[0], row[0].to(torch.int32)


def _launch(vals: torch.Tensor, tile: int):
    global launches, fold_launches
    from repro_torch.kernels.popmin.kernel import LIBRARY

    lib = LIBRARY.load()
    dev = vals.device
    n = vals.shape[0]
    n_parts = -(-n // tile)
    part_val = torch.empty(n_parts, dtype=torch.float32, device=dev)
    part_row = torch.empty(n_parts, dtype=torch.int32, device=dev)
    out_val = torch.empty(1, dtype=torch.float32, device=dev)
    out_idx = torch.empty(1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.popmin_partials(vals.data_ptr(), n, tile, part_val.data_ptr(),
                              part_row.data_ptr(), stream)
    if err:
        raise RuntimeError(f"popmin partials launch failed: CUDA error {err}")
    launches += 1
    err = lib.popmin_fold(part_val.data_ptr(), part_row.data_ptr(), n_parts,
                          out_val.data_ptr(), out_idx.data_ptr(), stream)
    if err:
        raise RuntimeError(f"popmin fold launch failed: CUDA error {err}")
    fold_launches += 1
    return out_val[0], out_idx[0]


def fold_partials(part_val: torch.Tensor, part_row: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold (K,) float32 partial values with their distinct (K,) int32
    indices into the NaN-first (value, index), as 0-d tensors: the fold
    launch on CUDA tensors, :func:`~repro_torch.kernels._plain.
    nan_first_rows` on CPU tensors.  Not counted in ``fold_launches``."""
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
    return out_val[0], out_idx[0]


def population_min(vals: torch.Tensor, *, tile: int = 1024
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(P,) values -> (min float32, argmin int32), 0-d tensors on the
    values' device with no host synchronisation.  ``tile`` is the number
    of values per thread block of the partials launch (and per tile of
    the plain version)."""
    if vals.dim() != 1 or not 1 <= vals.shape[0] < _INT_MAX:
        raise ValueError(f"vals must be (P,) with 1 <= P < 2^31, got "
                         f"{tuple(vals.shape)}")
    if tile < 1:
        raise ValueError(f"tile must be >= 1, got {tile}")
    vals = vals.to(torch.float32).contiguous()
    if vals.is_cuda:
        return _launch(vals, tile)
    if vals.device.type != "cpu":
        raise ValueError(f"popmin runs on CUDA or CPU tensors, got "
                         f"{vals.device}")
    return population_min_plain(vals, tile)
