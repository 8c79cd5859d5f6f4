"""Public wrappers for the fused population step.

``population_step``     — full 2N-1 population of one parent -> (val, id).
``population_step_ids`` — an arbitrary id subset, optionally cut into
virtual blocks (the engine's virtual processing) -> (val, global id).

Where the tensors live decides how the step runs.  On a CUDA tensor the
wrapper launches the CUDA kernel (``csrc/popstep.cu``) or raises; on a
CPU tensor it runs the plain PyTorch version of the same function
(:func:`population_step_ids_plain`), which repeats the kernel's
arithmetic with tensor operations.  No path falls back from one to the
other.

A step is two kernels: ``popstep_partials_kernel`` (one partial per
thread block) and ``popstep_fold_kernel`` (the step's winner).
``launches`` counts the first and ``fold_launches`` the second, each
where the step launches it; :func:`fold_partials` (the fold alone, for
checks) is not counted.  Callers that need a count for one run set
both to 0 first.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.encoding import Encoding, decode_levels, levels_of
from repro_torch.core.objectives import OBJECTIVE_IDS, RS_NVARS
from repro_torch.core.population import table_on
from repro_torch.kernels._plain import child_levels, nan_first_rows

launches = 0
fold_launches = 0

CHUNK = 4                 # rows per thread block of the partials launch
MAX_SMEM = 48 * 1024      # static limit for the decoded-point buffers
WARPS = 4                 # warps per thread block (csrc/popstep.cu kWarps)


def _fn_of(objective):
    return getattr(objective, "fn", objective)


def _kernel_of(objective):
    return getattr(objective, "kernel", None)


# ---------------------------------------------------------------------------
# stages in plain PyTorch (the kernel's arithmetic, vectorized)
# ---------------------------------------------------------------------------

def fold_partials_plain(part_val: torch.Tensor, part_row: torch.Tensor,
                        ids: torch.Tensor, n_vblocks: int,
                        sentinel: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The selection rule of the kernel's fold, in PyTorch.

    ``part_val``/``part_row`` hold ``n_vblocks`` equal runs of partial
    (value, row) pairs.  Inside a run: a NaN wins (smallest row), else the
    smallest value, ties to the smallest row.  With one run its winner is
    returned as (value, ids[row]); with several, NaN runs are dropped and
    the rest fold lexicographically on (value, ids[row]) from
    (+inf, sentinel)."""
    best, row = nan_first_rows(part_val.reshape(n_vblocks, -1),
                               part_row.to(torch.int64).reshape(n_vblocks, -1))
    gid = ids.to(torch.int64)[row.clamp(max=ids.shape[0] - 1)]
    if n_vblocks == 1:
        return best[0], gid[0].to(torch.int32)
    keep = ~torch.isnan(best)
    v2 = torch.where(keep, best, torch.inf)
    g2 = torch.where(keep, gid, sentinel)
    win = v2.amin()
    win_id = torch.where(v2 == win, g2, sentinel).amin()
    return win, win_id.to(torch.int32)


def child_values_plain(objective, parent_bits: torch.Tensor,
                       child_ids: torch.Tensor, enc: Encoding,
                       valid: torch.Tensor | None = None) -> torch.Tensor:
    """(K,) float32 objective values of the children ``child_ids``
    (+inf where ``valid`` is False), computed with tensor operations."""
    ids = child_ids.to(torch.int64).clamp(0, 2 * enc.n_bits - 2)
    table = table_on("table", enc.n_bits, parent_bits.device)
    lv = child_levels(levels_of(parent_bits, enc), table[ids, 0],
                      table[ids, 1], enc)
    vals = _fn_of(objective)(decode_levels(lv, enc)).to(torch.float32)
    if valid is not None:
        vals = torch.where(valid.to(torch.bool), vals, torch.inf)
    return vals


def population_step_ids_plain(objective, parent_bits: torch.Tensor,
                              child_ids: torch.Tensor, enc: Encoding, *,
                              valid: torch.Tensor | None = None,
                              virtual_block: int | None = None
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of :func:`population_step_ids`, on any
    device."""
    k = child_ids.shape[0]
    n_vb = _n_vblocks(k, virtual_block)
    vals = child_values_plain(objective, parent_bits, child_ids, enc, valid)
    ids = child_ids.to(torch.int64).clamp(0, 2 * enc.n_bits - 2)
    rows = torch.arange(k, device=vals.device)
    return fold_partials_plain(vals, rows, ids, n_vb, enc.population)


def _n_vblocks(k: int, virtual_block: int | None) -> int:
    vb = k if virtual_block is None else int(virtual_block)
    if k < 1 or vb < 1 or k % vb:
        raise ValueError(f"{k} child ids do not split into virtual blocks "
                         f"of {virtual_block}")
    return k // vb


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def _check_kernel_form(kernel, enc: Encoding) -> None:
    ids = OBJECTIVE_IDS
    shapes = tuple(tuple(c.shape) for c in kernel.consts)
    n = enc.n_vars
    want = {ids["shekel"]: lambda: len(shapes) == 2
            and shapes[0][1:] == (n,) and shapes[1] == shapes[0][:1],
            ids["xor"]: lambda: n == 8 and len(shapes) == 2
            and shapes[0][1:] == (2,) and shapes[1] == shapes[0][:1],
            ids["remote_sensing"]: lambda: n == RS_NVARS
            and len(shapes) == 2 and shapes[0][1:] == (7,)
            and shapes[1] == (shapes[0][0], 8),
            ids["sample2d"]: lambda: n >= 2}.get(kernel.obj_id,
                                                 lambda: not shapes)
    if kernel.obj_id not in ids.values() or not want():
        raise ValueError(f"kernel form id={kernel.obj_id} with constants "
                         f"{shapes} does not fit n_vars={n}")


def _prepare_cuda(objective, child_ids, enc, valid, n_vb):
    """Check the inputs and build every device array that does not depend
    on the parent; returns ``launch(parent_bits) -> (val, id)``."""
    kernel = _kernel_of(objective)
    if kernel is None:
        raise ValueError(
            "this objective has no device form (only registry objectives "
            "carry one); run it with inner='fused' or on the CPU")
    if not 1 <= enc.bits <= 32:
        raise ValueError(f"the popstep kernel takes 1..32 bits per "
                         f"variable, got {enc.bits}")
    if WARPS * enc.n_vars * 4 > MAX_SMEM:
        raise ValueError(f"n_vars={enc.n_vars} exceeds the kernel's "
                         f"shared-memory budget")
    _check_kernel_form(kernel, enc)
    dev = child_ids.device
    if valid is not None and valid.device != dev:
        raise ValueError(f"valid is on {valid.device}, child_ids on {dev}")
    from repro_torch.kernels.popstep.kernel import LIBRARY

    lib = LIBRARY.load()
    k = child_ids.shape[0]
    vb = k // n_vb
    cpv = math.ceil(vb / CHUNK)
    ids = child_ids.to(torch.int64).clamp(0, 2 * enc.n_bits - 2)
    table = table_on("table", enc.n_bits, dev)
    starts = table[ids, 0].to(torch.int32).contiguous()
    ends = table[ids, 1].to(torch.int32).contiguous()
    ok = (torch.ones(k, dtype=torch.int32, device=dev) if valid is None
          else valid.to(torch.int32).contiguous())
    ids32 = ids.to(torch.int32).contiguous()
    # the kernel reads the constants through raw pointers: this copy
    # (a few KB) lives as long as ``launch`` does
    consts = tuple(c.to(device=dev, dtype=torch.float32).contiguous()
                   for c in kernel.consts)
    m = consts[0].shape[0] if consts else 0
    scale = float(torch.tensor(enc.scale, dtype=torch.float32))
    lo = float(torch.tensor(enc.lo, dtype=torch.float32))

    def launch(parent_bits: torch.Tensor):
        global launches, fold_launches
        c0 = consts[0].data_ptr() if consts else None
        c1 = consts[1].data_ptr() if len(consts) > 1 else None
        if parent_bits.device != dev or parent_bits.shape != (enc.n_bits,):
            raise ValueError(f"parent_bits must be ({enc.n_bits},) on {dev}, "
                             f"got {tuple(parent_bits.shape)} on "
                             f"{parent_bits.device}")
        parent = parent_bits.to(torch.int8).contiguous()
        part_val = torch.empty(n_vb * cpv, dtype=torch.float32, device=dev)
        part_row = torch.empty(n_vb * cpv, dtype=torch.int32, device=dev)
        out_val = torch.empty(1, dtype=torch.float32, device=dev)
        out_id = torch.empty(1, dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.popstep_partials(
            parent.data_ptr(), starts.data_ptr(), ends.data_ptr(),
            ok.data_ptr(), k, enc.n_vars, enc.bits, lo, scale,
            kernel.obj_id, c0, c1, m, float(kernel.param), vb, CHUNK, n_vb,
            cpv, part_val.data_ptr(), part_row.data_ptr(), stream)
        if err:
            raise RuntimeError(f"popstep partials launch failed: CUDA "
                               f"error {err}")
        launches += 1
        err = lib.popstep_fold(part_val.data_ptr(), part_row.data_ptr(),
                               ids32.data_ptr(), n_vb, cpv, enc.population,
                               out_val.data_ptr(), out_id.data_ptr(), stream)
        if err:
            raise RuntimeError(f"popstep fold launch failed: CUDA error "
                               f"{err}")
        fold_launches += 1
        return out_val[0], out_id[0]

    return launch


def fold_partials(part_val: torch.Tensor, part_row: torch.Tensor,
                  ids: torch.Tensor, n_vblocks: int,
                  sentinel: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold partial (value, row) pairs (see :func:`fold_partials_plain`
    for the rule): the kernel's fold launch on CUDA tensors, the plain
    rule on CPU tensors.  Not counted in ``fold_launches``."""
    if not part_val.is_cuda:
        return fold_partials_plain(part_val, part_row, ids, n_vblocks,
                                   sentinel)
    from repro_torch.kernels.popstep.kernel import LIBRARY

    n = part_val.shape[0]
    if n % n_vblocks or part_row.shape != (n,):
        raise ValueError("partials must split evenly into virtual blocks")
    if part_val.dtype != torch.float32 or part_row.dtype != torch.int32:
        raise ValueError("partials are (float32 values, int32 rows)")
    dev = part_val.device
    pv, pr = part_val.contiguous(), part_row.contiguous()
    ids32 = ids.to(device=dev, dtype=torch.int32).contiguous()
    out_val = torch.empty(1, dtype=torch.float32, device=dev)
    out_id = torch.empty(1, dtype=torch.int32, device=dev)
    err = LIBRARY.load().popstep_fold(
        pv.data_ptr(), pr.data_ptr(), ids32.data_ptr(), n_vblocks,
        n // n_vblocks, sentinel, out_val.data_ptr(), out_id.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"popstep fold launch failed: CUDA error {err}")
    return out_val[0], out_id[0]


# ---------------------------------------------------------------------------
# public wrappers
# ---------------------------------------------------------------------------

def prepare_step_ids(objective, child_ids: torch.Tensor, enc: Encoding, *,
                     valid: torch.Tensor | None = None,
                     virtual_block: int | None = None):
    """Bind a step over a fixed id subset once; returns ``launch(
    parent_bits) -> (best value, global child id)``, 0-d tensors on the
    ids' device with no host synchronisation.  On CUDA ids, ``launch``
    runs the kernel (after checking the inputs here, once); on CPU ids
    it runs the plain version.  See :func:`population_step_ids`."""
    n_vb = _n_vblocks(child_ids.shape[0], virtual_block)
    if child_ids.is_cuda:
        return _prepare_cuda(objective, child_ids, enc, valid, n_vb)
    if child_ids.device.type != "cpu":
        raise ValueError(f"popstep runs on CUDA or CPU tensors, got "
                         f"{child_ids.device}")

    def plain(parent_bits: torch.Tensor):
        if parent_bits.device != child_ids.device:
            raise ValueError(f"parent_bits is on {parent_bits.device}, "
                             f"child_ids on {child_ids.device}")
        return population_step_ids_plain(objective, parent_bits, child_ids,
                                         enc, valid=valid,
                                         virtual_block=virtual_block)

    return plain


def population_step_ids(objective, parent_bits: torch.Tensor,
                        child_ids: torch.Tensor, enc: Encoding, *,
                        valid: torch.Tensor | None = None,
                        virtual_block: int | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused step over an id subset -> (best value, global child id) as
    0-d tensors on the parent's device (no host synchronisation).

    ``objective`` is a registry :class:`~repro_torch.core.objectives.
    Objective` (its ``fn`` on the CPU, its kernel form on the card) or,
    on the CPU only, a batched callable.  ``valid`` (bool, like
    ``child_ids``) masks rows to +inf.  ``virtual_block`` cuts the ids
    into equal runs that are selected as the distributed engine's
    virtual blocks are (see :func:`fold_partials_plain`); ``None`` is one
    run, the semantics of ``repro.kernels.popstep.ops.population_step_ids``
    with ``jnp.argmin``'s NaN rule.
    """
    return prepare_step_ids(objective, child_ids, enc, valid=valid,
                            virtual_block=virtual_block)(parent_bits)


def population_step(objective, parent_bits: torch.Tensor, enc: Encoding
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(N,) int8 parent -> (best value, best child id) over all 2N-1."""
    ids = torch.arange(enc.population, device=parent_bits.device)
    return population_step_ids(objective, parent_bits, ids, enc)
