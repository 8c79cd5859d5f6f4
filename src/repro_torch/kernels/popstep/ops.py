"""Public wrappers for the fused population step.

``population_step``     — full 2N-1 population of one parent -> (val, id).
``population_step_ids`` — an arbitrary id subset, optionally cut into
virtual blocks (the engine's virtual processing) -> (val, global id).
``child_values``        — every child's value of such a step.

Where the tensors live decides how the step runs.  On a CUDA tensor the
wrapper launches the CUDA kernel (``csrc/popstep.cu``) or raises; on a
CPU tensor it runs the plain PyTorch version of the same function
(:func:`population_step_ids_plain`), which repeats the kernel's
arithmetic with tensor operations.  No path falls back from one to the
other.

A step is one launch of ``popstep_kernel``: every child's value, the
virtual blocks' winners and the cross-block fold.  ``n_shards`` groups the
virtual blocks into the shards of a mesh (the fold then runs per shard and
across shards, :func:`fold_values_plain`); ``restarts=R`` binds a step of
R parents over the same rows, one launch for all of them, with a live flag
per parent (:class:`_CudaStep`).  ``launches`` counts
it where a step launches it.  ``fold_launches`` counts launches of the
cross-block fold on its own (``popstep_fold_kernel``), which only
:func:`fold_partials` (the fold alone, for checks) makes: no step does,
so around the main path it reads 0.  Callers that need a count for one
run set both to 0 first.

For the remote-sensing MLP the kernel evaluates the parent's hidden
layer once per thread block and recomputes in each child only the
hidden units its segment pattern touches (:func:`hidden_unit_masks`);
:func:`hidden_reuse_values_plain` is that arithmetic in PyTorch.

For Rastrigin's function at <= 8 bits and at least ``TABLE_MIN_VARS``
variables (:func:`term_table`) each block computes the term of every
level once and each child looks its terms up (the same bits as the
cosine, :func:`rastrigin_table_values_plain`); ``table_launches``
counts those launches, and, on a traced wave, the spans' counter
``popstep.table_launches``.
"""
from __future__ import annotations

import ctypes
import math
import threading

import numpy as np
import torch

from repro_torch.core import spans
from repro_torch.core.cache import get_cache
from repro_torch.core.encoding import Encoding, decode_levels, levels_of
from repro_torch.core.objectives import (OBJECTIVE_IDS, RS_CLASSES, RS_HIDDEN,
                                         RS_IN, RS_NVARS)
from repro_torch.core.population import segment_table, table_on
from repro_torch.kernels._plain import _INT_MAX, child_levels, nan_first_rows

launches = 0
fold_launches = 0
table_launches = 0
# the counts are bumped from every thread that launches (the waves of the
# batched engine run on worker threads)
_COUNTS = threading.Lock()

WARPS = 8                 # warps per thread block, a child each (kWarps)
MAX_SMEM = 226 * 1024     # an H100 block's 227 KB (opt-in), less static
_RS_ID = OBJECTIVE_IDS["remote_sensing"]
_RAST_ID = OBJECTIVE_IDS["rastrigin"]
# Rastrigin's term table: 2^bits levels, one copy per shared-memory bank;
# below TABLE_MIN_VARS variables the block's fill costs more cosines than
# its children save (chip_smoke.py's table probe, n = 9, 64 and 1,000)
TABLE_MAX_BITS = 8
TABLE_MIN_VARS = 64
_RS_W1B1 = RS_IN * RS_HIDDEN + RS_HIDDEN   # the variables of W1 and b1
_ALL_UNITS = (1 << RS_HIDDEN) - 1
_MASKS = get_cache("popstep.hidden_masks", maxsize=32)
_GRIDS = get_cache("popstep.grids", maxsize=64)


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
    return _cross_fold(best, row, ids, sentinel)


def _cross_fold(best: torch.Tensor, row: torch.Tensor, ids: torch.Tensor,
                sentinel: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The cross-block rule (``fold_vblocks`` in ``csrc/popstep.cu``) over
    each virtual block's winner (value, row)."""
    gid = ids.to(torch.int64)[row.clamp(max=ids.shape[0] - 1)]
    if best.shape[0] == 1:
        return best[0], gid[0].to(torch.int32)
    keep = ~torch.isnan(best)
    v2 = torch.where(keep, best, torch.inf)
    win = v2.amin()
    hit = keep & (v2 == win)
    win_id = torch.where(hit, gid, _INT_MAX).amin()
    # the fold starts from (+inf, sentinel): it wins a tie at +inf
    win_id = torch.where(win == torch.inf,
                         torch.clamp(win_id, max=sentinel), win_id)
    # the winning block's own value (amin may return either zero of a tie
    # between -0.0 and 0.0), +inf where the start value won
    own = hit & (gid == win_id)
    win_val = torch.where(own.any(), best[own.to(torch.int8).argmax()],
                          torch.inf)
    return win_val, win_id.to(torch.int32)


def cand_keys_plain(vals: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """The kernel's 64-bit selection key of each (value, row) (``cand_key``
    in ``csrc/popstep.cu``), as int64 in the same order (the unsigned high
    word is shifted by 2^31): a NaN is smallest, then the value with -0 and
    +0 equal, then the row."""
    u = vals.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    u = torch.where(vals == 0, 0, u & 0xFFFFFFFF)
    hi = torch.where(u >= 1 << 31, ~u & 0xFFFFFFFF, u | 1 << 31)
    hi = torch.where(torch.isnan(vals), 0, hi)
    return ((hi - (1 << 31)) << 32) | rows.to(torch.int64)


def fold_values_plain(vals: torch.Tensor, ids: torch.Tensor, n_vblocks: int,
                      sentinel: int, n_shards: int = 1
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's selection over every child's value: ``vals`` (K,) in
    ``n_vblocks`` equal runs; each run's winner is its smallest key
    (:func:`cand_keys_plain`), its value read back from ``vals``; then the
    cross-block rule.  The same result as :func:`fold_partials_plain` with
    one partial per row.  With ``n_shards`` the runs are grouped into that
    many shards: the cross-block rule runs per shard, then
    :func:`_shard_fold` across them."""
    if n_shards > 1:
        per = vals.shape[0] // n_shards
        folds = [fold_values_plain(vals[s * per:(s + 1) * per],
                                   ids[s * per:(s + 1) * per],
                                   n_vblocks // n_shards, sentinel)
                 for s in range(n_shards)]
        return _shard_fold(torch.stack([v for v, _ in folds]),
                           torch.stack([i for _, i in folds]), sentinel)
    rows = torch.arange(vals.shape[0], device=vals.device)
    key = cand_keys_plain(vals, rows).reshape(n_vblocks, -1).amin(1)
    row = key & 0xFFFFFFFF
    return _cross_fold(vals[row], row, ids, sentinel)


def _shard_fold(best: torch.Tensor, gid: torch.Tensor,
                sentinel: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The cross-shard rule (``fold_shards`` in ``csrc/popstep.cu``) over
    each shard's (value, child id): a NaN shard wins with id ``sentinel``
    (the first one's value), else the shards fold lexicographically from
    (+inf, sentinel)."""
    gid = gid.to(torch.int64)
    nan = torch.isnan(best)
    v2 = torch.where(nan, torch.inf, best)
    win = v2.amin()
    hit = ~nan & (v2 == win)
    win_id = torch.where(hit, gid, _INT_MAX).amin()
    win_id = torch.where(win == torch.inf,
                         torch.clamp(win_id, max=sentinel), win_id)
    own = hit & (gid == win_id)
    win_val = torch.where(own.any(), best[own.to(torch.int8).argmax()],
                          torch.inf)
    any_nan = nan.any()
    win_val = torch.where(any_nan, best[nan.to(torch.int8).argmax()],
                          win_val)
    win_id = torch.where(any_nan, sentinel, win_id)
    return win_val, win_id.to(torch.int32)


def hidden_unit_masks(n_bits: int, bits: int) -> np.ndarray:
    """(2N-1,) int64 per child of an N-bit parent of the remote-sensing
    layout (``bits`` per variable): bit j is set iff the child's segment
    pattern (``core.population.segment_patterns``) flips a bit of W1[k, j]
    (variable k * 42 + j, k < 7) or of b1[j] (variable 294 + j), i.e. iff
    hidden unit j must be recomputed.  It depends on (N, bits) and the
    segment only, never on the parent; built in closed form from the
    segment table and memoized."""
    n_bits, bits = int(n_bits), int(bits)

    def build() -> np.ndarray:
        table = segment_table(n_bits).astype(np.int64)
        s, e = table[:, :1], table[:, 1:]
        v = np.arange(_RS_W1B1)
        lo = np.maximum(s, v * bits)
        hi = np.minimum(e, (v + 1) * bits)
        # the first flipped bit inside [s, e) at or after lo (j - s even),
        # or the odd segment's tail reaching past e
        touched = ((lo + ((lo - s) & 1)) < hi) | (((e - s) & 1 == 1)
                                                   & ((v + 1) * bits > e))
        w1 = touched[:, :RS_IN * RS_HIDDEN].reshape(-1, RS_IN, RS_HIDDEN)
        units = w1.any(1) | touched[:, RS_IN * RS_HIDDEN:]
        return (units.astype(np.int64) << np.arange(RS_HIDDEN)).sum(1)

    return _MASKS.get((n_bits, bits), build)


def hidden_reuse_values_plain(objective, parent_bits: torch.Tensor,
                              child_ids: torch.Tensor, enc: Encoding,
                              masks: torch.Tensor) -> torch.Tensor:
    """(K,) remote-sensing values of the children ``child_ids`` by the
    kernel's reuse arithmetic: hidden unit j of child k is recomputed from
    the child's weights where bit j of ``masks[k]`` is set, else taken
    from the parent's hidden layer; then layer 2 and the mean softmax
    cross-entropy.  Exact only with the masks of
    :func:`hidden_unit_masks`."""
    x, y = (c.to(device=parent_bits.device, dtype=torch.float32)
            for c in objective.kernel.consts)
    ids = child_ids.to(torch.int64).clamp(0, 2 * enc.n_bits - 2)
    table = table_on("table", enc.n_bits, parent_bits.device)
    plv = levels_of(parent_bits, enc)
    w = decode_levels(child_levels(plv, table[ids, 0], table[ids, 1], enc),
                      enc)
    wp = decode_levels(plv, enc)[None]

    def hidden(w):
        w1 = w[:, :RS_IN * RS_HIDDEN].reshape(-1, RS_IN, RS_HIDDEN)
        return torch.tanh(x @ w1 + w[:, None, RS_IN * RS_HIDDEN:_RS_W1B1])

    unit = (masks.to(torch.int64)[:, None]
            >> torch.arange(RS_HIDDEN, device=masks.device)) & 1
    h = torch.where(unit[:, None, :] == 1, hidden(w), hidden(wp))
    w2 = w[:, _RS_W1B1:RS_NVARS - RS_CLASSES].reshape(-1, RS_HIDDEN,
                                                      RS_CLASSES)
    logits = h @ w2 + w[:, None, RS_NVARS - RS_CLASSES:]
    return -(y * torch.log_softmax(logits, dim=-1)).sum(-1).mean(-1)


def term_table(obj_id: int, n_vars: int, bits: int) -> bool:
    """Whether a step of the objective with kernel id ``obj_id`` at
    ``n_vars`` variables of ``bits`` bits reads its terms from a table of
    the levels (Rastrigin's, whose term is one function of the level for
    every variable) instead of a cosine a term."""
    return (obj_id == _RAST_ID and bits <= TABLE_MAX_BITS
            and n_vars >= TABLE_MIN_VARS)


def rastrigin_table_values_plain(parent_bits: torch.Tensor,
                                 child_ids: torch.Tensor, enc: Encoding,
                                 valid: torch.Tensor | None = None
                                 ) -> torch.Tensor:
    """(K,) Rastrigin values of the children ``child_ids`` by the
    kernel's table arithmetic: the term of each of the 2^bits levels,
    once; each child's level of variable k the parent's before its
    segment's first variable, the parent's XOR the odd segment's tail from
    the first variable wholly at or past its end, and the closed-form
    child level only in between; its terms looked up and summed as the
    objective sums them (+inf where ``valid`` is False)."""
    dev = parent_bits.device
    x = decode_levels(torch.arange(1 << enc.bits, device=dev), enc)
    term = x * x - 10.0 * torch.cos(2 * math.pi * x)
    ids = child_ids.to(torch.int64).clamp(0, 2 * enc.n_bits - 2)
    table = table_on("table", enc.n_bits, dev)
    s, e = table[ids, 0].to(torch.int64), table[ids, 1].to(torch.int64)
    plv = levels_of(parent_bits, enc)
    k = torch.arange(enc.n_vars, device=dev)
    v_lo = (s // enc.bits)[:, None]
    v_hi = ((e + enc.bits - 1) // enc.bits)[:, None]
    tail = torch.where((e - s) & 1 == 1, (1 << enc.bits) - 1, 0)[:, None]
    lv = torch.where(k < v_lo, plv,
                     torch.where(k >= v_hi, plv ^ tail,
                                 child_levels(plv, s, e, enc)))
    vals = 10.0 * enc.n_vars + term[lv].sum(-1)
    if valid is not None:
        vals = torch.where(valid.to(torch.bool), vals, torch.inf)
    return vals


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
                              virtual_block: int | None = None,
                              n_shards: int = 1
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of :func:`population_step_ids`, on any
    device."""
    k = child_ids.shape[0]
    n_vb = _n_vblocks(k, virtual_block, n_shards)
    vals = child_values_plain(objective, parent_bits, child_ids, enc, valid)
    ids = child_ids.to(torch.int64).clamp(0, 2 * enc.n_bits - 2)
    return fold_values_plain(vals, ids, n_vb, enc.population, n_shards)


def population_steps_plain(objective, parents: torch.Tensor,
                           child_ids: torch.Tensor, enc: Encoding, *,
                           valid: torch.Tensor | None = None,
                           virtual_block: int | None = None,
                           n_shards: int = 1,
                           live: torch.Tensor | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of a step of R parents ``(R, N)``: the
    one-parent step (:func:`population_step_ids_plain`) on each parent
    whose ``live`` flag is set, so a parent's result does not depend on
    the others; ``(value, id)`` (R,) each, (+inf, population) where not
    live."""
    flags = [True] * parents.shape[0] if live is None else live.tolist()
    return each_parent(lambda p: population_step_ids_plain(
        objective, p, child_ids, enc, valid=valid,
        virtual_block=virtual_block, n_shards=n_shards),
        parents, flags, enc.population)


def each_parent(step_one, parents: torch.Tensor, flags, sentinel: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain step of R parents: ``step_one(parent) -> (value, id)`` on
    each parent whose entry of ``flags`` (R bools) is set, (+inf,
    ``sentinel``) on the others; ``(value, id)`` (R,) each."""
    vals = torch.full((parents.shape[0],), torch.inf, device=parents.device)
    ids = torch.full((parents.shape[0],), sentinel, dtype=torch.int32,
                     device=parents.device)
    for r, flag in enumerate(flags):
        if flag:
            vals[r], ids[r] = step_one(parents[r])
    return vals, ids


def _n_vblocks(k: int, virtual_block: int | None, n_shards: int = 1) -> int:
    vb = k if virtual_block is None else int(virtual_block)
    if k < 1 or vb < 1 or k % vb:
        raise ValueError(f"{k} child ids do not split into virtual blocks "
                         f"of {virtual_block}")
    if n_shards < 1 or (k // vb) % n_shards:
        raise ValueError(f"{k // vb} virtual blocks do not split into "
                         f"{n_shards} shards")
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


def _smem_bytes(kernel, enc: Encoding, table: bool = False) -> int:
    """Dynamic shared memory of one thread block: the parent's point and
    levels, one child point per warp (on the table path the larger of
    those and the term table, 32 copies of 2^bits levels, in the same
    area) and, for the remote-sensing MLP (``RS::smem_floats``), the
    parent's hidden layer for m samples rounded up to passes of 128, the
    samples and the labels ((7 + 8) x m), rounded up to 16 bytes."""
    points = WARPS * enc.n_vars
    floats = 2 * enc.n_vars + (max(points, 32 << enc.bits) if table
                               else points)
    if kernel.obj_id == _RS_ID:
        m = kernel.consts[0].shape[0]
        layer = RS_HIDDEN * 128 * -(-m // 128)
        floats += -(-(layer + (RS_IN + RS_CLASSES) * m) // 4) * 4
    return 4 * floats


class _CudaStep:
    """A step bound to its id subset on the card: ``step(parent_bits) ->
    (value, child id)``, one kernel launch.  ``values`` is the (K,)
    float32 value of every child of the latest launch (+inf where not
    valid).  The selection state (the virtual blocks' keys, the work
    counter and the ticket) lives here and each launch leaves it reset for
    the next, so one bound step runs on one stream: the first call's, and
    a call from another stream raises.

    Bound with ``restarts=R``: ``step(parents, live=None) -> (values,
    ids)``, ``parents`` (R, N) and ``live`` an (R,) bool tensor on the card
    (None: every parent); one launch steps every live parent, each with its
    own selection state, and ``values`` is (R, K).  A parent that is not
    live costs no evaluation and its outputs are not written."""

    def __init__(self, lib, enc: Encoding, dev, n_rows: int, args: tuple,
                 keep: list, restarts: int | None, blocks: int, smem: int,
                 table: bool = False):
        self._lib, self._enc, self._dev, self._k = lib, enc, dev, n_rows
        self._args = args        # popstep_step's arguments after out_id
        self.table = table       # Rastrigin's terms from the level table
        self._keep = keep        # the device arrays behind those pointers
        self._r = restarts       # None: one parent, (N,)
        self._grid = (blocks, smem)
        self._stream = None      # the stream of the first launch
        self.values = None

    def _check(self, parent_bits: torch.Tensor, live) -> int:
        enc, dev, r = self._enc, self._dev, self._r
        want = (enc.n_bits,) if r is None else (r, enc.n_bits)
        if parent_bits.device != dev or parent_bits.shape != want:
            raise ValueError(f"parent_bits must be {want} on {dev}, got "
                             f"{tuple(parent_bits.shape)} on "
                             f"{parent_bits.device}")
        if live is not None:
            if r is None:
                raise ValueError("a live flag needs a step bound with "
                                 "restarts=R")
            if (live.device != dev or live.dtype != torch.bool
                    or live.shape != (r,)):
                raise ValueError(f"live must be ({r},) torch.bool on {dev}, "
                                 f"got {tuple(live.shape)} {live.dtype} on "
                                 f"{live.device}")
        stream = torch.cuda.current_stream(dev).cuda_stream
        if self._stream is None:
            self._stream = stream
        elif stream != self._stream:
            raise RuntimeError(
                f"this bound popstep step runs on stream {self._stream:#x} "
                f"and keeps its selection state on the card between "
                f"launches; bind another step for stream {stream:#x}")
        return stream

    def __call__(self, parent_bits: torch.Tensor, live=None):
        global launches, table_launches
        stream = self._check(parent_bits, live)
        k, n = self._k, 1 if self._r is None else self._r
        parent = parent_bits.to(torch.int8).contiguous()
        # every child's value, then each parent's (value, id): one allocation
        buf = torch.empty(n * (k + 2), dtype=torch.float32, device=self._dev)
        ptr = buf.data_ptr()
        err = self._lib.popstep_step(
            parent.data_ptr(), ptr, ptr + 4 * n * k, ptr + 4 * n * (k + 1),
            *self._args, n, None if live is None else live.data_ptr(),
            *self._grid, stream)
        if err:
            raise RuntimeError(f"popstep launch failed: CUDA error {err}")
        with _COUNTS:
            launches += 1
            table_launches += self.table
        if self.table:
            spans.count("popstep.table_launches", 1)
        vals = buf[n * k: n * (k + 1)]
        ids = buf[n * (k + 1):].view(torch.int32)
        if self._r is None:
            self.values = buf[:k]
            return vals[0], ids[0]
        self.values = buf[:n * k].view(n, k)
        return vals, ids


def _prepare_cuda(objective, child_ids, enc, valid, n_vb, n_shards=1,
                  restarts=None, *, reuse=True):
    """Check the inputs and build every device array that does not depend
    on the parent; returns the bound step (:class:`_CudaStep`).
    ``reuse=False`` evaluates each child in full, with the same values,
    bitwise: every hidden unit of the remote-sensing MLP marked, and
    Rastrigin's cosine a term where :func:`term_table` would take the
    table.  With
    ``restarts=R`` each parent has its own keys and counters, and each
    gets ``1/R`` of the persistent grid."""
    kernel = _kernel_of(objective)
    if kernel is None:
        raise ValueError(
            "this objective has no device form (only registry objectives "
            "carry one); run it with inner='fused' or on the CPU")
    if not 1 <= enc.bits <= 32:
        raise ValueError(f"the popstep kernel takes 1..32 bits per "
                         f"variable, got {enc.bits}")
    _check_kernel_form(kernel, enc)
    use_table = reuse and term_table(kernel.obj_id, enc.n_vars, enc.bits)
    smem = _smem_bytes(kernel, enc, use_table)
    if smem > MAX_SMEM:
        raise ValueError(
            f"n_vars={enc.n_vars}"
            + (f" with m={kernel.consts[0].shape[0]} samples"
               if kernel.obj_id == _RS_ID else "")
            + f" needs {smem} bytes of shared memory a block, over the "
              f"kernel's shared-memory budget of {MAX_SMEM}")
    dev = child_ids.device
    if valid is not None and valid.device != dev:
        raise ValueError(f"valid is on {valid.device}, child_ids on {dev}")
    from repro_torch.kernels.popstep.kernel import LIBRARY

    lib = LIBRARY.load()
    k = child_ids.shape[0]
    ids = child_ids.to(torch.int64).clamp(0, 2 * enc.n_bits - 2)
    table = table_on("table", enc.n_bits, dev)
    ok = (torch.ones(k, dtype=torch.int32, device=dev) if valid is None
          else valid.to(torch.int32))
    starts, ends, ok = (t.to(torch.int32).contiguous() for t in (
        table[ids, 0], table[ids, 1], ok))
    # without a hidden layer: no masks, and the rows in order
    masks = order = None
    if kernel.obj_id == _RS_ID:
        masks = (torch.as_tensor(hidden_unit_masks(enc.n_bits, enc.bits),
                                 device=dev)[ids] if reuse else
                 torch.full((k,), _ALL_UNITS, dtype=torch.int64, device=dev))
        # work order: the most hidden units to recompute first, masked rows
        # last (their value is +inf without any work)
        cost = torch.where(ok == 1, _units_of(masks), -1)
        order = torch.argsort(-cost, stable=True).to(torch.int32)
    ids32 = ids.to(torch.int32).contiguous()
    consts = [c.to(device=dev, dtype=torch.float32).contiguous()
              for c in kernel.consts] + [None, None]
    n_par = 1 if restarts is None else int(restarts)
    if n_par < 1:
        raise ValueError(f"restarts must be >= 1, got {restarts}")
    keys = torch.full((n_par, n_vb), -1, dtype=torch.int64, device=dev)
    ctl = torch.zeros((n_par, 2), dtype=torch.int32, device=dev)

    grid = min(math.ceil(_resident_blocks(lib, kernel.obj_id, smem, dev)
                         / n_par), math.ceil(k / WARPS))
    scale = float(torch.tensor(enc.scale, dtype=torch.float32))
    lo = float(torch.tensor(enc.lo, dtype=torch.float32))
    # the kernel reads these through raw pointers: the bound step keeps
    # them (the objective's constants too, a few KB)
    keep = [starts, ends, ok, masks, order, ids32, consts[0], consts[1],
            keys, ctl]
    p = [None if t is None else t.data_ptr() for t in keep]
    args = (*p[:6], k, enc.n_vars, enc.bits, lo, scale, kernel.obj_id,
            p[6], p[7], 0 if consts[0] is None else consts[0].shape[0],
            float(kernel.param), k // n_vb, n_vb, n_shards, enc.population,
            int(use_table), p[8], p[9])
    return _CudaStep(lib, enc, dev, k, args, keep, restarts, grid, smem,
                     use_table)


def _resident_blocks(lib, obj_id: int, smem: int, dev) -> int:
    """Blocks of ``WARPS`` warps and ``smem`` bytes that the card holds at
    once (the persistent grid), asked of the CUDA runtime once per library
    and shape (the call also lifts the kernel's shared-memory limit)."""
    def ask() -> int:
        blocks = ctypes.c_int(0)
        err = lib.popstep_grid(obj_id, smem, ctypes.byref(blocks))
        if err or blocks.value < 1:
            raise RuntimeError(f"popstep: no block of {WARPS * 32} threads "
                               f"and {smem} bytes fits the card (CUDA error "
                               f"{err})")
        return blocks.value

    return _GRIDS.get((lib._name, dev.index, obj_id, smem), ask)


def _units_of(masks: torch.Tensor) -> torch.Tensor:
    """The number of hidden units each mask marks."""
    units = torch.arange(RS_HIDDEN, device=masks.device)
    return ((masks[:, None] >> units) & 1).sum(1)


def fold_partials(part_val: torch.Tensor, part_row: torch.Tensor,
                  ids: torch.Tensor, n_vblocks: int,
                  sentinel: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold partial (value, row) pairs (see :func:`fold_partials_plain`
    for the rule): on CUDA tensors ``popstep_fold_kernel``, which runs
    the step kernel's own cross-block rule (``fold_vblocks``) over them,
    counted in ``fold_launches``; the plain rule on CPU tensors."""
    global fold_launches
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
    with _COUNTS:
        fold_launches += 1
    return out_val[0], out_id[0]


# ---------------------------------------------------------------------------
# public wrappers
# ---------------------------------------------------------------------------

def prepare_step_ids(objective, child_ids: torch.Tensor, enc: Encoding, *,
                     valid: torch.Tensor | None = None,
                     virtual_block: int | None = None, n_shards: int = 1,
                     restarts: int | None = None):
    """Bind a step over a fixed id subset once; returns ``launch(
    parent_bits) -> (best value, global child id)``, 0-d tensors on the
    ids' device with no host synchronisation.  On CUDA ids, ``launch``
    runs the kernel (after checking the inputs here, once); on CPU ids
    it runs the plain version.  See :func:`population_step_ids`.

    ``n_shards`` folds the virtual blocks per shard and then across shards
    (:func:`fold_values_plain`).  ``restarts=R`` binds ``launch(parents,
    live=None) -> (values, ids)`` over R parents ``(R, N)``: one kernel
    launch for every live parent on CUDA, the one-parent plain step per
    live parent on the CPU (:func:`population_steps_plain`)."""
    n_vb = _n_vblocks(child_ids.shape[0], virtual_block, n_shards)
    if child_ids.is_cuda:
        return _prepare_cuda(objective, child_ids, enc, valid, n_vb,
                             n_shards, restarts)
    if child_ids.device.type != "cpu":
        raise ValueError(f"popstep runs on CUDA or CPU tensors, got "
                         f"{child_ids.device}")

    def plain(parent_bits: torch.Tensor, live=None):
        if parent_bits.device != child_ids.device:
            raise ValueError(f"parent_bits is on {parent_bits.device}, "
                             f"child_ids on {child_ids.device}")
        if restarts is None:
            if live is not None:
                raise ValueError("a live flag needs a step bound with "
                                 "restarts=R")
            return population_step_ids_plain(
                objective, parent_bits, child_ids, enc, valid=valid,
                virtual_block=virtual_block, n_shards=n_shards)
        if parent_bits.shape != (restarts, enc.n_bits):
            raise ValueError(f"parent_bits must be ({restarts}, "
                             f"{enc.n_bits}), got {tuple(parent_bits.shape)}")
        return population_steps_plain(
            objective, parent_bits, child_ids, enc, valid=valid,
            virtual_block=virtual_block, n_shards=n_shards, live=live)

    return plain


def population_step_ids(objective, parent_bits: torch.Tensor,
                        child_ids: torch.Tensor, enc: Encoding, *,
                        valid: torch.Tensor | None = None,
                        virtual_block: int | None = None, n_shards: int = 1
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
    with ``jnp.argmin``'s NaN rule.  ``n_shards`` groups the virtual blocks
    into the shards of a mesh (:func:`fold_values_plain`).
    """
    return prepare_step_ids(objective, child_ids, enc, valid=valid,
                            virtual_block=virtual_block,
                            n_shards=n_shards)(parent_bits)


def child_values(objective, parent_bits: torch.Tensor,
                 child_ids: torch.Tensor, enc: Encoding,
                 valid: torch.Tensor | None = None, *,
                 reuse: bool = True) -> torch.Tensor:
    """(K,) float32 value of every child in ``child_ids`` (+inf where
    ``valid`` is False): on CUDA ids the buffer one kernel launch fills
    (counted in ``launches``; ``reuse=False`` recomputes every hidden unit
    of the remote-sensing MLP and takes Rastrigin's cosine a term instead
    of its level table, which must give the same bits); on CPU ids
    :func:`child_values_plain`."""
    if not child_ids.is_cuda:
        return child_values_plain(objective, parent_bits, child_ids, enc,
                                  valid)
    step = _prepare_cuda(objective, child_ids, enc, valid, 1, reuse=reuse)
    step(parent_bits)
    return step.values


def population_step(objective, parent_bits: torch.Tensor, enc: Encoding
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(N,) int8 parent -> (best value, best child id) over all 2N-1."""
    ids = torch.arange(enc.population, device=parent_bits.device)
    return population_step_ids(objective, parent_bits, ids, enc)
