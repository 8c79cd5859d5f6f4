"""Distributed DGO on one device: the engines behind ``Distributed`` and
``Batched``.

The layout and semantics follow ``repro.core.distributed``.  A mesh is
geometry only here (:class:`MeshGeometry`): the product of its sizes over
``pop_axes`` is the number of virtual shards, and every shard runs on the
one card.  The 2N-1 children are dealt ``chunk = ceil(pop / n_shards)`` a
shard; on round ``it`` shard ``s`` covers slot ``(s + it) % n_shards``, so
a dead shard (a False entry of the quorum mask, whose children are +inf)
shadows other children each round.  Inside a shard the children are cut
into virtual blocks of at most ``virtual_block`` (the paper's NCUBE
"virtual processing"); each block yields its best (value, child id), the
blocks fold into the shard's winner, the shards into the step's, which
replaces the parent if it is strictly better.

Selection, exactly as the reference engine does it:

* inside a block, a NaN child makes the block's value NaN, else the
  smallest value wins with ties to the smallest id;
* across a shard's blocks, a NaN block is ignored and the rest fold
  lexicographically on (value, id) from (+inf, pop); with a single block
  its result is used as it is;
* across shards, ``jnp.min`` over the gathered values: a NaN shard wins
  and the step then stalls (its winner carries no id); else the smallest
  value with the smallest id at it.  So a NaN child stalls a step whose
  shard holds one block, and only hides its own block in a shard of
  several;
* the winner's XOR pattern is gathered on the device from the (2N-1, N)
  pattern table (no bit string or id travels to the host), and
  ``improved = winner < parent``.

With every shard alive the rotation is invisible and one stall ends a run;
with a dead shard a run ends after ``n_shards`` steps in a row without an
improvement (a full rotation), on both drivers.

Inners (``inner=``): ``"popstep"`` runs the whole population through the
CUDA popstep kernel (one launch per step for every shard; its plain
version on the CPU), ``"fused"`` generates children by the hoisted XOR
patterns and decodes with one matmul, ``"jnp"`` keeps the literal generate
-> decode pipeline (the reference's name for it).  ``inner=None`` is
``"popstep"`` on CUDA and ``"fused"`` on the CPU.  A step is bound once per
quorum mask and rotation phase that occurs (one when every shard is
alive), and, for the kernel, per CUDA stream: a bound kernel step keeps
its selection state on the card.

Devices: every builder here takes ``device=None`` as the CUDA card and
raises ``RuntimeError`` without one (:func:`resolve_device`); pass
``device="cpu"`` for the plain PyTorch versions.

Drivers: ``"device"`` keeps the loop state in device tensors and reads
the stall flag on the host only every ``STALL_CHECK_EVERY`` steps, on
every device; steps after a stall are predicated no-ops (the parent
cannot change once no child beats it), so ``iters``, ``history`` and
``trace`` equal the reference's per-step loop.  ``"host"`` steps from Python, syncing the stall flag each
step, chains a multi-resolution schedule (paper step 5) and polls a
``runtime.failure.FailureInjector``: an injected failure drops a shard
from the quorum (``runtime.elastic.drop_shard``), and an empty quorum
stops the run with the best point so far.

Resolution schedules on the device driver (``res_bits`` with several
resolutions) run the folded engine of ``repro.core.distributed``: the
stacked ``population.ScheduleTables``, the shards planned at the FINEST
resolution with a chunk of ``ceil(pop_r / n_shards)`` children of each
resolution (offsets past it masked), one step bound per resolution, and
the escalation (paper step 5) applied when the host reads the stall flag
or has launched ``max_iters`` steps at a resolution.  :func:`_run_schedule`
is that loop; ``core/dgo.py``'s fused engine runs it too, with its own step.

The batched engine (``Batched``, ``solve_many``, the serving stack) steps
R restarts in lockstep: per-slot ``active`` flags and iteration caps, a
stall counter per slot, and on CUDA one popstep launch a step for every
live slot.  Each slot's trajectory is a function of its own start and cap
only, so a wave's slot equals the one-restart run bit for bit.
:func:`_submit_batched` runs a wave's loop on a worker thread, on a CUDA
stream of its own, and :meth:`PendingBatched.finish` joins it; a blocking
wave (:func:`_run_batched`, ``solve_many``) runs on the caller's thread
and stream.
"""
from __future__ import annotations

import math
import os
import threading
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.cache import get_cache
from repro_torch.core.encoding import Encoding, _f32, decode, decode_np, encode
from repro_torch.core.population import (
    ScheduleTables, generate_children, schedule_tables, table_on)
# the module, not its function: importing the wrapper first imports this
# module while the wrapper is still half-initialised
from repro_torch.kernels.popstep import ops as popstep_ops

_INNERS = ("fused", "popstep", "jnp")

# device driver: host reads of the stall flag (each one a synchronisation
# on the card; the CPU runs the same loop, so that its tests cover the
# predicated steps)
STALL_CHECK_EVERY = 16

# engine builds go through the keyed cache under the reference's name:
# "engines built" in the serving metrics counts the caches named *.engine
_ENGINES = get_cache("distributed.engine")


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA card, or ``RuntimeError`` when there is none;
    anything else is passed to ``torch.device`` as it is."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch versions on the CPU")
    return torch.device("cuda")


def _resolve_inner(inner: str | None, device: torch.device,
                   objective=None) -> str:
    """``None`` -> ``"popstep"`` on CUDA, ``"fused"`` elsewhere.  The
    kernel needs the objective's device form: ``"popstep"`` on CUDA with
    an objective that has none raises ``ValueError``."""
    if inner is None:
        inner = "popstep" if device.type == "cuda" else "fused"
    if inner not in _INNERS:
        raise ValueError(f"inner must be one of {_INNERS}, got {inner!r}")
    if (inner == "popstep" and device.type == "cuda"
            and getattr(objective, "kernel", None) is None):
        raise ValueError(
            "inner='popstep' on CUDA needs an objective with a device form "
            "(the registry objectives); pass inner='fused' for a custom "
            "objective")
    return inner


def _decode_matrix(enc: Encoding) -> np.ndarray:
    """(N, n_vars) weights: bit-string @ matrix = per-var lattice levels
    (MSB-first powers of two < 2^24, exact in float32)."""
    w = np.zeros((enc.n_bits, enc.n_vars), np.float32)
    weights = 2.0 ** np.arange(enc.bits - 1, -1, -1)
    for v in range(enc.n_vars):
        w[v * enc.bits: (v + 1) * enc.bits, v] = weights
    return w


# ---------------------------------------------------------------------------
# mesh geometry and quorum
# ---------------------------------------------------------------------------

class MeshGeometry(NamedTuple):
    """A mesh as the engines see it on one card: axis names and sizes.
    The product of the sizes over the population axes is the number of
    virtual shards (``repro.core.distributed._axis_prod``)."""

    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    def n_shards(self, pop_axes: Sequence[str]) -> int:
        n = 1
        for name in pop_axes:
            if name not in self.axis_names:
                raise ValueError(f"pop axis {name!r} is not an axis of the "
                                 f"mesh {self.axis_names}")
            n *= self.shape[name]
        return n


def fleet() -> tuple[int, int] | None:
    """(rank, world size) of a launcher fleet (``launch/launcher.py
    --processes K``: the default ``torch.distributed`` group, when it has
    more than one rank), else None."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    world = dist.get_world_size()
    return (dist.get_rank(), world) if world > 1 else None


# the backend of a group whose ranks each own a GPU: NCCL for CUDA tensors
# beside gloo for host ones (the host copies of the fleet's pairs)
CARD_BACKEND = "cpu:gloo,cuda:nccl"


def cuda_collectives() -> bool:
    """True when the default group carries CUDA tensors (NCCL); a gloo
    group (ranks sharing one GPU, or on the CPU) carries host copies."""
    return "nccl" in str(dist.get_backend())


def default_shards() -> int:
    """The shards of a default mesh: the launcher's ``--devices``
    (``DGO_DEVICES``, else 1) in each process of the fleet."""
    per = int(os.environ.get("DGO_DEVICES") or 1)
    fl = fleet()
    return per * (fl[1] if fl else 1)


def _fleet_fold(val: torch.Tensor, gid: torch.Tensor, pop: int):
    """The step's winner across a fleet: each process's (value, child id)
    pairs (one, or one a restart) all-gathered as 8-byte pairs over the
    default group, host copies, and folded by the cross-shard rule
    (``popstep_ops._shard_fold``; it is associative, so folding the
    processes' folds gives the fold over every shard)."""
    world = dist.get_world_size()
    pair = torch.stack([val.detach().reshape(-1).to("cpu", torch.float32)
                        .view(torch.int32),
                        gid.reshape(-1).to("cpu", torch.int32)], dim=-1)
    got = [torch.empty_like(pair) for _ in range(world)]
    dist.all_gather(got, pair)
    allp = torch.stack(got)                           # (world, R, 2)
    vals = allp[..., 0].contiguous().view(torch.float32)
    ids = allp[..., 1]
    folded = [popstep_ops._shard_fold(vals[:, r], ids[:, r], pop)
              for r in range(pair.shape[0])]
    v = torch.stack([f[0] for f in folded]).reshape(val.shape)
    g = torch.stack([f[1] for f in folded]).reshape(gid.shape)
    return v.to(val.device), g.to(gid.device)


def _n_shards(mesh, pop_axes: Sequence[str]) -> int:
    """Virtual shards of ``mesh`` (None: one) over ``pop_axes``."""
    return 1 if mesh is None else mesh.n_shards(tuple(pop_axes))


def _alive(quorum_mask, n_shards: int) -> tuple:
    """The quorum mask as a tuple of ``n_shards`` bools (None: all
    alive)."""
    if quorum_mask is None:
        return (True,) * n_shards
    if isinstance(quorum_mask, torch.Tensor):
        quorum_mask = quorum_mask.detach().cpu().numpy()
    mask = np.asarray(quorum_mask, dtype=bool).reshape(-1)
    if mask.shape != (n_shards,):
        raise ValueError(f"quorum_mask must have one entry per shard "
                         f"({n_shards}), got {mask.shape[0]}")
    return tuple(bool(a) for a in mask)


def _stall_limit(alive: tuple) -> int:
    """One step without an improvement ends a run of a full quorum; a
    degraded quorum needs a full rotation of them."""
    return 1 if all(alive) else len(alive)


class _ShardPlan(NamedTuple):
    """Static population-distribution geometry shared by every driver."""

    n_shards: int
    pop: int
    chunk: int       # children per shard (paper's virtual-processing count)
    n_blocks: int    # virtual blocks per shard
    block: int       # children per virtual block


def _shard_plan(pop: int, n_shards: int = 1,
                virtual_block: int = 256) -> _ShardPlan:
    chunk = math.ceil(pop / n_shards)
    n_blocks = math.ceil(chunk / virtual_block)
    block = math.ceil(chunk / n_blocks)
    return _ShardPlan(n_shards, pop, chunk, n_blocks, block)


def _resolve_res_bits(enc: Encoding, res_bits) -> tuple:
    """Normalize a schedule argument: ``None`` -> fixed at ``enc.bits``."""
    if res_bits is None:
        return (enc.bits,)
    res_bits = tuple(int(b) for b in res_bits)
    return res_bits or (enc.bits,)


def _shard_rows(enc: Encoding, plan: _ShardPlan, alive: tuple, phase: int,
                bounded: bool, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The rows of one step, shard after shard: (ids clamped below the
    population, valid).  Shard ``s`` covers slot ``(s + phase) % n_shards``
    of ``chunk`` children, in ``n_blocks`` blocks of ``block`` offsets.
    The fixed-resolution engines take ``chunk`` of the plan and mask ids
    past the population only (an offset past the chunk evaluates a child
    of the next slot again, as the reference's blocks do); ``bounded``
    (the folded schedule) takes ``ceil(pop_r / n_shards)`` of the live
    population and also masks offsets past it.  A dead shard's rows are
    all invalid (+inf)."""
    pop, n_shards = enc.population, plan.n_shards
    chunk = math.ceil(pop / n_shards) if bounded else plan.chunk
    offs = np.arange(plan.n_blocks * plan.block)
    ids, valid = [], []
    for s in range(n_shards):
        slot_ids = ((s + phase) % n_shards) * chunk + offs
        ok = (slot_ids < pop) & alive[s]
        if bounded:
            ok &= offs < chunk
        ids.append(np.minimum(slot_ids, pop - 1))
        valid.append(ok)
    return (torch.as_tensor(np.concatenate(ids)).to(device),
            torch.as_tensor(np.concatenate(valid)).to(device))


def _block_fold(vals: torch.Tensor, ids: torch.Tensor, pop: int):
    """The reference engine's selection over (n_shards, n_blocks, block)
    values (module docstring): ``min`` per block (NaN wins) with the
    smallest id at that value, the blocks of each shard (one: as it is;
    several: NaN blocks dropped, lexicographic from (+inf, pop)), then
    across shards the rule of the kernel's ``fold_shards`` (a NaN shard
    wins with id ``pop``, else the smallest value with the smallest id at
    it: ``jnp.min`` over the gathered values)."""
    v = vals.amin(2)
    gid = torch.where(vals == v[..., None], ids, pop).amin(2)
    if vals.shape[1] == 1:
        sv, sg = v[:, 0], gid[:, 0]
    else:
        keep = ~torch.isnan(v)
        v2 = torch.where(keep, v, torch.inf)
        g2 = torch.where(keep, gid, pop)
        sv = v2.amin(1)
        sg = torch.where(v2 == sv[:, None], g2, pop).amin(1)
    return popstep_ops._shard_fold(sv, sg, pop)


def _stream_key(device: torch.device):
    """The CUDA stream a bound kernel step belongs to (None off the
    card)."""
    if device.type != "cuda":
        return None
    return torch.cuda.current_stream(device).cuda_stream


def _build_shard_step(objective, enc: Encoding, plan: _ShardPlan,
                      inner: str, device: torch.device, *,
                      bounded: bool = False, restarts: int | None = None):
    """One DGO iteration over every shard.  Returns ``prepare(quorum_mask)
    -> step``; ``step(parent_bits, parent_val, it=0) -> (new_bits,
    new_val, improved)``, or with ``restarts=R`` ``step(parents (R, N),
    vals (R,), it, live (R,) bool) -> (new_bits, new_vals, improved)``,
    all on the device.  The rows of each (quorum, rotation phase) that
    occurs are bound once, on first use (for the kernel, once per CUDA
    stream); with every shard alive the phase does not change the step
    and one binding serves every round.  ``plan`` may cover more ids than
    ``enc.population`` (the folded engine plans every resolution at the
    finest one, ``bounded``): rows past it are masked to +inf.

    With R restarts the kernel steps every live parent in one launch;
    the plain inners run the one-parent step on each parent, so a
    parent's result does not depend on the others.

    In a fleet (:func:`fleet`) of W processes, process ``r`` steps shards
    ``r * S/W .. (r+1) * S/W - 1`` of the S and the processes' (value,
    id) pairs are all-gathered every step (:func:`_fleet_fold`), so every
    process takes the step one process of S shards takes."""
    pop, n_shards = enc.population, plan.n_shards
    fl = fleet()
    if fl is not None and n_shards % fl[1]:
        raise ValueError(f"{n_shards} shards do not divide over a fleet of "
                         f"{fl[1]} processes")
    rank, local = (fl[0], n_shards // fl[1]) if fl else (0, n_shards)
    rows = plan.n_blocks * plan.block
    shape = (local, plan.n_blocks, plan.block)
    f_batch = objective.fn
    pat = table_on("patterns", enc.n_bits, device)          # (2N-1, N) int8
    if inner == "fused":
        wmat = torch.as_tensor(_decode_matrix(enc), device=device)
        scale, lo = _f32(enc.scale, wmat), _f32(enc.lo, wmat)
    bindings: dict = {}

    def plain_best(parent_bits, ids_c, valid):
        if inner == "fused":
            children = torch.bitwise_xor(parent_bits[None, :], pat[ids_c])
            xs = (children.to(torch.float32) @ wmat) * scale + lo
        else:
            xs = decode(generate_children(parent_bits, ids_c), enc)
        vals = torch.where(valid, f_batch(xs).to(torch.float32), torch.inf)
        return _block_fold(vals.reshape(shape), ids_c.reshape(shape), pop)

    def bound(alive: tuple, phase: int):
        """The (value, id) function of a quorum and phase, bound once."""
        if all(alive):
            phase = 0
        key = (alive, phase, _stream_key(device) if inner == "popstep"
               else None)
        fn = bindings.get(key)
        if fn is None:
            ids_c, valid = _shard_rows(enc, plan, alive, phase, bounded,
                                       device)
            if fl is not None:         # this process's shards
                ids_c = ids_c[rank * local * rows:(rank + 1) * local * rows]
                valid = valid[rank * local * rows:(rank + 1) * local * rows]
            if inner == "popstep":     # one kernel launch per step
                fn = popstep_ops.prepare_step_ids(
                    objective, ids_c, enc, valid=valid,
                    virtual_block=plan.block, n_shards=local,
                    restarts=restarts)
            elif restarts is None:
                def fn(parent_bits, ids_c=ids_c, valid=valid):
                    return plain_best(parent_bits, ids_c, valid)
            else:
                def fn(parents, live, ids_c=ids_c, valid=valid):
                    # each parent alone; a parent that is not live is
                    # skipped where the flag can be read without a sync
                    flags = (live.tolist() if live.device.type == "cpu"
                             else [True] * parents.shape[0])
                    return popstep_ops.each_parent(
                        lambda p: plain_best(p, ids_c, valid), parents,
                        flags, pop)
            if fl is not None:
                def fn(*args, local_fn=fn):
                    return _fleet_fold(*local_fn(*args), pop)
            bindings[key] = fn
        return fn

    def select(parent_bits, parent_val, local_val, local_id):
        # a NaN winner carries no id (the reference's packed gather)
        win_id = torch.where(local_val == local_val,
                             local_id.to(torch.int64), pop)
        improved = local_val < parent_val
        # index_select, not pat[win_id]: indexing with a 0-d tensor reads
        # it on the host, a synchronisation per step
        win_pat = pat.index_select(0, win_id.clamp(0, pop - 1).reshape(-1))
        win_bits = torch.bitwise_xor(parent_bits,
                                     win_pat.reshape(parent_bits.shape))
        keep = improved[..., None] if restarts is not None else improved
        new_bits = torch.where(keep, win_bits, parent_bits)
        new_val = torch.where(improved, local_val, parent_val)
        return new_bits, new_val, improved

    def prepare(quorum_mask=None):
        alive = _alive(quorum_mask, n_shards)

        if restarts is None:
            def step(parent_bits, parent_val, it=0):
                local_val, local_id = bound(alive, int(it) % n_shards)(
                    parent_bits)
                return select(parent_bits, parent_val, local_val, local_id)
        else:
            def step(parents, vals, it, live):
                local_val, local_id = bound(alive, int(it) % n_shards)(
                    parents, live)
                # outputs of a parent that is not live are not written
                local_val = torch.where(live, local_val, torch.inf)
                return select(parents, vals, local_val, local_id)

        return step

    return prepare


def _as_f32(x0, device) -> torch.Tensor:
    """A start point (tensor, array or list) as a float32 tensor on
    ``device``, copied from numpy (a read-only array included)."""
    if isinstance(x0, torch.Tensor):
        return x0.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.array(x0, dtype=np.float32)).to(device)


def _initial(objective, enc: Encoding, x0, device):
    x = _as_f32(x0, device)
    bits = encode(x, enc)
    val = objective.fn(decode(bits, enc)[None])[0].to(torch.float32)
    return bits, val


def make_distributed_step(objective, enc: Encoding, *, mesh=None,
                          pop_axes: Sequence[str] = ("data",),
                          virtual_block: int = 256,
                          inner: str | None = None, device=None):
    """One-iteration step: ``step(parent_bits, parent_val, quorum_mask=None,
    it=0) -> (new_bits, new_val, improved)``, all device tensors.  ``it``
    rotates the shards' slots (round ``it``: shard ``s`` covers slot
    ``(s + it) % n_shards``).

    ``objective`` carries ``fn`` ((B, n_vars) -> (B,)) and, for the
    popstep kernel, its ``kernel`` form (a registry
    :class:`~repro_torch.core.objectives.Objective`).  ``mesh`` is a
    :class:`MeshGeometry` (None: one shard).  ``device=None`` is the CUDA
    card (:func:`resolve_device`)."""
    device = resolve_device(device)
    inner = _resolve_inner(inner, device, objective)
    plan = _shard_plan(enc.population, _n_shards(mesh, pop_axes),
                       virtual_block)
    prepare = _build_shard_step(objective, enc, plan, inner, device)
    steps: dict = {}

    def step(parent_bits, parent_val, quorum_mask=None, it=0):
        alive = _alive(quorum_mask, plan.n_shards)
        if alive not in steps:
            steps[alive] = prepare(alive)
        return steps[alive](parent_bits, parent_val, it)

    return step


def _predicated_run(step, bits, val, max_iters: int, stall_limit: int = 1):
    """Up to ``max_iters`` steps of ``step(bits, val, k)`` from ``(bits,
    val)`` on the device, until ``stall_limit`` steps in a row without an
    improvement: the host reads the stall flag every ``STALL_CHECK_EVERY``
    steps, and steps after the stall are predicated no-ops (not counted).
    Returns ``(bits, val, vals, iters)``: ``vals`` (max_iters + 1,) holds
    the start value and the parent value after each launched step (those
    past ``iters`` repeat the final value), ``iters`` the steps taken, a
    device scalar."""
    device = val.device
    vals = val.repeat(max_iters + 1)
    stalls = torch.zeros((), dtype=torch.int32, device=device)
    iters = torch.zeros((), dtype=torch.int64, device=device)
    for k in range(max_iters):
        new_bits, new_val, improved = step(bits, val, k)
        live = stalls < stall_limit
        bits = torch.where(live, new_bits, bits)
        val = torch.where(live, new_val, val)
        vals[k + 1] = val
        iters = iters + live.to(torch.int64)
        stalls = torch.where(live & improved, 0,
                             stalls + live.to(torch.int32))
        if (k + 1) % STALL_CHECK_EVERY == 0 and bool(
                stalls >= stall_limit):
            break
    return bits, val, vals, iters


class ScheduleRun(NamedTuple):
    """One run of a resolution schedule, as the host reads it back.

    ``starts[r]``/``finals[r]`` are the (value, bits) device pairs of the
    parent entering and leaving resolution ``r`` (entering: the start,
    then each re-encode; with ``escalate_last`` one more start, the last
    resolution's parent re-encoded at that resolution); ``bits`` are at
    the resolution's own width.  ``start_vals``/``final_vals`` are their
    values on the host, ``live[r]`` the steps taken at ``r`` and
    ``history`` the raw parent value after each step, ``history[0]`` the
    start (re-encodes are not recorded)."""

    starts: list
    finals: list
    start_vals: np.ndarray
    final_vals: np.ndarray
    live: list
    history: list

    def best(self) -> tuple:
        """The best parent found, (value, bits, resolution), as the
        reference's engines track it: a running strict ``<`` (a NaN never
        wins, and a NaN start is never beaten) over each resolution's
        start, then its final parent (the values inside a resolution
        never rise, so its steps' best is its final parent), then any
        last re-encode."""
        cands = []
        for r, (v, b) in enumerate(self.starts):
            cands.append((self.start_vals[r], v, b,
                          min(r, len(self.finals) - 1)))
            if r < len(self.finals):
                v, b = self.finals[r]
                cands.append((self.final_vals[r], v, b, r))
        best = cands[0]
        for c in cands[1:]:
            if c[0] < best[0]:
                best = c
        return best[1:]


def _run_schedule(objective, tables: ScheduleTables, steps: list, bits, val,
                  max_iters: int, *, escalate_last: bool = False,
                  stall_limit: int = 1) -> ScheduleRun:
    """Run the resolution schedule of ``tables`` from the parent ``(bits,
    val)`` at resolution 0: at each resolution ``r``, ``steps[r]`` until
    ``stall_limit`` steps in a row without an improvement or ``max_iters``
    steps (:func:`_predicated_run`; the step's round restarts at 0), then
    the parent re-encoded at the next resolution and evaluated (paper step
    5).  ``escalate_last`` also re-encodes after the last resolution, at
    that resolution, as the fused engine does.  One host read at the end
    carries every value."""
    f = objective.fn
    n_res = tables.n_res
    starts, finals, runs = [(val, bits)], [], []
    for r in range(n_res):
        if r > 0:
            bits, val = _escalate(f, tables, bits, r - 1, r)
            starts.append((val, bits))
        bits, val, vals, iters = _predicated_run(steps[r], bits, val,
                                                 max_iters, stall_limit)
        finals.append((val, bits))
        runs.append((vals, iters))
    if escalate_last:
        bits, val = _escalate(f, tables, bits, n_res - 1, n_res - 1)
        starts.append((val, bits))
    host = torch.cat([
        torch.stack([v for v, _ in starts]),
        torch.stack([v for v, _ in finals]),
        torch.stack([it for _, it in runs]).to(torch.float32),
        torch.cat([vals for vals, _ in runs])]).cpu().numpy()
    n_s = len(starts)
    start_vals = host[:n_s]
    final_vals = host[n_s:n_s + n_res]
    live = [int(i) for i in host[n_s + n_res:n_s + 2 * n_res]]
    vals = host[n_s + 2 * n_res:].reshape(n_res, max_iters + 1)
    history = [float(start_vals[0])]
    for r in range(n_res):
        history.extend(float(v) for v in vals[r, 1:live[r] + 1])
    return ScheduleRun(starts, finals, start_vals, final_vals, live,
                       history)


def _escalate(f, tables: ScheduleTables, bits, r: int, nxt: int):
    """Paper step 5: the parent at resolution ``r`` re-encoded at ``nxt``
    (at ``nxt``'s own width), and its value."""
    bits = tables.reencode(bits, r, nxt)[: tables.encodings[nxt].n_bits]
    return bits, f(tables.decode(bits, nxt)[None])[0].to(torch.float32)


def _schedule_inner(inner: str | None, device: torch.device,
                    objective) -> str:
    """The schedule engines' step: the popstep kernel on CUDA for an
    objective with a device form, else the plain tensor step
    (``"fused"``); an explicit ``inner`` must be None or ``"fused"``, as in
    the reference (``inner="fused"`` is the plain step on any device)."""
    if inner not in (None, "fused"):
        raise ValueError(
            f"the folded resolution schedule supports inner='fused' only "
            f"(or None: the popstep kernel on the card); got inner={inner!r}")
    if (inner is None and device.type == "cuda"
            and getattr(objective, "kernel", None) is not None):
        return "popstep"
    return "fused"


def make_distributed_engine(objective, enc: Encoding, *, mesh=None,
                            pop_axes: Sequence[str] = ("data",),
                            max_iters: int = 256, virtual_block: int = 256,
                            inner: str | None = None, device=None,
                            res_bits: Sequence[int] | None = None):
    """The device-driver engine on ``device`` (``None``: the CUDA card, see
    :func:`resolve_device`) over the shards of ``mesh`` (a
    :class:`MeshGeometry`; None: one).  The host reads the stall flag
    every ``STALL_CHECK_EVERY`` steps; steps after a stall are predicated
    no-ops.

    Fixed resolution (``res_bits`` None or one entry): ``engine(x0,
    quorum_mask=None) -> (bits, val, iters, trace)`` with ``trace`` a
    (max_iters + 1,) history (``trace[0]`` the start value, entries past
    ``iters`` padded with the final value), all on the device.

    Folded schedule (``res_bits`` with several resolutions):
    ``engine(x0, quorum_mask=None) -> (best_bits, best_val, best_res_idx,
    iters, trace)``: ``best_bits`` the (n_vars * max(res_bits),) buffer of
    the best parent found (live prefix ``n_vars * res_bits[best_res_idx]``)
    and ``best_val`` its value, on the device; ``best_res_idx`` and
    ``iters`` ints; ``trace`` a CPU float32 tensor of capacity
    ``len(res_bits) * max_iters + 1`` (raw per-iteration parent values,
    re-encodes not recorded, padded with the final value).  The shards of
    every resolution are planned at the finest one, and each
    resolution's step is built here, once; ``inner`` must be None or
    ``"fused"`` (:func:`_schedule_inner`)."""
    device = resolve_device(device)
    n_shards = _n_shards(mesh, pop_axes)
    schedule = _resolve_res_bits(enc, res_bits)
    if len(schedule) > 1:
        return _schedule_engine(objective, enc, schedule, max_iters,
                                virtual_block, inner, device, n_shards)
    inner = _resolve_inner(inner, device, objective)
    plan = _shard_plan(enc.population, n_shards, virtual_block)
    prepare = _build_shard_step(objective, enc, plan, inner, device)

    def engine(x0, quorum_mask=None):
        alive = _alive(quorum_mask, n_shards)
        bits, val = _initial(objective, enc, x0, device)
        bits, val, trace, iters = _predicated_run(
            prepare(alive), bits, val, max_iters, _stall_limit(alive))
        idx = torch.arange(max_iters + 1, device=device)
        trace = torch.where(idx <= iters, trace, val)
        return bits, val, iters, trace

    return engine


def _schedule_engine(objective, enc: Encoding, schedule: tuple,
                     max_iters: int, virtual_block: int, inner: str | None,
                     device: torch.device, n_shards: int = 1):
    inner = _schedule_inner(inner, device, objective)
    tables = schedule_tables(enc.n_vars, schedule, enc.lo, enc.hi, device)
    plan = _shard_plan(tables.p_max, n_shards, virtual_block)
    prepares = [_build_shard_step(objective, e, plan, inner, device,
                                  bounded=True)
                for e in tables.encodings]
    t_max = tables.n_res * max_iters + 1

    def engine(x0, quorum_mask=None):
        alive = _alive(quorum_mask, n_shards)
        steps = [prepare(alive) for prepare in prepares]
        bits, val = _initial_at(objective, tables, x0, device)
        run = _run_schedule(objective, tables, steps, bits, val, max_iters,
                            stall_limit=_stall_limit(alive))
        best_val, best_bits, best_res = run.best()
        trace = torch.full((t_max,), run.history[-1], dtype=torch.float32)
        trace[: len(run.history)] = torch.tensor(run.history)
        best_bits = torch.nn.functional.pad(
            best_bits, (0, tables.n_max - best_bits.shape[0]))
        return best_bits, best_val, best_res, len(run.history) - 1, trace

    return engine


def _initial_at(objective, tables: ScheduleTables, x0, device):
    """The start parent at resolution 0 of a schedule (its own width) and
    its value."""
    x = _as_f32(x0, device)
    bits = tables.encode(x, 0)[..., : tables.encodings[0].n_bits]
    val = objective.fn(tables.decode(bits, 0).reshape(-1, tables.n_vars))
    return bits, val.to(torch.float32).reshape(bits.shape[:-1])


def _run_fixed_resolution(objective, enc: Encoding, x0, max_iters: int,
                          virtual_block: int, inner: str, driver: str,
                          device: torch.device, mesh=None,
                          pop_axes: Sequence[str] = ("data",),
                          quorum_mask=None, injector=None):
    """One fixed-resolution run at ``enc.bits``; returns
    ``(bits, val, history)``.  On the host driver an ``injector``'s
    failure drops a shard for the rest of this resolution, and an empty
    quorum stops it with the parent so far."""
    n_shards = _n_shards(mesh, pop_axes)
    alive = _alive(quorum_mask, n_shards)
    if driver == "device":
        engine = make_distributed_engine(
            objective, enc, mesh=mesh, pop_axes=pop_axes,
            max_iters=max_iters, virtual_block=virtual_block, inner=inner,
            device=device)
        bits, val, iters, trace = engine(x0, alive)
        # ONE device->host transfer for the whole history
        history = trace[: int(iters) + 1].cpu().tolist()
        return bits, val, history

    plan = _shard_plan(enc.population, n_shards, virtual_block)
    prepare = _build_shard_step(objective, enc, plan, inner, device)
    if injector is not None:
        from repro_torch.runtime.elastic import drop_shard
        from repro_torch.runtime.failure import SimulatedFailure
    step = prepare(alive)
    bits, val = _initial(objective, enc, x0, device)
    vals = [val]
    stalls = 0
    for it in range(max_iters):
        if injector is not None:
            try:
                injector.maybe_fail(it)
            except SimulatedFailure:
                try:
                    alive = _alive(drop_shard(np.asarray(alive)), n_shards)
                except RuntimeError:    # every shard lost: stop with the
                    break               # parent found so far
                step = prepare(alive)
        bits, val, improved = step(bits, val, it)
        vals.append(val)
        # the stall rule of the device driver: a degraded quorum needs a
        # full rotation of steps without an improvement
        stalls = 0 if bool(improved) else stalls + 1
        if stalls >= _stall_limit(alive):
            break
    return bits, val, torch.stack(vals).cpu().tolist()


def _run_distributed(objective, enc: Encoding, x0, *, mesh=None,
                     pop_axes: Sequence[str] = ("data",),
                     max_iters: int = 256, virtual_block: int = 256,
                     quorum_mask=None, inner: str | None = None,
                     driver: str = "device", injector=None,
                     res_bits: Sequence[int] | None = None, device=None):
    """Distributed DGO over the resolution schedule ``res_bits`` (``None``
    -> fixed at ``enc.bits``) on one device (``None``: the CUDA card, see
    :func:`resolve_device`), over the shards of ``mesh`` under
    ``quorum_mask``.

    Returns ``(bits, val, history, bits_resolution)``: the best parent's
    bit string at its own resolution, its value, and the raw
    per-iteration value history (``history[0]`` the starting value;
    escalation re-encodes are not recorded).  The configuration is
    checked before any tensor reaches ``device``."""
    if driver not in ("device", "host"):
        raise ValueError(f"driver must be 'device' or 'host', got {driver!r}")
    if injector is not None and driver != "host":
        raise ValueError("failure injection requires driver='host' — "
                         "the device loop cannot interpose host policy")
    n_shards = _n_shards(mesh, pop_axes)
    alive = _alive(quorum_mask, n_shards)
    schedule = _resolve_res_bits(enc, res_bits)
    device = resolve_device(device)
    if driver == "device" and len(schedule) > 1:
        engine = make_distributed_engine(
            objective, enc.with_bits(schedule[0]), mesh=mesh,
            pop_axes=pop_axes, max_iters=max_iters,
            virtual_block=virtual_block, inner=inner, device=device,
            res_bits=schedule)
        best_bits, best_val, best_res, iters, trace = engine(x0, alive)
        b = schedule[best_res]
        return (best_bits[: enc.n_vars * b], best_val,
                trace[: iters + 1].tolist(), b)
    inner = _resolve_inner(inner, device, objective)

    x = _as_f32(x0, device)
    history: list[float] = []
    best = None   # (float val, device val, bits, bits-per-var)
    for i, b in enumerate(schedule):
        enc_b = enc.with_bits(b)
        bits, val, hist = _run_fixed_resolution(
            objective, enc_b, x, max_iters, virtual_block, inner, driver,
            device, mesh, pop_axes, alive, injector)
        history.extend(hist if i == 0 else hist[1:])
        if best is None or hist[-1] < best[0]:
            best = (hist[-1], val, bits, b)
        x = decode(bits, enc_b)
    _, best_val, best_bits, best_b = best
    return best_bits, best_val, history, best_b


# ---------------------------------------------------------------------------
# the batched engine: R restarts in lockstep (the MP-1 cluster mode over
# concurrent requests)
# ---------------------------------------------------------------------------

def _parent_vals(objective, xs: torch.Tensor) -> torch.Tensor:
    """The objective at each row of ``xs`` (R, n_vars), every row
    evaluated alone, so a slot's start value does not depend on how many
    rows ride the wave (the reference's ``_parent_vals``)."""
    f = objective.fn
    return torch.stack([f(xs[i:i + 1])[0] for i in range(xs.shape[0])]
                       ).to(torch.float32)


def _batched_live(active, stalls, stall_limit: int, iters, slot_iters):
    return active & (stalls < stall_limit) & (iters < slot_iters)


def make_distributed_engine_batched(objective, enc: Encoding,
                                    n_restarts: int, *, mesh=None,
                                    pop_axes: Sequence[str] = ("data",),
                                    max_iters: int = 256,
                                    virtual_block: int = 256,
                                    res_bits: Sequence[int] | None = None,
                                    inner: str | None = None, device=None):
    """The engine over R lockstep restarts, on ``device`` (None: the CUDA
    card).  Every call takes per-slot arrays beside the start points:
    ``vals0`` (R,) the objective at each snapped start (evaluated outside,
    row by row, :func:`_parent_vals`), ``active`` (R,) bool (padding slots
    never step) and ``slot_iters`` (R,) int, each slot's own cap (per
    resolution on the schedule path).  A slot steps while it is active,
    has fewer than ``stall_limit`` steps in a row without an improvement
    and is under its cap; on CUDA every live slot's step is one popstep
    launch for all of them (``inner`` None or ``"popstep"``), and the host
    reads whether any slot is live every ``STALL_CHECK_EVERY`` steps.

    Fixed resolution: ``engine(x0s (R, n_vars), vals0, quorum_mask,
    active, slot_iters) -> (bits (R, N), vals (R,), iters (R,), trace
    (R, max_iters + 1))``.  Folded schedule: the batch escalates in
    lockstep once no slot is live (or ``max_iters`` steps at a
    resolution), every slot's re-encode evaluated row by row; returns
    ``(bits (R, N_r), vals (R,), best_vals (R,), best_bits (R, n_max),
    best_res (R,), iters (R,), trace (R, len(res_bits) * max_iters + 1))``
    with ``best_*`` each slot's best parent across resolutions.  All on
    the device; ``active`` and ``slot_iters`` may be numpy arrays."""
    device = resolve_device(device)
    n_shards = _n_shards(mesh, pop_axes)
    schedule = _resolve_res_bits(enc, res_bits)
    if inner not in (None, "fused", "popstep", "jnp"):
        raise ValueError(f"inner must be one of {_INNERS}, got {inner!r}")
    if inner is None:
        inner = _schedule_inner(None, device, objective)
    if len(schedule) > 1:
        return _schedule_engine_batched(objective, enc, n_restarts, schedule,
                                        max_iters, virtual_block, inner,
                                        device, n_shards)
    plan = _shard_plan(enc.population, n_shards, virtual_block)
    prepare = _build_shard_step(objective, enc, plan, inner, device,
                                restarts=n_restarts)

    def engine(x0s, vals0, quorum_mask, active, slot_iters):
        alive = _alive(quorum_mask, n_shards)
        limit = _stall_limit(alive)
        step = prepare(alive)
        act, caps = _slot_arrays(active, slot_iters, n_restarts, device)
        bits = encode(_as_f32(x0s, device), enc)
        vals = vals0.to(device=device, dtype=torch.float32)
        stalls = torch.zeros(n_restarts, dtype=torch.int32, device=device)
        iters = torch.zeros(n_restarts, dtype=torch.int32, device=device)
        trace = vals[:, None].repeat(1, max_iters + 1)
        for k in range(max_iters if _any_steps(active, slot_iters) else 0):
            live = _batched_live(act, stalls, limit, iters, caps)
            nb, nv, improved = step(bits, vals, k, live)
            bits = torch.where(live[:, None], nb, bits)
            vals = torch.where(live, nv, vals)
            iters = iters + live.to(torch.int32)
            trace[:, k + 1] = torch.where(live, vals, trace[:, k])
            stalls = torch.where(live & improved, 0,
                                 stalls + live.to(torch.int32))
            if ((k + 1) % STALL_CHECK_EVERY == 0 and not bool(
                    _batched_live(act, stalls, limit, iters, caps).any())):
                break
        idx = torch.arange(max_iters + 1, device=device)[None, :]
        trace = torch.where(idx <= iters[:, None], trace, vals[:, None])
        return bits, vals, iters, trace

    return engine


def _slot_arrays(active, slot_iters, n_restarts: int, device):
    act = torch.as_tensor(np.asarray(active, bool)).to(device)
    caps = torch.as_tensor(np.asarray(slot_iters, np.int32)).to(device)
    if act.shape != (n_restarts,) or caps.shape != (n_restarts,):
        raise ValueError(f"active/slot_iters must be ({n_restarts},), got "
                         f"{tuple(act.shape)}/{tuple(caps.shape)}")
    return act, caps


def _any_steps(active, slot_iters) -> bool:
    """Whether any slot can step at all (host arrays: no device read)."""
    return bool((np.asarray(active, bool)
                 & (np.asarray(slot_iters) > 0)).any())


def _schedule_engine_batched(objective, enc: Encoding, n_restarts: int,
                             schedule: tuple, max_iters: int,
                             virtual_block: int, inner: str,
                             device: torch.device, n_shards: int):
    tables = schedule_tables(enc.n_vars, schedule, enc.lo, enc.hi, device)
    plan = _shard_plan(tables.p_max, n_shards, virtual_block)
    prepares = [_build_shard_step(objective, e, plan, inner, device,
                                  bounded=True, restarts=n_restarts)
                for e in tables.encodings]
    n_res, n_max = tables.n_res, tables.n_max
    t_max = n_res * max_iters + 1
    rows = torch.arange(n_restarts, device=device)

    def wide(bits):
        return torch.nn.functional.pad(bits, (0, n_max - bits.shape[1]))

    def engine(x0s, vals0, quorum_mask, active, slot_iters):
        alive = _alive(quorum_mask, n_shards)
        limit = _stall_limit(alive)
        steps = [prepare(alive) for prepare in prepares]
        act, caps = _slot_arrays(active, slot_iters, n_restarts, device)
        any_steps = _any_steps(active, slot_iters)
        x = _as_f32(x0s, device)
        bits = tables.encode(x, 0)[:, : tables.encodings[0].n_bits]
        vals = vals0.to(device=device, dtype=torch.float32)
        best_vals, best_bits = vals.clone(), wide(bits)
        best_res = torch.zeros(n_restarts, dtype=torch.int32, device=device)
        pos = torch.zeros(n_restarts, dtype=torch.int32, device=device)
        trace = vals[:, None].repeat(1, t_max)
        for r in range(n_res):
            if r > 0:                   # paper step 5, in lockstep
                bits = tables.reencode(bits, r - 1, r)[
                    :, : tables.encodings[r].n_bits]
                vals = _parent_vals(objective, tables.decode(bits, r))
                better = vals < best_vals
                best_vals = torch.where(better, vals, best_vals)
                best_bits = torch.where(better[:, None], wide(bits),
                                        best_bits)
                best_res = torch.where(better, r, best_res)
            stalls = torch.zeros(n_restarts, dtype=torch.int32,
                                 device=device)
            for k in range(max_iters if any_steps else 0):
                live = _batched_live(act, stalls, limit, k, caps)
                nb, nv, improved = steps[r](bits, vals, k, live)
                bits = torch.where(live[:, None], nb, bits)
                vals = torch.where(live, nv, vals)
                pos = pos + live.to(torch.int32)
                trace[rows, pos.clamp(0, t_max - 1)] = vals
                stalls = torch.where(live & improved, 0,
                                     stalls + live.to(torch.int32))
                better = vals < best_vals
                best_vals = torch.where(better, vals, best_vals)
                best_bits = torch.where(better[:, None], wide(bits),
                                        best_bits)
                best_res = torch.where(better, r, best_res)
                if ((k + 1) % STALL_CHECK_EVERY == 0 and not bool(
                        _batched_live(act, stalls, limit, k + 1,
                                      caps).any())):
                    break
        idx = torch.arange(t_max, device=device)[None, :]
        trace = torch.where(idx <= pos[:, None], trace, vals[:, None])
        return bits, vals, best_vals, best_bits, best_res, pos, trace

    return engine


def _batched_engine_for(objective, enc: Encoding, mesh, n_restarts: int,
                        pop_axes: tuple, max_iters: int, virtual_block: int,
                        res_bits: tuple, inner, device: torch.device):
    """The batched engine, built once per objective, geometry, width and
    device (``distributed.engine``)."""
    return _ENGINES.get(
        ("batched", objective.fn, enc, mesh, n_restarts, pop_axes,
         max_iters, virtual_block, res_bits, inner, str(device)),
        lambda: make_distributed_engine_batched(
            objective, enc, n_restarts, mesh=mesh, pop_axes=pop_axes,
            max_iters=max_iters, virtual_block=virtual_block,
            res_bits=res_bits, inner=inner, device=device))


class BatchedResult(NamedTuple):
    """Result of the batched engine (R concurrent restarts)."""

    bits: torch.Tensor     # (R, N) int8: final-resolution string a restart
    values: torch.Tensor   # (R,) f32: best value a restart
    iterations: np.ndarray  # (R,) int: population steps taken a restart
    trace: np.ndarray      # (R, T) f32: value history a restart
    best: int              # index of the winning restart
    best_xs: np.ndarray | None = None   # (R, n_vars), schedule path only:
    #                       each restart's best point at its own resolution


class PendingBatched:
    """One wave submitted by :func:`_submit_batched`: its stepped loop runs
    on a worker thread (on the card, on a CUDA stream of its own), or has
    run already on the caller's.  :meth:`finish` joins the thread,
    re-raises its error and assembles the :class:`BatchedResult`."""

    __slots__ = ("_finish",)

    def __init__(self, finish):
        self._finish = finish

    def finish(self, timeout: float | None = None) -> BatchedResult:
        """Wait for the wave (``TimeoutError`` after ``timeout`` seconds)
        and assemble its result; an error of the wave's loop is raised
        here."""
        return self._finish(timeout)


class _StreamPool:
    """CUDA streams for the waves' worker threads, reused so that the
    steps bound on a stream are reused too."""

    def __init__(self):
        self._free: dict = {}
        self._lock = threading.Lock()

    def acquire(self, device: torch.device):
        with self._lock:
            free = self._free.setdefault(device.index, [])
            if free:
                return free.pop()
        return torch.cuda.Stream(device)

    def release(self, device: torch.device, stream) -> None:
        with self._lock:
            self._free.setdefault(device.index, []).append(stream)


_STREAMS = _StreamPool()


class _Wave(threading.Thread):
    """A wave's loop on its own thread (and CUDA stream); ``ready`` is an
    event of the submitting stream that the wave's stream waits for."""

    def __init__(self, fn, device: torch.device, inputs: list):
        super().__init__(name="dgo-wave", daemon=True)
        self._fn, self._device, self._inputs = fn, device, inputs
        self.result = self.error = None
        self._ready = None
        if device.type == "cuda":
            self._ready = torch.cuda.Event()
            self._ready.record(torch.cuda.current_stream(device))

    def run(self) -> None:
        try:
            if self._device.type != "cuda":
                self.result = self._fn()
                return
            stream = _STREAMS.acquire(self._device)
            try:
                with torch.cuda.stream(stream):
                    stream.wait_event(self._ready)
                    for t in self._inputs:
                        t.record_stream(stream)
                    self.result = self._fn()
                stream.synchronize()
            finally:
                _STREAMS.release(self._device, stream)
        except BaseException as err:       # noqa: BLE001 — re-raised by
            self.error = err               # finish() on the caller

    def join_result(self, timeout: float | None):
        self.join(timeout)
        if self.is_alive():
            raise TimeoutError(f"the wave did not finish in {timeout} s")
        if self.error is not None:
            raise self.error
        return self.result


def _start(run, device: torch.device, inputs: list, threaded: bool):
    """Run a wave's loop ``run()``: on a worker thread (:class:`_Wave`)
    when ``threaded``, else here and now.  Returns ``get(timeout)``, its
    result."""
    if not threaded:
        out = run()
        return lambda timeout=None: out
    wave = _Wave(run, device, inputs)
    wave.start()
    return wave.join_result


def _run_batched(objective, enc: Encoding, x0s, **kwargs) -> BatchedResult:
    """The blocking shape of :func:`_submit_batched`: one wave, its loop
    on the caller's thread, and its result."""
    return _submit_batched(objective, enc, x0s, threaded=False,
                           **kwargs).finish()


def _submit_batched(objective, enc: Encoding, x0s, *, mesh=None,
                    pop_axes: Sequence[str] = ("data",),
                    max_iters: int = 256, virtual_block: int = 256,
                    quorum_mask=None, res_bits: Sequence[int] | None = None,
                    active=None, slot_iters=None, inner: str | None = None,
                    device=None, threaded: bool = True) -> PendingBatched:
    """Batched multi-start distributed DGO: R restarts from ``x0s``
    (R, n_vars) in lockstep through one engine (one popstep launch a step
    on the card), over the resolution schedule ``res_bits`` when it names
    several.  ``active`` (R,) bool marks padding slots (False: never
    stepped); ``slot_iters`` (R,) int gives each slot its own cap (per
    resolution on the schedule path).  Defaults: every slot active, every
    cap ``max_iters``.  Neither enters the engine's cache key, so waves of
    any fill share one engine.

    Returns at once: the wave's loop runs on a worker thread (on the
    card, on a CUDA stream of its own, waiting for the submitting
    stream's work) and :meth:`PendingBatched.finish` joins it.  With
    ``threaded=False`` the loop runs here, on the caller's stream, before
    this returns."""
    device = resolve_device(device)
    x0 = _as_f32(x0s, device)
    if x0.ndim != 2:
        raise ValueError(f"x0s must be (R, n_vars), got {tuple(x0.shape)}")
    n_restarts = x0.shape[0]
    pop_axes = tuple(pop_axes)
    n_shards = _n_shards(mesh, pop_axes)
    alive = _alive(quorum_mask, n_shards)
    active = (np.ones(n_restarts, bool) if active is None
              else np.asarray(active, bool))
    slot_iters = (np.full(n_restarts, max_iters, np.int32)
                  if slot_iters is None else np.asarray(slot_iters, np.int32))
    if active.shape != (n_restarts,) or slot_iters.shape != (n_restarts,):
        raise ValueError(f"active/slot_iters must be ({n_restarts},), got "
                         f"{active.shape}/{slot_iters.shape}")
    schedule = _resolve_res_bits(enc, res_bits)
    enc0 = enc.with_bits(schedule[0])
    engine = _batched_engine_for(objective, enc0, mesh, n_restarts, pop_axes,
                                 max_iters, virtual_block, schedule, inner,
                                 device)
    # each start snapped to the first lattice and evaluated alone: a
    # slot's trace[0] is its one-restart run's, bit for bit
    vals0 = _parent_vals(objective, decode(encode(x0, enc0), enc0))

    if len(schedule) == 1:
        def run():
            bits, vals, iters, trace = engine(x0, vals0, alive, active,
                                              slot_iters)
            return bits, vals, iters.cpu().numpy(), trace.cpu().numpy()

        get = _start(run, device, [x0, vals0], threaded)

        def finish(timeout=None) -> BatchedResult:
            bits, vals, iters, trace = get(timeout)
            _use_here(bits, vals)
            return BatchedResult(
                bits=bits, values=vals, iterations=iters,
                trace=trace[:, : int(iters.max()) + 1],
                best=int(np.argmin(vals.cpu().numpy())))

        return PendingBatched(finish)

    def run_schedule():
        (_, _, best_vals, best_bits, best_res, iters, trace) = engine(
            x0, vals0, alive, active, slot_iters)
        return (iters.cpu().numpy(), trace.cpu().numpy(),
                best_bits.cpu().numpy(), best_res.cpu().numpy(),
                best_vals.cpu().numpy())

    get = _start(run_schedule, device, [x0, vals0], threaded)

    def finish_schedule(timeout=None) -> BatchedResult:
        iters_h, trace_h, bits_h, res_h, vals_h = get(timeout)
        # per-restart monotone histories, truncated to the longest run and
        # padded past each restart's own end with its final best; padding
        # slots are not decoded
        t_len = int(iters_h.max()) + 1
        mono = np.repeat(trace_h[:, :1], t_len, axis=1)
        best_xs = np.zeros((n_restarts, enc.n_vars), np.float32)
        for r in np.flatnonzero(active):
            h = np.minimum.accumulate(trace_h[r, : int(iters_h[r]) + 1])
            mono[r, : len(h)] = h
            mono[r, len(h):] = h[-1]
            # each restart's best point decoded at its OWN resolution; the
            # bits field reports it quantized at the FINAL resolution
            b = schedule[int(res_h[r])]
            best_xs[r] = decode_np(bits_h[r][: enc.n_vars * b],
                                   enc.with_bits(b))
        enc_final = enc.with_bits(schedule[-1])
        bits = encode(torch.as_tensor(best_xs), enc_final).to(device)
        return BatchedResult(
            bits=bits, values=torch.as_tensor(vals_h).to(device),
            iterations=iters_h, trace=mono, best=int(np.argmin(vals_h)),
            best_xs=best_xs)

    return PendingBatched(finish_schedule)


def _use_here(*tensors) -> None:
    """A wave's device tensors are used from here on by the calling
    thread's stream: the allocator must not hand their memory back to the
    wave's stream before that stream's work is done."""
    for t in tensors:
        if t.is_cuda:
            t.record_stream(torch.cuda.current_stream(t.device))
