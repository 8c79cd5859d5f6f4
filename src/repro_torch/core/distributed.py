"""Distributed DGO on one device: the engine behind ``Distributed``.

The layout and semantics follow ``repro.core.distributed`` on a mesh of
one shard.  The 2N-1 children of the parent are cut into virtual blocks
of at most ``virtual_block`` (the paper's NCUBE "virtual processing");
each block yields its best (value, child id), and the blocks fold into
the step's winner, which replaces the parent if it is strictly better.

Selection, exactly as the reference engine does it:

* inside a block, a NaN child makes the block's value NaN, else the
  smallest value wins with ties to the smallest id;
* across blocks, a NaN block is ignored and the rest fold
  lexicographically on (value, id) from (+inf, pop); with a single block
  its result is used as it is — so a NaN child stalls a one-block step
  but only hides its own block in a many-block step;
* the winner's XOR pattern is gathered on the device from the (2N-1, N)
  pattern table, bound once per engine (no bit string or id travels to
  the host), and ``improved = winner < parent``.

Inners (``inner=``): ``"popstep"`` runs the whole population through the
CUDA popstep kernel (one launch per step; its plain version on the
CPU), ``"fused"`` generates children by the hoisted XOR patterns and
decodes with one matmul, ``"jnp"`` keeps the literal generate -> decode
pipeline (the reference's name for it).  ``inner=None`` is ``"popstep"``
on CUDA and ``"fused"`` on the CPU.

Devices: every builder here takes ``device=None`` as the CUDA card and
raises ``RuntimeError`` without one (:func:`resolve_device`); pass
``device="cpu"`` for the plain PyTorch versions.

Drivers: ``"device"`` keeps the loop state in device tensors and reads
the stall flag on the host only every ``STALL_CHECK_EVERY`` steps; steps after
a stall are predicated no-ops (the parent cannot change once no child
beats it), so ``iters``, ``history`` and ``trace`` equal the reference's
per-step loop.  ``"host"`` steps from Python, syncing the stall flag each
step, and chains a multi-resolution schedule (paper step 5).

Resolution schedules on the device driver (``res_bits`` with several
resolutions) run the folded engine of ``repro.core.distributed``: the
stacked ``population.ScheduleTables``, the blocks planned at the FINEST
resolution (ids ``< p_max``, ``valid = ids < pop_r``), one step bound per
resolution at engine build, and the escalation (paper step 5) applied
when the host reads the stall flag or has launched ``max_iters`` steps at
a resolution.  :func:`_run_schedule` is that loop; ``core/dgo.py``'s fused
engine runs it too, with its own step.

Not yet ported (each raises ``NotImplementedError``): meshes of more than
one device, quorum masks other than all-alive, and failure injection
(``ROADMAP.md`` queue 1 #5).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.encoding import Encoding, _f32, decode, encode
from repro_torch.core.population import (
    ScheduleTables, generate_children, schedule_tables, table_on)
# the module, not its function: importing the wrapper first imports this
# module while the wrapper is still half-initialised
from repro_torch.kernels.popstep import ops as popstep_ops

_INNERS = ("fused", "popstep", "jnp")

# device driver: host reads of the stall flag (each one a synchronisation)
STALL_CHECK_EVERY = 16


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


def _check_quorum(quorum_mask) -> None:
    if quorum_mask is not None and not bool(np.asarray(quorum_mask).all()):
        raise NotImplementedError(
            "quorum masks with dead shards are not ported yet (ROADMAP.md "
            "queue 1); the single-device engine runs all-alive")


def _block_fold(vals: torch.Tensor, ids: torch.Tensor, pop: int):
    """The reference engine's selection over (n_blocks, block) values:
    ``min`` per block (NaN wins) with the smallest id at that value, then
    the across-block fold described in the module docstring."""
    v = vals.amin(1)
    gid = torch.where(vals == v[:, None], ids, pop).amin(1)
    if vals.shape[0] == 1:
        return v[0], gid[0]
    keep = ~torch.isnan(v)
    v2 = torch.where(keep, v, torch.inf)
    g2 = torch.where(keep, gid, pop)
    win = v2.amin()
    return win, torch.where(v2 == win, g2, pop).amin()


def _build_shard_step(objective, enc: Encoding, plan: _ShardPlan,
                      inner: str, device: torch.device):
    """One DGO iteration on one shard.  Returns ``prepare(quorum_mask) ->
    step(parent_bits, parent_val, it) -> (new_bits, new_val, improved)``;
    the tables are bound once, outside the loop.  With one shard the
    reference's per-round rotation ``(shard + it) % n_shards`` is always
    slot 0, so ``it`` does not change the step.  ``plan`` may cover more
    ids than ``enc.population`` (the folded engine plans every resolution
    at the finest one): ids past it are masked to +inf."""
    pop, n_blocks, block = enc.population, plan.n_blocks, plan.block
    f_batch = objective.fn
    ids = torch.arange(n_blocks * block, device=device)
    valid = ids < pop
    ids_c = ids.clamp(max=pop - 1)
    pat = table_on("patterns", enc.n_bits, device)          # (2N-1, N) int8
    if inner == "popstep":           # one kernel launch per step
        popstep = popstep_ops.prepare_step_ids(objective, ids_c, enc,
                                               valid=valid,
                                               virtual_block=block)
    if inner == "fused":
        wmat = torch.as_tensor(_decode_matrix(enc), device=device)
        scale, lo = _f32(enc.scale, wmat), _f32(enc.lo, wmat)

    def local_best(parent_bits):
        if inner == "popstep":
            return popstep(parent_bits)
        if inner == "fused":
            children = torch.bitwise_xor(parent_bits[None, :], pat[ids_c])
            xs = (children.to(torch.float32) @ wmat) * scale + lo
        else:
            xs = decode(generate_children(parent_bits, ids_c), enc)
        vals = torch.where(valid, f_batch(xs).to(torch.float32), torch.inf)
        return _block_fold(vals.reshape(n_blocks, block),
                           ids_c.reshape(n_blocks, block), pop)

    def prepare(quorum_mask=None):
        _check_quorum(quorum_mask)

        def step(parent_bits, parent_val, it=0):
            local_val, local_id = local_best(parent_bits)
            # a NaN winner carries no id (the reference's packed gather)
            win_id = torch.where(local_val == local_val,
                                 local_id.to(torch.int64), pop)
            improved = local_val < parent_val
            # index_select, not pat[win_id]: indexing with a 0-d tensor
            # reads it on the host, a synchronisation per step
            win_pat = pat.index_select(0, win_id.clamp(max=pop - 1).reshape(1))
            win_bits = torch.bitwise_xor(parent_bits, win_pat[0])
            new_bits = torch.where(improved, win_bits, parent_bits)
            new_val = torch.where(improved, local_val, parent_val)
            return new_bits, new_val, improved

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


def make_distributed_step(objective, enc: Encoding, *,
                          virtual_block: int = 256,
                          inner: str | None = None, device=None):
    """One-iteration step: ``step(parent_bits, parent_val, quorum_mask=None,
    it=0) -> (new_bits, new_val, improved)``, all device tensors.

    ``objective`` carries ``fn`` ((B, n_vars) -> (B,)) and, for the
    popstep kernel, its ``kernel`` form (a registry
    :class:`~repro_torch.core.objectives.Objective`).  ``device=None`` is
    the CUDA card (:func:`resolve_device`)."""
    device = resolve_device(device)
    inner = _resolve_inner(inner, device, objective)
    plan = _shard_plan(enc.population, 1, virtual_block)
    prepare = _build_shard_step(objective, enc, plan, inner, device)

    def step(parent_bits, parent_val, quorum_mask=None, it=0):
        return prepare(quorum_mask)(parent_bits, parent_val, it)

    return step


def _predicated_run(step, bits, val, max_iters: int):
    """Up to ``max_iters`` steps of ``step`` from ``(bits, val)`` on the
    device: the host reads the stall flag every ``STALL_CHECK_EVERY``
    steps, and steps after a stall are predicated no-ops (not counted).
    Returns ``(bits, val, vals, iters)``: ``vals`` (max_iters + 1,) holds
    the start value and the parent value after each launched step (those
    past ``iters`` repeat the final value), ``iters`` the steps taken, a
    device scalar."""
    device = val.device
    vals = val.repeat(max_iters + 1)
    stalled = torch.zeros((), dtype=torch.bool, device=device)
    iters = torch.zeros((), dtype=torch.int64, device=device)
    for k in range(max_iters):
        new_bits, new_val, improved = step(bits, val, k)
        live = ~stalled
        bits = torch.where(live, new_bits, bits)
        val = torch.where(live, new_val, val)
        vals[k + 1] = val
        iters = iters + live.to(torch.int64)
        stalled = stalled | ~improved
        if (k + 1) % STALL_CHECK_EVERY == 0 and bool(stalled):
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
                  max_iters: int, *, escalate_last: bool = False
                  ) -> ScheduleRun:
    """Run the resolution schedule of ``tables`` from the parent ``(bits,
    val)`` at resolution 0: at each resolution ``r``, ``steps[r]`` until a
    stall or ``max_iters`` steps (:func:`_predicated_run`), then the
    parent re-encoded at the next resolution and evaluated (paper step
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
                                                 max_iters)
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


def make_distributed_engine(objective, enc: Encoding, *,
                            max_iters: int = 256, virtual_block: int = 256,
                            inner: str | None = None, device=None,
                            res_bits: Sequence[int] | None = None):
    """The device-driver engine on ``device`` (``None``: the CUDA card, see
    :func:`resolve_device`).  The host reads the stall flag every
    ``STALL_CHECK_EVERY`` steps; steps after a stall are predicated no-ops.

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
    re-encodes not recorded, padded with the final value).  The blocks of
    every resolution are planned at the finest one, and each resolution's
    step is bound here, once; ``inner`` must be None or ``"fused"``
    (:func:`_schedule_inner`)."""
    device = resolve_device(device)
    schedule = _resolve_res_bits(enc, res_bits)
    if len(schedule) > 1:
        return _schedule_engine(objective, enc, schedule, max_iters,
                                virtual_block, inner, device)
    inner = _resolve_inner(inner, device, objective)
    plan = _shard_plan(enc.population, 1, virtual_block)
    prepare = _build_shard_step(objective, enc, plan, inner, device)

    def engine(x0, quorum_mask=None):
        one_step = prepare(quorum_mask)
        bits, val = _initial(objective, enc, x0, device)
        bits, val, trace, iters = _predicated_run(one_step, bits, val,
                                                  max_iters)
        idx = torch.arange(max_iters + 1, device=device)
        trace = torch.where(idx <= iters, trace, val)
        return bits, val, iters, trace

    return engine


def _schedule_engine(objective, enc: Encoding, schedule: tuple,
                     max_iters: int, virtual_block: int, inner: str | None,
                     device: torch.device):
    inner = _schedule_inner(inner, device, objective)
    tables = schedule_tables(enc.n_vars, schedule, enc.lo, enc.hi, device)
    plan = _shard_plan(tables.p_max, 1, virtual_block)
    prepares = [_build_shard_step(objective, e, plan, inner, device)
                for e in tables.encodings]
    t_max = tables.n_res * max_iters + 1

    def engine(x0, quorum_mask=None):
        steps = [prepare(quorum_mask) for prepare in prepares]
        bits, val = _initial_at(objective, tables, x0, device)
        run = _run_schedule(objective, tables, steps, bits, val, max_iters)
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
                          device: torch.device):
    """One fixed-resolution run at ``enc.bits``; returns
    ``(bits, val, history)``."""
    if driver == "device":
        engine = make_distributed_engine(
            objective, enc, max_iters=max_iters, virtual_block=virtual_block,
            inner=inner, device=device)
        bits, val, iters, trace = engine(x0)
        # ONE device->host transfer for the whole history
        history = trace[: int(iters) + 1].cpu().tolist()
        return bits, val, history

    step = make_distributed_step(objective, enc, virtual_block=virtual_block,
                                 inner=inner, device=device)
    bits, val = _initial(objective, enc, x0, device)
    vals = [val]
    for it in range(max_iters):
        bits, val, improved = step(bits, val, None, it)
        vals.append(val)
        if not bool(improved):      # full quorum: one stall ends the run
            break
    return bits, val, torch.stack(vals).cpu().tolist()


def _run_distributed(objective, enc: Encoding, x0, *,
                     max_iters: int = 256, virtual_block: int = 256,
                     quorum_mask=None, inner: str | None = None,
                     driver: str = "device", injector=None,
                     res_bits: Sequence[int] | None = None, device=None):
    """Distributed DGO over the resolution schedule ``res_bits`` (``None``
    -> fixed at ``enc.bits``) on one device (``None``: the CUDA card, see
    :func:`resolve_device`).

    Returns ``(bits, val, history, bits_resolution)``: the best parent's
    bit string at its own resolution, its value, and the raw
    per-iteration value history (``history[0]`` the starting value;
    escalation re-encodes are not recorded).  The configuration is
    checked before any tensor reaches ``device``."""
    if driver not in ("device", "host"):
        raise ValueError(f"driver must be 'device' or 'host', got {driver!r}")
    if injector is not None:
        if driver != "host":
            raise ValueError("failure injection requires driver='host' — "
                             "the device loop cannot interpose host policy")
        raise NotImplementedError("failure injection is not ported yet "
                                  "(ROADMAP.md queue 1)")
    _check_quorum(quorum_mask)
    schedule = _resolve_res_bits(enc, res_bits)
    device = resolve_device(device)
    if driver == "device" and len(schedule) > 1:
        engine = make_distributed_engine(
            objective, enc.with_bits(schedule[0]), max_iters=max_iters,
            virtual_block=virtual_block, inner=inner, device=device,
            res_bits=schedule)
        best_bits, best_val, best_res, iters, trace = engine(x0)
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
            device)
        history.extend(hist if i == 0 else hist[1:])
        if best is None or hist[-1] < best[0]:
            best = (hist[-1], val, bits, b)
        x = decode(bits, enc_b)
    _, best_val, best_bits, best_b = best
    return best_bits, best_val, history, best_b
