"""DGO drivers of ``repro.core.dgo`` in PyTorch: the sequential baseline,
the fused single-device engine and the clustered multi-start.

The paper's algorithm (its "Outline of DGO", steps 1-6): pick a parent,
generate its 2N-1 children by Gray-code segment inversion, take the best
child, keep it if it improves on the parent (else raise the resolution),
stop past the maximum resolution.

* The fused engine (``Fused`` strategy) runs the whole optimization,
  population steps and the resolution schedule, on the device.  Each
  resolution's step is bound once, at its own width, when the engine is
  built: on CUDA, for an objective with a device form, one popstep kernel
  launch a step over ids ``0..pop_r-1`` as one run (so a NaN child wins
  the step's selection, as ``jnp.argmin`` does, and stalls it); otherwise
  the plain tensor step.  The loop and its escalations are those of the
  folded distributed engine (``core.distributed._run_schedule``): the host
  reads the stall flag every ``STALL_CHECK_EVERY`` steps, steps after a
  stall are predicated no-ops, and ``max_iters`` steps at a resolution
  escalate on time.  The reference jits one ``lax.while_loop`` over a
  max-width buffer; the trajectory here is the same.
* The clustered engine (``Clustered``) runs the fused engine from
  independent starts, one after another on the same bound steps; a
  finished cluster takes no further steps, as in the reference's vmapped
  loop.
* The sequential baseline (``Sequential``) is the reference's literal
  one-child-at-a-time numpy loop, the denominator of every speedup.
"""
from __future__ import annotations

import dataclasses
import time
from types import SimpleNamespace
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.distributed import (
    _build_shard_step, _initial_at, _predicated_run, _run_schedule,
    _schedule_inner, _shard_plan, resolve_device)
from repro_torch.core.encoding import Encoding
from repro_torch.core.population import schedule_tables, segment_table


@dataclasses.dataclass(frozen=True)
class DGOConfig:
    """Resolution schedule + iteration caps (paper steps 5/6)."""

    encoding: Encoding                 # starting resolution
    max_bits: int = 16                 # maximum resolution (paper step 6)
    bits_step: int = 2                 # resolution increment on stall
    max_iters_per_resolution: int = 512  # safety cap on step-4 loops

    def resolutions(self) -> list[int]:
        return list(range(self.encoding.bits, self.max_bits + 1, self.bits_step))


class DGOState(NamedTuple):
    """Carried across iterations at a fixed resolution."""

    parent_bits: torch.Tensor   # (N,) int8
    parent_val: torch.Tensor    # () f32
    improved: torch.Tensor      # () bool — did the last step improve?
    iters: torch.Tensor         # () int64


class DGOResult(NamedTuple):
    x: torch.Tensor          # (n_vars,) best point found
    value: torch.Tensor      # () f32
    bits: torch.Tensor       # best point's bits (N,) at the final resolution
    evaluations: int         # total function evaluations
    iterations: int          # total accepted/attempted steps
    trace: np.ndarray        # (iterations,) best value after each step


# ---------------------------------------------------------------------------
# one DGO iteration (paper steps 2-4): the reference's public names; no
# engine runs them (each engine binds its steps in core.distributed)
# ---------------------------------------------------------------------------

def _iteration_step(f_batch: Callable[[torch.Tensor], torch.Tensor],
                    enc: Encoding, device: torch.device):
    """The plain one-run step of ``core.distributed`` through the literal
    generate -> decode -> evaluate pipeline (inner ``"jnp"``)."""
    plan = _shard_plan(enc.population, 1, enc.population)
    return _build_shard_step(SimpleNamespace(fn=f_batch), enc, plan, "jnp",
                             device)(None)


def dgo_iteration(f_batch: Callable[[torch.Tensor], torch.Tensor],
                  enc: Encoding, parent_bits: torch.Tensor,
                  parent_val: torch.Tensor) -> DGOState:
    """Generate all 2N-1 children, evaluate, select (steps 2-4).
    ``f_batch`` maps (P, n_vars) -> (P,); a NaN child wins the selection
    (and keeps the parent), else the first minimum, and the parent is kept
    unless the winner is strictly better."""
    step = _iteration_step(f_batch, enc, parent_bits.device)
    bits, val, improved = step(parent_bits.to(torch.int8),
                               parent_val.to(torch.float32))
    return DGOState(bits, val, improved, torch.ones((), dtype=torch.int64))


def dgo_resolution_step(f_batch: Callable[[torch.Tensor], torch.Tensor],
                        enc: Encoding, max_iters: int,
                        parent_bits: torch.Tensor,
                        parent_val: torch.Tensor
                        ) -> tuple[DGOState, torch.Tensor]:
    """The step-2..4 loop at one resolution until a stall or ``max_iters``
    steps.  Returns the final state and a (max_iters,) trace of parent
    values (padded with the final value after the stall point)."""
    bits, val, vals, iters = _predicated_run(
        _iteration_step(f_batch, enc, parent_bits.device),
        parent_bits.to(torch.int8), parent_val.to(torch.float32), max_iters)
    n = int(iters)
    # a stalled run's last step kept the parent: its value did not fall
    improved = (vals[n] < vals[n - 1] if n
                else torch.ones((), dtype=torch.bool))
    idx = torch.arange(max_iters, device=vals.device)
    trace = torch.where(idx < iters, vals[1:], val)
    return DGOState(bits, val, improved, iters), trace


# ---------------------------------------------------------------------------
# the fused engine: the whole optimization (population steps AND the
# resolution schedule) on the device
# ---------------------------------------------------------------------------

class EngineState(NamedTuple):
    """What the fused engine ends with: the parts of the reference's loop
    carry that its result reads."""

    best_val: torch.Tensor   # () f32 — best value found
    best_x: torch.Tensor     # (n_vars,) f32 — best point found
    iters: int               # total steps
    evals: int               # total function evaluations
    trace: np.ndarray        # (t_max,) f32 — best value after each step


class _EngineStatic(NamedTuple):
    """Host-side constants of one engine."""

    n_vars: int
    lo: float
    hi: float
    res_bits: tuple          # the resolution schedule
    max_iters: int
    n_max: int               # n_vars * max(res_bits): the bit-buffer width
    p_max: int               # 2 * n_max - 1
    t_max: int               # trace capacity


def _engine_static(cfg: DGOConfig) -> _EngineStatic:
    enc0 = cfg.encoding
    # a degenerate schedule (max_bits < starting bits) still runs the
    # starting resolution instead of crashing
    res_bits = tuple(cfg.resolutions()) or (enc0.bits,)
    n_max = enc0.n_vars * res_bits[-1]
    return _EngineStatic(
        n_vars=enc0.n_vars, lo=enc0.lo, hi=enc0.hi, res_bits=res_bits,
        max_iters=cfg.max_iters_per_resolution, n_max=n_max,
        p_max=2 * n_max - 1,
        t_max=len(res_bits) * cfg.max_iters_per_resolution)


def _engine_tables(cfg: DGOConfig, device=None):
    """The engine's stacked per-resolution tables on ``device`` (``None``:
    the CUDA card)."""
    st = _engine_static(cfg)
    return st, schedule_tables(st.n_vars, st.res_bits, st.lo, st.hi,
                               resolve_device(device))


def _engine_loop(objective, cfg: DGOConfig, *, device=None,
                 inner: str | None = None):
    """The fused engine, ``(static, tables, loop)`` with ``loop(bits0,
    val0) -> EngineState``: ``bits0`` the start parent at resolution 0's
    own width (or the max-width buffer), ``val0`` its value.  Each
    resolution's step is bound here, once (:func:`_fused_steps`), and
    every run of ``loop`` reuses it."""
    device = resolve_device(device)
    st, tables = _engine_tables(cfg, device)
    steps = _fused_steps(objective, tables, inner, device)

    def loop(bits0: torch.Tensor, val0: torch.Tensor) -> EngineState:
        bits0 = bits0[: tables.encodings[0].n_bits]
        run = _run_schedule(objective, tables, steps, bits0,
                            val0.to(torch.float32), st.max_iters,
                            escalate_last=True)
        best_val, best_bits, best_r = run.best()
        # the best value after each step; a re-encode counts where it
        # beats the best, as the reference's escalation does
        trace = np.full(st.t_max, run.start_vals[0], np.float32)
        best, i, steps_vals = run.start_vals[0], 0, iter(run.history[1:])
        for r in range(tables.n_res):
            if r > 0 and run.start_vals[r] < best:
                best = run.start_vals[r]
            for _ in range(run.live[r]):
                v = next(steps_vals)
                best = v if v < best else best
                trace[i] = best
                i += 1
        return EngineState(
            best_val=best_val, best_x=tables.decode(best_bits, best_r),
            iters=i,
            evals=sum(n * e.population
                      for n, e in zip(run.live, tables.encodings)),
            trace=trace)

    return st, tables, loop


def _fused_steps(objective, tables, inner: str | None,
                 device: torch.device) -> list:
    """One bound step a resolution, each at the resolution's own width
    over ids ``0..pop_r-1`` as one run: the popstep kernel on CUDA for an
    objective with a device form, else the plain tensor step
    (``core.distributed._schedule_inner``)."""
    inner = _schedule_inner(inner, device, objective)
    return [_build_shard_step(objective, e,
                              _shard_plan(e.population, 1, e.population),
                              inner, device)(None)
            for e in tables.encodings]


def make_fused_engine(objective, cfg: DGOConfig, *, device=None,
                      inner: str | None = None) -> Callable:
    """Build ``engine(bits0, val0) -> EngineState``: the full DGO run,
    population steps and resolution schedule, on ``device`` (``None``:
    the CUDA card).  ``objective`` carries the batched ``fn`` and, for
    the popstep kernel, its ``kernel`` form; ``inner="fused"`` forces the
    plain tensor step on any device."""
    return _engine_loop(objective, cfg, device=device, inner=inner)[2]


def bucket_split(cfg: DGOConfig) -> int:
    """Default coarse-bucket length of the reference's two-compilation
    engine: the resolutions at most half the final one."""
    res = tuple(cfg.resolutions()) or (cfg.encoding.bits,)
    return sum(1 for b in res if 2 * b <= res[-1])


def make_fused_engine_bucketed(objective, cfg: DGOConfig,
                               n_coarse: int | None = None, *,
                               device=None) -> Callable:
    """The reference's two-bucket fused engine.  Every resolution's step
    here already runs at its own width, so the buckets are the same
    engine: ``n_coarse`` (default :func:`bucket_split`) is checked as the
    reference checks it and the result is the fused engine's, bitwise."""
    res = tuple(cfg.resolutions()) or (cfg.encoding.bits,)
    if n_coarse is None:
        n_coarse = bucket_split(cfg)
    if not 0 < n_coarse < len(res):
        raise ValueError(
            f"n_coarse must split the {len(res)}-resolution schedule, "
            f"got {n_coarse} (no worthwhile split -> use the plain "
            f"fused engine)")
    return make_fused_engine(objective, cfg, device=device)


def _best_bits(best_x: torch.Tensor, tables) -> torch.Tensor:
    """Bit string of the best point, quantized to the final resolution."""
    return tables.encode(best_x, tables.n_res - 1)


def _result_from_state(s: EngineState, tables) -> DGOResult:
    trace = (s.trace[: s.iters] if s.iters
             else np.asarray([float(s.best_val)], np.float32))
    return DGOResult(x=s.best_x, value=s.best_val,
                     bits=_best_bits(s.best_x, tables),
                     evaluations=s.evals, iterations=s.iters, trace=trace)


def random_start(key, enc: Encoding, batch: int | None = None) -> np.ndarray:
    """Uniform start point(s) in the box from a threefry key, as
    ``jax.random.uniform(key, shape, minval=lo, maxval=hi)``."""
    shape = (enc.n_vars,) if batch is None else (batch, enc.n_vars)
    return prng.uniform(key, shape, enc.lo, enc.hi)


def _fused_result(objective, cfg: DGOConfig, x0=None, key=None, *,
                  device=None, inner: str | None = None) -> DGOResult:
    """Full DGO through the fused engine on ``device`` (``None``: the CUDA
    card).  Without ``x0`` the start is drawn from ``key`` (default
    ``PRNGKey(0)``)."""
    device = resolve_device(device)
    if x0 is None:
        x0 = random_start(prng.PRNGKey(0) if key is None else key,
                          cfg.encoding)
    st, tables, loop = _engine_loop(objective, cfg, device=device,
                                    inner=inner)
    bits0, val0 = _initial_at(objective, tables, x0, device)
    return _result_from_state(loop(bits0, val0), tables)


def _bucketed_result(objective, cfg: DGOConfig, x0=None, key=None, *,
                     device=None) -> DGOResult:
    """``_fused_result`` through the bucketed engine, which here is the
    fused engine itself (:func:`make_fused_engine_bucketed`): the same
    result, bitwise, as the reference pins."""
    return _fused_result(objective, cfg, x0=x0, key=key, device=device)


# ---------------------------------------------------------------------------
# clustered multi-start (paper's MP-1 cluster mode)
# ---------------------------------------------------------------------------

def _clustered_result(objective, cfg: DGOConfig, n_clusters: int, key=None,
                      x0s=None, *, device=None) -> tuple[DGOResult, dict]:
    """Independent fused runs from ``n_clusters`` starts; best-of wins.

    ``x0s`` (n_clusters, n_vars) pins the starts; omitted, they are drawn
    from ``split(key, n_clusters)``, one uniform draw a key.  The clusters
    run one after another through the same bound steps (a cluster that
    has finished takes no more steps, as in the reference's vmapped
    loop).  Returns the :class:`DGOResult` (``trace`` the per-cluster
    best values, ``evaluations`` summed, ``iterations`` the largest) and
    an aux dict with the winner (the first best) and its own trace."""
    device = resolve_device(device)
    enc0 = cfg.encoding
    if x0s is None:
        if key is None:
            raise ValueError("clustered DGO needs either key or x0s")
        x0s = np.stack([random_start(k, enc0)
                        for k in prng.split(key, n_clusters)])
    else:
        x0s = torch.as_tensor(x0s, dtype=torch.float32)
        if x0s.shape[0] != n_clusters:
            raise ValueError(f"x0s has {x0s.shape[0]} rows for "
                             f"n_clusters={n_clusters}")
    st, tables, loop = _engine_loop(objective, cfg, device=device)
    bits0, vals0 = _initial_at(objective, tables, x0s, device)
    states = [loop(bits0[c], vals0[c]) for c in range(n_clusters)]
    best_vals = np.asarray([float(s.best_val) for s in states], np.float32)
    winner = int(np.argmin(best_vals))     # the first of equal bests
    w = states[winner]
    winner_trace = (w.trace[: w.iters] if w.iters
                    else np.asarray([float(w.best_val)], np.float32))
    result = DGOResult(x=w.best_x, value=w.best_val,
                       bits=_best_bits(w.best_x, tables),
                       evaluations=sum(s.evals for s in states),
                       iterations=max(s.iters for s in states),
                       trace=best_vals)
    aux = {"cluster_values": best_vals, "winner": winner,
           "winner_trace": winner_trace}
    return result, aux


# ---------------------------------------------------------------------------
# sequential reference — the paper's SPARC-IV-style baseline
# ---------------------------------------------------------------------------

def _sequential_result(f: Callable[[np.ndarray], float], cfg: DGOConfig,
                       x0: np.ndarray, time_budget_s: float | None = None,
                       max_iters: int | None = None) -> DGOResult:
    """One-child-at-a-time DGO in plain numpy: per iteration 2N-1
    sequential (transform + evaluate) passes of O(N) work each, the O(n^2)
    structure of the paper's Fig. 6, and the speedup denominator.

    ``f`` follows the host convention ``np.ndarray -> float`` (the solver
    adapts torch objectives via ``Problem.host_fn``).  ``max_iters`` caps
    TOTAL iterations across the whole resolution schedule.  Decoding is
    float64, as in the reference."""
    enc0 = cfg.encoding

    def np_b2g(b):
        g = b.copy()
        g[1:] ^= b[:-1]
        return g

    def np_g2b(g):
        return np.cumsum(g) % 2

    def np_decode(b, enc):
        lv = b.reshape(enc.n_vars, enc.bits)
        weights = 2 ** np.arange(enc.bits - 1, -1, -1)
        level = (lv * weights).sum(axis=-1).astype(np.float64)
        return enc.lo + level * ((enc.hi - enc.lo) / (enc.levels - 1))

    def np_encode(x, enc):
        level = np.clip(np.round((x - enc.lo) / (enc.hi - enc.lo)
                                 * (enc.levels - 1)), 0, enc.levels - 1)
        level = level.astype(np.int64)
        shifts = np.arange(enc.bits - 1, -1, -1)
        return ((level[:, None] >> shifts) & 1).reshape(-1).astype(np.int8)

    t_start = time.perf_counter()
    bits = np_encode(np.asarray(x0, np.float64), enc0)
    val = float(f(np_decode(bits, enc0)))
    evals, iters = 1, 0
    trace = [val]
    best_run_val, best_run_bits, best_run_enc = val, bits, enc0

    prev_enc = enc0
    for res in cfg.resolutions():
        enc = enc0.with_bits(res)
        if enc.bits != prev_enc.bits:
            bits = np_encode(np_decode(bits, prev_enc), enc)
            val = float(f(np_decode(bits, enc)))
        n = enc.n_bits
        table = segment_table(n)
        improved = True
        it = 0
        while improved and it < cfg.max_iters_per_resolution:
            if max_iters is not None and iters >= max_iters:
                break
            improved = False
            gray = np_b2g(bits)
            best_val, best_bits = val, bits
            for c in range(2 * n - 1):           # the sequential hot loop
                mask = np.zeros(n, np.int8)
                mask[table[c, 0]: table[c, 1]] = 1
                child = np_g2b(gray ^ mask)       # O(N) transform
                v = float(f(np_decode(child, enc)))
                evals += 1
                if v < best_val:
                    best_val, best_bits = v, child
            if best_val < val:
                val, bits = best_val, best_bits
                improved = True
            it += 1
            iters += 1
            trace.append(val)
            if time_budget_s and time.perf_counter() - t_start > time_budget_s:
                break
        # best-so-far across resolutions: step-5 re-quantization can raise
        # the parent value
        if val < best_run_val:
            best_run_val, best_run_bits, best_run_enc = val, bits, enc
        prev_enc = enc
        if time_budget_s and time.perf_counter() - t_start > time_budget_s:
            break
        if max_iters is not None and iters >= max_iters:
            break

    return DGOResult(x=torch.as_tensor(np_decode(best_run_bits, best_run_enc),
                                       dtype=torch.float32),
                     value=torch.tensor(best_run_val, dtype=torch.float32),
                     bits=torch.as_tensor(best_run_bits),
                     evaluations=evals, iterations=iters,
                     trace=np.asarray(trace))
