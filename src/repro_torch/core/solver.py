"""The ``solve()`` front door of the PyTorch port.

A :class:`Problem` says *what* to optimize, a :class:`Strategy` says
*how*, and :func:`solve` returns a :class:`SolveResult` — the API of
``repro.core.solver``.  Strategies: ``sequential`` (the numpy baseline),
``fused`` (the default: the whole schedule on one device), ``clustered``
(independent fused runs, best-of), ``distributed`` (population
distribution over the virtual shards of a mesh, with quorum masks and, on
the host driver, failure injection) and ``batched`` (R restarts in
lockstep, the serving path), with the popstep CUDA kernel as the step on
the card.  :func:`solve_many` and :func:`submit_wave` serve heterogeneous
:class:`SolveRequest` s through the batched engine, waves grouped by
:func:`engine_signature`; ``repro_torch.serving`` queues and schedules
them.

A mesh is geometry only on one card (:func:`resolve_mesh`): the product
of its sizes over ``pop_axes`` is the number of virtual shards.

``seed`` becomes ``PRNGKey(seed)`` through the threefry twin
(:mod:`repro_torch.core.prng`), so a seeded solve starts where the
reference's does.

Devices: every entry point runs on the card unless the caller asks for
the CPU.  ``device=None`` means CUDA and raises ``RuntimeError`` when no
card is present; pass ``device="cpu"`` to run the plain PyTorch versions.

  >>> from repro_torch.core.solver import solve
  >>> res = solve("rastrigin", "fused", seed=0, device="cpu")
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, ClassVar, NamedTuple

import numpy as np
import torch

from repro_torch.core import objectives as objectives_registry
from repro_torch.core import prng
from repro_torch.core.cache import get_cache
from repro_torch.core.dgo import DGOConfig, random_start
from repro_torch.core.distributed import (
    MeshGeometry, default_shards, resolve_device)
from repro_torch.core.encoding import Encoding, decode, decode_np
from repro_torch.core.objectives import KernelForm, Objective

__all__ = [
    "Batched", "Clustered", "Distributed", "Fused", "NonFiniteResult",
    "PendingWave", "Problem", "Sequential", "SolveRequest", "SolveResult",
    "Strategy", "as_problem", "as_strategy", "engine_signature",
    "resolve_device", "resolve_mesh", "result_is_finite", "solve",
    "solve_many", "strategy_names", "submit_wave",
]


# ---------------------------------------------------------------------------
# Problem: what to optimize
# ---------------------------------------------------------------------------

def _is_host_convention_error(e: Exception) -> bool:
    """A call on a meta tensor failed only because the callable needs
    concrete values (``np.asarray``, ``float``, ``.item()`` on it)."""
    return isinstance(e, (TypeError, RuntimeError)) and "meta" in str(e)


def _detect_kind(fn: Callable, n_vars: int, batched: bool) -> str:
    """"torch" if ``fn`` runs on a float32 tensor on the meta device (the
    shapes alone, no values), "numpy" if that fails only because the
    callable needs concrete values.  Any other error is a real bug in the
    objective and propagates as ``ValueError``."""
    shape = (2, n_vars) if batched else (n_vars,)
    try:
        fn(torch.zeros(shape, device="meta"))
        return "torch"
    except Exception as e:      # classified, then re-raised
        if _is_host_convention_error(e):
            return "numpy"
        raise ValueError(
            f"objective failed on a meta tensor ({type(e).__name__}: {e}); "
            f"if it is a host/numpy objective, pass kind='numpy' "
            f"explicitly") from e


def _host_to_torch(fn: Callable) -> Callable:
    """A host objective ``np.ndarray (n_vars,) -> float`` as a batched
    torch function ``(B, n_vars) -> (B,)``: one device-to-host copy of the
    batch, ``fn`` on each row, one copy back (the reference's
    ``pure_callback``)."""
    def batched(xs: torch.Tensor) -> torch.Tensor:
        rows = xs.detach().cpu().numpy()
        vals = np.asarray([fn(row) for row in rows], np.float32)
        return torch.as_tensor(vals).to(xs.device)

    return batched


@dataclasses.dataclass(frozen=True)
class Problem:
    """An optimization problem: objective + search box/resolution.

    ``fn`` follows one of two calling conventions: a PyTorch function
    (``kind="torch"``) of one point, ``(n_vars,) -> ()``, or, with
    ``batched=True``, of a batch, ``(B, n_vars) -> (B,)`` (a one-point
    function is batched with ``torch.vmap``); or a host function
    (``kind="numpy"``), ``np.ndarray (n_vars,) -> float``, which the
    device engines call through one device-to-host copy a batch.  The
    convention is detected once, on a meta tensor, unless ``kind`` is
    given; ``host_fn`` is the objective in the host convention (the
    sequential loop's).  ``kernel`` is the objective's device form for
    the popstep kernel; only registry objectives (:meth:`get`) carry one.
    ``signature`` is a hashable semantic identity that
    :func:`engine_signature` keys on in place of ``fn`` (set by the
    ``subspace-lm:*`` tuning family, None for the other registry
    problems); ``materialize`` maps a winning point back to the
    objective's state (a tuning problem's model parameters,
    ``core.subspace.materialize_winner``).
    """

    fn: Callable[[Any], Any]
    encoding: Encoding
    name: str = "custom"
    f_opt: float | None = None
    tol: float | None = None
    batched: bool = False
    kernel: KernelForm | None = None
    kind: str | None = None      # "torch" | "numpy" | None = detect
    signature: tuple | None = None
    materialize: Callable[[Any], Any] | None = None

    def __post_init__(self):
        if self.kind is None:
            object.__setattr__(self, "kind", _detect_kind(
                self.fn, self.encoding.n_vars, self.batched))
        if self.kind not in ("torch", "numpy"):
            raise ValueError(f"kind must be 'torch' or 'numpy', "
                             f"got {self.kind!r}")
        if self.kind == "numpy" and self.batched:
            raise ValueError("a host (kind='numpy') objective takes one "
                             "point; batched=True is for torch functions")

    @classmethod
    def from_objective(cls, obj: Objective) -> "Problem":
        return cls(fn=obj.fn, encoding=obj.encoding, name=obj.name,
                   f_opt=obj.f_opt, tol=obj.tol, batched=True,
                   kernel=obj.kernel, kind="torch",
                   signature=obj.signature, materialize=obj.materialize)

    @classmethod
    def get(cls, name: str, n: int | None = None, **kwargs) -> "Problem":
        """Build from the objective registry (``Problem.get("rastrigin",
        n=5)``), memoized per semantic spec (``objectives.canonical_spec``)."""
        key = objectives_registry.canonical_spec(name, n=n, **kwargs)
        return _PROBLEMS.get(key, lambda: cls.from_objective(
            objectives_registry.get(name, n=n, **kwargs)))

    def replace(self, **changes) -> "Problem":
        """Functional update (e.g. ``problem.replace(encoding=enc)``)."""
        return dataclasses.replace(self, **changes)

    @property
    def objective(self) -> Objective:
        """The problem as the engines consume it: a batched torch ``fn``
        plus the kernel form, built once per Problem (the engines' cache
        keys on its ``fn``)."""
        obj = self.__dict__.get("_objective")
        if obj is None:
            if self.kind == "numpy":
                fn = _host_to_torch(self.fn)
            else:
                fn = self.fn if self.batched else torch.vmap(self.fn)
            obj = Objective(self.name, fn, self.encoding, self.f_opt,
                            self.tol, self.kernel, self.signature,
                            self.materialize)
            object.__setattr__(self, "_objective", obj)
        return obj

    def host_fn(self, device="cpu") -> Callable:
        """The objective as a host ``np.ndarray -> float`` function; a
        torch objective is evaluated on ``device``, one point a call."""
        if self.kind == "numpy":
            return self.fn
        fn, batched, dev = self.fn, self.batched, torch.device(device)

        def f_host(x):
            t = torch.as_tensor(np.asarray(x), dtype=torch.float32).to(dev)
            return float(fn(t[None])[0] if batched else fn(t))

        return f_host

    def random_x0(self, key, batch: int | None = None) -> np.ndarray:
        """Uniform start point(s) in the search box: ``jax.random.uniform(
        key, shape, minval=lo, maxval=hi)`` through the threefry twin, a
        float32 numpy array."""
        return random_start(key, self.encoding, batch)


_PROBLEMS = get_cache("solver.problem", maxsize=128)


# ---------------------------------------------------------------------------
# SolveResult and result hygiene
# ---------------------------------------------------------------------------

class SolveResult(NamedTuple):
    """Uniform result of :func:`solve`.

    ``extras`` keys are a contract per strategy (``docs/api.md``), and
    every path adds ``finite``:

    ============  =========================================================
    sequential    ``bits``, ``evaluations``, ``raw_trace``
    fused         ``bits``, ``evaluations``
    clustered     ``bits``, ``evaluations``, ``cluster_values``, ``winner``
    distributed   ``bits``, ``bits_resolution``, ``history``, ``schedule``
    batched       ``bits``, ``values``, ``restart_iterations``, ``trace``,
                  ``best``, ``schedule``
    solve_many    ``bits``, ``schedule``, ``wave_slot``, ``wave_size``
    ============  =========================================================

    A problem with a ``signature`` adds ``problem_signature``.
    """

    best_x: torch.Tensor     # (n_vars,) best point found
    best_f: torch.Tensor     # () objective value at best_x
    iterations: int          # population steps taken
    trace: np.ndarray        # (T,) monotone best-value-so-far history
    extras: dict             # per-strategy detail


class NonFiniteResult(RuntimeError):
    """A solve produced a non-finite ``best_f`` or trace value and the
    caller asked for ``on_nonfinite="raise"``; the result rides along as
    ``.result``."""

    def __init__(self, message: str, result: SolveResult):
        super().__init__(message)
        self.result = result


def result_is_finite(res: SolveResult) -> bool:
    """Whether ``best_f`` and every trace value of ``res`` are finite —
    the check behind ``extras["finite"]``."""
    best = float(torch.as_tensor(res.best_f).item())
    return bool(np.isfinite(np.float32(best))
                and np.isfinite(np.asarray(res.trace, np.float32)).all())


def _apply_result_hygiene(res: SolveResult, on_nonfinite: str,
                          context: str) -> SolveResult:
    """Stamp ``extras["finite"]`` and apply the ``on_nonfinite`` policy."""
    if on_nonfinite not in ("flag", "raise"):
        raise ValueError(f"on_nonfinite must be 'flag' or 'raise', "
                         f"got {on_nonfinite!r}")
    finite = result_is_finite(res)
    res.extras["finite"] = finite
    if not finite and on_nonfinite == "raise":
        raise NonFiniteResult(
            f"{context} produced a non-finite result "
            f"(best_f={float(torch.as_tensor(res.best_f).item())!r})", res)
    return res


# ---------------------------------------------------------------------------
# Strategy registry
# ---------------------------------------------------------------------------

STRATEGIES: dict[str, type] = {}


def _register(cls):
    STRATEGIES[cls.name] = cls
    return cls


def strategy_names() -> tuple[str, ...]:
    """Registered strategy keys, sorted."""
    return tuple(sorted(STRATEGIES))


class Strategy:
    """How to execute DGO.  Subclasses are frozen dataclasses carrying
    engine knobs; ``solve()`` accepts an instance, the class, or its
    string key."""

    name: ClassVar[str] = "abstract"

    def _solve(self, problem: Problem, *, key: np.ndarray | None, x0,
               max_iters: int | None,
               device: torch.device) -> SolveResult:
        raise NotImplementedError

    def _config(self, problem: Problem, max_iters: int | None,
                max_bits: int | None, bits_step: int) -> DGOConfig:
        return DGOConfig(
            encoding=problem.encoding,
            max_bits=16 if max_bits is None else max_bits,
            bits_step=bits_step,
            max_iters_per_resolution=512 if max_iters is None else max_iters)


@_register
@dataclasses.dataclass(frozen=True)
class Sequential(Strategy):
    """The paper's SPARC baseline: the one-child-at-a-time numpy loop
    (``dgo._sequential_result``), the objective evaluated a point at a
    time on the solve's device.

    extras: ``bits`` (best bit string), ``evaluations``, ``raw_trace``
    (the parent value after each step; it can rise at an escalation).
    """

    name: ClassVar[str] = "sequential"
    max_bits: int | None = None       # None -> DGOConfig default (16)
    bits_step: int = 2
    time_budget_s: float | None = None
    max_total_iters: int | None = None   # total-iteration guard

    def _solve(self, problem, *, key, x0, max_iters, device):
        from repro_torch.core import dgo
        cfg = self._config(problem, max_iters, self.max_bits, self.bits_step)
        if x0 is None:
            x0 = problem.random_x0(key)
        r = dgo._sequential_result(problem.host_fn(device),
                                   cfg, np.asarray(x0),
                                   time_budget_s=self.time_budget_s,
                                   max_iters=self.max_total_iters)
        return SolveResult(best_x=r.x, best_f=r.value,
                           iterations=int(r.iterations),
                           trace=np.minimum.accumulate(r.trace),
                           extras={"bits": r.bits,
                                   "evaluations": r.evaluations,
                                   "raw_trace": r.trace})


@_register
@dataclasses.dataclass(frozen=True)
class Fused(Strategy):
    """The whole optimization, population steps and resolution schedule,
    on one device (``dgo._fused_result``): one popstep launch a step on
    the card for a registry objective, the plain tensor step otherwise.

    ``bucketed=True`` is the reference's two-compilation engine; here
    every resolution already runs at its own width, so the result is the
    same, bitwise.

    extras: ``bits``, ``evaluations``.
    """

    name: ClassVar[str] = "fused"
    max_bits: int | None = None
    bits_step: int = 2
    bucketed: bool = False

    def _solve(self, problem, *, key, x0, max_iters, device):
        from repro_torch.core import dgo
        cfg = self._config(problem, max_iters, self.max_bits, self.bits_step)
        run = dgo._bucketed_result if self.bucketed else dgo._fused_result
        r = run(problem.objective, cfg, x0=x0, key=key, device=device)
        return SolveResult(best_x=r.x, best_f=r.value,
                           iterations=int(r.iterations), trace=r.trace,
                           extras={"bits": r.bits,
                                   "evaluations": r.evaluations})


@_register
@dataclasses.dataclass(frozen=True)
class Clustered(Strategy):
    """Independent fused runs from ``n_clusters`` starts (the paper's MP-1
    cluster mode); best-of wins.

    ``x0`` may pin the starts as an ``(n_clusters, n_vars)`` array;
    omitted, they are drawn from the seed.

    extras: ``bits``, ``evaluations`` (summed), ``cluster_values``
    ((n_clusters,) best value per cluster), ``winner`` (index).
    """

    name: ClassVar[str] = "clustered"
    n_clusters: int = 8
    max_bits: int | None = None
    bits_step: int = 2

    def _solve(self, problem, *, key, x0, max_iters, device):
        from repro_torch.core import dgo
        cfg = self._config(problem, max_iters, self.max_bits, self.bits_step)
        if x0 is not None:
            x0 = torch.as_tensor(x0, dtype=torch.float32)
            if x0.ndim != 2:
                raise ValueError(f"clustered starts must be "
                                 f"(n_clusters, n_vars), got "
                                 f"{tuple(x0.shape)}")
        r, aux = dgo._clustered_result(problem.objective, cfg,
                                       self.n_clusters, key=key, x0s=x0,
                                       device=device)
        return SolveResult(best_x=r.x, best_f=r.value,
                           iterations=int(r.iterations),
                           trace=aux["winner_trace"],
                           extras={"bits": r.bits,
                                   "evaluations": r.evaluations,
                                   "cluster_values": aux["cluster_values"],
                                   "winner": aux["winner"]})


def _resolution_schedule(enc: Encoding, max_bits: int | None,
                         bits_step: int) -> list[int]:
    """Fixed at ``enc.bits`` when ``max_bits`` is None, else the paper's
    step-5 escalation."""
    if max_bits is None:
        return [enc.bits]
    cfg = DGOConfig(encoding=enc, max_bits=max_bits, bits_step=bits_step)
    return cfg.resolutions() or [enc.bits]


_MESH_AXIS_NAMES = {1: ("data",), 2: ("data", "model"),
                    3: ("pod", "data", "model")}


def resolve_mesh(mesh=None) -> MeshGeometry:
    """Normalize a mesh-geometry parameter (``repro.core.solver.
    resolve_mesh``): ``None`` — ``("data",)`` of the launcher's shards,
    ``--devices`` (1 without it) in each process of a fleet
    (``core.distributed.default_shards``); an ``int`` N —
    ``("data",)`` of N; a shape tuple — ``(data,)``, ``(data, model)`` or
    ``(pod, data, model)`` with the conventional axis names; ``((name,
    size), ...)`` pairs — explicit geometry; a :class:`MeshGeometry` —
    passed through.  On one card a mesh is geometry only: its shards are
    virtual, and no device count is checked.  Equal geometries are equal
    values, so cache keys stay stable across calls."""
    if mesh is None:
        return MeshGeometry(("data",), (default_shards(),))
    if isinstance(mesh, MeshGeometry):
        return mesh
    if isinstance(mesh, (int, np.integer)):
        mesh = (int(mesh),)
    if not isinstance(mesh, (tuple, list)):
        raise TypeError(f"bad mesh geometry: {mesh!r}")
    entries = tuple(mesh)
    if entries and all(isinstance(e, (tuple, list)) and len(e) == 2
                       for e in entries):
        names = tuple(str(n) for n, _ in entries)
        shape = tuple(int(n) for _, n in entries)
    elif entries and all(isinstance(e, (int, np.integer)) for e in entries):
        if len(entries) not in _MESH_AXIS_NAMES:
            raise ValueError(
                f"shape-only mesh geometry supports 1-3 axes "
                f"{tuple(_MESH_AXIS_NAMES.values())}, got {entries}; pass "
                f"((name, size), ...) pairs for custom axes")
        names = _MESH_AXIS_NAMES[len(entries)]
        shape = tuple(int(n) for n in entries)
    else:
        raise TypeError(f"bad mesh geometry: {mesh!r}")
    if any(n < 1 for n in shape) or len(set(names)) != len(names):
        raise ValueError(f"bad mesh geometry: {tuple(zip(names, shape))}")
    return MeshGeometry(names, shape)


@_register
@dataclasses.dataclass(frozen=True)
class Distributed(Strategy):
    """Population distribution (MP-1/NCUBE) over the virtual shards of a
    mesh on one device: ``mesh`` (see :func:`resolve_mesh`) sharded over
    ``pop_axes``; ``quorum_mask`` (one bool a shard) marks dead shards,
    whose children are +inf each round while the rotation deals their
    slots to the others.

    ``driver="device"`` keeps the loop on the device (the host reads the
    stall flag every 16 steps); ``driver="host"`` steps from Python,
    chains the resolution schedule set by ``max_bits`` and polls
    ``injector`` (a ``runtime.failure.FailureInjector``: a failure drops a
    shard, an empty quorum stops the run).  ``inner`` picks the per-step
    engine (``"popstep"`` — the CUDA kernel, ``"fused"``, ``"jnp"``;
    ``None`` is ``"popstep"`` on CUDA, ``"fused"`` on the CPU).

    extras: ``bits`` (best parent bit string at its resolution),
    ``history`` (raw per-iteration parent values), ``schedule``,
    ``bits_resolution``.
    """

    name: ClassVar[str] = "distributed"
    mesh: Any = None                  # None -> one shard on ("data",)
    pop_axes: tuple = ("data",)
    driver: str = "device"
    inner: str | None = None
    virtual_block: int = 256
    max_bits: int | None = None       # None -> fixed resolution
    bits_step: int = 2
    quorum_mask: Any = None
    injector: Any = None

    def _solve(self, problem, *, key, x0, max_iters, device):
        from repro_torch.core import distributed
        mesh = resolve_mesh(self.mesh)
        mi = 256 if max_iters is None else max_iters
        enc0 = problem.encoding
        if x0 is None:
            x0 = problem.random_x0(key)
        schedule = _resolution_schedule(enc0, self.max_bits, self.bits_step)
        bits, val, history, best_b = distributed._run_distributed(
            problem.objective, enc0, x0, mesh=mesh,
            pop_axes=tuple(self.pop_axes), max_iters=mi,
            virtual_block=self.virtual_block, quorum_mask=self.quorum_mask,
            inner=self.inner, driver=self.driver, injector=self.injector,
            res_bits=tuple(schedule), device=device)
        best_enc = enc0.with_bits(best_b)
        trace = np.minimum.accumulate(np.asarray(history, np.float32))
        return SolveResult(best_x=decode(bits, best_enc), best_f=val,
                           iterations=len(history) - 1, trace=trace,
                           extras={"bits": bits,
                                   "bits_resolution": best_b,
                                   "history": history,
                                   "schedule": tuple(schedule)})


@_register
@dataclasses.dataclass(frozen=True)
class Batched(Strategy):
    """R restarts advancing in lockstep through one engine — the
    batched-request serving path (``serve --dgo``): on the card one
    popstep launch a step for every live restart.

    ``x0`` pins start points as ``(R, n_vars)`` (its leading dim then
    overrides ``restarts``); omitted, ``restarts`` uniform starts are
    drawn from the seed.  Fixed resolution by default; ``max_bits`` folds
    the resolution schedule into the same engine (the batch escalates in
    lockstep), like :class:`Distributed`.

    extras: ``bits`` ((R, N) per-restart best points as final-resolution
    strings — the engine's final parents on the fixed-resolution path),
    ``values`` ((R,) per-restart best), ``restart_iterations`` ((R,)),
    ``trace`` ((R, T) per-restart histories), ``best`` (winner index),
    ``schedule``.
    """

    name: ClassVar[str] = "batched"
    restarts: int = 8
    mesh: Any = None
    pop_axes: tuple = ("data",)
    virtual_block: int = 256
    max_bits: int | None = None
    bits_step: int = 2
    quorum_mask: Any = None

    def _solve(self, problem, *, key, x0, max_iters, device):
        from repro_torch.core import distributed
        mesh = resolve_mesh(self.mesh)
        mi = 256 if max_iters is None else max_iters
        enc0 = problem.encoding
        if x0 is None:
            x0 = problem.random_x0(key, batch=self.restarts)
        x0s = np.asarray(x0, np.float32)
        if x0s.ndim != 2:
            raise ValueError(f"batched starts must be (R, n_vars), "
                             f"got {x0s.shape}")
        schedule = _resolution_schedule(enc0, self.max_bits, self.bits_step)
        res = distributed._run_batched(
            problem.objective, enc0, x0s, mesh=mesh,
            pop_axes=tuple(self.pop_axes), max_iters=mi,
            virtual_block=self.virtual_block, quorum_mask=self.quorum_mask,
            res_bits=tuple(schedule), device=device)
        winner = res.best
        if res.best_xs is not None:           # schedule path: best points
            best_x = res.best_xs[winner]
        else:                                 # fixed resolution: decode
            best_x = decode_np(res.bits[winner].cpu().numpy(), enc0)
        return SolveResult(
            best_x=torch.as_tensor(best_x).to(device),
            best_f=res.values[winner],
            iterations=int(np.asarray(res.iterations).max()),
            trace=res.trace[winner],
            extras={"bits": res.bits, "values": res.values,
                    "restart_iterations": res.iterations,
                    "trace": res.trace, "best": winner,
                    "schedule": tuple(schedule)})


# ---------------------------------------------------------------------------
# solve(): the front door
# ---------------------------------------------------------------------------

def as_problem(problem, **kwargs) -> Problem:
    """Coerce a Problem / Objective / registry name into a Problem."""
    if isinstance(problem, Problem):
        return problem
    if isinstance(problem, Objective):
        return Problem.from_objective(problem)
    if isinstance(problem, str):
        return Problem.get(problem, **kwargs)
    raise TypeError(f"cannot interpret {type(problem).__name__} as a "
                    f"Problem (want Problem, Objective, or registry name)")


def as_strategy(strategy) -> Strategy:
    """Coerce a Strategy instance / class / string key into an instance."""
    if isinstance(strategy, Strategy):
        return strategy
    if isinstance(strategy, type) and issubclass(strategy, Strategy):
        return strategy()
    if isinstance(strategy, str):
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {strategy!r}; registered: "
                             f"{', '.join(strategy_names())}")
        return STRATEGIES[strategy]()
    raise TypeError(f"cannot interpret {type(strategy).__name__} as a "
                    f"Strategy (want Strategy, its class, or a string key)")


def solve(problem, strategy="fused", *, seed=0, x0=None,
          max_iters: int | None = None, on_nonfinite: str = "flag",
          device=None) -> SolveResult:
    """Run DGO on ``problem`` under ``strategy``; the one front door.

    ``problem``: a :class:`Problem`, an ``objectives.Objective``, or a
    registry name.  ``strategy``: a :class:`Strategy` instance/class or
    string key (``strategy_names()``; the default is the reference's,
    ``"fused"``).  ``seed`` drives random start points: an int becomes
    ``PRNGKey(seed)`` of the threefry twin (the reference's start for the
    same seed), or pass a ``(2,)`` uint32 key; ``x0`` pins the start
    instead (``(n_vars,)``, or ``(n_clusters, n_vars)`` for clustered).
    ``max_iters`` caps iterations per resolution (when None: 512 for the
    schedule engines, 256 for ``distributed``).  ``on_nonfinite`` is
    ``"flag"`` (stamp ``extras["finite"]``) or ``"raise"``
    (:class:`NonFiniteResult`).  ``device``: ``None`` is the CUDA card
    (``RuntimeError`` without one), ``"cpu"`` runs the plain PyTorch
    versions.
    """
    dev = resolve_device(device)
    prob = as_problem(problem)
    strat = as_strategy(strategy)
    key = None
    if x0 is None:
        key = (prng.PRNGKey(int(seed)) if isinstance(seed, (int, np.integer))
               else prng.as_key(seed))
    res = strat._solve(prob, key=key, x0=x0, max_iters=max_iters, device=dev)
    if prob.signature is not None:
        res.extras["problem_signature"] = prob.signature
    return _apply_result_hygiene(res, on_nonfinite,
                                 f"solve({prob.name!r}, {strat.name!r})")


# ---------------------------------------------------------------------------
# solve_many(): heterogeneous requests over the batched engine
# ---------------------------------------------------------------------------

_DEFAULT_REQUEST_ITERS = 256     # the distributed engines' max_iters default


@dataclasses.dataclass(frozen=True)
class SolveRequest:
    """One optimization request for :func:`solve_many` and the serving
    stack (``repro_torch.serving``).

    ``problem`` is anything :func:`as_problem` accepts.  ``x0`` pins the
    start point; omitted, it is drawn from ``seed`` exactly as a
    per-request ``solve(..., Batched(restarts=1), seed=seed)`` draws it,
    so batching requests never changes their answers.  ``max_iters`` caps
    iterations (per resolution when the dispatch sets a schedule);
    ``priority`` orders the serving queue (higher first; ignored by
    :func:`solve_many`, which keeps input order); ``deadline_s`` is a TTL
    in seconds stamped onto the serving handle at submit.
    """

    problem: Any
    seed: int = 0
    x0: Any = None
    max_iters: int | None = None
    priority: int = 0
    deadline_s: float | None = None

    def resolve(self) -> "SolveRequest":
        """Coerce ``problem`` to a :class:`Problem` and check ``x0``
        against its encoding, at the submission boundary, so one malformed
        request cannot poison the wave it would have ridden."""
        prob = as_problem(self.problem)
        if self.x0 is not None:
            _check_request_x0(prob, self.x0)
        if prob is self.problem:
            return self
        return dataclasses.replace(self, problem=prob)


def engine_signature(problem, *, mesh=None, pop_axes=("data",),
                     virtual_block: int = 256, max_bits: int | None = None,
                     bits_step: int = 2) -> tuple:
    """The bucket key of the batched engine that would serve ``problem``
    under the given dispatch configuration: the objective's identity
    (``Problem.signature`` when set, else its ``fn``), the starting
    encoding, the mesh geometry, the population axes, the virtual block
    and the resolution schedule.  The wave width, the iteration caps and
    the device are not part of it.  The serving scheduler buckets queued
    requests by this value; :func:`solve_many` groups by it."""
    prob = as_problem(problem)
    schedule = _resolution_schedule(prob.encoding, max_bits, bits_step)
    mesh = resolve_mesh(mesh)
    enc0 = prob.encoding.with_bits(schedule[0])
    fid = prob.signature if prob.signature is not None else prob.fn
    return ("batched", fid, enc0, mesh, tuple(pop_axes), virtual_block,
            tuple(schedule))


def _as_request(req) -> SolveRequest:
    if isinstance(req, SolveRequest):
        return req.resolve()
    return SolveRequest(problem=as_problem(req))


def _check_request_x0(prob: Problem, x0) -> None:
    shape = tuple(np.shape(x0))
    if shape != (prob.encoding.n_vars,):
        raise ValueError(
            f"request x0 must be ({prob.encoding.n_vars},) for "
            f"problem {prob.name!r}, got {shape}")


def _request_x0(prob: Problem, req: SolveRequest) -> np.ndarray:
    """The request's start point: pinned, or the draw a per-request
    ``solve(Batched(restarts=1), seed=...)`` makes."""
    if req.x0 is not None:
        _check_request_x0(prob, req.x0)
        x0 = req.x0
        if isinstance(x0, torch.Tensor):
            x0 = x0.detach().cpu().numpy()
        return np.asarray(x0, np.float32)
    return prob.random_x0(prng.PRNGKey(int(req.seed)), batch=1)[0]


def _slot_result(res, bits_h, slot: int, enc0: Encoding, schedule: tuple,
                 wave_size: int, device) -> SolveResult:
    """One slot's SolveResult: the post-processing ``Batched._solve``
    applies to its winner, applied to the slot, so a request's result is
    bit for bit its per-request solve's.  ``bits_h`` is the wave's bits
    fetched once (None on the schedule path, which carries decoded best
    points)."""
    if res.best_xs is not None:
        best_x = res.best_xs[slot]
    else:
        best_x = decode_np(bits_h[slot], enc0)
    iters = int(res.iterations[slot])
    return SolveResult(
        best_x=torch.as_tensor(best_x).to(device),
        best_f=res.values[slot],
        iterations=iters,
        trace=res.trace[slot][: iters + 1],
        extras={"bits": res.bits[slot], "schedule": schedule,
                "wave_slot": slot, "wave_size": wave_size})


class PendingWave:
    """One submitted wave of :func:`submit_wave`: its stepped loop runs
    on a worker thread (on the card, on its own CUDA stream), or has run
    already on the caller's (``threaded=False``).
    :meth:`finalize` waits for it and assembles one :class:`SolveResult`
    per request, in input order — exactly what :func:`solve_many` returns
    (``solve_many`` is ``submit_wave`` plus an immediate ``finalize``)."""

    def __init__(self, reqs, pending, enc0: Encoding, schedule: tuple,
                 width: int, on_nonfinite: str, contexts, device):
        self._reqs = reqs
        self._pending = pending
        self._enc0 = enc0
        self._schedule = schedule
        self._width = width
        self._on_nonfinite = on_nonfinite
        self._contexts = contexts
        self._device = device

    def finalize(self, timeout: float | None = None) -> list[SolveResult]:
        """Wait for the wave (``TimeoutError`` after ``timeout`` seconds)
        and assemble one result per request; raises whatever the wave's
        loop raised."""
        res = self._pending.finish(timeout)
        bits_h = None if res.best_xs is not None else res.bits.cpu().numpy()
        out: list[SolveResult] = []
        for slot, req in enumerate(self._reqs):
            result = _slot_result(res, bits_h, slot, self._enc0,
                                  self._schedule, self._width, self._device)
            if req.problem.signature is not None:
                result.extras["problem_signature"] = req.problem.signature
            out.append(_apply_result_hygiene(
                result, self._on_nonfinite, self._contexts[slot]))
        return out


def submit_wave(requests, *, mesh=None, pop_axes=("data",),
                virtual_block: int = 256, max_bits: int | None = None,
                bits_step: int = 2, pad_to: int | None = None,
                quorum_mask=None, on_nonfinite: str = "flag",
                contexts=None, device=None,
                threaded: bool = True) -> PendingWave:
    """Submit ONE wave of same-signature requests without waiting for
    its results; returns a :class:`PendingWave` whose ``finalize()``
    yields exactly what :func:`solve_many` would.

    All requests must share one :func:`engine_signature` under the given
    dispatch configuration (``ValueError`` otherwise), and fit one wave:
    ``pad_to`` (the wave width, padded with inactive slots) must be
    ``>= len(requests)``.  ``contexts`` labels each request for hygiene
    errors.  ``device``: None is the card, ``"cpu"`` the plain versions.
    ``threaded=False`` runs the wave's loop on the caller's thread (and
    CUDA stream) before returning, as :func:`solve_many` does.
    """
    from repro_torch.core import distributed

    reqs = [_as_request(r) for r in requests]
    if not reqs:
        raise ValueError("submit_wave needs at least one request")
    dev = resolve_device(device)
    mesh = resolve_mesh(mesh)
    sigs = {engine_signature(req.problem, mesh=mesh, pop_axes=pop_axes,
                             virtual_block=virtual_block,
                             max_bits=max_bits, bits_step=bits_step)
            for req in reqs}
    if len(sigs) > 1:
        raise ValueError(
            f"submit_wave requests span {len(sigs)} engine signatures; "
            f"one wave serves one signature (use solve_many to group)")
    width = pad_to if pad_to is not None else len(reqs)
    if width < len(reqs):
        raise ValueError(f"pad_to={pad_to} smaller than the "
                         f"{len(reqs)}-request wave")
    prob: Problem = reqs[0].problem
    schedule = tuple(_resolution_schedule(prob.encoding, max_bits,
                                          bits_step))
    enc0 = prob.encoding.with_bits(schedule[0])
    x0s = [_request_x0(req.problem, req) for req in reqs]
    caps = [req.max_iters if req.max_iters is not None
            else _DEFAULT_REQUEST_ITERS for req in reqs]
    n_pad = width - len(reqs)
    if n_pad:                     # padding: clones of slot 0,
        x0s += [x0s[0]] * n_pad   # inactive, zero budget
        caps += [0] * n_pad
    active = np.arange(width) < len(reqs)
    # the engine's cap sizes the trace only (slots stop at their own);
    # rounded up so that mixes of caps share one engine
    cap = max(64, -(-max(caps) // 64) * 64)
    pending = distributed._submit_batched(
        prob.objective, enc0, np.stack(x0s), mesh=mesh,
        pop_axes=tuple(pop_axes), max_iters=cap,
        virtual_block=virtual_block, quorum_mask=quorum_mask,
        res_bits=schedule, active=active, slot_iters=np.asarray(caps),
        device=dev, threaded=threaded)
    if contexts is None:
        contexts = [f"submit_wave request {i} ({prob.name!r})"
                    for i in range(len(reqs))]
    return PendingWave(reqs, pending, enc0, schedule, width, on_nonfinite,
                       list(contexts), dev)


def solve_many(requests, *, mesh=None, pop_axes=("data",),
               virtual_block: int = 256, max_bits: int | None = None,
               bits_step: int = 2, pad_to: int | None = None,
               quorum_mask=None, on_nonfinite: str = "flag",
               device=None) -> list[SolveResult]:
    """Solve heterogeneous requests through the batched engine, one wave
    after another per signature bucket; results in input order.

    Requests are grouped by :func:`engine_signature`; each group runs as
    waves of lockstep restarts with per-slot starts and caps.  ``pad_to``
    fixes the wave width: groups are cut to it and the last partial wave
    is padded with inactive slots, so every wave of a signature reuses one
    engine.  ``pad_to=None`` runs each group at its own width.  Each
    wave's loop runs on the caller's thread (``submit_wave(...,
    threaded=False)``).

    Each request's ``best_x``/``best_f``/``iterations``/``trace`` equal a
    per-request ``solve(problem, Batched(restarts=1, ...), ...)`` bit for
    bit.  Per-request extras: ``bits``, ``schedule``, ``wave_slot``,
    ``wave_size``, ``finite``.  ``on_nonfinite`` applies per request.
    """
    reqs = [_as_request(r) for r in requests]
    mesh = resolve_mesh(mesh)
    if pad_to is not None and pad_to < 1:
        raise ValueError(f"pad_to must be >= 1, got {pad_to}")

    groups: dict[tuple, list[int]] = {}
    for i, req in enumerate(reqs):
        sig = engine_signature(req.problem, mesh=mesh, pop_axes=pop_axes,
                               virtual_block=virtual_block,
                               max_bits=max_bits, bits_step=bits_step)
        groups.setdefault(sig, []).append(i)

    results: list[SolveResult | None] = [None] * len(reqs)
    for idxs in groups.values():
        prob: Problem = reqs[idxs[0]].problem
        width = pad_to if pad_to is not None else len(idxs)
        for start in range(0, len(idxs), width):
            wave = idxs[start: start + width]
            pending = submit_wave(
                [reqs[i] for i in wave], mesh=mesh, pop_axes=pop_axes,
                virtual_block=virtual_block, max_bits=max_bits,
                bits_step=bits_step, pad_to=width,
                quorum_mask=quorum_mask, on_nonfinite=on_nonfinite,
                contexts=[f"solve_many request {i} ({prob.name!r})"
                          for i in wave], device=device, threaded=False)
            for i, result in zip(wave, pending.finalize()):
                results[i] = result
    return results
