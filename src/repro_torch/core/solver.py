"""The ``solve()`` front door of the PyTorch port.

A :class:`Problem` says *what* to optimize, a :class:`Strategy` says
*how*, and :func:`solve` returns a :class:`SolveResult` — the API of
``repro.core.solver``.  Ported: ``sequential`` (the numpy baseline),
``fused`` (the default: the whole schedule on one device), ``clustered``
(independent fused runs, best-of) and ``distributed`` (one device, the
folded schedule on the device driver), with the popstep CUDA kernel as
the step on the card.  ``batched`` is not registered yet and raises
``ValueError``; ``solve_many`` and the serving stack wait too.

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
from repro_torch.core.distributed import resolve_device
from repro_torch.core.encoding import Encoding, decode
from repro_torch.core.objectives import KernelForm, Objective

__all__ = [
    "Clustered", "Distributed", "Fused", "NonFiniteResult", "Problem",
    "Sequential", "SolveResult", "Strategy", "as_problem", "as_strategy",
    "resolve_device", "result_is_finite", "solve", "strategy_names",
]

# the reference's strategy keys that this package has not ported yet
_UNPORTED = ("batched",)


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
    """

    fn: Callable[[Any], Any]
    encoding: Encoding
    name: str = "custom"
    f_opt: float | None = None
    tol: float | None = None
    batched: bool = False
    kernel: KernelForm | None = None
    kind: str | None = None      # "torch" | "numpy" | None = detect

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
                   kernel=obj.kernel, kind="torch")

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
        plus the kernel form."""
        if self.kind == "numpy":
            fn = _host_to_torch(self.fn)
        else:
            fn = self.fn if self.batched else torch.vmap(self.fn)
        return Objective(self.name, fn, self.encoding, self.f_opt, self.tol,
                         self.kernel)

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
    ============  =========================================================
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


@_register
@dataclasses.dataclass(frozen=True)
class Distributed(Strategy):
    """Population distribution (MP-1/NCUBE) on one device.

    ``driver="device"`` keeps the loop on the device (the host reads the
    stall flag every 16 steps); ``driver="host"`` steps from
    Python and chains the resolution schedule set by ``max_bits``.
    ``inner`` picks the per-step engine (``"popstep"`` — the CUDA kernel,
    ``"fused"``, ``"jnp"``; ``None`` is ``"popstep"`` on CUDA, ``"fused"``
    on the CPU).  ``mesh`` must be None or 1 (one device); quorum masks
    with dead shards, ``injector`` and ``max_bits`` with the device driver
    are not ported yet and raise ``NotImplementedError``.

    extras: ``bits`` (best parent bit string at its resolution),
    ``history`` (raw per-iteration parent values), ``schedule``,
    ``bits_resolution``.
    """

    name: ClassVar[str] = "distributed"
    mesh: Any = None
    driver: str = "device"
    inner: str | None = None
    virtual_block: int = 256
    max_bits: int | None = None       # None -> fixed resolution
    bits_step: int = 2
    quorum_mask: Any = None
    injector: Any = None

    def _solve(self, problem, *, key, x0, max_iters, device):
        from repro_torch.core import distributed
        if self.mesh not in (None, 1):
            raise NotImplementedError(
                f"meshes of more than one device are not ported yet "
                f"(ROADMAP.md queue 1); got mesh={self.mesh!r}")
        mi = 256 if max_iters is None else max_iters
        enc0 = problem.encoding
        if x0 is None:
            x0 = problem.random_x0(key)
        schedule = _resolution_schedule(enc0, self.max_bits, self.bits_step)
        bits, val, history, best_b = distributed._run_distributed(
            problem.objective, enc0, x0, max_iters=mi,
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
            note = (" (not ported to repro_torch yet)"
                    if strategy in _UNPORTED else "")
            raise ValueError(f"unknown strategy {strategy!r}{note}; "
                             f"registered: {', '.join(strategy_names())}")
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
    return _apply_result_hygiene(res, on_nonfinite,
                                 f"solve({prob.name!r}, {strat.name!r})")
