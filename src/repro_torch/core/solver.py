"""The ``solve()`` front door of the PyTorch port.

A :class:`Problem` says *what* to optimize, a :class:`Strategy` says
*how*, and :func:`solve` returns a :class:`SolveResult` — the API of
``repro.core.solver``.  Ported so far: the ``distributed`` strategy on one
device, with the popstep CUDA kernel as its inner loop on the card.  The
other strategy keys of the reference (``sequential``, ``fused``,
``clustered``, ``batched``) are not registered yet and raise
``ValueError``; ``solve_many`` and the serving stack wait too.

Devices: every entry point runs on the card unless the caller asks for
the CPU.  ``device=None`` means CUDA and raises ``RuntimeError`` when no
card is present; pass ``device="cpu"`` to run the plain PyTorch versions.

  >>> from repro_torch.core.solver import Distributed, solve
  >>> res = solve("rastrigin", Distributed(), seed=0, device="cpu")
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, ClassVar, NamedTuple

import numpy as np
import torch

from repro_torch.core import objectives as objectives_registry
from repro_torch.core.cache import get_cache
from repro_torch.core.dgo import DGOConfig
from repro_torch.core.distributed import resolve_device
from repro_torch.core.encoding import Encoding, decode
from repro_torch.core.objectives import KernelForm, Objective

__all__ = [
    "Distributed", "NonFiniteResult", "Problem", "SolveResult", "Strategy",
    "as_problem", "as_strategy", "resolve_device", "result_is_finite",
    "solve", "strategy_names",
]

# the reference's strategy keys that this package has not ported yet
_UNPORTED = ("batched", "clustered", "fused", "sequential")


# ---------------------------------------------------------------------------
# Problem: what to optimize
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Problem:
    """An optimization problem: objective + search box/resolution.

    ``fn`` is a PyTorch function of one point, ``(n_vars,) -> ()``, or,
    with ``batched=True``, of a batch, ``(B, n_vars) -> (B,)``.  A
    one-point function is batched with ``torch.vmap``.  ``kernel`` is the
    objective's device form for the popstep kernel; only registry
    objectives (:meth:`get`) carry one.
    """

    fn: Callable[[torch.Tensor], torch.Tensor]
    encoding: Encoding
    name: str = "custom"
    f_opt: float | None = None
    tol: float | None = None
    batched: bool = False
    kernel: KernelForm | None = None

    @classmethod
    def from_objective(cls, obj: Objective) -> "Problem":
        return cls(fn=obj.fn, encoding=obj.encoding, name=obj.name,
                   f_opt=obj.f_opt, tol=obj.tol, batched=True,
                   kernel=obj.kernel)

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
        """The problem as the engines consume it: a batched ``fn`` plus
        the kernel form."""
        fn = self.fn if self.batched else torch.vmap(self.fn)
        return Objective(self.name, fn, self.encoding, self.f_opt, self.tol,
                         self.kernel)

    def random_x0(self, generator: torch.Generator,
                  batch: int | None = None) -> torch.Tensor:
        """Uniform start point(s) in the search box, drawn on the CPU from
        ``generator``.  These are not the reference's numbers (``jax.random``
        from the same seed differs; a threefry twin is ``ROADMAP.md``
        queue 1 #2): pin ``x0`` to compare the two packages."""
        enc = self.encoding
        shape = (enc.n_vars,) if batch is None else (batch, enc.n_vars)
        u = torch.rand(shape, generator=generator, dtype=torch.float32)
        return enc.lo + u * (enc.hi - enc.lo)


_PROBLEMS = get_cache("solver.problem", maxsize=128)


# ---------------------------------------------------------------------------
# SolveResult and result hygiene
# ---------------------------------------------------------------------------

class SolveResult(NamedTuple):
    """Uniform result of :func:`solve`.

    ``extras`` keys are a contract per strategy (``docs/api.md``):
    ``distributed`` reports ``bits``, ``bits_resolution``, ``history``,
    ``schedule`` and, like every path, ``finite``.
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

    def _solve(self, problem: Problem, *, generator: torch.Generator | None,
               x0, max_iters: int | None,
               device: torch.device) -> SolveResult:
        raise NotImplementedError


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

    def _solve(self, problem, *, generator, x0, max_iters, device):
        from repro_torch.core import distributed
        if self.mesh not in (None, 1):
            raise NotImplementedError(
                f"meshes of more than one device are not ported yet "
                f"(ROADMAP.md queue 1); got mesh={self.mesh!r}")
        mi = 256 if max_iters is None else max_iters
        enc0 = problem.encoding
        if x0 is None:
            x0 = problem.random_x0(generator)
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


def solve(problem, strategy="distributed", *, seed: int = 0, x0=None,
          max_iters: int | None = None, on_nonfinite: str = "flag",
          device=None) -> SolveResult:
    """Run DGO on ``problem`` under ``strategy``; the one front door.

    ``problem``: a :class:`Problem`, an ``objectives.Objective``, or a
    registry name.  ``strategy``: a :class:`Strategy` instance/class or
    string key (``strategy_names()``; the reference's default ``"fused"``
    is not ported yet, so the default here is ``"distributed"``).
    ``seed`` seeds a ``torch.Generator`` for the start point; ``x0``
    pins it instead.  ``max_iters`` caps iterations per resolution (256
    when None).  ``on_nonfinite`` is ``"flag"`` (stamp
    ``extras["finite"]``) or ``"raise"`` (:class:`NonFiniteResult`).
    ``device``: ``None`` is the CUDA card (``RuntimeError`` without one),
    ``"cpu"`` runs the plain PyTorch versions.
    """
    dev = resolve_device(device)
    prob = as_problem(problem)
    strat = as_strategy(strategy)
    generator = None
    if x0 is None:
        generator = torch.Generator().manual_seed(int(seed))
    res = strat._solve(prob, generator=generator, x0=x0,
                       max_iters=max_iters, device=dev)
    return _apply_result_hygiene(res, on_nonfinite,
                                 f"solve({prob.name!r}, {strat.name!r})")
