"""A cell's objective names its kernels: the traced window is retried
only where the session recorded none of them, and a cell whose objective
has no popstep form runs the harness whole, traced and untraced.  On the
CPU, at small sizes."""
import dataclasses
import math
import types

import pytest
import torch

from dgobench import run
from dgobench import trace as tracing
from dgobench.test_dgobench_check import SEED, quantities, small

POPSTEP_COUNT = ("popstep_kernel",)
GEMM_COUNT = ("sgemm",)
PLAIN_COUNT = ("elementwise_kernel", "reduce_kernel")


def summary(kernels=0, **launches):
    return {"kernels": kernels, "popstep_launches": launches.get(
        "popstep_kernel", 0), "launches_of": launches}


@pytest.mark.parametrize("count, rec, wanted", [
    (POPSTEP_COUNT, summary(43, popstep_kernel=1), True),
    (POPSTEP_COUNT, summary(42), False),
    (POPSTEP_COUNT, summary(0), False),
    (GEMM_COUNT, summary(40, sgemm=12), True),
    (GEMM_COUNT, summary(40, popstep_kernel=1), False),
    (PLAIN_COUNT, summary(9, reduce_kernel=2), True),
    (PLAIN_COUNT, summary(9, popstep_kernel=3), False),
])
def test_the_retry_asks_for_the_kernels_the_count_names(count, rec, wanted):
    assert tracing.recorded(rec, count) is wanted


class _Event:
    def __init__(self, name, t0, t1, device=True):
        self._n, self._t0, self._t1, self._d = name, t0, t1, device

    def name(self):
        return self._n

    def start_ns(self):
        return self._t0

    def end_ns(self):
        return self._t1

    def device_type(self):
        return "DeviceType.CUDA" if self._d else "DeviceType.CPU"


def _prof(events):
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=results))


@pytest.mark.parametrize("kernels", [POPSTEP_COUNT, GEMM_COUNT,
                                     POPSTEP_COUNT + GEMM_COUNT])
def test_summaries_keep_the_popstep_numbers(kernels):
    events = [_Event(tracing.WINDOW, 0, 10_000, device=False),
              _Event("void popstep::popstep_kernel<1>(StepArgs)", 100, 1100),
              _Event("void popstep::popstep_kernel<1>(StepArgs)", 900, 2100),
              _Event("ampere_sgemm_128x64_nn", 3000, 3500),
              _Event("Memcpy DtoH (Device -> Pinned)", 4000, 4100),
              _Event("aten::mm", 2900, 3600, device=False)]
    s = tracing.summarize(_prof(events), kernels)
    assert s["popstep_launches"] == 2
    assert s["popstep_s"] == pytest.approx(2000 / 1e9)
    assert s["kernels"] == 3 and s["busy_s"] == pytest.approx(2600 / 1e9)
    assert set(s["launches_of"]) == set(kernels)
    assert s["launches_of"].get("popstep_kernel", 2) == 2
    assert s["launches_of"].get("sgemm", 1) == 1
    assert tracing.recorded(s, kernels)


SHIFT = 1.2345


def _quadratic(n: int = 6):
    """A plain-torch objective with no device form (``kernel=None``)."""
    from repro_torch.core.encoding import Encoding
    from repro_torch.core.objectives import Objective

    def fn(x):
        d = x - SHIFT
        return (d * d).sum(-1)

    return Objective(f"bench_plain_quadratic{n}", fn,
                     Encoding(n_vars=n, bits=8, lo=-10.0, hi=10.0), 0.0,
                     1e-2)


def _reference():
    ref = types.ModuleType("plain_quadratic_reference")
    ref.CHUNK = 1024
    ref.state = lambda config: {}
    ref.values = lambda x, st: ((x - SHIFT) ** 2).sum(-1)
    ref.control_values = lambda x, st: (
        (x.to(torch.bfloat16) - SHIFT) ** 2).to(torch.float32).sum(-1)
    return ref


def _count():
    count = types.ModuleType("plain_quadratic_count")
    count.KERNELS = PLAIN_COUNT
    count.ops_per_restart_step = lambda config: float(
        3 * int(config["n_vars"]) * (2 * config["n_vars"] * 8 - 1))
    count.bytes_per_launch = lambda config, live: 0.0
    return count


@pytest.fixture
def kernel_less_cell(monkeypatch):
    from repro_torch.core import objectives

    objectives._registry()
    monkeypatch.setitem(objectives._REGISTRY, "bench_plain_quadratic",
                        (_quadratic, True))
    base = small("r1000.closed")
    cfg = dict(base.config, name="plain_quadratic6",
               problem="bench_plain_quadratic", problem_spec={"n": 6},
               n_vars=6, bits=8, lo=-10.0, hi=10.0, max_iters=6)
    assert objectives.get("bench_plain_quadratic", n=6).kernel is None
    return dataclasses.replace(base, config=cfg, reference=_reference(),
                               count=_count())


@pytest.mark.parametrize("traced", [False, True])
def test_a_kernel_less_objective_runs_correct(kernel_less_cell, traced):
    res = run.run_cell(kernel_less_cell, SEED, 1.0, traced, device="cpu")
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["attempted"] > 0
    q = quantities(res)
    assert "popstep_roofline" not in q
    if traced:
        assert q["bucket_fill"] == 100.0
        assert "wave_ms" in q
    else:
        assert set(q) == {"setup_s", "solves_per_s"}
    assert math.isfinite(res["check"]["final_gap"]["value"])
