"""Meshes, quorum masks and failure injection in the PyTorch port, on the
CPU.

On one card a mesh is geometry only: ``Distributed(mesh=8)`` deals the
population to 8 virtual shards, rotates their slots each round and folds
their winners as the reference's ``shard_map`` does across 8 devices.  The
port's runs are held against the reference run on 8 devices (a subprocess
with ``--xla_force_host_platform_device_count=8``, as
``tests/test_distributed.py`` runs it; every reference run of this file
comes from one subprocess): quorum masks with dead shards on both drivers,
fixed and folded (``max_bits=12``), the stall limit, the injector on the
host driver, the NaN rule across shards, and ``Batched`` over a masked
mesh.  Histories are compared under the near-tie rule of
``tests/test_torch_solver.py``."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import solver as tsolver
from repro_torch.core.distributed import (
    STALL_CHECK_EVERY, MeshGeometry, _block_fold, _predicated_run,
    _shard_plan, _shard_rows)
from repro_torch.core.encoding import Encoding as TEnc
from repro_torch.kernels.popstep import ops as tops
from repro_torch.runtime import FailureInjector, drop_shard
from test_torch_solver import _nan_problems, near_tie_step

ROOT = Path(__file__).resolve().parents[1]
TWO_DEAD = [True, False, True, True, False, True, True, True]
ONE_DEAD = [True, True, True, True, True, True, False, True]

# name -> spec; a spec names the problem (registry name and kwargs, or
# ["nan", n_vars]: (x - 0.5)^2 summed, NaN where x_0 > 1.5, at 8 bits), an
# optional bits override, the mesh, the quorum mask, the driver, max_bits,
# the pinned start, max_iters and an injector (rate, seed)
CASES = {
    "all-alive-device": dict(problem=["rastrigin", {"n": 3}], bits=None,
                             mask=None, driver="device", max_bits=None,
                             x0=[3.1, -2.2, 1.7], max_iters=48),
    "two-dead-device": dict(problem=["rastrigin", {"n": 2}], bits=None,
                            mask=TWO_DEAD, driver="device", max_bits=None,
                            x0=[3.1, -2.2], max_iters=48),
    "two-dead-host": dict(problem=["rastrigin", {"n": 2}], bits=None,
                          mask=TWO_DEAD, driver="host", max_bits=None,
                          x0=[3.1, -2.2], max_iters=48),
    "two-dead-max12-device": dict(problem=["rastrigin", {"n": 3}], bits=8,
                                  mask=TWO_DEAD, driver="device",
                                  max_bits=12, x0=[2.9, -1.3, 0.6],
                                  max_iters=48),
    "two-dead-max12-host": dict(problem=["rastrigin", {"n": 3}], bits=8,
                                mask=TWO_DEAD, driver="host", max_bits=12,
                                x0=[2.9, -1.3, 0.6], max_iters=48),
    "one-dead-one-block-shards": dict(problem=["rastrigin", {"n": 9}],
                                      bits=16, mask=ONE_DEAD,
                                      driver="device", max_bits=None,
                                      x0=None, max_iters=64),
    "quadratic-two-dead-device": dict(problem=["quadratic", {"n": 2}],
                                      bits=None, mask=TWO_DEAD,
                                      driver="device", max_bits=None,
                                      x0=[4.0, -3.0], max_iters=128),
    "injector-host": dict(problem=["rastrigin", {"n": 2}], bits=None,
                          mask=None, driver="host", max_bits=None,
                          x0=[3.1, -2.2], max_iters=48, injector=[0.3, 1]),
    "injector-host-max12": dict(problem=["rastrigin", {"n": 3}], bits=8,
                                mask=None, driver="host", max_bits=12,
                                x0=[2.9, -1.3, 0.6], max_iters=48,
                                injector=[0.25, 4]),
    "nan-one-block-device": dict(problem=["nan", 2], bits=None, mask=None,
                                 driver="device", max_bits=None,
                                 x0=[-2.0] * 2, max_iters=64),
    "nan-one-block-host": dict(problem=["nan", 2], bits=None, mask=None,
                               driver="host", max_bits=None,
                               x0=[-2.0] * 2, max_iters=64),
    "nan-two-blocks-device": dict(problem=["nan", 130], bits=None,
                                  mask=None, driver="device", max_bits=None,
                                  x0=[-2.0] * 130, max_iters=24),
    "nan-two-blocks-host": dict(problem=["nan", 130], bits=None, mask=None,
                                driver="host", max_bits=None,
                                x0=[-2.0] * 130, max_iters=24),
}
# runs with no near-tie anywhere, which must end on the reference's bits
# (elsewhere two children within the bar may be chosen differently)
SAME_BITS = {"nan-one-block-device", "nan-one-block-host",
             "quadratic-two-dead-device"}
# Batched over a masked mesh: (problem, bits, mask, max_bits, x0s, iters)
BATCHED = {
    "batched-two-dead": dict(problem=["rastrigin", {"n": 2}], bits=None,
                             mask=TWO_DEAD, max_bits=None,
                             x0=[[3.1, -2.2], [1.4, 0.3], [-4.1, 2.5]],
                             max_iters=32),
    "batched-two-dead-max12": dict(problem=["rastrigin", {"n": 3}], bits=8,
                                   mask=TWO_DEAD, max_bits=12,
                                   x0=[[2.9, -1.3, 0.6], [0.4, 3.3, -2.0]],
                                   max_iters=24),
}


def _x0(spec, n_vars):
    if spec["x0"] is not None:
        return np.asarray(spec["x0"], np.float32)
    return np.random.default_rng(5).uniform(
        -5.12, 5.12, n_vars).astype(np.float32)


REFERENCE = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.core import solver as S
from repro.core.encoding import Encoding
from repro.runtime.failure import FailureInjector

cases, batched = json.loads(sys.stdin.read())


def problem(spec):
    name, kw = spec["problem"]
    if name == "nan":
        def fj(x):
            return jnp.sum((x - 0.5) ** 2) + jnp.where(x[0] > 1.5, jnp.nan,
                                                       0.0)
        return S.Problem(fn=fj, encoding=Encoding(kw, 8, -4.0, 4.0),
                         name="nan")
    p = S.Problem.get(name, **kw)
    if spec["bits"] is not None:
        p = p.replace(encoding=p.encoding.with_bits(spec["bits"]))
    return p


out = {}
for name, spec in cases.items():
    p = problem(spec)
    inj = spec.get("injector")
    strat = S.Distributed(
        mesh=8, driver=spec["driver"], max_bits=spec["max_bits"],
        quorum_mask=None if spec["mask"] is None else jnp.asarray(
            spec["mask"]),
        injector=None if inj is None else FailureInjector(inj[0],
                                                          seed=inj[1]))
    r = S.solve(p, strat, x0=jnp.asarray(spec["x0"], jnp.float32),
                max_iters=spec["max_iters"])
    out[name] = {"history": [float(v) for v in r.extras["history"]],
                 "best_f": float(r.best_f), "iterations": r.iterations,
                 "bits": np.asarray(r.extras["bits"]).tolist()}
for name, spec in batched.items():
    p = problem(spec)
    r = S.solve(p, S.Batched(mesh=8, max_bits=spec["max_bits"],
                             quorum_mask=jnp.asarray(spec["mask"])),
                x0=jnp.asarray(spec["x0"], jnp.float32),
                max_iters=spec["max_iters"])
    iters = np.asarray(r.extras["restart_iterations"])
    out[name] = {"trace": np.asarray(r.extras["trace"]).tolist(),
                 "iterations": iters.tolist(),
                 "values": np.asarray(r.extras["values"]).tolist()}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    """Every reference run of this file, on 8 devices, in one
    subprocess."""
    cases = {}
    for name, spec in CASES.items():
        n = (spec["problem"][1] if spec["problem"][0] == "nan"
             else tsolver.Problem.get(spec["problem"][0],
                                      **spec["problem"][1]).encoding.n_vars)
        cases[name] = dict(spec, x0=_x0(spec, n).tolist())
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE)],
                         input=json.dumps([cases, BATCHED]),
                         capture_output=True, text=True, env=env,
                         timeout=420)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _port_problem(spec):
    name, kw = spec["problem"]
    if name == "nan":
        return _nan_problems(kw)[1]
    p = tsolver.Problem.get(name, **kw)
    if spec["bits"] is not None:
        p = p.replace(encoding=p.encoding.with_bits(spec["bits"]))
    return p


def _port_run(spec, inner=None, mesh=8):
    p = _port_problem(spec)
    inj = spec.get("injector")
    strat = tsolver.Distributed(
        mesh=mesh, driver=spec["driver"], max_bits=spec["max_bits"],
        inner=inner, quorum_mask=spec["mask"],
        injector=None if inj is None else FailureInjector(inj[0],
                                                          seed=inj[1]))
    return tsolver.solve(p, strat, x0=_x0(spec, p.encoding.n_vars),
                         max_iters=spec["max_iters"], device="cpu")


def _inners(name):
    spec = CASES[name]
    if spec["driver"] == "device" and spec["max_bits"] is not None:
        return ["fused"]           # the folded schedule's plain step
    return ["fused", "popstep", "jnp"]


@pytest.mark.parametrize("case,inner", [(c, i) for c in CASES
                                        for i in _inners(c)])
def test_distributed_mesh_matches_eight_devices(reference, case, inner):
    """The port's 8-shard run takes the reference's 8-device steps (under
    the near-tie rule) and ends where it ends."""
    spec, ref = CASES[case], reference[case]
    port = _port_run(spec, inner)
    h_p, h_r = port.extras["history"], ref["history"]
    t = near_tie_step(h_p, h_r)
    if t is None:
        assert port.iterations == ref["iterations"]
        assert np.isclose(float(port.best_f), ref["best_f"], rtol=1e-5,
                          atol=1e-5)
        if case in SAME_BITS:
            assert np.array_equal(port.extras["bits"].numpy(),
                                  np.asarray(ref["bits"]))
    else:
        assert t >= 0.8 * (len(h_r) - 1), (t, len(h_r))


@pytest.mark.parametrize("case", ["two-dead-device", "two-dead-host",
                                  "quadratic-two-dead-device"])
def test_dead_shards_need_a_full_rotation_to_stall(reference, case):
    """With a dead shard a run ends only after ``n_shards`` steps in a row
    without an improvement (children shadowed on one round are dealt to
    a live shard on a later one); with a full quorum, after one."""
    spec = CASES[case]
    port = _port_run(spec)
    h = port.extras["history"]
    if port.iterations < spec["max_iters"]:
        assert h[-9:] == [h[-1]] * 9 and h[-10] > h[-1]
    full = _port_run(dict(spec, mask=None))
    hf = full.extras["history"]
    assert hf[-2] == hf[-1] and (len(hf) < 3 or hf[-3] > hf[-1])
    # losing shards slows the descent but reaches the full quorum's
    # minimum on the quadratic (every child is dealt to a live shard)
    if case.startswith("quadratic"):
        assert float(port.best_f) == pytest.approx(float(full.best_f),
                                                   abs=1e-6)
        assert port.iterations > full.iterations


@pytest.mark.parametrize("case", ["nan-one-block-device",
                                  "nan-two-blocks-device"])
def test_nan_child_across_shards(reference, case):
    """A NaN child wins its block; a shard of one block then reports NaN
    and wins the cross-shard min (``jnp.min`` over the gathered values):
    the step stalls.  In a shard of several blocks the NaN block is
    dropped and the run goes on."""
    spec = CASES[case]
    port = _port_run(spec, "popstep")
    plan = _shard_plan(_port_problem(spec).encoding.population, 8, 256)
    if case.startswith("nan-one"):
        assert plan.n_blocks == 1 and port.iterations == 1
    else:
        assert plan.n_blocks == 2 and port.iterations > 5
        assert port.extras["finite"]
    assert port.iterations == reference[case]["iterations"]


@pytest.mark.parametrize("case", list(BATCHED))
def test_batched_masked_mesh_matches_eight_devices(reference, case):
    spec, ref = BATCHED[case], reference[case]
    p = _port_problem(spec)
    port = tsolver.solve(p, tsolver.Batched(
        mesh=8, max_bits=spec["max_bits"], quorum_mask=spec["mask"]),
        x0=np.asarray(spec["x0"], np.float32), max_iters=spec["max_iters"],
        device="cpu")
    iters = np.asarray(port.extras["restart_iterations"])
    for r in range(len(spec["x0"])):
        h_p = port.extras["trace"][r][: iters[r] + 1]
        h_r = ref["trace"][r][: ref["iterations"][r] + 1]
        t = near_tie_step(h_p, h_r)
        assert t is None or t >= 0.8 * (len(h_r) - 1), (r, t)


@pytest.mark.parametrize("driver", ["device", "host"])
@pytest.mark.parametrize("inner", ["fused", "popstep", "jnp"])
def test_mesh_sizes_give_the_same_trajectory(driver, inner):
    """With every shard alive the rotation is invisible: one, two and
    eight shards take the same children, bit for bit."""
    spec = dict(CASES["all-alive-device"], driver=driver)
    runs = [_port_run(spec, inner, mesh) for mesh in (None, 1, 2, 8)]
    for res in runs[1:]:
        assert res.extras["history"] == runs[0].extras["history"]
        assert torch.equal(res.extras["bits"], runs[0].extras["bits"])


@pytest.mark.parametrize("mesh,pop_axes,n", [
    (None, ("data",), 1), (8, ("data",), 8), ((4, 2), ("data",), 4),
    ((4, 2), ("data", "model"), 8), ((("pod", 2), ("data", 3)), ("pod",), 2),
    ((2, 2, 2), ("pod", "data"), 4)])
def test_resolve_mesh_geometry(mesh, pop_axes, n):
    geo = tsolver.resolve_mesh(mesh)
    assert isinstance(geo, MeshGeometry)
    assert geo == tsolver.resolve_mesh(geo) == tsolver.resolve_mesh(mesh)
    assert geo.n_shards(pop_axes) == n


def test_resolve_mesh_rejects_bad_geometry():
    with pytest.raises(ValueError, match="1-3 axes"):
        tsolver.resolve_mesh((1, 1, 1, 1))
    with pytest.raises(TypeError, match="bad mesh"):
        tsolver.resolve_mesh("data")
    with pytest.raises(ValueError, match="not an axis"):
        tsolver.resolve_mesh(4).n_shards(("model",))
    with pytest.raises(ValueError, match="one entry per shard"):
        tsolver.solve("rastrigin", tsolver.Distributed(
            mesh=8, quorum_mask=[True] * 4), device="cpu")
    with pytest.raises(ValueError, match="requires driver='host'"):
        tsolver.solve("rastrigin", tsolver.Distributed(
            injector=FailureInjector(0.5)), device="cpu")


def test_drop_shard_returns_a_new_mask():
    mask = np.asarray(TWO_DEAD)
    out = drop_shard(mask)
    assert out.tolist() == [False, False, True, True, False, True, True,
                            True]
    assert mask.tolist() == TWO_DEAD


def test_shard_rows_rotate_and_mask():
    """Shard ``s`` covers slot ``(s + phase) % n_shards``; a dead shard's
    rows are invalid; the fixed engines mask ids past the population only
    (an offset past the chunk evaluates the next slot's child again, as
    the reference's blocks do), the folded one offsets past its chunk
    too."""
    enc = TEnc(2, 8, -4.0, 4.0)                  # 31 children
    plan = _shard_plan(enc.population, 4, 3)     # chunk 8: blocks of 3
    assert (plan.chunk, plan.n_blocks, plan.block) == (8, 3, 3)
    alive = (True, False, True, True)
    ids, valid = _shard_rows(enc, plan, alive, 1, False, "cpu")
    ids, valid = ids.reshape(4, 9), valid.reshape(4, 9)
    assert ids[0].tolist() == list(range(8, 17))       # slot 1
    assert ids[3].tolist() == list(range(0, 9))        # slot 0
    assert not valid[1].any()                          # shard 1 is dead
    assert ids[2].tolist() == [24, 25, 26, 27, 28, 29, 30, 30, 30]
    assert valid[2].tolist() == [True] * 7 + [False] * 2
    _, bounded = _shard_rows(enc, plan, alive, 1, True, "cpu")
    assert bounded.reshape(4, 9)[0].tolist() == [True] * 8 + [False]


def _fold_cases():
    rng = np.random.default_rng(3)
    nan, inf = np.nan, np.inf
    out = []
    for shards, blocks, block in ((4, 1, 5), (4, 2, 3), (1, 3, 4),
                                  (8, 1, 2), (3, 2, 2)):
        n = shards * blocks * block
        for kind in ("random", "ties", "nan-one", "nan-all", "inf"):
            v = rng.integers(0, 4, n).astype(np.float32)
            if kind == "random":
                v = rng.normal(size=n).astype(np.float32)
            if kind == "nan-one":
                v[rng.integers(n)] = nan
            if kind == "nan-all":
                v[: blocks * block] = nan
            if kind == "inf":
                v[:] = inf
                v[-1] = 2.0
            out.append((shards, blocks, block, v))
    return out


@pytest.mark.parametrize("case", range(len(_fold_cases())))
def test_kernel_fold_follows_the_engine_rule(case):
    """The popstep kernel's selection over shards (its plain version,
    ``fold_values_plain`` with ``n_shards``) picks the engine's (value,
    id): per block NaN wins, per shard NaN blocks drop unless the shard
    has one block, across shards NaN wins."""
    shards, blocks, block, v = _fold_cases()[case]
    vals = torch.as_tensor(v)
    ids = torch.arange(vals.shape[0])
    pop = vals.shape[0]
    ev, ei = _block_fold(vals.reshape(shards, blocks, block),
                         ids.reshape(shards, blocks, block), pop)
    kv, ki = tops.fold_values_plain(vals, ids, shards * blocks, pop,
                                    n_shards=shards)
    if torch.isnan(ev):
        assert torch.isnan(kv) and int(ki) == pop
    else:
        assert float(kv) == float(ev) and int(ki) == int(ei)


def test_restart_steps_equal_one_parent_steps():
    """The plain R-restart step is the one-parent step on each live
    parent (+inf, population where not live), over shards too."""
    obj = tsolver.Problem.get("rastrigin", n=9).objective
    enc = obj.encoding.with_bits(8)
    plan = _shard_plan(enc.population, 8, 256)
    ids, valid = _shard_rows(enc, plan, tuple(TWO_DEAD), 3, False, "cpu")
    parents = torch.as_tensor(np.random.default_rng(1).integers(
        0, 2, (5, enc.n_bits)).astype(np.int8))
    live = torch.tensor([True, False, True, True, False])
    step = tops.prepare_step_ids(obj, ids, enc, valid=valid,
                                 virtual_block=plan.block, n_shards=8,
                                 restarts=5)
    vals, wins = step(parents, live)
    one = tops.prepare_step_ids(obj, ids, enc, valid=valid,
                                virtual_block=plan.block, n_shards=8)
    for r in range(5):
        if live[r]:
            v, i = one(parents[r])
            assert float(vals[r]) == float(v) and int(wins[r]) == int(i)
        else:
            assert float(vals[r]) == np.inf and int(wins[r]) == enc.population
    with pytest.raises(ValueError, match="live flag"):
        one(parents[0], live)
    with pytest.raises(ValueError, match=r"parent_bits must be \(5"):
        step(parents[:2], live[:2])


@pytest.mark.parametrize("stall_limit", [1, 8])
def test_cpu_runs_the_cards_predicated_steps(stall_limit):
    """The CPU reads the stall counter every ``STALL_CHECK_EVERY`` steps,
    as the card does: the steps after a stall are launched and change
    nothing, with a full quorum (limit 1) and a degraded one (a full
    rotation of 8)."""
    calls = []

    def step(bits, val, k):
        calls.append(k)
        improved = torch.tensor(k < 3)
        return bits + 1, torch.where(improved, val - 1, val), improved

    bits, val, vals, iters = _predicated_run(
        step, torch.zeros(4, dtype=torch.int8), torch.tensor(10.0), 64,
        stall_limit)
    taken = 3 + stall_limit
    assert len(calls) == STALL_CHECK_EVERY * -(-taken // STALL_CHECK_EVERY)
    assert int(iters) == taken
    assert torch.equal(bits, torch.full((4,), taken, dtype=torch.int8))
    assert float(val) == 7.0
    assert vals.tolist()[:5] == [10.0, 9.0, 8.0, 7.0, 7.0]
    # the launched steps past the stall repeat the final value
    assert set(vals.tolist()[4:len(calls) + 1]) == {7.0}
