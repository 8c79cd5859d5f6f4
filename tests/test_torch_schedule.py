"""The resolution schedule of the PyTorch port vs the JAX package:
``population.ScheduleTables`` and the folded Distributed engine
(``Distributed(max_bits=...)`` on the device driver), on the CPU.

Tables: XOR patterns, encode and re-encode bit for bit; decode bit for bit
against the reference's eager decode and, jitted (XLA contracts
``lo + levels * scale`` into an FMA on the CPU), within one ulp of the
larger operand.
Solves: the near-tie rule of ``tests/test_torch_solver.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import population as jpop
from repro.core import solver as jsolver
from repro_torch.core import population as tpop
from repro_torch.core import prng
from repro_torch.core import solver as tsolver
from test_torch_solver import _nan_problems, assert_same_run, near_tie_step

TABLE_CASES = [(2, (8, 10, 12)), (9, (8, 10, 12, 14, 16)), (3, (4,))]
BOX = (-5.12, 5.12)
MAX_ITERS = 64


def _tables(n_vars, res_bits):
    return (jpop.schedule_tables(n_vars, res_bits, *BOX),
            tpop.schedule_tables(n_vars, res_bits, *BOX, device="cpu"))


@pytest.mark.parametrize("n_vars,res_bits", TABLE_CASES)
def test_schedule_tables_match_bitwise(n_vars, res_bits):
    jt, tt = _tables(n_vars, res_bits)
    assert (tt.n_max, tt.p_max, tt.n_res) == (jt.n_max, jt.p_max, jt.n_res)
    assert np.array_equal(tt.stacked_patterns().numpy(),
                          np.asarray(jt.patterns))
    layout = tt.stacked_layout()
    for name in ("wmat", "var", "shift", "active"):
        assert np.array_equal(layout[name], np.asarray(getattr(jt, name))), \
            name
    for name in ("pop", "scale", "max_level"):
        assert np.array_equal(getattr(tt, name).numpy(),
                              np.asarray(getattr(jt, name))), name
    for r, enc in enumerate(tt.encodings):
        assert enc.bits == res_bits[r] and enc.scale == float(jt.scale[r])


@pytest.mark.parametrize("n_vars,res_bits", TABLE_CASES)
def test_schedule_encode_decode_reencode_children(n_vars, res_bits):
    jt, tt = _tables(n_vars, res_bits)
    x = np.random.default_rng(n_vars).uniform(
        *BOX, (64, n_vars)).astype(np.float32)
    jdecode = jax.jit(jt.decode)
    for r in range(tt.n_res):
        ri = jnp.int32(r)
        want = np.asarray(jt.encode(jnp.asarray(x), ri))
        bits = tt.encode(torch.as_tensor(x), r)
        assert np.array_equal(bits.numpy(), want)
        got = tt.decode(bits, r).numpy()
        eager = np.asarray(jt.decode(jnp.asarray(want), ri))
        assert np.array_equal(got.view(np.int32), eager.view(np.int32))
        # jitted, the reference's decode is one FMA: within one ulp of the
        # larger of |levels * scale| and |lo|
        jitted = np.asarray(jdecode(jnp.asarray(want), ri))
        levels = want.astype(np.float32) @ np.asarray(jt.wmat[r])
        scale = np.asarray(jt.scale[r])
        assert np.array_equal(jitted, prng._fma32(levels, scale,
                                                  np.float32(BOX[0])))
        big = np.maximum(np.abs(levels * scale), np.float32(abs(BOX[0])))
        assert (np.abs(jitted - got) <= np.spacing(big)).all()
        if r + 1 < tt.n_res:
            assert np.array_equal(
                tt.reencode(bits, r, r + 1).numpy(),
                np.asarray(jt.reencode(jnp.asarray(want), ri, ri + 1)))
        ids = np.arange(tt.p_max)
        assert np.array_equal(
            tt.children(bits[0], torch.as_tensor(ids), r).numpy(),
            np.asarray(jt.children(jnp.asarray(want[0]), jnp.asarray(ids),
                                   ri)))


def test_table_scale_is_a_float32_division():
    """At [-5.12, 5.12] and 14 bits the table's step (a float32 division,
    as the reference's numpy table rounds it) is one ulp from the double
    quotient rounded once, the fixed-resolution engines' step."""
    _, tt = _tables(9, (8, 10, 12, 14, 16))
    enc14 = tt.encodings[3]
    assert enc14.bits == 14
    assert enc14.scale != float(np.float32(tsolver.Encoding(
        9, 14, *BOX).scale))
    assert enc14.with_bits(14).scale == tsolver.Encoding(9, 14, *BOX).scale


FOLDED = {   # (objective, kwargs, x0, max_bits)
    "quadratic3-8to12": ("quadratic", {"n": 3}, [4.0, -3.0, 6.5], 12),
    "rastrigin2-8to12": ("rastrigin", {"n": 2}, [3.1, -2.2], 12),
    "rastrigin9-8to16": ("rastrigin", {"n": 9}, None, 16),
    "shekel-8to12": ("shekel", {}, [2.0, 7.0, 1.0, 9.0], 12),
}


def _folded_case(case):
    name, kw, x0, max_bits = FOLDED[case]
    jp, tp = jsolver.Problem.get(name, **kw), tsolver.Problem.get(name, **kw)
    if x0 is None:
        x0 = np.random.default_rng(7).uniform(*BOX, jp.encoding.n_vars)
    return jp, tp, np.asarray(x0, np.float32), max_bits


@pytest.mark.parametrize("inner", [None, "fused"])
@pytest.mark.parametrize("case", list(FOLDED))
def test_folded_schedule_matches_reference(case, inner):
    """``Distributed(max_bits=...)`` on the device driver: the folded
    engine, blocks planned at the finest resolution."""
    jp, tp, x0, max_bits = _folded_case(case)
    ref = jsolver.solve(jp, jsolver.Distributed(mesh=1, max_bits=max_bits),
                        x0=jnp.asarray(x0), max_iters=MAX_ITERS)
    port = tsolver.solve(tp, tsolver.Distributed(max_bits=max_bits,
                                                 inner=inner),
                         x0=x0, max_iters=MAX_ITERS, device="cpu")
    assert port.extras["schedule"] == ref.extras["schedule"]
    assert_same_run(port, ref, min_prefix=0.9,
                    same_bits=case != "rastrigin9-8to16")


@pytest.mark.parametrize("case", ["quadratic3-8to12", "shekel-8to12"])
def test_folded_schedule_matches_host_chaining(case):
    """The reference's ``test_folded_schedule_matches_python_chaining`` in
    the port: on boxes where the table's step equals the encoding's, the
    folded history is the host-chained one, step for step."""
    _, tp, x0, max_bits = _folded_case(case)
    runs = [tsolver.solve(tp, tsolver.Distributed(max_bits=max_bits,
                                                  driver=driver),
                          x0=x0, max_iters=MAX_ITERS, device="cpu")
            for driver in ("device", "host")]
    folded, chained = runs
    assert folded.extras["history"] == chained.extras["history"]
    assert folded.extras["bits_resolution"] == chained.extras[
        "bits_resolution"]
    assert torch.equal(folded.extras["bits"], chained.extras["bits"])
    assert float(folded.best_f) == float(chained.best_f)
    assert np.array_equal(folded.trace, chained.trace)


@pytest.mark.parametrize("inner", ["popstep", "jnp"])
def test_folded_schedule_takes_no_other_inner(inner):
    """The reference's check: the folded schedule runs the ``"fused"``
    step (or ``None``); it is raised before any tensor is made."""
    with pytest.raises(ValueError, match="inner='fused' only"):
        tsolver.solve("rastrigin", tsolver.Distributed(max_bits=12,
                                                      inner=inner),
                      device="cpu")


def test_folded_nan_hides_only_its_finest_planned_block():
    """n_vars = 20, 8 -> 10 bits: at 8 bits the 319 children lie in both
    of the two blocks planned at the finest resolution (200 each), so a
    NaN child hides its block and the run goes on, as in the reference."""
    jp, tp = _nan_problems(20)
    x0 = np.full(20, -2.0, np.float32)
    ref = jsolver.solve(jp, jsolver.Distributed(mesh=1, max_bits=10),
                        x0=jnp.asarray(x0), max_iters=MAX_ITERS)
    port = tsolver.solve(tp, tsolver.Distributed(max_bits=10), x0=x0,
                         max_iters=MAX_ITERS, device="cpu")
    assert_same_run(port, ref)
    assert port.iterations > 5 and port.extras["finite"]


def test_folded_all_inf_objective_changes_no_bits():
    """+inf everywhere: no step improves.  The step's winner id may differ
    from the reference's (its fold starts from (+inf, p_max), a step
    bound at resolution r from pop_r), but ``improved`` is false, so the
    bits are the start's at every resolution."""
    enc = (jsolver.Encoding(3, 8, -4.0, 4.0), tsolver.Encoding(3, 8, -4.0,
                                                              4.0))
    jp = jsolver.Problem(fn=lambda x: jnp.inf + 0.0 * jnp.sum(x),
                         encoding=enc[0])
    tp = tsolver.Problem(fn=lambda x: torch.full(x.shape[:1], torch.inf),
                         encoding=enc[1], batched=True)
    x0 = np.asarray([1.0, -2.0, 3.0], np.float32)
    ref = jsolver.solve(jp, jsolver.Distributed(mesh=1, max_bits=12),
                        x0=jnp.asarray(x0), max_iters=MAX_ITERS)
    port = tsolver.solve(tp, tsolver.Distributed(max_bits=12), x0=x0,
                         max_iters=MAX_ITERS, device="cpu")
    assert port.extras["history"] == ref.extras["history"] == [np.inf] * 4
    assert port.extras["bits_resolution"] == ref.extras["bits_resolution"]
    assert np.array_equal(port.extras["bits"].numpy(),
                          np.asarray(ref.extras["bits"]))
    assert port.extras["finite"] is False


def test_folded_engine_returns_the_reference_layout():
    from repro_torch.core.distributed import make_distributed_engine

    tp = tsolver.Problem.get("rastrigin", n=2)
    engine = make_distributed_engine(tp.objective, tp.encoding, max_iters=8,
                                     res_bits=(8, 10, 12), device="cpu")
    best_bits, best_val, best_res, iters, trace = engine(
        np.asarray([3.1, -2.2], np.float32))
    assert best_bits.shape == (2 * 12,) and best_bits.dtype == torch.int8
    assert not best_bits[2 * (8 + 2 * best_res):].any()
    assert trace.shape == (3 * 8 + 1,) and 0 < iters <= 24
    assert bool((trace[iters:] == trace[iters]).all())
    assert near_tie_step(trace[: iters + 1].tolist(),
                         trace[: iters + 1].tolist()) is None
