"""The README's subspace-tuning example on the port: xlstm-125m (two
layers: an mLSTM and an sLSTM) tuned by ``Batched`` DGO, held against
the JAX package's solve of the same problem (in a file of its own: the
reference's engine takes most of a minute to compile here).

Bars: the trace under the near-tie rule of tests/test_torch_batched.py
(``_follows``), the best value under tests/test_torch_strategies.py's."""
import jax
import numpy as np

from repro.core import solver as jsolver
from repro_torch.core.solver import Batched, Problem, solve
from repro_torch.core.tree import entries
from test_torch_batched import _follows
from test_torch_strategies import _close as near


def test_readme_xlstm_tuning_example_solves_as_the_reference():
    """``Problem.get("subspace-lm:xlstm-125m", d=12, layers=2)`` under
    ``Batched(restarts=1, max_bits=6)``, ``max_iters=6``: the trace
    follows the reference's, the best value is its, and the winner
    materialises into every parameter of the two-layer model."""
    port_p = Problem.get("subspace-lm:xlstm-125m", d=12, layers=2)
    ref_p = jsolver.Problem.get("subspace-lm:xlstm-125m", d=12, layers=2)
    port = solve(port_p, Batched(restarts=1, max_bits=6), max_iters=6,
                 device="cpu")
    ref = jsolver.solve(ref_p, jsolver.Batched(restarts=1, max_bits=6),
                        max_iters=6)
    _follows(np.asarray(port.trace), np.asarray(ref.trace))
    assert near(float(port.best_f), float(ref.best_f))
    assert (np.diff(np.asarray(port.trace)) <= 1e-6).all()
    params = port_p.materialize(port.best_x)
    assert [k for k, _ in entries(params)] == [
        "/".join(str(p) for p in path) for path, _ in
        jax.tree_util.tree_flatten_with_path(ref_p.materialize(ref.best_x))[0]]
