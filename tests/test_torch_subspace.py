"""Subspace DGO on the port (``repro_torch.core.subspace``, ``core.meta``,
the ``subspace-lm:*`` registry and ``serve --dgo --ckpt-dir``) against
the JAX package.

Bars: parameters from ``apply_subspace`` within 1e-6 of the reference's
(its directions are the threefry twin's normals, within 4 ulp of jax's);
objective values within rtol 1e-5 (a whole reduced model in float32 in
another order; measured up to 8.4e-6 at the registry defaults, where z
near the box's corners makes losses of ~100 and the reference's own
jitted and vmapped evaluations of one point differ by 1.05e-5);
``meta_objective``'s solve under the near-tie rule of
``tests/test_torch_strategies.py``.  The tuning problem's solves are in
``tests/test_torch_subspace_solve.py``."""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jax_restore
from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro.core import meta as jmeta
from repro.core import objectives as jobj
from repro.core import solver as jsolver
from repro.core import subspace as jsub
from repro.models import init_model as jax_init_model
from repro_torch.checkpoint import latest_step
from repro_torch.core import objectives as tobj
from repro_torch.core import prng
from repro_torch.core.encoding import Encoding, decode, encode
from repro_torch.core.meta import HyperBox, meta_objective
from repro_torch.core.solver import Fused, Problem, engine_signature, solve
from repro_torch.core.subspace import apply_subspace, materialize_winner
from repro_torch.core.tree import entries
from test_torch_strategies import assert_same_solve

ROOT = Path(__file__).resolve().parent.parent
NAME = "subspace-lm:qwen2-1.5b"
MAX_ITERS = 3
TINY = dict(d=4, bits=3, batch=2, seq=8, layers=1)
PARAM_TOL = 1e-6
VALUE_RTOL = 1e-5


@pytest.fixture(scope="module")
def tiny_problem():
    return Problem.get(NAME, **TINY)


@pytest.fixture(scope="module")
def tiny_reference():
    return jsolver.Problem.get(NAME, **TINY)


def _tiny_tree():
    return {"w": torch.linspace(-1.0, 1.0, 6).reshape(3, 2),
            "b": torch.tensor([0.5, -0.25]),
            "step": torch.tensor(7, dtype=torch.int32),
            "layers": [{"v": torch.full((2,), float(i))} for i in range(3)]}


def _jax_tiny_tree():
    return {"w": jnp.linspace(-1.0, 1.0, 6).reshape(3, 2),
            "b": jnp.asarray([0.5, -0.25]),
            "step": jnp.asarray(7, jnp.int32),
            "layers": {"v": jnp.stack([jnp.full((2,), float(i))
                                       for i in range(3)])}}


def _flat(tree):
    return {k: (v.stacked() if hasattr(v, "stacked") else v).numpy()
            for k, v in entries(tree)}


def _jflat(tree):
    return {"/".join(str(k) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# apply_subspace / materialize_winner
# ---------------------------------------------------------------------------

def test_apply_subspace_deterministic_under_fold_in():
    z = torch.tensor([0.5, -1.0, 0.25, 0.0])
    key = prng.PRNGKey(3)
    a = apply_subspace(_tiny_tree(), z, key, alpha=2.0)
    b = apply_subspace(_tiny_tree(), z, key, alpha=2.0)
    for k, v in _flat(a).items():
        assert np.array_equal(v, _flat(b)[k])
    c = apply_subspace(_tiny_tree(), z, prng.PRNGKey(4), alpha=2.0)
    assert not np.array_equal(_flat(a)["['w']"], _flat(c)["['w']"])


def test_apply_subspace_non_float_passthrough():
    out = apply_subspace(_tiny_tree(), np.ones(4, np.float32),
                         prng.PRNGKey(0), alpha=1.0)
    assert out["step"].dtype == torch.int32 and int(out["step"]) == 7
    assert out["w"].dtype == torch.float32
    assert len(out["layers"]) == 3 and out["layers"][1]["v"].shape == (2,)
    assert not torch.equal(out["w"], _tiny_tree()["w"])


@pytest.mark.parametrize("seed", [0, 11])
def test_apply_subspace_matches_reference(seed):
    """Leaf i of the reference's order (layer lists stacked), direction j
    ``normal(fold_in(fold_in(key, i), j))``."""
    z = np.random.default_rng(seed).uniform(-1, 1, 5).astype(np.float32)
    want = _jflat(jsub.apply_subspace(_jax_tiny_tree(), jnp.asarray(z),
                                      jax.random.PRNGKey(seed), alpha=1.5))
    got = _flat(apply_subspace(_tiny_tree(), z, prng.PRNGKey(seed),
                               alpha=1.5))
    assert list(got) == list(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=PARAM_TOL)


def test_materialize_winner_dense_parity():
    """The leaf-streamed sum against a dense reconstruction that stacks
    the (d, *leaf) directions and sums in the same order: bit for bit;
    the bit-string and z-vector entry points bitwise identical."""
    enc = Encoding(n_vars=4, bits=3, lo=-2.0, hi=2.0)
    key, alpha = prng.PRNGKey(11), 1.5
    bits = encode(torch.tensor([0.3, -1.2, 1.7, 0.0]), enc)
    z = decode(bits, enc)
    params0 = _tiny_tree()
    scale = np.float32(alpha / math.sqrt(4))
    dense = {}
    for i, (k, leaf) in enumerate(entries(params0)):
        leaf = leaf.stacked() if hasattr(leaf, "stacked") else leaf
        if not leaf.is_floating_point():
            dense[k] = leaf.numpy()
            continue
        eps = np.stack([prng.normal(prng.fold_in(prng.fold_in(key, i), j),
                                    tuple(leaf.shape)) for j in range(4)])
        delta = z.numpy()[0] * eps[0]
        for j in range(1, 4):
            delta = delta + z.numpy()[j] * eps[j]
        dense[k] = leaf.numpy() + scale * delta
    streamed = _flat(materialize_winner(params0, bits, enc, key, alpha))
    for k, v in dense.items():
        assert np.array_equal(streamed[k], v), k
    via_z = _flat(materialize_winner(params0, z, None, key, alpha))
    for k, v in streamed.items():
        assert np.array_equal(via_z[k], v), k


# ---------------------------------------------------------------------------
# the zoo tuning family as Problems
# ---------------------------------------------------------------------------

def test_registry_has_the_ports_zoo():
    assert NAME in tobj.names() and NAME in jobj.names()
    assert tobj.canonical_spec(NAME, d=8) == jobj.canonical_spec(NAME, d=8)
    # every architecture of the reference is a tuning problem; an
    # unknown one raises the reference's ValueError
    assert tobj.get("subspace-lm:xlstm-125m").signature == jobj.get(
        "subspace-lm:xlstm-125m").signature
    assert Problem.get("subspace-lm:zamba2-1.2b", d=4).signature \
        == jobj.get("subspace-lm:zamba2-1.2b", d=4).signature
    with pytest.raises(ValueError, match="unknown objective"):
        tobj.get("subspace-lm:mamba-7b")


def test_tuning_problems_bucket_by_semantic_signature(tiny_problem,
                                                      tiny_reference):
    a, b = tobj.get(NAME, **TINY), tobj.get(NAME, **TINY)
    assert a.fn is not b.fn
    assert a.signature == b.signature == tiny_problem.signature \
        == tiny_reference.signature
    assert (engine_signature(Problem.from_objective(a))
            == engine_signature(Problem.from_objective(b))
            == engine_signature(tiny_problem))
    other = Problem.get(NAME, d=4, bits=3, batch=2, seq=8, layers=1, seed=1)
    assert engine_signature(other) != engine_signature(tiny_problem)
    assert tiny_problem is Problem.get(NAME, seed=0, **TINY)
    assert tiny_problem.encoding.n_vars == 4 and tiny_problem.kernel is None


@pytest.mark.parametrize("spec", [TINY, {}], ids=["tiny", "registry"])
def test_objective_values_match_reference(spec):
    """fn over a population of z (chunks of ``CHUNK`` children) against
    the reference's fn, point by point."""
    ref = jobj.get(NAME, **spec)
    port = tobj.get(NAME, **spec)
    d = ref.encoding.n_vars
    zs = np.random.default_rng(d).uniform(-1, 1, (70, d)).astype(np.float32)
    zs[0] = 0.0
    want = np.asarray(jax.jit(jax.vmap(ref.fn))(jnp.asarray(zs)))
    got = port.fn(torch.from_numpy(zs))
    assert got.shape == (70,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=VALUE_RTOL)


def test_materialize_evaluates_to_the_objective(tiny_problem):
    """The winner's parameters (streamed) give the objective's value
    (one matrix product) within float32 rounding of a whole model
    (``VALUE_RTOL``; up to 8e-7 measured over 20 points of the box)."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models.lm import lm_loss
    import dataclasses

    z = torch.tensor([[0.3, -0.7, 0.1, 0.9]])
    params = tiny_problem.materialize(z[0])
    arch = dataclasses.replace(reduced(get_arch("qwen2-1.5b")), n_layers=1)
    from repro_torch.data import lm_synthetic_batch
    tokens, labels = lm_synthetic_batch(prng.PRNGKey(1), 2, 8, 256)
    loss = lm_loss(params, arch, {"tokens": torch.from_numpy(tokens).long(),
                                  "labels": torch.from_numpy(labels).long()},
                   dtype=torch.float32)
    np.testing.assert_allclose(float(loss), float(tiny_problem.fn(z)[0]),
                               rtol=VALUE_RTOL)


# ---------------------------------------------------------------------------
# meta_objective
# ---------------------------------------------------------------------------

def test_hyperbox_decode_matches_reference():
    u = np.array([[0.0, 0.5, 1.0], [0.25, 0.1, 0.7]], np.float32)
    got = HyperBox().decode_hypers(torch.from_numpy(u))
    for row in range(2):
        want = jmeta.HyperBox().decode_hypers(jnp.asarray(u[row]))
        for k, v in want.items():
            np.testing.assert_allclose(float(got[k][row]), float(v),
                                       rtol=1e-6)
    box = HyperBox()
    assert float(got["warmup_frac"][0]) == pytest.approx(box.warmup[1])
    assert box.encoding().n_vars == 3


def test_meta_dgo_finds_good_lr():
    """The reference's quadratic short-train through Fused(max_bits=7):
    DGO recovers a near-optimal lr; the run follows the reference's."""
    def short_train(hypers):
        lr = hypers["lr"]
        w = torch.full_like(lr, 4.0)
        for _ in range(30):
            w = w - lr * 2 * w
        return w * w

    def jshort_train(hypers):
        lr = hypers["lr"]

        def body(w, _):
            return w - lr * 2 * w, None
        w, _ = jax.lax.scan(body, jnp.float32(4.0), None, length=30)
        return w * w

    res = solve(meta_objective(short_train, HyperBox(bits=5)),
                Fused(max_bits=7), seed=0, device="cpu")
    assert float(res.best_f) < 1e-2
    ref = jsolver.solve(jmeta.meta_objective(jshort_train,
                                             jmeta.HyperBox(bits=5)),
                        jsolver.Fused(max_bits=7), seed=0)
    assert_same_solve(res, ref, same_bits=False)


# ---------------------------------------------------------------------------
# serve --dgo with subspace-lm and --ckpt-dir
# ---------------------------------------------------------------------------

_SERVE = """
import json, sys, torch
from repro_torch.launch import serve
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.core.tree import entries
seen = {}
real = serve._persist_winners
def persist(ckpt_dir, handles, submitted):
    seen["handles"] = handles
    return real(ckpt_dir, handles, submitted)
serve._persist_winners = persist
args = serve.build_parser().parse_args(sys.argv[1:])
report = serve.serve_dgo(args, device="cpu")
tuned = [h for h in seen["handles"] if h.request.problem.name.startswith(
    "subspace-lm")]
best = min(tuned, key=lambda h: float(h.result().best_f))
want = best.request.problem.materialize(best.result().best_x)
path = report["checkpoints"][0]
step = int(path.rsplit("_", 1)[1])
got = restore_checkpoint(path.rsplit("/", 1)[0], step, want)
same = all(torch.equal(a.stacked() if hasattr(a, "stacked") else a,
                       b.stacked() if hasattr(b, "stacked") else b)
           for (_, a), (_, b) in zip(entries(got), entries(want)))
print(json.dumps({"report": report, "restored_equals_winner": same,
                  "tuned": len(tuned)}))
"""


def test_serve_dgo_tunes_and_persists_winners(tmp_path):
    """``serve --dgo --problems subspace-lm:qwen2-1.5b,rastrigin:9
    --ckpt-dir``: every request completes, the tuning winner's checkpoint
    restores to ``materialize(best_x)`` bit for bit, and the reference
    reads it into its own model tree."""
    ckpt = tmp_path / "ck"
    argv = ["--dgo", "--problems", f"{NAME},rastrigin:9", "--restarts", "2",
            "--waves", "1", "--max-iters", "3", "--no-pipeline",
            "--ckpt-dir", str(ckpt)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _SERVE] + argv, env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=240, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["report"]["completed"] == 2 and res["report"]["failed"] == 0
    assert res["tuned"] == 1 and res["restored_equals_winner"]
    sub = ckpt / "subspace-lm__qwen2-1.5b"
    assert res["report"]["checkpoints"] == [str(sub / "step_00000002")]
    assert latest_step(sub) == 2
    ja = jax_reduced(jax_get_arch("qwen2-1.5b"))
    like = jax_init_model(ja, jax.random.PRNGKey(0))
    restored = _jflat(jax_restore(sub, 2, like))
    assert list(restored) == list(_jflat(like))
    port = tobj.get(NAME)
    assert port.encoding.n_vars == 24
    assert all(np.isfinite(v).all() for v in restored.values())
