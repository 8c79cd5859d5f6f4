"""PyTorch port vs the JAX package: the registry objectives.

Values must agree within rtol=atol=1e-5 (the reference kernel's bar,
tests/test_popstep.py); float32 sums taken in another order get an atol
of 4 * n * |largest term| * 2^-23 where that is larger."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import objectives as jobj
from repro_torch.core import objectives as tobj

CASES = [
    ("quadratic", {"n": 5}), ("rastrigin", {"n": 9}), ("ackley", {"n": 3}),
    ("griewank", {"n": 4}), ("shekel", {}), ("shekel", {"m": 10}),
    ("becker_lago", {}), ("sample2d", {}), ("xor", {}),
    ("remote_sensing", {}),
]


def reference_rs_arrays():
    """The reference's remote-sensing samples (``PRNGKey(42)``)."""
    x, y = jobj.make_remote_sensing_data(jax.random.PRNGKey(42))
    return {"x": np.asarray(x), "y": np.asarray(y)}


def port_objective(name, kw):
    if name == "remote_sensing":
        return tobj.load_reference_state(name, reference_rs_arrays())
    return tobj.get(name, **kw)


def atol_for(name, enc):
    if name == "rastrigin":     # x^2 - 10 cos(2 pi x), summed over n_vars
        big = max(abs(enc.lo), abs(enc.hi)) ** 2 + 10.0
        return max(1e-5, 4 * enc.n_vars * big * 2.0**-23)
    return 1e-5


@pytest.mark.parametrize("name,kw", CASES,
                         ids=[f"{n}{kw}" for n, kw in CASES])
def test_objective_values_match_reference(name, kw):
    ref = jobj.get(name, **kw)
    port = port_objective(name, kw)
    enc = ref.encoding
    assert (port.encoding.n_vars, port.encoding.bits, port.encoding.lo,
            port.encoding.hi) == (enc.n_vars, enc.bits, enc.lo, enc.hi)
    assert (port.f_opt, port.tol) == (ref.f_opt, ref.tol)
    assert port.name == ref.name
    rng = np.random.default_rng(len(name) * 7 + enc.n_vars)
    x = rng.uniform(enc.lo, enc.hi, (256, enc.n_vars)).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(ref.fn))(jnp.asarray(x)))
    got = port.fn(torch.as_tensor(x)).numpy()
    assert got.shape == (256,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=atol_for(name, enc))


def test_registry_mirrors_reference():
    ref_names = tuple(n for n in jobj.names() if ":" not in n)
    assert tuple(n for n in tobj.names() if ":" not in n) == ref_names
    zoo = [n for n in tobj.names() if ":" in n]
    assert zoo == [n for n in jobj.names() if ":" in n]
    assert len(zoo) == 10            # a tuning problem for every arch
    for name in ref_names:
        assert tobj.accepts_n(name) == jobj.accepts_n(name)
    for name, kw in [("rastrigin", {}), ("rastrigin", {"n": 2}),
                     ("shekel", {"m": 7}), ("quadratic", {"n": 3})]:
        assert tobj.canonical_spec(name, **kw) == jobj.canonical_spec(
            name, **kw)
    with pytest.raises(ValueError, match="valid names"):
        tobj.get("nope")
    with pytest.raises(ValueError, match="fixed dimensionality"):
        tobj.get("shekel", n=3)


def test_every_registry_objective_has_a_kernel_form():
    """Every registry objective but the model-zoo tuning family, which
    has no device form (the reference runs it through the plain step)."""
    ids = set()
    paper = [n for n in tobj.names() if ":" not in n]
    for name in paper:
        form = tobj.get(name).kernel
        assert form is not None and form.obj_id == tobj.OBJECTIVE_IDS[name]
        assert all(c.dtype == torch.float32 and c.is_contiguous()
                   for c in form.consts)
        ids.add(form.obj_id)
    assert len(ids) == len(paper) == len(tobj.OBJECTIVE_IDS)
    for name in tobj.names():
        if ":" in name:
            assert tobj.get(name, d=2, layers=1).kernel is None


def test_load_reference_state_carries_the_data():
    arrays = reference_rs_arrays()
    port = tobj.load_reference_state("remote_sensing", arrays)
    x, y1h = port.kernel.consts
    np.testing.assert_array_equal(x.numpy(), arrays["x"])
    np.testing.assert_array_equal(y1h.numpy().argmax(1), arrays["y"])
    # the numpy-seeded default has the same shapes and distribution
    own = tobj.get("remote_sensing").kernel.consts
    assert [tuple(c.shape) for c in own] == [(256, 7), (256, 8)]
    shekel = tobj.load_reference_state(
        "shekel", {"a": tobj.SHEKEL_A[:7], "c": tobj.SHEKEL_C[:7]}, m=7)
    assert shekel.name == "shekel7" and shekel.f_opt == jobj.shekel(7).f_opt
    assert tobj.load_reference_state("ackley", {}, n=3).encoding.n_vars == 3
    with pytest.raises(ValueError, match="takes arrays"):
        tobj.load_reference_state("remote_sensing", {"x": arrays["x"]})


# ---------------------------------------------------------------------------
# the networks' public helpers (xor_forward, rs_unpack, rs_forward,
# rs_accuracy)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_xor_forward_matches_reference(seed):
    """On the four XOR inputs and on a batch of random ones."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(-8, 8, 8).astype(np.float32)
    for x in (tobj.XOR_X, rng.standard_normal((16, 2)).astype(np.float32)):
        want = np.asarray(jobj.xor_forward(jnp.asarray(w), jnp.asarray(x)))
        got = tobj.xor_forward(torch.as_tensor(w), torch.as_tensor(x))
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_rs_unpack_matches_reference():
    w = np.arange(tobj.RS_NVARS, dtype=np.float32)
    for got, want in zip(tobj.rs_unpack(torch.as_tensor(w)),
                         jobj.rs_unpack(jnp.asarray(w))):
        assert tuple(got.shape) == want.shape
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1])
def test_rs_forward_and_accuracy_match_reference(seed):
    """Logits of the reference's 256 samples at rtol = atol = 1e-5, and
    the accuracy of random weights and of weights that learnt a little."""
    arrays = reference_rs_arrays()
    x, y = arrays["x"], arrays["y"]
    rng = np.random.default_rng(seed)
    w = rng.uniform(-1, 1, tobj.RS_NVARS).astype(np.float32)
    want = np.asarray(jobj.rs_forward(jnp.asarray(w), jnp.asarray(x)))
    got = tobj.rs_forward(torch.as_tensor(w), torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    acc_t = tobj.rs_accuracy(torch.as_tensor(w), torch.tensor(x),
                             torch.tensor(y))
    acc_j = jobj.rs_accuracy(jnp.asarray(w), jnp.asarray(x), jnp.asarray(y))
    assert acc_t.dtype == torch.float32 and float(acc_t) == float(acc_j)
    assert 0.0 <= float(acc_t) <= 1.0
