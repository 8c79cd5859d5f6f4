"""The threefry twin (``repro_torch.core.prng``) vs ``jax.random``, and the
remote-sensing samples the registry draws from it.

``PRNGKey``, ``split``, ``uniform`` and ``bernoulli`` must match bit for
bit under ``jax_threefry_partitionable=True`` (jax 0.9.0's default).  jax's
jitted ``uniform`` computes ``u * (maxval - minval) + minval`` as one
fused multiply-add on the CPU, and the twin rounds it once too.
``normal`` goes through XLA's float32 ``erf_inv``, whose ``log1p`` and
polynomial the twin evaluates with numpy's roundings: within 4 ulp."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import objectives as jobj
from repro_torch.core import objectives as tobj
from repro_torch.core import prng

NORMAL_ULP = 4


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def test_partitionable_threefry_is_the_default():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 1, 2**31 - 1, 2**32 + 5])
def test_prng_key_bitwise(seed):
    assert np.array_equal(prng.PRNGKey(seed),
                          np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("n", [1, 2, 8])
def test_split_bitwise(n):
    for seed in (0, 7, 2**31 - 1):
        key = jax.random.PRNGKey(seed)
        got = prng.split(np.asarray(key), n)
        assert got.dtype == np.uint32 and got.shape == (n, 2)
        assert np.array_equal(got, np.asarray(jax.random.split(key, n)))
    # a key split from a split key: the twin takes its own keys back
    sub = jax.random.split(jax.random.split(jax.random.PRNGKey(3))[1], n)
    assert np.array_equal(prng.split(prng.split(prng.PRNGKey(3))[1], n),
                          np.asarray(sub))


@pytest.mark.parametrize("shape", [(3,), (8, 9), (680,)])
@pytest.mark.parametrize("box", [(-5.12, 5.12), (-4.0, 4.0)])
def test_uniform_bitwise(shape, box):
    for seed in range(8):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax.random.uniform(key, shape, minval=box[0],
                                             maxval=box[1]))
        got = prng.uniform(np.asarray(key), shape, *box)
        assert got.dtype == np.float32 and got.shape == shape
        assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_uniform_rounds_once():
    """At [-5.12, 5.12] a product and a sum rounded apart differ from
    jax's on some draws; the twin's single rounding on none."""
    key = jax.random.PRNGKey(0)
    want = np.asarray(jax.random.uniform(key, (680,), minval=-5.12,
                                         maxval=5.12))
    u = prng._unit(np.asarray(key), (680,))
    lo, hi = np.float32(-5.12), np.float32(5.12)
    twice = np.maximum(lo, (u * (hi - lo)).astype(np.float32) + lo)
    assert (twice != want).any()
    assert np.array_equal(prng.uniform(np.asarray(key), (680,), -5.12, 5.12),
                          want)


def test_bernoulli_bitwise():
    for seed in range(8):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax.random.bernoulli(key, 0.5, (144,)))
        got = prng.bernoulli(np.asarray(key), 0.5, (144,))
        assert got.dtype == bool and np.array_equal(got, want)


@pytest.mark.parametrize("shape", [(8, 32, 7), (20_000,)])
def test_normal_within_ulps(shape):
    for seed in (0, 1, 42):
        key = jax.random.split(jax.random.PRNGKey(seed))[1]
        want = np.asarray(jax.random.normal(key, shape))
        got = prng.normal(np.asarray(key), shape)
        assert got.dtype == np.float32 and got.shape == shape
        assert _ulps(got, want).max() <= NORMAL_ULP


def test_key_from_a_torch_tensor_and_a_bad_key():
    key = prng.PRNGKey(5)
    assert np.array_equal(prng.split(torch.as_tensor(key.astype(np.int64))),
                          prng.split(key))
    with pytest.raises(TypeError, match=r"\(2,\) integer"):
        prng.split(np.zeros(3, np.uint32))


def test_remote_sensing_samples_are_the_references():
    """The registry draws the reference's ``PRNGKey(42)`` samples: the
    centers bitwise, the noise (0.3 x normal) within the normal's ulps,
    so each sample within those ulps of the noise plus one rounding of
    the sum."""
    x_ref, y_ref = jobj.make_remote_sensing_data(jax.random.PRNGKey(42))
    x_ref, y_ref = np.asarray(x_ref), np.asarray(y_ref)
    x, y = tobj.make_remote_sensing_data()
    assert x.dtype == np.float32 and x.shape == x_ref.shape == (256, 7)
    assert np.array_equal(y, y_ref)
    kc, kx = jax.random.split(jax.random.PRNGKey(42))
    centers = np.asarray(jax.random.uniform(kc, (8, 7), minval=-2.0,
                                            maxval=2.0))
    t_kc, t_kx = prng.split(prng.PRNGKey(42))
    assert np.array_equal(prng.uniform(t_kc, (8, 7), -2.0, 2.0), centers)
    noise = np.asarray(0.3 * jax.random.normal(kx, (8, 32, 7)))
    t_noise = np.float32(0.3) * prng.normal(t_kx, (8, 32, 7))
    assert _ulps(t_noise, noise).max() <= NORMAL_ULP + 1
    bound = ((NORMAL_ULP + 1) * np.spacing(np.abs(noise))).reshape(-1, 7) \
        + np.spacing(np.abs(x_ref))
    assert (np.abs(x - x_ref) <= bound).all()


def test_remote_sensing_objective_is_the_references():
    """``Problem.get("remote_sensing")`` evaluates the reference's samples
    without ``load_reference_state``: one objective value within 1e-5."""
    ref = jobj.remote_sensing_objective()
    port = tobj.get("remote_sensing")
    w = np.random.default_rng(0).uniform(-4, 4, 680).astype(np.float32)
    want = float(jax.jit(ref.fn)(jnp.asarray(w)))
    got = float(port.fn(torch.as_tensor(w)[None])[0])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# fold_in, randint, permutation, and the PyTorch twin of the draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("data", [0, 1, 7, 2**31 - 1, 2**31 + 3, 2**32 - 1])
def test_fold_in_bitwise(data):
    for seed in (0, 3, 2**31 - 1):
        key = jax.random.PRNGKey(seed)
        assert np.array_equal(prng.fold_in(np.asarray(key), data),
                              np.asarray(jax.random.fold_in(key, data)))


@pytest.mark.parametrize("box", [(0, 256), (0, 151_936), (-5, 7), (3, 3),
                                 (9, 2), (0, 2**31 - 1),
                                 (-2**31, 2**31 - 1)])
def test_randint_bitwise(box):
    """The span/multiplier arithmetic in wrapping uint32, an empty range
    (minval returned) included."""
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax.random.randint(key, (1000,), *box))
        got = prng.randint(np.asarray(key), (1000,), *box)
        assert got.dtype == want.dtype == np.int32
        assert np.array_equal(got, want)


@pytest.mark.parametrize("n", [1, 2, 5, 256, 4096, 151_936])
def test_permutation_bitwise(n):
    """jax's ``_shuffle``: one sort round up to n = 1,663, two at the full
    vocabulary (stable among equal 32-bit keys)."""
    for seed in (7, 11):
        key = jax.random.PRNGKey(seed)
        assert np.array_equal(prng.permutation(np.asarray(key), n),
                              np.asarray(jax.random.permutation(key, n)))


@pytest.fixture
def small_chunks(monkeypatch):
    """Chunks of 1,000 elements, so the draws below cross chunk edges."""
    monkeypatch.setattr(prng, "TORCH_CHUNK", 1000)


@pytest.mark.parametrize("shape", [(7,), (33, 61), (4, 1000, 3)])
def test_torch_twin_equals_numpy_twin(small_chunks, shape):
    """uniform and normal through PyTorch (int64-emulated uint32) equal
    the numpy twin's bit for bit."""
    for seed in (0, 1, 42):
        key = prng.split(prng.PRNGKey(seed))[1]
        for box in ((0.0, 1.0), (-5.12, 5.12), (1e-6, 1.0)):
            u = prng.uniform_torch(key, shape, *box).numpy()
            assert np.array_equal(u.view(np.int32),
                                  prng.uniform(key, shape, *box)
                                  .view(np.int32))
        got = prng.normal_torch(key, shape)
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        assert np.array_equal(got.numpy().view(np.int32),
                              prng.normal(key, shape).view(np.int32))


def test_torch_twin_normal_within_ulps_of_jax():
    """The PyTorch twin's normals are the numpy twin's, so within its
    ulps of ``jax.random.normal`` (a leaf of the reduced model's shape,
    drawn as ``init_params`` draws it)."""
    key = jax.random.fold_in(jax.random.PRNGKey(0), 5)
    want = np.asarray(jax.random.normal(key, (4, 64, 2, 16)))
    got = prng.normal_torch(np.asarray(key), (4, 64, 2, 16)).numpy()
    assert _ulps(got, want).max() <= NORMAL_ULP
