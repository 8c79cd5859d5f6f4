"""The redesigned popstep's plain twins on CPU tensors: the hidden-unit
masks the kernel reuses the parent's hidden layer by, the reuse
arithmetic against the JAX package's objective, and the 64-bit selection
key the kernel folds its virtual blocks with."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import objectives as jobj
from repro.core.encoding import Encoding as JEnc
from repro.core.encoding import decode as jdecode
from repro.core.population import generate_children as jchildren
from repro.core.population import segment_patterns as jpatterns
from repro_torch.core import objectives as tobj
from repro_torch.core.encoding import Encoding as TEnc
from repro_torch.kernels.popstep import ops

TOL = dict(rtol=1e-5, atol=1e-5)
N_W1, N_HIDDEN = 7 * 42, 42


def _brute_force_masks(n_bits, bits):
    """Bit j of row c: the JAX package's pattern c flips a bit of W1[:, j]
    or b1[j] (variables k * 42 + j and 294 + j)."""
    pat = jpatterns(n_bits)
    touched = pat.reshape(pat.shape[0], n_bits // bits, bits).any(2)
    units = (touched[:, :N_W1].reshape(-1, 7, N_HIDDEN).any(1)
             | touched[:, N_W1:N_W1 + N_HIDDEN])
    return (units.astype(np.int64) << np.arange(N_HIDDEN)).sum(1)


@pytest.mark.parametrize("bits", [4, 1, 3])
def test_hidden_unit_masks_match_the_patterns(bits):
    """Every row of the remote-sensing layout (680 variables), at the
    registry's 4 bits (5,439 rows) and at two smaller encodings."""
    n_bits = 680 * bits
    got = ops.hidden_unit_masks(n_bits, bits)
    want = _brute_force_masks(n_bits, bits)
    assert got.shape == (2 * n_bits - 1,)
    assert np.array_equal(got, want)
    if bits == 4:
        # 2,748 children recompute no hidden unit, 1,779 all 42, 14.90 on
        # average: 35.5 % of the hidden layer
        units = np.array([bin(int(m)).count("1") for m in got])
        assert (units == 0).sum() == 2748 and (units == 42).sum() == 1779
        assert round(units.mean(), 2) == 14.90


def _reference_pair():
    x, y = jobj.make_remote_sensing_data(jax.random.PRNGKey(42))
    to = tobj.load_reference_state("remote_sensing",
                                   {"x": np.asarray(x), "y": np.asarray(y)})
    return jobj.remote_sensing_objective(), to


def _rows_of_every_kind(seed):
    """Children that recompute no unit, all 42, and some: 128 of each."""
    masks = ops.hidden_unit_masks(2720, 4)
    units = np.array([bin(int(m)).count("1") for m in masks])
    rng = np.random.default_rng(seed)
    picks = [rng.choice(np.nonzero(sel)[0], 128, replace=False)
             for sel in (units == 0, units == 42, (units > 0) & (units < 42))]
    return np.sort(np.concatenate(picks))


@pytest.mark.parametrize("mask", ["exact", "none", "shifted"])
def test_reuse_arithmetic_matches_the_jax_objective(mask):
    """The plain twin of the kernel's reuse (the parent's hidden unit where
    the mask is clear, the child's where it is set) against the JAX
    objective on the same children, at the reference's own samples.  A
    wrong mask (no unit recomputed; every mask one unit off) must fail."""
    jo, to = _reference_pair()
    enc = jo.encoding
    parent = np.random.default_rng(8).integers(0, 2, enc.n_bits).astype(
        np.int8)
    ids = _rows_of_every_kind(9)
    masks = torch.as_tensor(ops.hidden_unit_masks(enc.n_bits, enc.bits))[ids]
    if mask == "none":
        masks = torch.zeros_like(masks)
    elif mask == "shifted":
        masks = (masks << 1) & ((1 << N_HIDDEN) - 1)
    got = ops.hidden_reuse_values_plain(
        to, torch.as_tensor(parent), torch.as_tensor(ids),
        TEnc(enc.n_vars, enc.bits, enc.lo, enc.hi), masks).numpy()
    xs = jdecode(jchildren(jnp.asarray(parent), jnp.asarray(ids)), enc)
    want = np.asarray(jax.jit(jax.vmap(jo.fn))(xs))
    close = np.allclose(got, want, **TOL)
    assert close == (mask == "exact")


def test_reuse_arithmetic_equals_the_full_evaluation():
    """With the exact masks the twin gives the port's plain objective's
    values."""
    obj = tobj.get("remote_sensing")
    enc = obj.encoding
    parent = torch.as_tensor(np.random.default_rng(3).integers(
        0, 2, enc.n_bits).astype(np.int8))
    ids = torch.as_tensor(_rows_of_every_kind(4))
    masks = torch.as_tensor(ops.hidden_unit_masks(enc.n_bits, enc.bits))[ids]
    got = ops.hidden_reuse_values_plain(obj, parent, ids, enc, masks)
    want = ops.child_values_plain(obj, parent, ids, enc)
    assert np.allclose(got.numpy(), want.numpy(), **TOL)


NAN, INF = float("nan"), float("inf")
CRAFTED = [3.0, -0.0, 0.0, NAN, 1.0, INF, -INF, 2.0, 2.0, 0.0, -0.0, NAN,
           -1.5, -1.5, INF, 7.0, -0.0, 0.0, 0.0, -0.0, INF, INF, 5.0, 5.0]


def test_cand_keys_order_the_in_block_rule():
    """Sorting by key is the in-block rule: NaNs first (by row), then the
    value with -0 equal to +0, then the row."""
    vals = torch.tensor(CRAFTED)
    rows = torch.arange(len(CRAFTED))
    order = torch.argsort(ops.cand_keys_plain(vals, rows)).tolist()

    def rank(r):
        v = CRAFTED[r]
        return (0, 0.0, r) if np.isnan(v) else (1, v + 0.0, r)

    assert order == sorted(range(len(CRAFTED)), key=rank)


@pytest.mark.parametrize("n_vblocks", [1, 2, 3, 4, 6, 8, 12, 24])
@pytest.mark.parametrize("sentinel", [99, 1000])
def test_key_fold_folds_like_fold_partials(n_vblocks, sentinel):
    """The kernel's key-based selection over every child's value gives
    what ``fold_partials_plain`` gives over the same values as partials,
    value (with its sign) and id, for crafted NaNs, signed zeros,
    infinities and ties, with the sentinel below and above the ids."""
    vals = torch.tensor(CRAFTED)
    rows = torch.arange(len(CRAFTED), dtype=torch.int32)
    ids = torch.arange(100, 100 + len(CRAFTED)).flip(0)
    kv, ki = ops.fold_values_plain(vals, ids, n_vblocks, sentinel)
    pv, pi = ops.fold_partials_plain(vals, rows, ids, n_vblocks, sentinel)
    assert int(ki) == int(pi)
    assert (np.isnan(float(kv)) and np.isnan(float(pv))) or (
        float(kv) == float(pv)
        and np.signbit(float(kv)) == np.signbit(float(pv)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_key_fold_on_random_steps(seed):
    """Random values with NaNs, infinities and ties in engine-like virtual
    blocks."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(-5, 5, 240).astype(np.float32)
    vals[rng.random(240) < 0.05] = np.nan
    vals[rng.random(240) < 0.05] = np.inf
    vals[rng.random(240) < 0.05] = -0.0
    ids = torch.as_tensor(rng.permutation(240))
    for nb in (1, 2, 5, 10):
        kv, ki = ops.fold_values_plain(torch.as_tensor(vals), ids, nb, 240)
        pv, pi = ops.fold_partials_plain(
            torch.as_tensor(vals), torch.arange(240, dtype=torch.int32), ids,
            nb, 240)
        assert int(ki) == int(pi)
        assert float(kv) == float(pv) or (np.isnan(float(kv))
                                          and np.isnan(float(pv)))


def test_child_values_on_the_cpu_is_the_plain_version():
    obj = tobj.get("rastrigin", n=3)
    enc = obj.encoding
    parent = torch.as_tensor(np.random.default_rng(2).integers(
        0, 2, enc.n_bits).astype(np.int8))
    ids = torch.arange(enc.population)
    valid = ids % 5 != 0
    before = ops.launches
    got = ops.child_values(obj, parent, ids, enc, valid, reuse=False)
    assert ops.launches == before
    assert torch.equal(got, ops.child_values_plain(obj, parent, ids, enc,
                                                   valid))
    assert torch.isinf(got[~valid]).all()


def test_the_parent_hidden_layer_must_fit_shared_memory():
    """The kernel keeps the samples, the labels and the parent's hidden
    layer in shared memory; a step whose data does not fit is refused
    when it is bound (before anything is built)."""
    rng = np.random.default_rng(0)
    big = tobj.load_reference_state("remote_sensing", {
        "x": rng.standard_normal((1024, 7)).astype(np.float32),
        "y": rng.integers(0, 8, 1024)})
    with pytest.raises(ValueError, match="shared-memory budget"):
        ops._prepare_cuda(big, torch.arange(4), big.encoding, None, 1)


def test_jax_encoding_matches_the_port_layout():
    """The masks index variables by the port's remote-sensing layout,
    which is the reference's (7 x 42 W1, 42 b1, 42 x 8 W2, 8 b2)."""
    jo, to = _reference_pair()
    assert jo.encoding == JEnc(680, 4, -4.0, 4.0)
    assert to.encoding.n_vars == 680 and to.encoding.bits == 4
