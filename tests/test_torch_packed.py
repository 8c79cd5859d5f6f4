"""The port's packed-word kernels (their plain PyTorch versions, on CPU
tensors) vs the JAX package's ``graycode``, ``fixedpoint`` and ``popmin``
wrappers (interpret mode, as tests/test_kernels.py runs them) and their
oracles, at the shapes of tests/test_kernels.py.

Inputs are made with numpy from a seed and handed to both packages.

Bars: graycode bitwise; fixedpoint bitwise against the oracle and within
1 ulp of the JAX kernel; popmin exact against the oracle, NaN and ties
included (not against the TPU kernel's tile fold, ROADMAP queue 3)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encoding as jenc
from repro.core import objectives as jobj
from repro.kernels.fixedpoint import ops as jfix
from repro.kernels.fixedpoint import ref as jfix_ref
from repro.kernels.graycode import ops as jgray
from repro.kernels.graycode import ref as jgray_ref
from repro.kernels.popmin import ops as jmin
from repro.kernels.popmin import ref as jmin_ref
from repro_torch.core import encoding as tenc
from repro_torch.core import objectives as tobj
from repro_torch.core.population import table_on
from repro_torch.kernels.fixedpoint import ops as tfix
from repro_torch.kernels.fixedpoint import ref as tfix_ref
from repro_torch.kernels.graycode import ops as tgray
from repro_torch.kernels.graycode import ref as tgray_ref
from repro_torch.kernels.popmin import ops as tmin
from repro_torch.kernels.popmin import ref as tmin_ref
from repro_torch.kernels.popstep import ops as tstep

TOL = dict(rtol=1e-5, atol=1e-5)

# the integer JAX oracles, jitted: eager op-by-op dispatch costs seconds
# a call.  The decode oracle runs eagerly, as tests/test_kernels.py runs
# it: under jit, XLA contracts its lo + level * scale into an FMA too.
gray_oracle = jax.jit(jgray_ref.graycode_children_ref, static_argnums=2)
min_oracle = jax.jit(jmin_ref.popmin_ref)


def _bits(shape, seed):
    return np.random.default_rng(seed).integers(0, 2, shape).astype(np.int8)


# ---------------------------------------------------------------------------
# graycode
# ---------------------------------------------------------------------------

# W odd and even; 1,100 (W = 35) and 2,720 (W = 85, remote_sensing) are
# odd W past the first few words
@pytest.mark.parametrize("n", [9, 32, 63, 100, 128, 257, 680, 1100, 2720])
def test_graycode_matches_reference_bitwise(n):
    parent = _bits(n, n)
    w = (n + 31) // 32
    ids = np.arange(2 * n - 1)
    got = tgray.generate_population_packed(torch.as_tensor(parent)).numpy()
    assert got.shape == (2 * n - 1, w) and got.dtype == np.int64
    want_kernel = np.asarray(jgray.generate_population_packed(
        jnp.asarray(parent)), np.int64)
    want_ref = np.asarray(gray_oracle(
        jnp.asarray(parent), jnp.asarray(ids), w), np.int64)
    assert np.array_equal(got, want_kernel)
    assert np.array_equal(got, want_ref)
    assert np.array_equal(tgray_ref.graycode_children_ref(
        torch.as_tensor(parent), torch.as_tensor(ids), w).numpy(), want_ref)


def test_graycode_plain_on_a_subset_of_children():
    """The plain version on arbitrary segments (the kernel's inputs) is
    the oracle on those children."""
    n = 257
    parent = torch.as_tensor(_bits(n, 3))
    ids = torch.as_tensor(np.random.default_rng(4).permutation(2 * n - 1)[:50])
    table = table_on("table", n, "cpu")[ids]
    got = tgray.graycode_children_plain(parent, table[:, 0], table[:, 1])
    assert torch.equal(got, tgray_ref.graycode_children_ref(parent, ids, 9))


def test_graycode_children_at_the_shared_memory_budget():
    """``graycode_children`` on a subset of the children (an odd count) of
    the largest parent the kernel takes (W = MAX_SMEM / 4 words, a partial
    last word) is the JAX oracle's."""
    n = 32 * (tgray.MAX_SMEM // 4) - 5
    parent = _bits(n, 5)
    ids = np.random.default_rng(6).choice(2 * n - 1, 63, replace=False)
    table = table_on("table", n, "cpu")[torch.as_tensor(ids)]
    got = tgray.graycode_children(torch.as_tensor(parent), table[:, 0],
                                  table[:, 1]).numpy()
    want = np.asarray(gray_oracle(jnp.asarray(parent), jnp.asarray(ids),
                                  (n + 31) // 32), np.int64)
    assert got.shape == (63, n // 32 + 1) and np.array_equal(got, want)


def test_graycode_children_rejects_what_the_kernel_does_not_take():
    parent = torch.zeros(40, dtype=torch.int8)
    with pytest.raises(ValueError, match="starts and ends"):
        tgray.graycode_children(parent, torch.zeros(0, dtype=torch.int32),
                                torch.zeros(0, dtype=torch.int32))
    with pytest.raises(ValueError, match="starts and ends"):
        tgray.graycode_children(parent, torch.zeros(3, dtype=torch.int32),
                                torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="parent_bits"):
        tgray.graycode_children(torch.zeros((2, 2), dtype=torch.int8),
                                torch.zeros(3), torch.zeros(3))


# ---------------------------------------------------------------------------
# fixedpoint
# ---------------------------------------------------------------------------

# widths dividing 32 at 9 vars, whose rows of points start off 16-byte
# boundaries, straddling fields (7 and 6 bits), and rows of 1, 127, 128
# and 129 vars around the kernel's step of 128 points
FIX_SHAPES = [(2, 8), (9, 7), (8, 6), (680, 4), (3, 16), (5, 32), (9, 1),
              (9, 2), (9, 8), (9, 16), (9, 32), (1, 7), (127, 3), (128, 2),
              (129, 1)]


@pytest.mark.parametrize("n_vars,bits", FIX_SHAPES)
def test_fixedpoint_matches_reference(n_vars, bits):
    je = jenc.Encoding(n_vars, bits, -3.0, 7.0)
    te = tenc.Encoding(n_vars, bits, -3.0, 7.0)
    arr = _bits((je.population, je.n_bits), bits)
    jwords = jenc.pack_bits(jnp.asarray(arr))
    twords = tenc.pack_bits(torch.as_tensor(arr))
    assert np.array_equal(twords.numpy(), np.asarray(jwords, np.int64))

    got = tfix.decode_packed(twords, te).numpy()
    assert got.shape == (je.population, n_vars) and got.dtype == np.float32
    oracle = np.asarray(jfix_ref.fixedpoint_decode_ref(jwords, je))
    assert np.array_equal(got.view(np.int32), oracle.view(np.int32))
    assert np.array_equal(
        tfix_ref.fixedpoint_decode_ref(twords, te).numpy().view(np.int32),
        oracle.view(np.int32))
    # the JAX kernel's decode contracts lo + level * span into an FMA and
    # differs from its own oracle by 1 ulp (ROADMAP queue 3); the port's
    # decode rounds twice, as the oracle does
    kernel = np.asarray(jfix.decode_packed(jwords, je))
    ulp = np.spacing(np.float32(max(abs(te.lo), abs(te.hi))))
    assert np.max(np.abs(got - kernel)) <= ulp


@pytest.mark.parametrize("n_vars,bits", [(1, 1), (3, 31), (7, 5), (2, 32)])
def test_fixedpoint_straddling_fields_bitwise(n_vars, bits):
    """Fields that straddle words at every offset, 1..32 bits, on words
    with extra trailing words and on signed 32-bit views of the words."""
    te = tenc.Encoding(n_vars, bits, -1.5, 2.5)
    arr = torch.as_tensor(_bits((40, te.n_bits), n_vars * bits))
    words = tenc.pack_bits(arr, (te.n_bits + 31) // 32 + 2)
    want = tenc.decode(arr, te)
    for w in (words, words.to(torch.int32)):
        got = tfix.decode_packed(w, te)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("n_vars,bits,pop", [
    (9, 16, 100_000), (9, 7, 100_000), (680, 4, 20_000), (60_000, 7, 9)])
def test_fixedpoint_large_population_matches_reference(n_vars, bits, pop):
    """Whole random words (bits past n_bits set) at populations past one
    wave of the card's blocks, and rows longer than the kernel stages,
    against the JAX oracle on the same uint32 words."""
    te = tenc.Encoding(n_vars, bits, -3.0, 7.0)
    je = jenc.Encoding(n_vars, bits, -3.0, 7.0)
    words = np.random.default_rng(n_vars * bits).integers(
        0, 2**32, (pop, (te.n_bits + 31) // 32))
    got = tfix.decode_packed(torch.as_tensor(words), te).numpy()
    oracle = np.asarray(jfix_ref.fixedpoint_decode_ref(
        jnp.asarray(words.astype(np.uint32)), je))
    assert got.shape == (pop, n_vars)
    assert np.array_equal(got.view(np.int32), oracle.view(np.int32))


def test_fixedpoint_rejects_what_the_kernel_does_not_take():
    te = tenc.Encoding(5, 8)
    with pytest.raises(ValueError, match="fewer than"):
        tfix.decode_packed(torch.zeros((3, 1), dtype=torch.int64), te)
    with pytest.raises(ValueError, match="1..32"):
        tfix.decode_packed(torch.zeros((3, 2), dtype=torch.int64),
                           tenc.Encoding(1, 33))
    with pytest.raises(ValueError, match="integer"):
        tfix.decode_packed(torch.zeros((3, 2)), te)


# ---------------------------------------------------------------------------
# popmin
# ---------------------------------------------------------------------------

def _same_min(t, j):
    tv, ti = float(t[0]), int(t[1])
    jv, ji = float(j[0]), int(j[1])
    assert ti == ji
    assert tv == jv or (np.isnan(tv) and np.isnan(jv))


@pytest.mark.parametrize("p", [17, 125, 1000, 4096, 10000])
def test_popmin_matches_reference(p):
    vals = np.random.default_rng(p).standard_normal(p).astype(np.float32)
    got = tmin.population_min(torch.as_tensor(vals), tile=256)
    _same_min(got, min_oracle(jnp.asarray(vals)))
    _same_min(got, jmin.population_min(jnp.asarray(vals), tile=256))
    _same_min(tmin_ref.popmin_ref(torch.as_tensor(vals)),
              min_oracle(jnp.asarray(vals)))
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32


@pytest.mark.parametrize("tile", [1, 3, 256, 1024])
@pytest.mark.parametrize("case", ["late_nan", "ties", "all_inf", "float64"])
def test_popmin_nan_and_ties_match_the_oracle(case, tile):
    """A NaN in a late tile wins at its first index (the TPU kernel's fold
    hides it, ROADMAP queue 3); ties go to the smallest index."""
    rng = np.random.default_rng(11)
    vals = rng.integers(0, 50, 1000).astype(np.float64)
    if case == "late_nan":
        vals[[700, 930]] = np.nan
        vals[650] = -5.0
    elif case == "ties":
        vals[[880, 120, 512]] = -3.0
    elif case == "all_inf":
        vals[:] = np.inf
    dtype = np.float64 if case == "float64" else np.float32
    vals = vals.astype(dtype)
    got = tmin.population_min(torch.as_tensor(vals), tile=tile)
    _same_min(got, min_oracle(jnp.asarray(vals, jnp.float32)))
    assert got[0].dtype == torch.float32


# P = 1..9 (fewer values than one 16-byte load), and P at the CUDA
# launch's switch from one block to a grid (ops.ONE_BLOCK_MAX) and +-1
@pytest.mark.parametrize("p", [*range(1, 10), tmin.ONE_BLOCK_MAX - 1,
                               tmin.ONE_BLOCK_MAX, tmin.ONE_BLOCK_MAX + 1])
def test_popmin_small_and_switch_populations(p):
    vals = np.random.default_rng(p).standard_normal(p).astype(np.float32)
    got = tmin.population_min(torch.as_tensor(vals))
    _same_min(got, min_oracle(jnp.asarray(vals)))
    _same_min(got, jmin.population_min(jnp.asarray(vals)))
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32


@pytest.mark.parametrize("at", ["head", "tail"])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_popmin_offset_views(k, at):
    """A view v[k:] starts off a 16-byte boundary, which .contiguous()
    keeps; the minimum sits in the values before the first aligned one
    or after the last whole 16 bytes."""
    base = np.random.default_rng(k).standard_normal(5439 + k).astype(
        np.float32)
    base[k if at == "head" else -1] = -10.0
    view = torch.as_tensor(base)[k:]
    assert view.storage_offset() == k and view.is_contiguous()
    got = tmin.population_min(view)
    _same_min(got, min_oracle(jnp.asarray(base[k:])))
    assert int(got[1]) == (0 if at == "head" else 5438)


@pytest.mark.parametrize("p", [5, 1000, 5439, tmin.ONE_BLOCK_MAX + 1])
@pytest.mark.parametrize("case", ["all_nan", "last_nan", "zero_first",
                                  "minus_zero_first"])
def test_popmin_nans_and_signed_zeros(case, p):
    """All NaN -> (NaN, 0); a NaN at the last index wins over a smaller
    value before it; a -0.0/0.0 tie goes to the smaller index with that
    element's own bits.  The JAX kernel is held to the same where it
    folds one tile (P <= 1024; its later tiles hide a NaN, ROADMAP
    queue 3)."""
    vals = np.abs(np.random.default_rng(p).standard_normal(p)).astype(
        np.float32) + 1.0
    if case == "all_nan":
        vals[:] = np.nan
    elif case == "last_nan":
        vals[p // 2] = -7.0
        vals[-1] = np.nan
    else:
        lo, hi = (p // 3, p // 2) if p > 2 else (1, 2)
        vals[[lo, hi]] = [0.0, -0.0] if case == "zero_first" else [-0.0, 0.0]
    got = tmin.population_min(torch.as_tensor(vals))
    want = min_oracle(jnp.asarray(vals))
    _same_min(got, want)
    assert torch.equal(got[0].view(torch.int32),
                       torch.as_tensor(vals[int(want[1])]).view(torch.int32))
    if p <= 1024:
        _same_min(got, jmin.population_min(jnp.asarray(vals)))


def _crafted_partials(case, k, seed):
    """(K,) partial values and distinct, unordered int32 indices."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(-20, 20, k).astype(np.float32)
    rows = rng.permutation(4 * k)[:k].astype(np.int32)
    if case == "nans":
        vals[[1, k // 2, k - 1]] = np.nan
    elif case == "ties":
        vals[[0, k // 3, k - 2]] = -50.0
    elif case == "signed_zero":
        vals = np.abs(vals) + 1.0
        vals[[2, k - 3]] = [-0.0, 0.0]
        vals[k // 2] = 0.0
    elif case == "all_inf":
        vals[:] = np.inf
    return vals, rows


@pytest.mark.parametrize("case", ["random", "nans", "ties", "signed_zero",
                                  "all_inf"])
def test_popmin_fold_alone_matches_the_oracle(case):
    """The fold on its own, on partials whose indices are not in order:
    the NaN-first winner by index, its own value (a -0.0 stays -0.0),
    and no count."""
    vals, rows = _crafted_partials(case, 37, 5)
    before = tmin.fold_launches
    v, i = tmin.fold_partials(torch.as_tensor(vals), torch.as_tensor(rows))
    assert tmin.fold_launches == before
    order = np.argsort(rows)
    j = int(tmin_ref.popmin_ref(torch.as_tensor(vals[order]))[1])
    assert int(i) == rows[order][j] and i.dtype == torch.int32
    want = torch.as_tensor(vals[order][j])
    assert torch.equal(v.view(torch.int32), want.view(torch.int32))


def test_popmin_rejects_empty_and_bad_tiles():
    with pytest.raises(ValueError, match="vals"):
        tmin.population_min(torch.zeros(0))
    with pytest.raises(ValueError, match="vals"):
        tmin.population_min(torch.zeros((2, 2)))
    with pytest.raises(ValueError, match="tile"):
        tmin.population_min(torch.zeros(4), tile=0)


# ---------------------------------------------------------------------------
# the packed step as a whole
# ---------------------------------------------------------------------------

def _jax_packed_step(jo, enc, parent):
    words = jgray.generate_population_packed(jnp.asarray(parent))
    vals = jax.vmap(jo.fn)(jfix.decode_packed(words, enc))
    v, i = jmin.population_min(vals)
    return float(v), int(i), np.asarray(vals)


def _port_packed_step(to, enc, parent):
    words = tgray.generate_population_packed(torch.as_tensor(parent))
    vals = to.fn(tfix.decode_packed(words, enc))
    v, i = tmin.population_min(vals)
    return float(v), int(i), vals.numpy()


@pytest.mark.parametrize("name,kw,bits", [("rastrigin", dict(n=9), 8),
                                          ("xor", {}, None)])
def test_packed_step_matches_reference(name, kw, bits):
    """generate -> decode -> objective -> (min, argmin) in both packages,
    and against the port's fused popstep on the same parent.  The ids may
    differ only at a near-tie (both winners within the bar)."""
    jo, to = jobj.get(name, **kw), tobj.get(name, **kw)
    je = jo.encoding if bits is None else jo.encoding.with_bits(bits)
    te = tenc.Encoding(je.n_vars, je.bits, je.lo, je.hi)
    for seed in range(3):
        parent = _bits(te.n_bits, 100 + seed)
        tv, ti, tvals = _port_packed_step(to, te, parent)
        jv, ji, jvals = _jax_packed_step(jo, je, parent)
        sv, si = tstep.population_step(to, torch.as_tensor(parent), te)
        assert np.isclose(tv, jv, **TOL)
        assert np.isclose(tv, float(sv), **TOL)
        for other in (ji, int(si)):
            if other != ti:
                assert np.isclose(tvals[ti], tvals[other], **TOL)
                assert np.isclose(jvals[ti], jvals[other], **TOL)
