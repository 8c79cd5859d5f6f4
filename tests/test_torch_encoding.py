"""PyTorch port vs the JAX package: encoding and population, bit for bit.

Inputs are made with numpy from a seed and handed to both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encoding as jenc
from repro.core import population as jpop
from repro_torch.core import encoding as tenc
from repro_torch.core import population as tpop

BOXES = [(-5.12, 5.12), (0.0, 10.0)]


def _encs(n_vars, bits, lo, hi):
    return (jenc.Encoding(n_vars, bits, lo, hi),
            tenc.Encoding(n_vars, bits, lo, hi))


@pytest.mark.parametrize("n_bits", [5, 16, 63, 99])
def test_segment_tables_and_patterns_bitwise(n_bits):
    assert np.array_equal(tpop.segment_table(n_bits),
                          jpop.segment_table(n_bits))
    assert np.array_equal(tpop.segment_patterns(n_bits),
                          jpop.segment_patterns(n_bits))
    ids = np.arange(2 * n_bits - 1)
    assert np.array_equal(
        tpop.segment_mask(torch.as_tensor(ids), n_bits).numpy(),
        np.asarray(jpop.segment_mask(jnp.asarray(ids), n_bits)))
    # the engine's per-device copies, built with tensor operations
    assert np.array_equal(tpop.table_on("patterns", n_bits, "cpu").numpy(),
                          jpop.segment_patterns(n_bits))
    assert np.array_equal(tpop.table_on("table", n_bits, "cpu").numpy(),
                          jpop.segment_table(n_bits))


@pytest.mark.parametrize("n_bits", [5, 16, 63, 99])
def test_generated_children_bitwise(n_bits):
    rng = np.random.default_rng(n_bits)
    for _ in range(1):
        parent = rng.integers(0, 2, n_bits).astype(np.int8)
        ref = np.asarray(jpop.generate_population(jnp.asarray(parent)))
        got = tpop.generate_population(torch.as_tensor(parent)).numpy()
        assert np.array_equal(got, ref)
        assert np.array_equal(got, parent[None, :] ^ tpop.segment_patterns(
            n_bits))
        ids = rng.integers(0, 2 * n_bits - 1, 17)
        assert np.array_equal(
            tpop.generate_children(torch.as_tensor(parent),
                                   torch.as_tensor(ids)).numpy(),
            np.asarray(jpop.generate_children(jnp.asarray(parent),
                                              jnp.asarray(ids))))


@pytest.mark.parametrize("bits", range(4, 17))
def test_encode_decode_bitwise_every_resolution(bits):
    """encode rounds (x - lo) / span * max_level half to even in float32;
    decode rounds lo + level * scale without contraction — both must match
    the reference on every point, including points outside the box."""
    rng = np.random.default_rng(bits)
    for lo, hi in BOXES:
        je, te = _encs(9, bits, lo, hi)
        x = rng.uniform(lo - 1.0, hi + 1.0, (2048, 9)).astype(np.float32)
        # lattice midpoints exercise the half-to-even rounding
        mids = (lo + (np.arange(9) + 0.5) * te.scale).astype(np.float32)
        x = np.concatenate([x, mids[None, :]])
        bj = np.array(jenc.encode(jnp.asarray(x), je))
        bt = tenc.encode(torch.as_tensor(x), te).numpy()
        assert np.array_equal(bt, bj)
        dj = np.asarray(jenc.decode(jnp.asarray(bj), je))
        dt = tenc.decode(torch.as_tensor(bj), te).numpy()
        assert np.array_equal(dt.view(np.int32), dj.view(np.int32))
        assert np.array_equal(tenc.decode_np(bj, te).view(np.int32),
                              jenc.decode_np(bj, je).view(np.int32))


@pytest.mark.parametrize("bits_from,bits_to", [(4, 6), (8, 10), (14, 16)])
def test_reencode_bitwise(bits_from, bits_to):
    rng = np.random.default_rng(bits_to)
    b = rng.integers(0, 2, (64, 9 * bits_from)).astype(np.int8)
    jf, tf = _encs(9, bits_from, -5.12, 5.12)
    jt, tt = _encs(9, bits_to, -5.12, 5.12)
    assert np.array_equal(
        tenc.reencode(torch.as_tensor(b), tf, tt).numpy(),
        np.asarray(jenc.reencode(jnp.asarray(b), jf, jt)))


@pytest.mark.parametrize("n_bits", [5, 16, 63, 99])
def test_gray_transforms_and_packing_bitwise(n_bits):
    rng = np.random.default_rng(100 + n_bits)
    b = rng.integers(0, 2, (8, n_bits)).astype(np.int8)
    g_ref = np.asarray(jenc.binary_to_gray(jnp.asarray(b)))
    g = tenc.binary_to_gray(torch.as_tensor(b)).numpy()
    assert np.array_equal(g, g_ref)
    assert np.array_equal(tenc.gray_to_binary(torch.as_tensor(g)).numpy(),
                          np.asarray(jenc.gray_to_binary(jnp.asarray(g))))
    assert np.array_equal(tenc.gray_to_binary(torch.as_tensor(g)).numpy(), b)
    words = tenc.pack_bits(torch.as_tensor(b))
    assert np.array_equal(words.numpy(),
                          np.asarray(jenc.pack_bits(jnp.asarray(b)))
                          .astype(np.int64))
    assert np.array_equal(tenc.unpack_bits(words, n_bits).numpy(), b)


def test_encoding_spec_mirrors_reference():
    je, te = _encs(9, 8, -5.12, 5.12)
    assert (te.n_bits, te.population, te.levels) == (
        je.n_bits, je.population, je.levels)
    assert te.with_bits(16) == tenc.Encoding(9, 16, -5.12, 5.12)
    assert tpop.population_size(72) == jpop.population_size(72) == 143
