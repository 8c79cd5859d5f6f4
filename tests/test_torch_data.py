"""The port's synthetic token pipeline (``repro_torch.data``) against the
JAX package: ``lm_synthetic_batch`` and ``SyntheticTokenPipeline.
batch_at`` bit for bit (tokens are an integer stage: a one-ulp difference
in a float32 power flips a token), the reference's own pipeline cases on
the port, and ``pow32`` against XLA's float32 power."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticTokenPipeline as JPipeline
from repro.data import lm_synthetic_batch as jax_batch
from repro_torch.core import prng
from repro_torch.data import (DataConfig, SyntheticTokenPipeline,
                              lm_synthetic_batch)
from repro_torch.data.pipeline import pow32

VOCAB = 151_936      # qwen2-1.5b's vocabulary


@pytest.mark.parametrize("shape", [(2, 16, 256), (4, 64, 512),
                                   (2, 33, VOCAB), (8, 256, VOCAB)])
def test_lm_synthetic_batch_bitwise(shape):
    b, s, v = shape
    for seed in (0, 1, 5, 2**31 - 1):
        key = jax.random.PRNGKey(seed)
        want_t, want_l = jax_batch(key, b, s, v)
        tokens, labels = lm_synthetic_batch(np.asarray(key), b, s, v)
        assert tokens.dtype == labels.dtype == np.int32
        assert np.array_equal(tokens, np.asarray(want_t))
        assert np.array_equal(labels, np.asarray(want_l))


def test_lm_synthetic_batch_options_bitwise():
    key = jax.random.PRNGKey(3)
    for frac, perm_seed in ((1.0, 7), (0.0, 7), (0.5, 11)):
        want = jax_batch(key, 3, 40, 300, pattern_frac=frac,
                         perm_seed=perm_seed)
        got = lm_synthetic_batch(np.asarray(key), 3, 40, 300,
                                 pattern_frac=frac, perm_seed=perm_seed)
        assert np.array_equal(got[0], np.asarray(want[0]))


@pytest.mark.parametrize("vocab", [256, VOCAB])
def test_batch_at_bitwise(vocab):
    """``batch_at(step)`` is keyed by ``fold_in(PRNGKey(seed), step)`` as
    the reference's; the port's batches are int64 tensors."""
    cfg = dict(vocab_size=vocab, seq_len=24, global_batch=3, seed=4)
    ref, port = JPipeline(JDataConfig(**cfg)), SyntheticTokenPipeline(
        DataConfig(**cfg))
    try:
        for step in (0, 1, 17, 1000):
            want, got = ref.batch_at(step), port.batch_at(step)
            assert got["tokens"].dtype == torch.int64
            for name in ("tokens", "labels"):
                assert np.array_equal(got[name].numpy(),
                                      np.asarray(want[name]))
    finally:
        ref.close()
        port.close()


def test_pow32_is_xlas_power():
    """Over 2^20 draws of the noise's uniform, ``pow32`` equals
    ``u ** -0.7`` as XLA computes it on the CPU, bit for bit."""
    key = jax.random.PRNGKey(0)
    u = jax.random.uniform(key, (2**20,), minval=1e-6, maxval=1.0)
    want = np.asarray(u ** -0.7)
    got = pow32(np.asarray(u), -0.7)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_batch_pure_function_of_step():
    cfg = DataConfig(vocab_size=128, seq_len=32, global_batch=4, seed=3)
    p1 = SyntheticTokenPipeline(cfg)
    p2 = SyntheticTokenPipeline(cfg, start_step=0)
    try:
        assert torch.equal(p1.batch_at(17)["tokens"],
                           p2.batch_at(17)["tokens"])
    finally:
        p1.close()
        p2.close()


def test_labels_are_next_token():
    toks, labels = lm_synthetic_batch(prng.PRNGKey(0), 2, 16, 64)
    np.testing.assert_array_equal(labels[:, :-1], toks[:, 1:])
    assert (labels[:, -1] == -1).all()


def test_learnable_structure():
    """Planted bigram chain: with frac=1, token[t+1] == perm[token[t]]."""
    toks, _ = lm_synthetic_batch(prng.PRNGKey(1), 4, 64, 512,
                                 pattern_frac=1.0)
    perm = np.asarray(jax.random.permutation(jax.random.PRNGKey(7), 512))
    assert (toks[:, 1:] == perm[toks[:, :-1]]).all()


def test_prefetch_iterator_order():
    cfg = DataConfig(vocab_size=64, seq_len=8, global_batch=2, seed=0)
    p = SyntheticTokenPipeline(cfg)
    try:
        assert [next(p)[0] for _ in range(3)] == [0, 1, 2]
    finally:
        p.close()


def test_extras_are_frontend_inputs():
    """A frontend stub's input: ``0.02 * normal`` keyed by the name, in
    the requested dtype, on the pipeline's device."""
    cfg = DataConfig(vocab_size=64, seq_len=8, global_batch=2, seed=0)
    p = SyntheticTokenPipeline(cfg, extras={"frames": ((5, 3),
                                                       torch.float32)})
    try:
        b = p.batch_at(2)
        assert b["frames"].shape == (2, 5, 3)
        assert b["frames"].dtype == torch.float32
        assert 0 < float(b["frames"].abs().max()) < 0.2
        assert torch.equal(b["frames"], p.batch_at(2)["frames"])
    finally:
        p.close()


def test_batch_on_a_device():
    cfg = DataConfig(vocab_size=64, seq_len=8, global_batch=2, seed=0)
    p = SyntheticTokenPipeline(cfg, device="meta")
    try:
        b = p.batch_at(0)
        assert b["tokens"].device.type == "meta"
    finally:
        p.close()


def test_noise_is_zipf_and_in_vocab():
    """Without the chain every token is Zipf noise: int32(u^-0.7 - 1)
    clipped to the vocabulary, as the reference draws it."""
    key = jax.random.PRNGKey(2)
    toks, _ = lm_synthetic_batch(np.asarray(key), 4, 128, 100,
                                 pattern_frac=0.0)
    kz = jax.random.split(key, 3)[0]
    u = jax.random.uniform(kz, (4, 128), minval=1e-6, maxval=1.0)
    want = jnp.minimum((u ** -0.7 - 1).astype(jnp.int32), 99)
    assert np.array_equal(toks, np.asarray(want))
    assert toks.min() >= 0 and toks.max() <= 99
