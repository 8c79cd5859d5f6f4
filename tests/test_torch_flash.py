"""The port's flash attention (``repro_torch.kernels.flash_attention``)
held against the JAX package's: the wrapper's plain version (what it runs
on CPU tensors) vs ``repro.kernels.flash_attention.ops.flash_sdpa`` in
interpret mode and vs both oracles, on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention \
    as jax_flash_attention
from repro.kernels.flash_attention.ops import flash_sdpa as jax_flash_sdpa
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_ref
from repro_torch.kernels.flash_attention import ops, ref

# the cases of tests/test_kernels.py::test_flash_attention_matches_oracle,
# then the bfloat16 twins of its float32 cases (the tensor-core kernel's
# arithmetic: 128 x 128 tiles, P rounded to bfloat16)
KERNEL_CASES = [
    (2, 128, 4, 4, 32, True, 0, "float32"),
    (1, 256, 8, 2, 64, True, 0, "float32"),
    (2, 192, 4, 1, 32, True, 64, "float32"),     # MQA + sliding window
    (1, 128, 4, 4, 32, False, 0, "float32"),     # bidirectional
    (1, 256, 4, 2, 64, True, 0, "bfloat16"),
    (2, 128, 4, 4, 32, True, 0, "bfloat16"),
    (1, 256, 8, 2, 64, True, 0, "bfloat16"),
    (2, 192, 4, 1, 32, True, 64, "bfloat16"),
    (1, 128, 4, 4, 32, False, 0, "bfloat16"),
]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}        # tests/test_kernels.py:65


def _inputs(seed, b, s, hq, hkv, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, hq, hd), np.float32),
            rng.standard_normal((b, s, hkv, hd), np.float32),
            rng.standard_normal((b, s, hkv, hd), np.float32))


def _both(arrays, dt):
    """The same arrays as JAX and torch tensors of type ``dt`` (float32
    -> bfloat16 rounds to nearest even on both sides)."""
    jx = [jnp.asarray(a).astype(jnp.dtype(dt)) for a in arrays]
    tx = [torch.as_tensor(a).to(getattr(torch, dt)) for a in arrays]
    return jx, tx


def _oracle(q, k, v, causal, window):
    """Port's ref.py in the model layout (B, S, H, hd)."""
    return ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal=causal,
                                   window=window).transpose(1, 2)


def _jax_oracle(q, k, v, causal, window):
    return jnp.moveaxis(jax_ref(jnp.moveaxis(q, 1, 2), jnp.moveaxis(k, 1, 2),
                                jnp.moveaxis(v, 1, 2), causal=causal,
                                window=window), 2, 1)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      else x.astype(jnp.float32))


@pytest.mark.parametrize("b,s,hq,hkv,hd,causal,window,dt", KERNEL_CASES)
def test_plain_matches_jax_flash_sdpa(b, s, hq, hkv, hd, causal, window, dt):
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(s + hq, b, s, hq, hkv, hd), dt)
    want = jax_flash_sdpa(jq, jk, jv, causal=causal, window=window,
                          block_q=64, block_k=64)
    before = ops.launches
    got = ops.flash_sdpa(tq, tk, tv, causal=causal, window=window)
    assert ops.launches == before          # CPU tensors: the plain version
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dt])
    np.testing.assert_allclose(_np(got), _np(_oracle(tq, tk, tv, causal,
                                                     window)), atol=TOL[dt])


@pytest.mark.parametrize("b,s,hq,hkv", [(2, 256, 4, 4), (1, 200, 4, 2),
                                       (1, 160, 6, 1)])
def test_head_dim_96_matches_jax_flash_sdpa(b, s, hq, hkv):
    """hd 96, phi-3-vision's (3,072 / 32), causal, in float32: the plain
    version against the reference wrapper in interpret mode and against
    the reference's oracle within 1e-5 (MHA, GQA off the block length,
    MQA)."""
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(s + hq, b, s, hq, hkv, 96),
                                       "float32")
    want = jax_flash_sdpa(jq, jk, jv, causal=True, block_q=64, block_k=64)
    got = ops.flash_sdpa(tq, tk, tv, causal=True)
    assert got.shape == tq.shape
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)
    np.testing.assert_allclose(_np(got), _np(_jax_oracle(jq, jk, jv, True,
                                                         0)), atol=1e-5)


def test_non_causal_whisper_encoder_length_matches_the_oracle():
    """Whisper's encoder: bidirectional attention over S = 1,500 frames
    at hd 64 (not a multiple of either tile): the plain version against
    the reference's ``flash_attention_ref`` (the reference wrapper leaves
    its 36 padded keys unmasked here, ROADMAP queue 3)."""
    arrays = _inputs(1500, 1, 1500, 2, 2, 64)
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, "float32")
    want = _np(_jax_oracle(jq, jk, jv, False, 0))
    got = ops.flash_sdpa(tq, tk, tv, causal=False)
    np.testing.assert_allclose(_np(got), want, atol=1e-5)


@pytest.mark.parametrize("s", [100, 160])
def test_non_causal_off_block_lengths_match_the_oracles(s):
    """S not a multiple of the blocks, causal=False: the port matches both
    oracles; the JAX wrapper pads K/V with zeros that it never masks and
    is wrong there (a reference fault, ROADMAP queue 3)."""
    arrays = _inputs(s, 1, s, 4, 2, 32)
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, "float32")
    want = _np(_jax_oracle(jq, jk, jv, False, 0))
    got = ops.flash_sdpa(tq, tk, tv, causal=False)
    np.testing.assert_allclose(_np(got), want, atol=1e-4)
    np.testing.assert_allclose(_np(_oracle(tq, tk, tv, False, 0)), want,
                               atol=1e-5)
    jax_got = _np(jax_flash_sdpa(jq, jk, jv, causal=False, block_q=64,
                                 block_k=64))
    assert np.abs(jax_got - want).max() > 1e-2


@pytest.mark.parametrize("s,causal,window,hq,hkv", [
    (100, True, 0, 4, 2), (160, True, 40, 6, 1), (200, False, 0, 4, 4),
    (64, True, 1, 2, 1), (130, True, 200, 4, 2)])
def test_plain_matches_port_oracle(s, causal, window, hq, hkv):
    """Off-block lengths, windows narrower and wider than a tile, a window
    of one key, MQA: the plain version (skipped tiles and all) vs ref.py."""
    tq, tk, tv = (torch.as_tensor(a) for a in _inputs(7, 2, s, hq, hkv, 16))
    got = ops.flash_sdpa(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(_np(got), _np(_oracle(tq, tk, tv, causal,
                                                     window)), atol=1e-5)


def test_key_range_skips_tiles_outside_the_mask():
    """float32: 128-row q tiles over 64-key tiles; bfloat16: 128 x 128."""
    assert list(ops.key_range(0, 1024, True, 0)) == [0, 64]
    assert list(ops.key_range(896, 1024, True, 0)) == list(range(0, 1024, 64))
    assert list(ops.key_range(960, 1024, True, 100)) == [832, 896, 960]
    assert list(ops.key_range(0, 100, False, 0)) == [0, 64]
    bf16 = torch.bfloat16
    assert list(ops.key_range(0, 1024, True, 0, bf16)) == [0]
    assert list(ops.key_range(896, 1024, True, 0, bf16)) == list(
        range(0, 1024, 128))
    assert list(ops.key_range(896, 1024, True, 100, bf16)) == [768, 896]
    assert list(ops.key_range(0, 100, False, 0, bf16)) == [0]


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "gqa", "shape",
                                 "window"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q, k, v = (torch.zeros(1, 8, 4, 16), torch.zeros(1, 8, 2, 16),
               torch.zeros(1, 8, 2, 16))
    kw = {}
    if bad == "head_dim":
        q, k, v = q[..., :12], k[..., :12], v[..., :12]
    elif bad == "dtype":
        q = q.double()
    elif bad == "gqa":
        k, v = torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 3, 16)
    elif bad == "shape":
        k = torch.zeros(1, 9, 2, 16)
    else:
        kw["window"] = -1
    with pytest.raises(ValueError):
        ops.flash_sdpa(q, k, v, **kw)


def test_bf16_output_keeps_its_type_and_rounds_once():
    """bfloat16 inputs: P is rounded to bfloat16 before P·V, as the TPU
    kernel's ``jnp.dot(p.astype(v.dtype), v)`` (kernel.py:59-60), while l
    sums the float32 P; the float32 result is rounded once at the end.
    S = 96 is one 128-key tile, so the online softmax is one step."""
    tq, tk, tv = (torch.as_tensor(a).bfloat16()
                  for a in _inputs(3, 1, 96, 4, 2, 32))
    got = ops.flash_sdpa(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    q, k, v = (t.float().transpose(1, 2) for t in (tq, tk, tv))
    k, v = k.repeat_interleave(2, dim=1), v.repeat_interleave(2, dim=1)
    sc = (q @ k.transpose(-1, -2)) * 32 ** -0.5
    sc = sc.masked_fill(~torch.ones(96, 96, dtype=torch.bool).tril(),
                        float("-inf"))
    p = torch.exp(sc - sc.amax(-1, keepdim=True))
    want = (p.bfloat16().float() @ v) / p.sum(-1, keepdim=True)
    assert torch.equal(got, want.transpose(1, 2).bfloat16())
    unrounded = (p @ v) / p.sum(-1, keepdim=True)
    assert not torch.equal(got, unrounded.transpose(1, 2).bfloat16())


def test_bf16_plain_matches_the_jax_kernel():
    """The bfloat16 plain version against the TPU kernel itself
    (``flash_attention``, 128-tiles, interpret mode) at (1, 256, 4, 2, 64)
    causal: the same tiles and the same rounding of P, so the two differ
    only by the order of float32 sums, well within 0.0039 (one bfloat16
    step at the outputs' size, the distance of 64-tiles)."""
    q, k, v = _inputs(0, 1, 256, 4, 2, 64)
    jq, jk, jv = (jnp.asarray(np.moveaxis(a, 1, 2)).astype(jnp.bfloat16)
                  for a in (q, k, v))
    want = _np(jnp.moveaxis(jax_flash_attention(jq, jk, jv, causal=True),
                            2, 1))
    tq, tk, tv = (torch.as_tensor(a).bfloat16() for a in (q, k, v))
    got = _np(ops.flash_sdpa(tq, tk, tv, causal=True))
    assert np.abs(got - want).max() <= 0.0039
