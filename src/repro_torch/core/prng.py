"""A numpy twin of the ``jax.random`` calls that ``seed=`` flows through.

Keys are the legacy ``(2,)`` uint32 arrays of ``jax.random.PRNGKey``
(threefry2x32), and every draw follows ``jax_threefry_partitionable=True``
(the default from jax 0.5 on): the counter of element ``i`` of a draw of
shape ``s`` is the 64-bit row-major index ``i`` split into (high, low)
32-bit words, hashed with the key.

* :func:`PRNGKey` — ``seed`` taken as an int32 (without 64-bit mode
  ``jax.random.PRNGKey`` truncates a larger seed the same way), so the key
  is ``(0, seed mod 2^32)``;
* :func:`split` — ``n`` keys, the hash of the counters ``0..n-1``;
* :func:`uniform` — the high 23 bits of ``b1 ^ b2`` as the mantissa of a
  float in [1, 2), minus 1, then ``max(minval, u * (maxval - minval) +
  minval)`` with the multiply and the add rounded once, a fused
  multiply-add, as jax 0.9.0's jitted sampler computes it on the CPU
  (``tests/test_torch_prng.py`` holds it bitwise);
* :func:`bernoulli` — ``uniform(key, shape) < p``;
* :func:`normal` — ``sqrt(2) * erf_inv(u)`` for ``u`` uniform on
  (-1, 1), with XLA's single-precision ``erf_inv`` polynomial (Giles).
  ``log1p`` is taken in float64 and rounded once to float32, and the
  polynomial's roundings are float32's, not XLA's fused ones, so a sample
  may differ from jax's by a few ulp (the test allows 4);
* :func:`fold_in` — the hash of the counter ``(0, data)``;
* :func:`randint` — two 32-bit draws from the two halves of a split key,
  folded into ``[minval, maxval)`` by jax's span/multiplier arithmetic
  (uint32, wrapping);
* :func:`permutation` — jax's ``_shuffle``: ``ceil(3 ln n / ln(2^32 - 1))``
  rounds, each a stable sort of the values keyed on 32 random bits from a
  fresh split.

These run on the host in numpy; callers move the result to a device.
:func:`uniform_torch` and :func:`normal_torch` are the same draws
computed with PyTorch on any device, uint32 arithmetic
emulated in int64 and every float32 step taken in the numpy twin's order,
in chunks of ``TORCH_CHUNK`` elements: a full-width model's 1.5 G
normals take seconds on the card where numpy would take minutes.
``tests/test_torch_prng.py`` holds them equal to the numpy twin, bit for
bit.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["PRNGKey", "as_key", "bernoulli", "fold_in",
           "normal", "normal_torch", "permutation", "randint", "split",
           "threefry2x32", "uniform", "uniform_torch"]

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _U32(r)) | (x >> _U32(32 - r))


def threefry2x32(key, x1: np.ndarray, x2: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of the counter words ``(x1,
    x2)`` under ``key``, elementwise; uint32 arithmetic wraps."""
    k1, k2 = (np.asarray(k, _U32) for k in as_key(key))
    ks = (k1, k2, k1 ^ k2 ^ _U32(_PARITY))
    x1 = np.asarray(x1, _U32) + ks[0]
    x2 = np.asarray(x2, _U32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = x1 + x2
            x2 = x1 ^ _rotl(x2, r)
        x1 = x1 + ks[(i + 1) % 3]
        x2 = x2 + ks[(i + 2) % 3] + _U32(i + 1)
    return x1, x2


def as_key(key) -> np.ndarray:
    """A key as a ``(2,)`` uint32 numpy array (from a numpy array, a list,
    a torch tensor or anything ``np.asarray`` reads)."""
    if hasattr(key, "numpy"):            # a torch tensor
        key = key.cpu().numpy()
    k = np.asarray(key)
    if k.shape != (2,) or not np.issubdtype(k.dtype, np.integer):
        raise TypeError(f"a PRNG key is a (2,) integer array, got "
                        f"{k.dtype}{list(k.shape)}")
    return k.astype(np.int64).astype(_U32)


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` without 64-bit mode: the seed wraps
    to an int32, the key is ``(0, that int32's 32 bits)``."""
    return np.array([0, int(seed) % 2**32], _U32)


def _counters(n: int) -> tuple[np.ndarray, np.ndarray]:
    idx = np.arange(n, dtype=np.uint64)
    return (idx >> np.uint64(32)).astype(_U32), idx.astype(_U32)


def split(key, n: int = 2) -> np.ndarray:
    """``jax.random.split(key, n)``: an ``(n, 2)`` uint32 array of keys."""
    b1, b2 = threefry2x32(key, *_counters(int(n)))
    return np.stack([b1, b2], axis=1)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: the hash of the counter
    ``(0, data mod 2^32)``, a ``(2,)`` uint32 key."""
    b1, b2 = threefry2x32(key, np.zeros(1, _U32),
                          np.array([int(data) % 2**32], _U32))
    return np.array([b1[0], b2[0]], _U32)


def _shape(shape) -> tuple:
    return (int(shape),) if np.ndim(shape) == 0 and shape != () \
        else tuple(int(s) for s in shape)


def _bits(key, shape: tuple) -> np.ndarray:
    b1, b2 = threefry2x32(key, *_counters(math.prod(shape)))
    return (b1 ^ b2).reshape(shape)


def _unit(key, shape: tuple) -> np.ndarray:
    """Floats in [0, 1): 23 random mantissa bits under exponent 0, less 1."""
    one = np.array(1.0, np.float32).view(_U32)
    return ((_bits(key, shape) >> _U32(9)) | one).view(np.float32) \
        - np.float32(1.0)


def uniform(key, shape=(), minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, minval=..., maxval=...)`` in
    float32."""
    shape = _shape(shape)
    lo, hi = np.float32(minval), np.float32(maxval)
    with np.errstate(over="ignore"):
        scaled = _fma32(_unit(key, shape), hi - lo, lo)
    return np.maximum(lo, scaled)


def _fma32(a: np.ndarray, b, c) -> np.ndarray:
    """``a * b + c`` of float32 operands rounded once to float32.  The
    product is exact in float64; the float64 sum is rounded a second time
    only where it is inexact and lands on a float32 midpoint, and there
    the sum's rounding error decides the direction."""
    p = a.astype(np.float64) * np.float64(b)
    s = p + np.float64(c)
    err = (p - (s - (s - p))) + (np.float64(c) - (s - p))   # two-sum
    r = s.astype(np.float32)
    down = np.nextafter(r, np.float32(-np.inf))
    up = np.nextafter(r, np.float32(np.inf))
    r = np.where((err < 0) & (s == (r.astype(np.float64) + down) / 2),
                 down, r)
    return np.where((err > 0) & (s == (r.astype(np.float64) + up) / 2),
                    up, r).astype(np.float32)


def randint(key, shape, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval)`` for int32:
    ``(hi % span) * m + lo % span``, mod ``span``, in wrapping uint32,
    with ``hi``/``lo`` the 32-bit draws of the split key's halves and
    ``m = (2^16 % span)^2 % span``."""
    shape = _shape(shape)
    k1, k2 = split(key)
    hi_bits, lo_bits = _bits(k1, shape), _bits(k2, shape)
    lo_v, hi_v = int(minval), int(maxval)
    span = _U32(1 if hi_v <= lo_v else (hi_v - lo_v) % 2**32)
    mult = _U32(2**16) % span
    with np.errstate(over="ignore"):
        mult = (mult * mult) % span
        off = (hi_bits % span) * mult + lo_bits % span
    off = off % span
    return (np.int64(lo_v) + off.astype(np.int64)).astype(np.int32)


def permutation(key, n: int) -> np.ndarray:
    """``jax.random.permutation(key, n)`` for an integer ``n``: int32."""
    n = int(n)
    x = np.arange(n, dtype=np.int32)
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        key, sub = split(key)
        x = x[np.argsort(_bits(sub, (n,)), kind="stable")]
    return x


def bernoulli(key, p: float = 0.5, shape=()) -> np.ndarray:
    """``jax.random.bernoulli(key, p, shape)`` (the default ``mode="low"``):
    a bool array."""
    return uniform(key, shape) < np.float32(p)


# XLA's single-precision erf_inv: two degree-8 polynomials in w, split at
# w = -log1p(-x^2) = 5 (M. Giles, "Approximating the erfinv function")
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def _erf_inv(x: np.ndarray) -> np.ndarray:
    f32 = np.float32
    w = -np.log1p(-(x * x).astype(np.float64)).astype(f32)
    small = w < f32(5.0)
    w = np.where(small, w - f32(2.5),
                 np.sqrt(w) - f32(3.0)).astype(f32)
    p = np.where(small, f32(_ERFINV_SMALL[0]), f32(_ERFINV_LARGE[0]))
    for a, b in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        p = (np.where(small, f32(a), f32(b)) + p * w).astype(f32)
    with np.errstate(over="ignore"):
        edge = x * np.finfo(f32).max
    return np.where(np.abs(x) == f32(1.0), edge, p * x).astype(f32)


def normal(key, shape=()) -> np.ndarray:
    """``jax.random.normal(key, shape)`` in float32, within a few ulp."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, lo, 1.0)
    return (np.float32(math.sqrt(2)) * _erf_inv(u)).astype(np.float32)


# ---------------------------------------------------------------------------
# the same draws in PyTorch, on any device
# ---------------------------------------------------------------------------

TORCH_CHUNK = 1 << 24     # elements a chunk: int64 temporaries of 128 MiB
_M32 = 0xFFFFFFFF


def _threefry_torch(ks: tuple, x1: torch.Tensor, x2: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`threefry2x32` on int64 tensors holding uint32 values."""
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = x1 ^ (((x2 << r) & _M32) | (x2 >> (32 - r)))
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _M32
    return x1, x2


def _key_words(key) -> tuple:
    k1, k2 = (int(k) for k in as_key(key))
    return k1, k2, k1 ^ k2 ^ _PARITY


def _chunk_bits(ks: tuple, start: int, n: int, device) -> torch.Tensor:
    """The 32-bit draws of elements ``start .. start + n - 1`` (int64)."""
    idx = torch.arange(start, start + n, dtype=torch.int64, device=device)
    b1, b2 = _threefry_torch(ks, idx >> 32, idx & _M32)
    return b1 ^ b2


def _unit_torch(bits: torch.Tensor) -> torch.Tensor:
    one = int(np.array(1.0, np.float32).view(_U32))
    return ((bits >> 9) | one).to(torch.int32).view(torch.float32) - 1.0


def _fma32_torch(a: torch.Tensor, b: float, c: float) -> torch.Tensor:
    """:func:`_fma32` in PyTorch (float64 on the device)."""
    p = a.double() * float(b)
    s = p + float(c)
    err = (p - (s - (s - p))) + (float(c) - (s - p))
    r = s.float()
    down = torch.nextafter(r, torch.full_like(r, -math.inf))
    up = torch.nextafter(r, torch.full_like(r, math.inf))
    r = torch.where((err < 0) & (s == (r.double() + down.double()) / 2),
                    down, r)
    return torch.where((err > 0) & (s == (r.double() + up.double()) / 2),
                       up, r)


def _uniform_chunk(ks, start, n, device, lo, hi) -> torch.Tensor:
    scaled = _fma32_torch(_unit_torch(_chunk_bits(ks, start, n, device)),
                          hi - lo, lo)
    return torch.clamp_min(scaled, float(lo))


def _erf_inv_torch(x: torch.Tensor) -> torch.Tensor:
    f32 = np.float32
    w = (-torch.log1p(-(x * x).double())).float()
    small = w < 5.0
    # float32 sqrt rounded once (PyTorch's float32 sqrt on the CPU is not)
    w = torch.where(small, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    p = torch.where(small, float(f32(_ERFINV_SMALL[0])),
                    float(f32(_ERFINV_LARGE[0])))
    for a, b in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        p = torch.where(small, float(f32(a)), float(f32(b))) + p * w
    edge = x * float(np.finfo(f32).max)
    return torch.where(torch.abs(x) == 1.0, edge, p * x)


def _fill(out: torch.Tensor, chunk_fn) -> torch.Tensor:
    flat = out.view(-1)
    for start in range(0, flat.numel(), TORCH_CHUNK):
        n = min(TORCH_CHUNK, flat.numel() - start)
        flat[start:start + n] = chunk_fn(start, n)
    return out


def uniform_torch(key, shape=(), minval: float = 0.0, maxval: float = 1.0,
                  device="cpu") -> torch.Tensor:
    """:func:`uniform`'s draw as a float32 tensor on ``device``."""
    shape = _shape(shape)
    ks, lo, hi = _key_words(key), np.float32(minval), np.float32(maxval)
    out = torch.empty(shape, dtype=torch.float32, device=device)
    return _fill(out, lambda s, n: _uniform_chunk(ks, s, n, out.device,
                                                  lo, hi))


def normal_torch(key, shape=(), device="cpu") -> torch.Tensor:
    """:func:`normal`'s draw as a float32 tensor on ``device``, bit for
    bit the numpy twin's."""
    shape = _shape(shape)
    ks = _key_words(key)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    sqrt2 = float(np.float32(math.sqrt(2)))
    out = torch.empty(shape, dtype=torch.float32, device=device)
    return _fill(out, lambda s, n: sqrt2 * _erf_inv_torch(_uniform_chunk(
        ks, s, n, out.device, lo, np.float32(1.0))))
