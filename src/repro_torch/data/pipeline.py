"""Deterministic synthetic LM token pipeline, the twin of
``repro.data.pipeline``.

Sequences are learnable (a planted bigram permutation chain over Zipf
noise), and a batch is a pure function of (seed, step): restart-safe,
resuming at step k regenerates the identical stream.  Every draw goes
through the threefry twin (:mod:`repro_torch.core.prng`), so a batch is
the reference's bit for bit.  Batches are made on the host in numpy and
moved to the caller's device.

The Zipf noise is ``int32(u ** -0.7 - 1)``: an integer stage, so its
float32 power must round as the reference's does.  XLA on the CPU
evaluates a float32 ``pow`` through the C library's ``powf``, and so does
:func:`pow32` (numpy's and PyTorch's float32 powers part from it by an
ulp on a fraction of inputs, which flips a token now and then).

A background thread keeps ``prefetch`` batches ahead of the training loop
(the host-side analogue of double buffering).
"""
from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch.core import prng


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    pattern_len: int = 16          # planted n-gram period
    pattern_frac: float = 0.75     # fraction of positions following a motif


@functools.lru_cache(maxsize=1)
def _powf():
    libm = ctypes.util.find_library("m")
    if libm is None:
        raise OSError("the C math library (libm) was not found: the "
                      "synthetic token stream needs its powf")
    fn = ctypes.CDLL(libm).powf
    fn.restype = ctypes.c_float
    fn.argtypes = [ctypes.c_float, ctypes.c_float]
    return fn


def pow32(x: np.ndarray, y: float) -> np.ndarray:
    """``x ** y`` for float32 ``x`` and exponent ``float32(y)``, each
    element through the C library's ``powf``: XLA's float32 power on the
    CPU, bit for bit."""
    fn, y32 = _powf(), float(np.float32(y))
    flat = np.asarray(x, np.float32).reshape(-1)
    out = np.fromiter((fn(float(v), y32) for v in flat), np.float32,
                      flat.size)
    return out.reshape(np.shape(x))


@functools.lru_cache(maxsize=8)
def _perm(perm_seed: int, vocab: int) -> np.ndarray:
    return prng.permutation(prng.PRNGKey(perm_seed), vocab)


def lm_synthetic_batch(key, batch: int, seq: int, vocab: int,
                       pattern_len: int = 16, pattern_frac: float = 0.75,
                       perm_seed: int = 7) -> tuple[np.ndarray, np.ndarray]:
    """(tokens, labels), int32 numpy arrays (B, S): a fixed bigram
    permutation chain over Zipf noise.  With probability ``pattern_frac``
    the next token is ``perm[token]`` for a fixed (seeded) vocabulary
    permutation, else Zipf noise; labels are the next tokens, -1 last.
    ``key`` is a JAX key (``(2,)`` uint32); ``pattern_len`` is kept for
    the reference's API (unused by the chain)."""
    del pattern_len
    kz, kp, k0 = prng.split(key, 3)
    perm = _perm(perm_seed, vocab)
    u = prng.uniform(kz, (batch, seq), 1e-6, 1.0)
    noise = np.minimum((pow32(u, -0.7) - np.float32(1)).astype(np.int32),
                       np.int32(vocab - 1))
    use = prng.uniform(kp, (batch, seq)) < np.float32(pattern_frac)
    prev = prng.randint(k0, (batch,), 0, vocab)
    tokens = np.empty((batch, seq), np.int32)
    for t in range(seq):
        prev = np.where(use[:, t], perm[prev], noise[:, t])
        tokens[:, t] = prev
    labels = np.concatenate(
        [tokens[:, 1:], np.full((batch, 1), -1, np.int32)], axis=1)
    return tokens, labels


class SyntheticTokenPipeline:
    """Deterministic, restart-safe, prefetching batch source.  Batches
    are dicts of int64 tensors on ``device`` (``"cpu"`` by default)."""

    def __init__(self, cfg: DataConfig, start_step: int = 0,
                 prefetch: int = 2, extras: dict | None = None,
                 device="cpu"):
        self.cfg = cfg
        self.step = start_step
        self.extras = extras or {}
        self.device = torch.device(device)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def batch_at(self, step: int) -> dict:
        """The batch of ``step``, keyed by ``fold_in(PRNGKey(seed),
        step)``.  ``extras`` (name -> (shape, dtype)) adds
        ``0.02 * normal`` frontend inputs, keyed as the reference keys
        them (by ``hash(name)``)."""
        key = prng.fold_in(prng.PRNGKey(self.cfg.seed), step)
        tokens, labels = lm_synthetic_batch(
            key, self.cfg.global_batch, self.cfg.seq_len,
            self.cfg.vocab_size, self.cfg.pattern_len, self.cfg.pattern_frac)
        out = {"tokens": torch.from_numpy(tokens).long().to(self.device),
               "labels": torch.from_numpy(labels).long().to(self.device)}
        for name, (shape, dtype) in self.extras.items():   # frontend stubs
            draw = prng.normal(prng.fold_in(key, hash(name) % 2**31),
                               (self.cfg.global_batch,) + tuple(shape))
            out[name] = (0.02 * torch.from_numpy(draw)).to(
                device=self.device, dtype=dtype)
        return out

    def _producer(self):
        step = self.step
        while not self._stop.is_set():
            try:
                self._q.put((step, self.batch_at(step)), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
