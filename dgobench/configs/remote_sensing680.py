"""Plain reference of ``remote_sensing680``: the paper's remote-sensing
MLP (7 bands -> 42 tanh units -> 8 classes, biases everywhere, 680
weights), its loss the mean softmax cross-entropy over the samples.

The samples are the benchmark's own, drawn here from the configuration's
``data`` (8 clusters, centres uniform in [-2, 2], noise 0.3 x N(0, 1),
``n_per_class`` each, numpy's generator at ``data.seed``) and handed to
both sides: the program builds its objective from them.
"""
from __future__ import annotations

import numpy as np
import torch

N_IN, N_HIDDEN, N_CLASSES = 7, 42, 8
N_W1 = N_IN * N_HIDDEN
N_B1 = N_W1 + N_HIDDEN
N_W2 = N_B1 + N_HIDDEN * N_CLASSES
CHUNK = 2048       # points a call: (2048, samples, 42) float64 at a time


def state(config: dict) -> dict:
    """The samples ``x`` (S, 7) float32 and their labels ``y`` (S,)."""
    d = config["data"]
    m = int(config["n_per_class"])
    rng = np.random.default_rng(int(d["seed"]))
    centers = rng.uniform(-2.0, 2.0, (N_CLASSES, N_IN)).astype(np.float32)
    noise = (np.float32(d["noise"])
             * rng.standard_normal((N_CLASSES, m, N_IN)).astype(np.float32))
    x = (centers[:, None, :] + noise).reshape(-1, N_IN)
    y = np.repeat(np.arange(N_CLASSES), m).astype(np.int64)
    return {"x": x, "y": y}


def _unpack(w):
    b = w.shape[0]
    return (w[:, :N_W1].reshape(b, N_IN, N_HIDDEN), w[:, N_W1:N_B1],
            w[:, N_B1:N_W2].reshape(b, N_HIDDEN, N_CLASSES), w[:, N_W2:])


def _loss(logits, y):
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, y.expand(logits.shape[0], -1)[..., None]
                        )[..., 0].mean(-1)


def values(w: torch.Tensor, st: dict) -> torch.Tensor:
    """The loss at each weight vector of ``w`` (B, 680) float64: layer 1
    of every vector as one matrix product over the samples."""
    w1, b1, w2, b2 = _unpack(w)
    x = st["x"].to(torch.float64)
    pre = (x @ w1.permute(1, 0, 2).reshape(N_IN, -1)).reshape(
        x.shape[0], -1, N_HIDDEN).transpose(0, 1)
    h = torch.tanh(pre + b1[:, None, :])
    return _loss(torch.bmm(h, w2) + b2[:, None, :], st["y"])


def tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa, to nearest, ties to
    even: what a TF32 matrix multiply does to its operands."""
    i = t.to(torch.float32).contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def control_values(w: torch.Tensor, st: dict) -> torch.Tensor:
    """The control: the same loss with both matrix multiplies in TF32
    (operands rounded, products accumulated in float32), the rest in
    float32: the configuration states float32 with TF32 off."""
    w1, b1, w2, b2 = _unpack(w.to(torch.float32))
    x = st["x"].to(torch.float32)
    h = torch.tanh(tf32(x) @ tf32(w1) + b1[:, None, :])
    return _loss(tf32(h) @ tf32(w2) + b2[:, None, :], st["y"])
