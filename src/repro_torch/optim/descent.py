"""Plain gradient descent baseline (paper refs [2,11]), the twin of
``repro.optim.descent``: a fixed step size, the method the paper's
Figs. 4-5 show stalling in local minima.  Gradients through autograd.
"""
from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.core.distributed import resolve_device
from repro_torch.core.encoding import Encoding


def gd_minimize(f, enc: Encoding, key, steps: int = 5_000, lr: float = 0.01,
                device=None):
    """``f``: (B, n_vars) -> (B,).  Starts at ``uniform(key)`` in the box;
    returns (x, f(x), per-step value trace).  ``device=None`` is the
    card."""
    dev = resolve_device(device)
    x = torch.from_numpy(prng.uniform(key, (enc.n_vars,), enc.lo,
                                      enc.hi)).to(dev)
    trace = []
    for _ in range(steps):
        xg = x.detach().requires_grad_()
        (g,) = torch.autograd.grad(f(xg[None])[0], xg)
        x = torch.clamp(x - lr * g, enc.lo, enc.hi)
        with torch.no_grad():
            trace.append(f(x[None])[0])
    with torch.no_grad():
        return x, f(x[None])[0], torch.stack(trace)
