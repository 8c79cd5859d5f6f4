"""Simulated annealing baseline (paper refs [3,4], Kirkpatrick et al.),
the twin of ``repro.optim.annealing``.

Continuous-space Metropolis SA with geometric cooling and a Gaussian
proposal whose scale anneals with the temperature.  Every draw comes from
the threefry twin (``core/prng.py``) in the reference's order, so a key
gives the reference's proposals and acceptance tests.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.distributed import resolve_device
from repro_torch.core.encoding import Encoding


def sa_minimize(f, enc: Encoding, key, steps: int = 20_000,
                t0: float = 1.0, t_final: float = 1e-4, device=None):
    """``f``: (B, n_vars) -> (B,) (an ``Objective.fn``).  Returns
    (best_x, best_f, per-step best trace).  ``device=None`` is the card."""
    dev = resolve_device(device)
    f32 = np.float32
    alpha = f32((t_final / t0) ** (1.0 / steps))
    span = f32(enc.hi - enc.lo)
    lo, hi = f32(enc.lo), f32(enc.hi)

    def value(x):
        return f(torch.from_numpy(x[None]).to(dev))[0].to(torch.float32)

    k0, key = prng.split(key)
    x = prng.uniform(k0, (enc.n_vars,), enc.lo, enc.hi)
    v = value(x)
    best_x, best_v = x, v
    temp = f32(t0)
    trace = []
    for _ in range(steps):
        key, kp, ka = prng.split(key, 3)
        scale = f32(0.1) * span * np.sqrt(f32(temp / f32(t0)))
        prop = np.clip(x + scale * prng.normal(kp, x.shape), lo, hi)
        pv = value(prop)
        u = prng.uniform(ka)
        accept = bool(torch.log(torch.tensor(u)) < (v - pv).cpu() / temp)
        if accept:
            x, v = prop, pv
        if bool(v < best_v):
            best_x, best_v = x, v
        trace.append(best_v)
        temp = f32(temp * alpha)
    return (torch.from_numpy(np.asarray(best_x, np.float32)).to(dev),
            best_v, torch.stack(trace))
