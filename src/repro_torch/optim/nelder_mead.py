"""Nelder-Mead simplex baseline, matlab's ``fmin``/``fminsearch``
analogue (the paper compares DGO against matlab's fmin), the twin of
``repro.optim.nelder_mead``: reflection/expansion/contraction/shrink with
the usual (1, 2, 0.5, 0.5) coefficients.  No randomness past the start
(``uniform(key)`` in the box).
"""
from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.core.distributed import resolve_device
from repro_torch.core.encoding import Encoding


@torch.no_grad()
def _nm_loop(f, x0: torch.Tensor, iters: int, scale: float):
    n = x0.shape[0]
    simplex = torch.cat([x0[None, :], x0[None, :] + scale * torch.eye(
        n, dtype=x0.dtype, device=x0.device)], dim=0)       # (n+1, n)
    values = f(simplex)
    for _ in range(iters):
        order = torch.argsort(values, stable=True)
        simplex, values = simplex[order], values[order]
        centroid = torch.mean(simplex[:-1], dim=0)
        worst = simplex[-1]
        xr = centroid + (centroid - worst)            # reflect
        xe = centroid + 2.0 * (centroid - worst)      # expand
        xc = centroid + 0.5 * (worst - centroid)      # contract
        fr, fe, fc = f(torch.stack([xr, xe, xc]))

        use_e = (fr < values[0]) & (fe < fr)
        use_r = (fr < values[-2]) & ~use_e
        use_c = (fc < values[-1]) & ~use_e & ~use_r
        new_last = torch.where(use_e, xe, torch.where(
            use_r, xr, torch.where(use_c, xc, worst)))
        new_flast = torch.where(use_e, fe, torch.where(
            use_r, fr, torch.where(use_c, fc, values[-1])))
        shrink = ~(use_e | use_r | use_c)
        if bool(shrink):
            simplex = simplex[0][None, :] + 0.5 * (simplex
                                                   - simplex[0][None, :])
            values = f(simplex)
        else:
            simplex = simplex.clone()
            values = values.clone()
            simplex[-1], values[-1] = new_last, new_flast
    best = torch.argmin(values)
    return simplex[best], values[best]


def nelder_mead_minimize(f, enc: Encoding, key, iters: int = 400,
                         device=None):
    """``f``: (B, n_vars) -> (B,).  Returns (x, f(x), None).
    ``device=None`` is the card."""
    dev = resolve_device(device)
    x0 = torch.from_numpy(prng.uniform(key, (enc.n_vars,), enc.lo,
                                       enc.hi)).to(dev)
    x, v = _nm_loop(f, x0, iters, 0.1 * (enc.hi - enc.lo))
    return x, v, None
