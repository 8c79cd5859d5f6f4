"""Genetic algorithm baseline (paper ref [1], Goldberg), the twin of
``repro.optim.ga``.

A bit-string GA over the same fixed-point encoding DGO uses, so the
comparison is encoding for encoding: tournament selection, single-point
crossover, per-bit mutation, elitism of 1.  The population and every
draw follow the reference's keys through the threefry twin.
"""
from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.core.distributed import resolve_device
from repro_torch.core.encoding import Encoding, decode


def ga_minimize(f, enc: Encoding, key, pop_size: int = 64,
                generations: int = 200, p_mut: float = 0.02,
                p_cross: float = 0.9, device=None):
    """``f``: (B, n_vars) -> (B,).  Returns (x_best, f_best,
    per-generation best trace).  ``device=None`` is the card."""
    dev = resolve_device(device)
    n = enc.n_bits

    def evaluate(pop):
        return f(decode(pop, enc)).to(torch.float32)

    def on(a):
        return torch.from_numpy(a).to(dev)

    k0, key = prng.split(key)
    pop = on(prng.bernoulli(k0, 0.5, (pop_size, n))).to(torch.int8)
    pos = torch.arange(n, device=dev)[None, :]
    trace = []
    for _ in range(generations):
        fit = evaluate(pop)
        key, kt1, kt2, kc, kcp, km = prng.split(key, 6)
        # tournament selection (size 2), one tournament per offspring slot
        i1 = on(prng.randint(kt1, (pop_size, 2), 0, pop_size)).long()
        i2 = on(prng.randint(kt2, (pop_size, 2), 0, pop_size)).long()
        p1 = torch.where(fit[i1[:, 0]] < fit[i1[:, 1]], i1[:, 0], i1[:, 1])
        p2 = torch.where(fit[i2[:, 0]] < fit[i2[:, 1]], i2[:, 0], i2[:, 1])
        # single-point crossover
        cut = on(prng.randint(kcp, (pop_size, 1), 1, n)).long()
        do_cross = on(prng.bernoulli(kc, p_cross, (pop_size, 1)))
        take_p1 = torch.where(do_cross, pos < cut, True)
        child = torch.where(take_p1, pop[p1], pop[p2])
        # mutation
        flips = on(prng.bernoulli(km, p_mut, (pop_size, n)))
        child = torch.bitwise_xor(child, flips.to(torch.int8))
        # elitism: keep the incumbent best in slot 0
        child[0] = pop[torch.argmin(fit)]
        trace.append(fit.min())
        pop = child
    fit = evaluate(pop)
    best = torch.argmin(fit)
    return decode(pop[best], enc), fit[best], torch.stack(trace)
