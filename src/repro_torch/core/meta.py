"""DGO as meta-optimizer: hyperparameter search over a gradient trainer,
the twin of ``repro.core.meta``.

The inner loop is a short gradient run; DGO searches the (log-lr,
log-wd, warmup-fraction) box at low resolution.  Each population member
is an independent short training run — embarrassingly parallel, the
paper's decomposition property.  As every objective of the port, the
one built here is batched: it evaluates a whole population at once.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.core.encoding import Encoding
from repro_torch.core.objectives import Objective


@dataclasses.dataclass(frozen=True)
class HyperBox:
    """log10-uniform box for (lr, weight_decay) + linear warmup fraction."""

    log_lr: tuple[float, float] = (-4.5, -1.0)
    log_wd: tuple[float, float] = (-4.0, -1.0)
    warmup: tuple[float, float] = (0.0, 0.5)
    bits: int = 5

    @property
    def n_vars(self) -> int:
        return 3

    def encoding(self) -> Encoding:
        # normalized [0,1] box; decode_hypers maps to physical ranges
        return Encoding(n_vars=self.n_vars, bits=self.bits, lo=0.0, hi=1.0)

    def decode_hypers(self, u: torch.Tensor) -> dict[str, torch.Tensor]:
        """``u`` (..., 3) in the unit box -> the physical hyperparameters,
        each of shape ``u.shape[:-1]``."""
        def lerp(lohi, t):
            return lohi[0] + (lohi[1] - lohi[0]) * t
        return {
            "lr": 10.0 ** lerp(self.log_lr, u[..., 0]),
            "weight_decay": 10.0 ** lerp(self.log_wd, u[..., 1]),
            "warmup_frac": lerp(self.warmup, u[..., 2]),
        }


def meta_objective(short_train: Callable[[dict], torch.Tensor],
                   box: HyperBox | None = None,
                   name: str = "meta_hyper") -> Objective:
    """Wrap a short-train function as a DGO Objective.  ``short_train``
    takes the decoded hyperparameters of a population, a dict of ``(B,)``
    tensors, and returns the ``(B,)`` final losses (a fixed step count
    inside: the reference's jit-compatible contract, batched)."""
    box = box or HyperBox()

    def fn(u):
        return short_train(box.decode_hypers(u))

    return Objective(name, fn, box.encoding(), f_opt=0.0, tol=math.inf)
