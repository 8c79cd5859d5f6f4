"""Optimizers of the port: the gradient trainers of ``repro.optim``
(AdamW, SGD) and the paper's comparison baselines (GA, simulated
annealing, Nelder-Mead 'fmin', gradient descent)."""
from repro_torch.optim.annealing import sa_minimize
from repro_torch.optim.descent import gd_minimize
from repro_torch.optim.ga import ga_minimize
from repro_torch.optim.gradient import (
    AdamWConfig,
    AdamWState,
    SGDConfig,
    SGDState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    make_optimizer,
    sgd_init,
    sgd_update,
)
from repro_torch.optim.nelder_mead import nelder_mead_minimize

__all__ = ["AdamWConfig", "AdamWState", "SGDConfig", "SGDState",
           "adamw_init", "adamw_update", "clip_by_global_norm",
           "ga_minimize", "gd_minimize", "global_norm", "make_optimizer",
           "nelder_mead_minimize", "sa_minimize", "sgd_init", "sgd_update"]
