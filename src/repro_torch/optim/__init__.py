"""Optimizers of the port: the gradient trainers of ``repro.optim``
(AdamW, SGD).  The paper's comparison baselines (GA, simulated
annealing, Nelder-Mead, descent) are not ported yet (ROADMAP queue 1
#9)."""
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

__all__ = ["AdamWConfig", "AdamWState", "SGDConfig", "SGDState",
           "adamw_init", "adamw_update", "clip_by_global_norm",
           "global_norm", "make_optimizer", "sgd_init", "sgd_update"]
