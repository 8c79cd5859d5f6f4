"""The system under test: the port's serving stack, as a loop of
``loops/<kind>.py`` drives it.

The path the window drives is ``serve --dgo``'s: a
``repro_torch.serving.PipelinedScheduler`` (its ``RequestQueue``, waves
of ``wave_size`` with ``max_in_flight`` on the card) -> ``core/solver.py``
``submit_wave`` -> the batched engine of ``core/distributed.py`` at the
configuration's fixed resolution -> one ``popstep_kernel`` launch a
step.  The objective is the registry's, built from the data the
benchmark hands over (``objectives.load_reference_state``).  Only this
module and the loops import the program.
"""
from __future__ import annotations

import dataclasses

import numpy as np

DRAIN_S = 120.0      # how long answers due in the window are waited for


@dataclasses.dataclass
class Sent:
    """One request as sent: its start levels and the program's handle."""

    levels0: np.ndarray
    handle: object


def build_problem(config: dict, arrays: dict):
    """The port's Problem for a configuration, from the registry, with
    the benchmark's data; its encoding must be the configuration's."""
    from repro_torch.core import objectives
    from repro_torch.core.solver import Problem

    obj = objectives.load_reference_state(
        config["problem"], arrays, **config.get("problem_spec", {}))
    enc = obj.encoding
    got = (enc.n_vars, enc.bits, enc.lo, enc.hi)
    want = (config["n_vars"], config["bits"], config["lo"], config["hi"])
    if got != tuple(want):
        raise ValueError(f"the registry's {config['problem']!r} is encoded "
                         f"as {got}, the configuration states {want}")
    return Problem.from_objective(obj)


def counters(sched) -> dict:
    """The program's counters that the per-layer metrics read as
    differences across a window."""
    m = sched.metrics_
    return {"waves": m.waves, "slots": m.slots,
            "padded_slots": m.padded_slots, "busy_s": m.busy_s}
