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

from dgobench.reference import Answer

DRAIN_S = 120.0      # how long answers due in the window are waited for


@dataclasses.dataclass
class Sent:
    """One request as sent: its start levels and the program's handle,
    until :func:`settle` takes what it returned to the host and lets the
    handle go."""

    levels0: np.ndarray
    handle: object | None
    submitted_at: float
    completed_at: float | None = None     # None: never answered
    error: BaseException | None = None
    answer: Answer | None = None
    wave_slot: int = -1

    @property
    def done(self) -> bool:
        return self.completed_at is not None


def drop_rows(batch: list) -> None:
    """Let go of the wave's rows that each returned answer of ``batch``
    holds on the card (``extras["bits"]``, a view of the wave's bit
    strings, which the check does not read), so that the answers kept
    until the window closes hold no wave-sized memory.  No call into
    torch: on a host-paced cell every such call contends with the
    program's threads for the interpreter."""
    for s in batch:
        h = s.handle
        if h.done() and h.error is None:
            h.result().extras.pop("bits", None)


def settle(batch: list) -> None:
    """Once the window has closed: take the answers of the requests of
    ``batch`` that returned to the host, each field of all of them in one
    copy, and let go of every handle of ``batch``, and with it the device
    memory its result holds.  A request that has not returned stays
    unanswered."""
    import torch

    taken = []
    for s in batch:
        h, s.handle = s.handle, None
        if h is None or not h.done():
            continue
        s.completed_at, s.error = h.completed_at, h.error
        if h.error is None:
            taken.append((s, h.result()))
    if not taken:
        return
    xs = torch.stack([r.best_x for _, r in taken]).cpu().numpy()
    fs = [r.best_f for _, r in taken]
    if isinstance(fs[0], torch.Tensor):
        fs = torch.stack(fs).cpu().numpy()
    for (s, r), x, f in zip(taken, xs, fs):
        s.answer = Answer(s.levels0, r.trace, r.iterations, x, f)
        s.wave_slot = r.extras["wave_slot"]


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


def segments(device) -> int:
    """The CUDA caching allocator's segments allocated so far (each a
    ``cudaMalloc``); 0 off the card."""
    import torch

    if torch.device(device).type != "cuda":
        return 0
    return int(torch.cuda.memory_stats(device).get(
        "segment.all.allocated", 0))
