"""The profiler around a traced window, and its reduction to numbers.

``torch.profiler`` records the card's activities (kernels, copies,
sets) and the host's (operators, CUDA runtime calls).  The window is a
user annotation (``WINDOW``) around the traced span; every interval is
clipped to it.  From the records: the seconds in which some activity ran
on the card (``busy_s``), the kernels launched, the ``popstep_kernel``
launches and the seconds in which one ran, the device operations that
took most time, and the longest idle gaps, each put under the host
record that overlaps it most (the shortest of those within a tenth of
that overlap, so a runtime call wins over the operator that made it).
"""
from __future__ import annotations

import collections
import contextlib

import numpy as np

WINDOW = "dgobench.window"
POPSTEP = "popstep_kernel"
TOP = 10
GAPS_ATTRIBUTED = 1000     # the longest gaps, put under host records


@contextlib.contextmanager
def session():
    """Profile the card and the host; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            yield prof


def _union(starts: np.ndarray, ends: np.ndarray):
    """Merged intervals of (start, end) pairs: (starts, ends) sorted."""
    if starts.size == 0:
        return starts, ends
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], np.maximum.accumulate(ends[order])
    new = np.ones(s.size, bool)
    new[1:] = s[1:] > e[:-1]
    idx = np.flatnonzero(new)
    return s[idx], np.append(e[idx[1:] - 1], e[-1])


def _is_device(ev) -> bool:
    return str(ev.device_type()).endswith("CUDA")


def summarize(prof) -> dict:
    """The traced window's numbers (module docstring): zero counts and
    seconds where the profiler recorded nothing on the card."""
    events = prof.profiler.kineto_results.events()
    win = [e for e in events if e.name() == WINDOW and not _is_device(e)]
    if not win:
        raise RuntimeError("the profiler recorded no window annotation")
    w0, w1 = win[0].start_ns(), win[0].end_ns()
    dev_name, dev_s, dev_e = [], [], []
    cpu_name, cpu_s, cpu_e = [], [], []
    for e in events:
        name = e.name()
        if name == WINDOW:
            continue
        s, t = max(e.start_ns(), w0), min(e.end_ns(), w1)
        if t <= s:
            continue
        if _is_device(e):
            dev_name.append(name)
            dev_s.append(s)
            dev_e.append(t)
        elif not getattr(e, "is_python_function", lambda: False)():
            cpu_name.append(name)
            cpu_s.append(s)
            cpu_e.append(t)
    dev_s, dev_e = np.asarray(dev_s, np.int64), np.asarray(dev_e, np.int64)
    us, ue = _union(dev_s, dev_e)
    busy_ns = int((ue - us).sum())
    window_ns = w1 - w0
    pop = np.asarray([POPSTEP in n for n in dev_name], bool)
    ps, pe = _union(dev_s[pop], dev_e[pop])
    kernels = sum(1 for n in dev_name
                  if not n.startswith(("Memcpy", "Memset")))
    per_op = collections.defaultdict(int)
    for n, s, t in zip(dev_name, dev_s, dev_e):
        per_op[n] += int(t - s)
    return {
        "window_s": window_ns / 1e9,
        "busy_s": busy_ns / 1e9,
        "kernels": kernels,
        "popstep_launches": int(pop.sum()),
        "popstep_s": float((pe - ps).sum()) / 1e9,
        "device_ops": [[n, t / 1e9] for n, t in sorted(
            per_op.items(), key=lambda kv: -kv[1])[:TOP]],
        "idle_gaps": _idle_gaps(us, ue, w0, w1, cpu_name,
                                np.asarray(cpu_s, np.int64),
                                np.asarray(cpu_e, np.int64)),
    }


def _idle_gaps(us, ue, w0, w1, names, cs, ce) -> list:
    """Seconds of idle gaps under the host record that overlaps each most,
    summed by name, the largest ``TOP``."""
    gs = np.concatenate([[w0], ue])
    ge = np.concatenate([us, [w1]])
    keep = ge > gs
    gs, ge = gs[keep], ge[keep]
    order = np.argsort(gs - ge, kind="stable")[:GAPS_ATTRIBUTED]
    dur = ce - cs
    by_name = collections.defaultdict(int)
    for i in order:
        a, b = gs[i], ge[i]
        over = np.minimum(ce, b) - np.maximum(cs, a)
        best = over.max() if over.size else 0
        if best <= 0:
            by_name["(no host record)"] += int(b - a)
            continue
        near = np.flatnonzero(over >= 0.9 * best)
        by_name[names[near[np.argmin(dur[near])]]] += int(b - a)
    return [[n, t / 1e9] for n, t in sorted(
        by_name.items(), key=lambda kv: -kv[1])[:TOP]]
