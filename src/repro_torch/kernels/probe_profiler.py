"""Measure how often ``torch.profiler`` loses a session's device records on
one CUDA card, and whether ``chip_smoke.py``'s retries ride it out.

    PYTHONPATH=src python3 -m repro_torch.kernels.probe_profiler \
        [--seconds S]

(from the repository root: it uses ``chip_smoke.py``'s timing helpers).
Part one opens profiler sessions one after another for ``S`` seconds,
each around 20 calls of ``popmin.ops.population_min`` (P = 287 to 2^24)
or ``popmin.ops.fold_partials``, as ``chip_smoke.device_ms`` does, and
prints every session that recorded fewer than 20 launches, with its time
since the start; then the runs of empty sessions and the seconds between
them.  Part two calls ``chip_smoke.device_ms`` for as long (each retry
prints a ``[time] profiler session`` line); it fails the run if a call
ends with no device time.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

REPS = 20


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=40.0)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("probe: needs a CUDA card")
    import chip_smoke
    from repro_torch.kernels.popmin import ops as mops

    print(chip_smoke.card_line())
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    calls = []
    for p in (287, 5439, 2**20, 2**24):
        v = torch.as_tensor(rng.standard_normal(p).astype(np.float32),
                            device=dev)
        calls.append((f"popmin_kernel P={p}", "popmin_kernel",
                      lambda v=v: mops.population_min(v)))
    parts = (torch.as_tensor(rng.standard_normal(1024).astype(np.float32),
                             device=dev),
             torch.arange(1024, dtype=torch.int32, device=dev))
    calls.append(("popmin_fold K=1024", "popmin_fold",
                  lambda: mops.fold_partials(*parts)))

    t0, s, runs, run, short = time.perf_counter(), 0, [], [], 0
    while time.perf_counter() - t0 < args.seconds:
        label, name, fn = calls[s % len(calls)]
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        _, n = chip_smoke._device_activity(prof, name)
        at = time.perf_counter() - t0
        if n < REPS:
            print(f"[profiler] session {s} at {at:.2f} s, {label}: "
                  f"{n} of {REPS} launches recorded")
            short += n > 0
        if n == 0:
            run.append(at)
        elif run:
            runs.append(run)
            run = []
        s += 1
    runs += [run] if run else []
    starts = [r[0] for r in runs]
    print(f"[profiler] {s} sessions in {args.seconds:.0f} s: "
          f"{sum(map(len, runs))} empty in runs of "
          f"{[len(r) for r in runs]}, spanning "
          f"{[round(r[-1] - r[0], 2) for r in runs]} s, "
          f"{np.round(np.diff(starts), 2).tolist()} s apart; {short} "
          f"partial")

    t0, n_calls = time.perf_counter(), 0
    while time.perf_counter() - t0 < args.seconds:
        _, name, fn = calls[n_calls % len(calls)]
        chip_smoke.device_ms(fn, REPS, dev, name=name)
        n_calls += 1
    print(f"[profiler] chip_smoke.device_ms: {n_calls} calls in "
          f"{args.seconds:.0f} s, every one with device time")


if __name__ == "__main__":
    main()
