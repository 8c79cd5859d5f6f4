"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place, computed in the precision below
the configuration's (``control_values`` of ``configs/<name>.py``), on the
first requests a run of the cell sends, as many as a run follows.  Its
answers are judged as the program's are; they have to come out not
correct.  It runs no program and no window.

    python3 -m dgobench.control --workload <cell> --seeds 11,12,13

prints one JSON line a seed: the numbers compared, their limits and the
verdict.  ``--device cpu`` runs it on the host.  ``--fault early_stop``
judges a planted fault in its place instead: the reference in the
configuration's own precision, every request stopped after half its
budget as if it had stalled (what ``stall_gap`` has to catch).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from dgobench.reference import Judge, Lattice
from dgobench.run import WINDOW_STREAM
from dgobench.spec import Cell, load_cell
from dgobench.traffic import Starts


def control_numbers(cell: Cell, seed: int, device: str = "cuda",
                    fault: str | None = None) -> dict:
    """The control's numbers for one seed of ``cell`` (or, with ``fault``
    ``"early_stop"``, the planted fault's)."""
    cfg = cell.config
    judge = Judge(cfg, cell.reference, device)
    n = int(cfg["check"]["sample"])
    starts = Starts(Lattice.of(cfg), seed, WINDOW_STREAM)
    levels = [starts.next()[0] for _ in range(n)]
    budget = int(cfg["max_iters"])
    stop_at = None if fault is None else budget // 2
    answers = judge.control_answers(levels, budget, stop_at)
    stalls = [i for i, a in enumerate(answers) if a.iterations < budget]
    numbers = judge.numbers(answers, list(range(n)), budget, stalls)
    correct, pairs = judge.verdict(numbers)
    return {"seed": seed, "fault": fault, "correct": correct,
            "check": {k: {"value": v, "limit": lim}
                      for k, (v, lim) in pairs.items()},
            "iterations": [a.iterations for a in answers]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fault", choices=("early_stop",), default=None)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",") if s):
        t = time.perf_counter()
        out = control_numbers(cell, seed, args.device, args.fault)
        out["seconds"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
