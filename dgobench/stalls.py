"""Where requests of a cell stall without a budget: the evidence for each
configuration's ``max_iters``.

    python3 -m dgobench.stalls --workload <cell> --seeds 1,2,3 --cap 512 --waves 1

Sends the first ``--waves`` waves of each seed's window (the cell's own
start points, ``wave_size`` a wave) through the port's ``solve_many``
with ``--cap`` steps a request and prints, a seed a line, the steps of
the requests that stopped before the cap (after a step without an
improvement).  The configuration's budget has to lie below the
earliest.
"""
from __future__ import annotations

import argparse
import json
import sys

from dgobench.reference import Lattice
from dgobench.run import WINDOW_STREAM
from dgobench.spec import ROOT, load_cell
from dgobench.traffic import Starts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--cap", type=int, default=512)
    ap.add_argument("--waves", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.solver import SolveRequest, solve_many

    from dgobench.driver import build_problem

    cell = load_cell(args.workload)
    cfg = cell.config
    width = cell.loop.parse(cell.traffic).wave_size
    problem = build_problem(cfg, cell.reference.state(cfg))
    for seed in (int(s) for s in args.seeds.split(",") if s):
        starts = Starts(Lattice.of(cfg), seed, WINDOW_STREAM)
        reqs = [SolveRequest(problem, x0=starts.next()[1],
                             max_iters=args.cap)
                for _ in range(width * args.waves)]
        steps = sorted(r.iterations for r in solve_many(
            reqs, pad_to=width))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "cap": args.cap, "requests": len(steps),
                          "budget": cfg["max_iters"],
                          "below_budget": sum(s < cfg["max_iters"]
                                              for s in steps),
                          "stopped": [s for s in steps if s < args.cap]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
