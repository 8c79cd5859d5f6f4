"""Subspace DGO tuning of a zoo LM on the port, through the solve()
front door: the model, config and data ride in the Problem
(``subspace-lm:*``), and the paper's resolution schedule (4 -> 6 bits)
is folded into the batched engine via ``max_bits``.

  PYTHONPATH=src python examples/torch/dgo_subspace_lm.py [--device cpu] [--small]
"""
import argparse

import torch

from repro_torch.core.solver import Batched, Problem, solve
from repro_torch.core.tree import tree_leaves

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="None: the CUDA card")
ap.add_argument("--small", action="store_true")
args = ap.parse_args()
d, iters = (4, 2) if args.small else (12, 6)

prob = Problem.get("subspace-lm:xlstm-125m", d=d, layers=2)
res = solve(prob, Batched(restarts=1, max_bits=6), x0=torch.zeros((1, d)),
            max_iters=iters, device=args.device)
trace = [float(v) for v in torch.as_tensor(res.trace).reshape(-1)]
print(f"schedule {res.extras['schedule']} (bits/var), "
      f"{res.iterations} iterations, spec {res.extras['problem_signature']}")
print("loss curve:", " -> ".join(f"{v:.4f}" for v in trace))
print(f"final loss {float(res.best_f):.4f} (started {trace[0]:.4f})")

winner = prob.materialize(torch.as_tensor(res.best_x))   # z -> parameters
leaves = tree_leaves(winner)
print(f"materialized winner: {sum(x.numel() for x in leaves)} parameters")

assert float(res.best_f) <= trace[0], "tuning must not regress"
assert all(bool(torch.isfinite(x).all()) for x in leaves
           if x.is_floating_point())
