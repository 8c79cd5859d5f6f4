"""Quickstart on the port: DGO through the one ``solve()`` front door.

  PYTHONPATH=src python examples/torch/quickstart.py [--device cpu] [--small]

A problem is a registry name (or a ``Problem`` spec), a strategy is a
string key (or a configured ``Strategy`` instance), and every strategy
returns the same ``SolveResult``.  Runs on the CUDA card unless given
``--device cpu``; ``--small`` cuts the resolution and clusters.
"""
import argparse

from repro_torch.core.solver import Clustered, Problem, solve

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="None: the CUDA card")
ap.add_argument("--small", action="store_true")
args = ap.parse_args()
clusters, bits = (2, 8) if args.small else (8, 14)

# DGO on a multimodal surface (a handful of clusters, the paper's MP-1
# mode: independent start points race inside one engine)
res = solve("rastrigin", strategy=Clustered(n_clusters=clusters,
                                            max_bits=bits),
            seed=0, device=args.device)
print(f"rastrigin-2d: f={float(res.best_f):.5f} at x={res.best_x} "
      f"({res.extras['evaluations']} evaluations)")

# same call, different problem: Shekel foxholes from the registry
prob = Problem.get("shekel")          # m=5 foxholes, known optimum rides along
res = solve(prob, strategy=Clustered(n_clusters=clusters, max_bits=bits),
            seed=1, device=args.device)
print(f"shekel-5:     f={float(res.best_f):.4f} "
      f"(global optimum {prob.f_opt})")

# swap the substrate by string: identical result type
res = solve("quadratic", strategy="fused", seed=0, device=args.device)
print(f"quadratic-2d: f={float(res.best_f):.6f} in {res.iterations} steps "
      f"[strategy='fused']")
