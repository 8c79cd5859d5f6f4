"""Batched serving on the port: LM decode waves on a reduced zamba2
model, then DGO optimization-as-a-service through the serving stack
(``repro_torch.serving``: request queue -> signature-bucketed scheduler
-> ``solve_many``), closed loop and open loop.

  PYTHONPATH=src python examples/torch/serving_batched.py [--device cpu] [--small]
"""
import argparse

from repro_torch.configs import get_arch, reduced
from repro_torch.launch.serve import build_parser, serve_dgo, serve_lm

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="None: the CUDA card")
ap.add_argument("--small", action="store_true")
args = ap.parse_args()
small = args.small

# wave 1: LM prefill + greedy decode
res = serve_lm(reduced(get_arch("zamba2-1.2b")), batch=2 if small else 4,
               prompt_len=16 if small else 32, gen_len=4 if small else 12,
               waves=1 if small else 2, seed=0, device=args.device)
print(f"LM serving: {res}")

# wave 2: closed-loop DGO serving: restarts * waves requests drained
# through the scheduler; same-signature requests share one wave's engine
serve_dgo(build_parser().parse_args(
    ["--dgo", "--problem", "rastrigin", "--restarts", "4" if small else "8",
     "--waves", "1" if small else "2", "--max-iters",
     "16" if small else "48"]), device=args.device)

# wave 3: open-loop DGO serving: Poisson arrivals over a mixed workload;
# the scheduler buckets by engine signature and reports tail latency
serve_dgo(build_parser().parse_args(
    ["--dgo", "--problems", "rastrigin:2,shekel,ackley:5",
     "--rps", "10" if small else "25", "--duration", "1" if small else "3",
     "--restarts", "2" if small else "4", "--max-iters",
     "8" if small else "32"]), device=args.device)
