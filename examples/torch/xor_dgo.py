"""Paper Fig. 4 on the port: train the 8-variable XOR network with DGO
and with gradient descent, printing both error traces.

  PYTHONPATH=src python examples/torch/xor_dgo.py [--device cpu] [--small]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.encoding import Encoding, decode
from repro_torch.core.objectives import XOR_X, XOR_Y, xor_forward
from repro_torch.core.solver import Clustered, Problem, solve
from repro_torch.optim import gd_minimize

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="None: the CUDA card")
ap.add_argument("--small", action="store_true")
args = ap.parse_args()
MAX_BITS, CLUSTERS, GD_STEPS = (8, 4, 300) if args.small else (16, 16, 3000)

prob = Problem.get("xor").replace(encoding=Encoding(8, 4, -8.0, 8.0))
res = solve(prob, strategy=Clustered(n_clusters=CLUSTERS, max_bits=MAX_BITS),
            seed=0, device=args.device)
print("DGO error trace (best cluster, downsampled):")
trace = np.asarray(res.trace, np.float32).reshape(-1)
trace = trace if trace.size else np.asarray([float(res.best_f)])
print(np.array2string(trace[:: max(len(trace) // 10, 1)], precision=4))
print(f"DGO final MSE: {float(res.best_f):.5f}")

_, gd_val, _ = gd_minimize(prob.fn, prob.encoding, prng.PRNGKey(0),
                           steps=GD_STEPS, device=args.device)
print(f"GD  final MSE: {float(gd_val):.5f} (paper Fig. 4: GD stalls higher)")

w = decode(torch.as_tensor(res.extras["bits"]).cpu(),
           Encoding(8, MAX_BITS, -8.0, 8.0))
preds = xor_forward(w, torch.from_numpy(XOR_X)).tolist()
print("XOR table (DGO):", [round(p, 3) for p in preds], "target",
      XOR_Y.tolist())
