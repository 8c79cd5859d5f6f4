"""End-to-end training on the port: an LM for a few hundred steps on
synthetic data with checkpointing and failure injection; the loss must
drop.

  PYTHONPATH=src python examples/torch/lm_train_e2e.py            # ~8M
  PYTHONPATH=src python examples/torch/lm_train_e2e.py --hundred-m --steps 300

The default is an ~8M-parameter qwen2-family model; ``--hundred-m``
selects the ~100M variant (same code path).  Runs on the CUDA card
unless given ``--device cpu``.  The full configurations are exercised by
the dry run (``python -m repro_torch.launch.dryrun``).
"""
import argparse
import dataclasses
import tempfile

import repro_torch.launch.train as T
from repro_torch.configs import get_arch
from repro_torch.models import n_params


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--hundred-m", action="store_true")
    ap.add_argument("--device", default=None, help="None: the CUDA card")
    args = ap.parse_args()

    base = get_arch(args.arch)
    if args.hundred_m:   # ~100M parameters: same depth/family, less width
        small = dataclasses.replace(
            base, d_model=512, n_heads=8, n_kv_heads=2, head_dim=64,
            d_ff=1536, vocab_size=65536, n_layers=12, remat=False,
            attn_chunk_q=128, loss_chunk=128)
    else:                # ~8M: same family, CPU-sized
        small = dataclasses.replace(
            base, d_model=192, n_heads=4, n_kv_heads=2, head_dim=48,
            d_ff=512, vocab_size=4096, n_layers=4, remat=False,
            attn_chunk_q=64, loss_chunk=64)
    tag = "100M" if args.hundred_m else "CPU-sized"
    print(f"model: {small.name} {tag} variant, "
          f"params={n_params(small) / 1e6:.1f}M")

    orig_get = T.get_arch
    T.get_arch = lambda name: small  # train this variant
    try:
        with tempfile.TemporaryDirectory() as ck:
            targs = T.build_argparser().parse_args([
                "--arch", args.arch, "--steps", str(args.steps),
                "--global-batch", "8", "--seq-len", "64",
                "--lr", "6e-3", "--ckpt-dir", ck, "--ckpt-every", "50",
                "--inject-failure-rate", "0.005", "--log-every", "20",
            ])
            out = T.run_training(targs, device=args.device)
    finally:
        T.get_arch = orig_get
    out = {k: v for k, v in out.items() if k not in ("losses", "step_s",
                                                     "ckpt_s")}
    print(out)
    assert out["final_loss"] < out["first_loss"] * 0.8, "loss did not drop"
    print(f"loss {out['first_loss']:.3f} -> {out['final_loss']:.3f} OK "
          f"(restarts survived: {out['restarts']})")


if __name__ == "__main__":
    main()
