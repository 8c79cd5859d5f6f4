"""Training driver of the port, the twin of ``repro.launch.train``:
end-to-end LM training with checkpoint/restart and failure injection, on
the card through PyTorch autograd.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --reduced --steps 50 --global-batch 8 --seq-len 64 --ckpt-every 20 \\
      --inject-failure-rate 0.02 --ckpt-dir ckpt

The restart loop is the fault-tolerance contract: any step may die
(``SimulatedFailure`` stands in for a lost node); the driver reloads the
newest valid checkpoint and continues.  Data is a pure function of the
step, so the token stream is identical across restarts.  The weights are
the reference's for the same ``--seed`` (``init_model`` from
``PRNGKey(seed)`` through the threefry twin), the batches are its
batches bit for bit, and a checkpoint holds the reference's leaves, so
either package can resume the other's run.

The step is ``launch.steps.make_train_step`` (one microbatch).
``--model-shards k`` other than 1 trains on a ``(data, model=k)`` mesh
(``launch.mesh.make_host_mesh``, on the run's device) over a launcher
fleet of a multiple of k ranks (``python -m repro_torch.launch.launcher
--processes K -- python -m repro_torch.launch.train ... --model-shards
k``): the parameters and moments are DTensors in the training layout
(``launch.sharding.TRAIN_RULES``), each rank computes on its data shard
of the batch, and a checkpoint holds the whole tensors (written by rank
0).  A process group with fewer ranks raises ``ValueError``, and so does
a run on the card whose fleet shares one GPU (a gloo group: NCCL takes
no two ranks on one GPU).  The attention is the plain chunked path
(``use_flash_attention=False``, as the reference trains: the flash
kernel has no backward pass).
``run_training(args)`` runs on the CUDA card; ``device="cpu"`` runs it on
the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from pathlib import Path

import torch

from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.configs import REGISTRY, get_arch, reduced
from repro_torch.core import prng
from repro_torch.core.distributed import fleet, resolve_device
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.data import DataConfig, SyntheticTokenPipeline
from repro_torch.launch import steps
from repro_torch.models.lm import init_model
from repro_torch.optim.gradient import AdamWConfig, AdamWState, adamw_init
from repro_torch.runtime import FailureInjector, SimulatedFailure


def build_argparser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(REGISTRY))
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced (smoke) variant")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--model-shards", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--inject-failure-rate", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", default="float32")
    return ap


def make_step(arch, opt_cfg, dtype, mesh=None, layouts=None):
    """The AdamW step of ``run_training``: (params, opt_state, batch) ->
    (params, opt_state, loss), the loss a 0-d tensor and ``batch`` the
    whole (B, ...) batch.  On a ``mesh`` (``layouts``: the parameters'
    and moments' :class:`~repro_torch.launch.sharding.Layout` tree) each
    rank computes on its data shard of the batch."""
    if mesh is None:
        fn, n, i = steps.make_train_step(arch, opt_cfg, 1, dtype), 1, 0
    else:
        fn = steps.mesh_scoped(steps.make_train_step(
            arch, opt_cfg, 1, dtype,
            constrain=steps.make_constrainer(arch, mesh, ("data",)),
            grad_shardings=layouts, param_shardings=layouts,
            moment_shardings=layouts, mesh=mesh, partial_axes=("data",)),
            mesh)
        n, i = mesh.size(0), mesh.get_coordinate()[0]

    def step(params, opt_state, batch):
        local = {k: v[None, i * (v.shape[0] // n):(i + 1) * (v.shape[0] // n)]
                 for k, v in batch.items()}
        return fn(params, opt_state, local)

    return step


def run_training(args, device=None, keep_state: bool = False) -> dict:
    """Train as the reference's ``run_training`` does and return its
    summary (``first_loss``, ``final_loss``, ``steps``, ``restarts``,
    ``injected_failures``) plus ``losses`` (every step's loss, in order,
    across restarts), ``step_s`` (each step's wall seconds, the batch and
    a synchronisation included) and ``ckpt_s`` (each save's seconds);
    ``keep_state`` adds ``state``, the final ``(params, opt_state)``.
    ``device``: None is the CUDA card (``RuntimeError`` without one),
    ``"cpu"`` the CPU."""
    dev = resolve_device(device)
    mesh = _model_mesh(args.model_shards, dev)
    arch = get_arch(args.arch)
    if args.reduced:
        arch = reduced(arch)
    dtype = getattr(torch, args.dtype)

    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                          total_steps=args.steps, weight_decay=0.01)
    data = SyntheticTokenPipeline(
        DataConfig(vocab_size=arch.vocab_size, seq_len=args.seq_len,
                   global_batch=args.global_batch, seed=args.seed),
        extras=_extras(arch, dtype), device=dev)
    injector = FailureInjector(args.inject_failure_rate, seed=args.seed + 1)
    ckpt_dir = Path(args.ckpt_dir)
    losses: list[float] = []
    step_s: list[float] = []
    ckpt_s: list[float] = []
    restarts = 0

    layouts = None if mesh is None else _layouts(arch, dtype, mesh)
    train_step = make_step(arch, opt_cfg, dtype, mesh, layouts)

    def fresh_state():
        params = init_model(arch, prng.PRNGKey(args.seed), dtype,
                            dev).tree()
        return _place((params, adamw_init(params)), layouts)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    params, opt_state = fresh_state()
    start = latest_step(ckpt_dir)
    step = 0
    if start is not None:
        params, opt_state = _restore(ckpt_dir, start, (params, opt_state),
                                     layouts)
        step = start
        print(f"[train] resumed from checkpoint step {step}")

    t0 = time.time()
    try:
        while step < args.steps:
            try:
                t_step = time.perf_counter()
                batch = data.batch_at(step)
                injector.maybe_fail(step)
                params, opt_state, loss = train_step(params, opt_state,
                                                     batch)
                loss = float(loss)
                sync()
                step_s.append(time.perf_counter() - t_step)
                losses.append(loss)
                step += 1
                if step % args.log_every == 0:
                    print(f"[train] step {step:5d} loss {loss:.4f} "
                          f"({(time.time() - t0) / step:.2f}s/step)")
                if step % args.ckpt_every == 0 or step == args.steps:
                    t_ck = time.perf_counter()
                    _save(ckpt_dir, step, (params, opt_state), layouts)
                    ckpt_s.append(time.perf_counter() - t_ck)
            except SimulatedFailure as e:
                restarts += 1
                print(f"[train] {e} -> restarting from latest checkpoint")
                start = latest_step(ckpt_dir)
                if start is None:
                    params, opt_state = fresh_state()
                    step = 0
                else:
                    params, opt_state = _restore(
                        ckpt_dir, start, (params, opt_state), layouts)
                    step = start
    finally:
        data.close()
    out = {"final_loss": losses[-1] if losses else None,
           "first_loss": losses[0] if losses else None,
           "steps": step, "restarts": restarts,
           "injected_failures": injector.injected,
           "losses": losses, "step_s": step_s, "ckpt_s": ckpt_s}
    if keep_state:
        out["state"] = (params, opt_state)
    return out


def _model_mesh(k: int, dev):
    """The (data, model=k) mesh of ``--model-shards k`` on ``dev`` (None
    for 1)."""
    if k == 1:
        return None
    fl = fleet()
    world = fl[1] if fl else 1
    if k < 1 or world % k:
        raise ValueError(
            f"--model-shards {k} needs a process group of a multiple of {k} "
            f"ranks, this one has {world}: run python -m "
            f"repro_torch.launch.launcher --processes {max(k, 1)} -- python "
            f"-m repro_torch.launch.train ... --model-shards {k}")
    from repro_torch.launch.mesh import make_host_mesh
    return make_host_mesh(model=k, device=dev)


def _layouts(arch, dtype, mesh):
    """The training layout of the parameters (and moments) over ``mesh``."""
    from repro_torch.launch.sharding import TRAIN_RULES, param_shardings
    from repro_torch.models.layers import abstract_params
    from repro_torch.models.lm import model_axes, model_spec
    return param_shardings(model_axes(arch),
                           abstract_params(model_spec(arch), dtype), mesh,
                           TRAIN_RULES)


def _place(state, layouts):
    """(params, opt_state) as DTensors of ``layouts`` (as they are for
    None)."""
    if layouts is None:
        return state
    from repro_torch.launch.sharding import replicated
    params, opt = state
    mesh = tree_leaves(layouts)[0].mesh
    return (steps.place(params, layouts),
            AdamWState(step=steps.place(opt.step, replicated(mesh)),
                       mu=steps.place(opt.mu, layouts),
                       nu=steps.place(opt.nu, layouts)))


def _whole(tree):
    from torch.distributed.tensor import DTensor
    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor)
                    else t, tree)


def _save(ckpt_dir, step: int, state, layouts) -> None:
    if layouts is None:
        save_checkpoint(ckpt_dir, step, state)
        return
    import torch.distributed as dist
    whole = _whole(state)
    if dist.get_rank() == 0:
        save_checkpoint(ckpt_dir, step, whole)
    dist.barrier()


def _restore(ckpt_dir, step: int, like, layouts):
    if layouts is None:
        return restore_checkpoint(ckpt_dir, step, like)
    return _place(restore_checkpoint(ckpt_dir, step, _whole(like)), layouts)


def _extras(arch, dtype):
    extras = {}
    if arch.vision_tokens:
        extras["images"] = ((arch.vision_tokens, arch.d_frontend), dtype)
    if arch.enc_dec:
        extras["frames"] = ((arch.n_frames, arch.d_model), dtype)
    return extras


def main(argv=None):
    args = build_argparser().parse_args(argv)
    result = run_training(args)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
