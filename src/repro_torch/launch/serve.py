"""Serving on the card: batched LM serving, the twin of
``repro.launch.serve``'s ``--arch`` branch, and DGO optimization serving
(``--dgo``), a thin CLI over ``repro_torch.serving``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \\
      --reduced --batch 4 --prompt-len 32 --gen-len 16

LM: requests arrive in waves; each wave is prefilled as a batch and
decoded token by token (greedy), in float32; throughput is reported as
decode tokens/s.  ``--arch`` takes every architecture of
``configs.REGISTRY``; a vision model's requests carry stub image
embeddings, an encoder-decoder's stub audio frames.

  # closed loop: submit restarts * waves requests, drain the queue
  PYTHONPATH=src python -m repro_torch.launch.serve --dgo \\
      --problems remote_sensing,rastrigin:9 --restarts 8 --waves 2

  # open loop: Poisson arrivals at --rps for --duration seconds
  PYTHONPATH=src python -m repro_torch.launch.serve --dgo \\
      --problems rastrigin:2,shekel,ackley:5 --rps 20 --duration 5

  # the same under the profiler: PATH/trace.json, one Chrome trace of
  # the card, the host and the serving path's spans; PATH/spans.json
  PYTHONPATH=src python -m repro_torch.launch.serve --dgo \\
      --problems remote_sensing --restarts 64 --waves 8 --trace PATH

DGO: ``--problems`` takes ``name[:n_vars]`` specs from the objective
registry, checked here; the scheduler buckets requests by engine
signature, pads each bucket to ``--restarts`` slots and serves it as one
wave of the batched engine (one popstep launch a step on the card); each
request's result is what its own solve would return.  Serving is
pipelined by default (``serving.PipelinedScheduler``, ``--max-in-flight``
waves running at once); ``--no-pipeline`` uses the synchronous scheduler.

Model-zoo tuning is served through the same loop: ``subspace-lm:<arch>``
names (``--problems subspace-lm:qwen2-1.5b,rastrigin:9``) are
subspace-DGO tuning problems over the reduced zoo model
(``core.subspace``), whose requests bucket by their semantic (arch, d,
bits, ...) signature; they take the plain tensor step (the popstep
kernel has no form of them).  ``--ckpt-dir`` persists each tuning
problem's winner parameters through the checkpoint store
(``checkpoint.store``, the reference's file layout), one directory per
problem (``subspace-lm__qwen2-1.5b/step_<requests>``).

Both run on the CUDA card (``serve_lm(..., device="cpu")`` and
``serve_dgo(args, device="cpu")`` run the plain PyTorch versions).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import threading
import time
from pathlib import Path

import torch

from repro_torch.configs import REGISTRY, get_arch, reduced
from repro_torch.core.distributed import resolve_device
from repro_torch.models.lm import ArchConfig, init_model, lm_decode, lm_prefill


@dataclasses.dataclass
class ServeResult:
    """Per wave: the prompts (B, prompt_len), the frontend stubs' inputs
    (``images`` / ``frames`` on the CPU, empty for a text model), the
    generated tokens (B, gen_len) and the float32 logits each token was
    chosen from (gen_len, B, V); the wall seconds of each wave's prefill;
    the decode wall seconds and tokens of all waves (the first token of a
    wave comes from its prefill and is not counted)."""

    prompts: list[torch.Tensor]
    extras: list[dict]
    tokens: list[torch.Tensor]
    logits: list[torch.Tensor]
    prefill_s: list[float]
    decode_s: float
    decode_tokens: int

    @property
    def decode_tokens_per_s(self) -> float:
        return self.decode_tokens / max(self.decode_s, 1e-9)


def _clock(dev: torch.device) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def frontend_inputs(arch: ArchConfig, batch: int,
                    gen: torch.Generator) -> dict:
    """The stub frontends' inputs of one wave, as the reference's serve
    loop makes them: ``images`` (B, vision_tokens, d_frontend) for a
    vision model, ``frames`` (B, n_frames, d_model) for an
    encoder-decoder, each 0.02 times a normal draw from ``gen``."""
    out = {}
    if arch.vision_tokens:
        out["images"] = 0.02 * torch.randn(
            (batch, arch.vision_tokens, arch.d_frontend), generator=gen)
    if arch.enc_dec:
        out["frames"] = 0.02 * torch.randn(
            (batch, arch.n_frames, arch.d_model), generator=gen)
    return out


def serve_lm(arch: ArchConfig, *, batch: int, prompt_len: int, gen_len: int,
             waves: int, seed: int, device=None, params=None) -> ServeResult:
    """Serve ``waves`` batches of ``batch`` random prompts of
    ``prompt_len`` tokens, each prefilled and then decoded greedily for
    ``gen_len`` tokens in all.  Weights: ``params`` when given (on the
    device), else :func:`init_model` from a generator on the device
    seeded with ``seed``.  Prompts, and after each wave's prompts its
    :func:`frontend_inputs`, are drawn from a CPU generator seeded with
    ``seed + 1``, so they do not depend on the device.  ``device``:
    None is the CUDA card (``RuntimeError`` without one), ``"cpu"`` runs
    the plain PyTorch versions.  Raises ``RuntimeError`` on non-finite
    logits."""
    dev = resolve_device(device)
    dtype = torch.float32
    if params is None:
        params = init_model(arch, torch.Generator(device=dev).manual_seed(
            seed), dtype)
    cache_len = prompt_len + gen_len
    prompt_gen = torch.Generator().manual_seed(seed + 1)
    res = ServeResult([], [], [], [], [], 0.0, 0)
    for _ in range(waves):
        prompts = torch.randint(0, arch.vocab_size, (batch, prompt_len),
                                generator=prompt_gen)
        extras = frontend_inputs(arch, batch, prompt_gen)
        inputs = {"tokens": prompts.to(dev),
                  **{k: v.to(dev, dtype) for k, v in extras.items()}}
        t0 = _clock(dev)
        logits, cache = lm_prefill(params, arch, inputs,
                                   cache_len=cache_len, dtype=dtype)
        tok = torch.argmax(logits, dim=-1)
        t1 = _clock(dev)
        outs, step_logits = [tok], [logits]
        for _ in range(gen_len - 1):
            logits, cache = lm_decode(params, arch, tok, cache, dtype=dtype)
            tok = torch.argmax(logits, dim=-1)
            outs.append(tok)
            step_logits.append(logits)
        t2 = _clock(dev)
        all_logits = torch.stack(step_logits)
        if not bool(torch.isfinite(all_logits).all()):
            raise RuntimeError("non-finite logits")
        res.prompts.append(prompts)
        res.extras.append(extras)
        res.tokens.append(torch.stack(outs, dim=1))
        res.logits.append(all_logits)
        res.prefill_s.append(t1 - t0)
        res.decode_s += t2 - t1
        res.decode_tokens += batch * (gen_len - 1)
    return res


# upper bound on --n-vars accepted at the CLI: the population is
# 2*n_vars*bits-1 children per step
MAX_CLI_N_VARS = 1024


def _parse_problem_specs(args) -> list:
    """Resolve ``--problems name[:n],...`` (or ``--problem`` +
    ``--n-vars``) into Problem instances, checked at the CLI boundary.
    ``Problem.get`` memoizes per spec, so every request of a spec shares
    one Problem (and one engine)."""
    from repro_torch.core.solver import Problem

    specs: list[tuple[str, int | None]] = []
    if args.problems:
        for item in args.problems.split(","):
            item = item.strip()
            if not item:
                continue
            # registry names may contain ":" (subspace-lm:xlstm-125m), so
            # only an integer tail is a variable count
            name, sep, n_str = item.rpartition(":")
            if sep and n_str.lstrip("-").isdigit():
                specs.append((name, int(n_str)))
            else:
                specs.append((item, None))
    else:
        specs.append((args.problem, args.n_vars))

    if not specs:
        raise SystemExit("--problems: no problem specs given "
                         "(want comma-separated name[:n_vars])")
    problems = []
    for name, n in specs:
        if n is not None and not 1 <= n <= MAX_CLI_N_VARS:
            raise SystemExit(
                f"--problems: n_vars for {name!r} must be in "
                f"[1, {MAX_CLI_N_VARS}], got {n}")
        try:
            problems.append(Problem.get(name, n=n))
        except ValueError as e:
            raise SystemExit(f"--problems: {e}")
    return problems


def _make_fault_plan(args):
    """The CLI's chaos knobs -> a seeded ``runtime.failure.FaultPlan``
    (None when no injection was asked for)."""
    if not (args.fault_rate or args.fault_latency_rate):
        return None
    from repro_torch.runtime.failure import FaultPlan

    return FaultPlan(seed=args.fault_seed,
                     dispatch_error_rate=args.fault_rate,
                     latency_rate=args.fault_latency_rate)


def _build_scheduler(args, problems, device=None):
    from repro_torch.serving import (
        PipelinedScheduler, RequestQueue, Scheduler)

    queue = RequestQueue(capacity=args.capacity, admission=args.admission)
    kwargs = dict(wave_size=args.restarts, max_bits=args.max_bits,
                  max_retries=args.max_retries,
                  retry_backoff_s=args.retry_backoff_s,
                  faults=_make_fault_plan(args), device=device)
    if args.no_pipeline:
        sched = Scheduler(queue, **kwargs)
    else:
        sched = PipelinedScheduler(queue, max_in_flight=args.max_in_flight,
                                   **kwargs)
    sched.warmup(problems, max_iters=args.max_iters)
    return sched


def _persist_winners(ckpt_dir: str, handles, submitted: int) -> list[str]:
    """Persist the best materializable result per problem: the winning z
    of each ``subspace-lm:*`` tuning problem mapped back to the model's
    parameters (``Problem.materialize``) and written through the atomic
    keep-k checkpoint store at step ``submitted``.  Returns the checkpoint
    paths written."""
    from pathlib import Path

    from repro_torch.checkpoint.store import save_checkpoint

    winners: dict[str, tuple[float, object, object]] = {}
    for h in handles:
        if not (h.done() and h.error is None):
            continue
        prob = h.request.problem
        if getattr(prob, "materialize", None) is None:
            continue
        res = h.result()
        f = float(res.best_f)
        if prob.name not in winners or f < winners[prob.name][0]:
            winners[prob.name] = (f, prob, res)
    paths = []
    for name, (_, prob, res) in sorted(winners.items()):
        params = prob.materialize(res.best_x)
        sub = name.replace(":", "__").replace("/", "__")
        path = save_checkpoint(Path(ckpt_dir) / sub, step=submitted,
                               tree=params)
        paths.append(str(path))
    return paths


def _report(sched, problems, best: float, wall_s: float,
            checkpoints: list[str] | None = None) -> dict:
    from repro_torch.core import cache

    m = sched.metrics()

    def _ms(key):
        return round(m[key], 1) if m[key] is not None else None

    # engine caches only: memo tables (solver.problem) would otherwise
    # inflate "engines built"/"hits" by one per request spec/submission
    eng = cache.totals(suffix=".engine")
    out = {
        "problems": [p.name for p in problems],
        "completed": m["completed"],
        "failed": m["failed"],
        "requeued": m["requeued"],
        "expired": m["expired"],
        "rejected": m["rejected"],
        "shed": m["shed"],
        "runs_per_s": (round(m["completed"] / wall_s, 1)
                       if wall_s > 0 else None),
        "latency_p50_ms": _ms("latency_p50_ms"),
        "latency_p95_ms": _ms("latency_p95_ms"),
        "latency_p99_ms": _ms("latency_p99_ms"),
        "waves": m["waves"],
        "bucket_fill": (round(m["fill_fraction"], 3)
                        if m["fill_fraction"] is not None else None),
        "cache_engines_built": eng["built"],
        "cache_hits": eng["hits"],
        "cache_evictions": m["cache_evictions"],
        "best_value": None if best == float("inf") else best,
        "checkpoints": checkpoints or [],
    }
    if "fault_injections" in m:
        out["fault_injections"] = m["fault_injections"]
    print(json.dumps(out))
    return out


@contextlib.contextmanager
def _profiled(path: str | None, device):
    """The ``with`` block under one ``torch.profiler`` session, CPU and
    (on the card) CUDA activity, when ``path`` is given; then
    ``path/trace.json``, the profiler's Chrome trace with the serving
    path's spans in it (``core.spans.export_chrome``), and
    ``path/spans.json``, ``core.spans.snapshot()``."""
    if path is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import spans

    activities = [ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    spans.clear()
    with profile(activities=activities) as prof:
        yield
    out = Path(path)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))
    spans.export_chrome(out / "trace.json")
    (out / "spans.json").write_text(json.dumps(spans.snapshot()))


def _run_serving_loop(args, problems, rps: float | None, device=None):
    """One serving run: open loop at ``rps`` (Poisson arrivals for
    ``--duration`` seconds) or, with ``rps=None``, closed loop
    (``restarts * waves`` requests up front).  Returns
    ``(sched, handles, wall_s, submitted)``."""
    import numpy as np

    from repro_torch.core.solver import SolveRequest
    from repro_torch.serving import QueueFull

    sched = _build_scheduler(args, problems, device)
    rng = np.random.default_rng(args.seed)
    submitted = 0
    handles = []

    def submit_next(arrived_at: float | None = None):
        nonlocal submitted
        prob = problems[submitted % len(problems)]
        req = SolveRequest(prob, seed=args.seed + submitted,
                           max_iters=args.max_iters,
                           deadline_s=args.deadline_s)
        submitted += 1
        try:
            h = sched.submit(req)
        except QueueFull:
            return      # the queue counted it (rejected/shed)
        if arrived_at is not None:
            # open loop: latency counts from the simulated arrival
            h.submitted_at = arrived_at
            if h.deadline_at is not None:
                h.deadline_at = arrived_at + args.deadline_s
        handles.append(h)

    try:
        with _profiled(args.trace, device):
            t_start = time.perf_counter()
            if rps is not None:
                t_end = t_start + args.duration
                stop = threading.Event()

                def arrivals():
                    # the arrival clock lives on its own thread, so dispatch
                    # never delays (or batches up) arrivals
                    next_arrival = t_start
                    while next_arrival < t_end and not stop.is_set():
                        now = time.perf_counter()
                        if next_arrival > now:
                            time.sleep(min(next_arrival - now, 0.01))
                            continue
                        submit_next(arrived_at=next_arrival)
                        next_arrival += rng.exponential(1.0 / rps)

                arr = threading.Thread(target=arrivals, name="dgo-arrivals",
                                       daemon=True)
                arr.start()
                try:
                    while arr.is_alive() or len(sched.queue):
                        if not sched.step():
                            time.sleep(0.001)
                finally:
                    stop.set()
                    arr.join()
                sched.drain()
            else:
                for _ in range(args.restarts * args.waves):
                    submit_next()
                sched.drain()
            wall_s = time.perf_counter() - t_start
    finally:
        sched.close()
    return sched, handles, wall_s, submitted


def serve_dgo(args, device=None) -> dict:
    """Serve DGO requests through the serving stack and print the report
    (one JSON line; with ``--sweep-rps`` one per rate and a summary).
    Open loop (``--rps``/``--duration``): Poisson arrivals independent of
    service progress.  Closed loop (``--waves``): ``restarts * waves``
    requests up front, then drain.  ``device``: None is the card, ``"cpu"``
    the plain versions.  Returns the report (the summary of a sweep)."""
    if args.rps is not None and args.rps <= 0:
        raise SystemExit(f"--rps must be > 0, got {args.rps}")
    if (args.rps is not None or args.sweep_rps) and args.duration <= 0:
        raise SystemExit(f"--duration must be > 0, got {args.duration}")
    if args.trace is not None and args.sweep_rps:
        raise SystemExit("--trace profiles one serving run, not a sweep")
    problems = _parse_problem_specs(args)

    if args.sweep_rps:
        try:
            points = [float(s) for s in args.sweep_rps.split(",") if s]
        except ValueError:
            raise SystemExit(f"--sweep-rps: want comma-separated rates, "
                             f"got {args.sweep_rps!r}")
        if not points or any(p <= 0 for p in points):
            raise SystemExit(f"--sweep-rps: rates must be > 0, "
                             f"got {args.sweep_rps!r}")
        sweep = []
        for rps in points:
            sched, handles, wall_s, submitted = _run_serving_loop(
                args, problems, rps, device)
            row = _report(sched, problems, _best(handles), wall_s)
            row["rps"] = rps
            row["offered_rps"] = rps
            row["achieved_rps"] = row["runs_per_s"]
            # a point saturates when the queue backlogs faster than the
            # service drains it: a drain tail well past the arrivals
            row["drain_tail_s"] = round(max(wall_s - args.duration, 0.0), 3)
            row["saturated"] = wall_s > 1.15 * args.duration
            row["submitted"] = submitted
            sweep.append(row)
        unsat = [r["offered_rps"] for r in sweep if not r["saturated"]]
        achieved = [r["achieved_rps"] for r in sweep
                    if r["achieved_rps"] is not None]
        summary = {"sweep_rps": points,
                   "knee_rps": max(unsat) if unsat else None,
                   "capacity_rps": max(achieved) if achieved else None,
                   "sweep": sweep}
        print(json.dumps(summary))
        return summary

    sched, handles, wall_s, submitted = _run_serving_loop(
        args, problems, args.rps, device)
    checkpoints = (_persist_winners(args.ckpt_dir, handles, submitted)
                   if args.ckpt_dir else None)
    return _report(sched, problems, _best(handles), wall_s, checkpoints)


def _best(handles) -> float:
    return min((float(h.result().best_f) for h in handles
                if h.done() and h.error is None), default=float("inf"))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(REGISTRY))
    ap.add_argument("--dgo", action="store_true",
                    help="serve DGO optimization requests (via the "
                         "repro_torch.serving scheduler) instead of LM "
                         "decode")
    ap.add_argument("--problem", default="rastrigin",
                    help="objective registry name (see repro_torch.core."
                         "objectives.names()); unknown names exit with the "
                         "valid list")
    ap.add_argument("--n-vars", type=int, default=None,
                    help="variable count for dimensioned objectives; omit "
                         "for fixed-dimensional ones (shekel, xor, ...)")
    ap.add_argument("--problems", default=None,
                    help="mixed workload as comma-separated name[:n_vars] "
                         "specs, e.g. remote_sensing,rastrigin:9 "
                         "(overrides --problem/--n-vars)")
    ap.add_argument("--rps", type=float, default=None,
                    help="open-loop mode: mean Poisson arrival rate "
                         "(requests/s); requires --duration")
    ap.add_argument("--duration", type=float, default=5.0,
                    help="open-loop mode: seconds of simulated arrivals")
    ap.add_argument("--sweep-rps", default=None,
                    help="saturation sweep: comma-separated arrival rates, "
                         "one open-loop run of --duration seconds each, and "
                         "a summary JSON line (knee_rps / capacity_rps)")
    ap.add_argument("--no-pipeline", action="store_true",
                    help="serve with the synchronous Scheduler instead of "
                         "the default PipelinedScheduler")
    ap.add_argument("--max-in-flight", type=int, default=2,
                    help="pipelined scheduler: waves running at once "
                         "before submission waits (2 = double-buffering)")
    ap.add_argument("--capacity", type=int, default=None,
                    help="bound the request queue (admission control at "
                         "this backlog; None = unbounded)")
    ap.add_argument("--admission", default="reject",
                    choices=["reject", "shed-lowest-priority", "block"],
                    help="what a full queue does to an arrival")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request TTL: expired requests fail fast "
                         "(DeadlineExceeded) and never occupy a wave slot")
    ap.add_argument("--max-retries", type=int, default=2,
                    help="charged dispatch retries per request before its "
                         "handle fails (DispatchFailed)")
    ap.add_argument("--retry-backoff-s", type=float, default=0.05,
                    help="base exponential backoff per failing signature "
                         "bucket (0 disables)")
    ap.add_argument("--fault-rate", type=float, default=0.0,
                    help="chaos: Bernoulli dispatch-failure rate via a "
                         "seeded runtime.failure.FaultPlan")
    ap.add_argument("--fault-latency-rate", type=float, default=0.0,
                    help="chaos: Bernoulli dispatch latency-spike rate")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed for the fault plan")
    ap.add_argument("--restarts", type=int, default=8,
                    help="scheduler wave width (requests per dispatch; "
                         "buckets are padded to it with inactive slots)")
    ap.add_argument("--max-iters", type=int, default=64)
    ap.add_argument("--max-bits", type=int, default=None,
                    help="fold a resolution schedule up to this many bits "
                         "into every dispatch (None = fixed resolution)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="run the serving loop under torch.profiler and "
                         "write PATH/trace.json (the profiler's Chrome "
                         "trace with the serving path's spans) and "
                         "PATH/spans.json (the spans' totals)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="persist each subspace-lm tuning problem's winner "
                         "parameters through the checkpoint store")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--waves", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)

    if args.dgo:
        serve_dgo(args)
        return
    if args.arch is None:
        ap.error("--arch is required unless --dgo is given")
    arch = get_arch(args.arch)
    if args.reduced:
        arch = reduced(arch)
    res = serve_lm(arch, batch=args.batch, prompt_len=args.prompt_len,
                   gen_len=args.gen_len, waves=args.waves, seed=args.seed)
    for wave, toks in enumerate(res.tokens):
        print(f"[serve] wave {wave}: generated {tuple(toks.shape)} tokens")
    print(json.dumps({
        "decode_tokens_per_s": round(res.decode_tokens_per_s, 1),
        "total_tokens": res.decode_tokens,
    }))


if __name__ == "__main__":
    main()
