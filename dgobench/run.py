"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m dgobench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Set-up (``setup_s``, from the process's
start): the imports, the kernels' build (``build/`` in the checkout; only
a checkout's first run compiles), the objective from the benchmark's
data, and the warm-up of the cell's loop (``loops/<kind>.py``: for a
closed loop ``warmup_waves`` full waves of the cell's own traffic, which
bind the kernel's step on every CUDA stream the window uses).  The window
is ``--seconds`` of the loop (with ``--trace 1`` at most
``TRACE_SECONDS``, under the profiler); the answers still out at its
close are waited for.  Then, with the program's state freed, the plain
reference judges the answers (``reference.py``), and the last line of
standard output is the result: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and
``check``, each number compared beside its limit, also the last lines
of standard error.  The run exits non-zero, printing no result, without
a CUDA card, without the program's sources beside the benchmark, or if
the JAX package or JAX was loaded.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

from dgobench import layers  # noqa: E402
from dgobench.reference import Answer, Judge, Lattice  # noqa: E402
from dgobench.spec import ROOT, Cell, load_cell  # noqa: E402
from dgobench.traffic import Starts  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
# a traced window is at most this long: the profiler's records of a
# longer one cost minutes to reduce and some of them are lost
TRACE_SECONDS = 10.0
WARMUP_STREAM, WINDOW_STREAM = 0, 1


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def loaded_forbidden() -> list[str]:
    """Top-level modules loaded that the benchmark must not load, names
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not readable"


def answers_of(sent) -> tuple[list[Answer], list]:
    """(answers, handles) of the requests that returned a result."""
    out, handles = [], []
    for s in sent:
        h = s.handle
        if not h.done() or h.error is not None:
            continue
        r = h.result()
        out.append(Answer(
            s.levels0, np.asarray(r.trace, np.float64), int(r.iterations),
            r.best_x.detach().cpu().numpy().astype(np.float32),
            float(r.best_f)))
        handles.append(h)
    return out, handles


def group_waves(handles, answers) -> list[tuple[int, int, int]]:
    """(slots, longest slot's steps, all slots' steps) of each wave:
    a wave's handles complete one after another, slot 0 first."""
    order = sorted(range(len(handles)),
                   key=lambda i: handles[i].completed_at)
    waves = []
    for i in order:
        slot = handles[i].result().extras["wave_slot"]
        if slot == 0 or not waves:
            waves.append([0, 0, 0])
        it = answers[i].iterations
        waves[-1][0] += 1
        waves[-1][1] = max(waves[-1][1], it)
        waves[-1][2] += it
    return [tuple(w) for w in waves]


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_process: float = T_PROCESS) -> dict:
    """One run of ``cell``: set-up, the window, the check.  Returns the
    result line's object."""
    import torch

    from dgobench import driver
    from dgobench import trace as tracing

    cfg, mix = cell.config, cell.loop.parse(cell.traffic)
    lat = Lattice.of(cfg)
    budget = int(cfg["max_iters"])
    dev = torch.device(device)
    arrays = cell.reference.state(cfg)
    if dev.type == "cuda":
        torch.zeros(1, device=dev)          # the CUDA context
    t_ready = time.perf_counter()
    loop = cell.loop.Loop(driver.build_problem(cfg, arrays), mix, budget,
                          device)
    try:
        warm = loop.warm_up(Starts(lat, seed, WARMUP_STREAM))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        setup_s = time.perf_counter() - t_process
        log(f"[setup] {setup_s:.3f} s to the first measured request: "
            f"{t_ready - t_process:.3f} s imports and the CUDA context, "
            f"{setup_s - t_ready + t_process:.3f} s the program's objective "
            f"and the warm-up ({len(warm)} requests)")
        starts = Starts(lat, seed, WINDOW_STREAM)
        if trace:
            seconds = min(seconds, TRACE_SECONDS)
        for attempt in (1, 2):
            before = driver.counters(loop.sched)
            if trace:
                with tracing.session() as prof:
                    t0 = time.perf_counter()
                    sent = loop.run(starts, until=t0 + seconds)
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
            else:
                t0 = time.perf_counter()
                sent = loop.run(starts, until=t0 + seconds)
            after = driver.counters(loop.sched)
            t_end = t0 + seconds
            if not trace:
                break
            summary = tracing.summarize(prof)
            if summary["popstep_launches"] or dev.type != "cuda":
                break
            log(f"[trace] profiler session {attempt} recorded no "
                f"{tracing.POPSTEP}"
                + ("; tracing the window again" if attempt == 1 else ""))
            if attempt == 2:
                raise RuntimeError("the profiler recorded no popstep_kernel "
                                   "in two sessions")
    finally:
        loop.close()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    answers, handles = answers_of(sent)
    in_window = [s.handle.submitted_at < t_end for s in sent]
    attempted = sum(in_window)
    failed = sum(1 for s, w in zip(sent, in_window)
                 if w and (not s.handle.done() or s.handle.error is not None))
    done_in = [i for i, h in enumerate(handles) if h.completed_at <= t_end]
    stopped = [i for i in done_in if answers[i].iterations < budget]
    waves = group_waves(handles, answers)
    latencies = [handles[i].completed_at - handles[i].submitted_at
                 for i in done_in]
    log(f"[window] {len(sent)} sent, {attempted} in the window, "
        f"{len(done_in)} answered in it, {failed} failed; {len(waves)} "
        f"waves; stopped before the budget of {budget}: {len(stopped)}")
    del loop
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    result = {"correct": False, "attempted": attempted, "failed": failed}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if trace:
        rec = {"config": cfg, "count": cell.count, "waves": waves,
               "trace": summary, "latencies_s": latencies,
               "counters": {k: after[k] - before[k] for k in before}}
        vals = {name: reader.read(rec) for name, reader in
                cell.readers.items()}
        log(f"[trace] window {summary['window_s']:.3f} s, device busy "
            f"{summary['busy_s']:.3f} s, {summary['kernels']} kernels, "
            f"{summary['popstep_launches']} popstep launches over "
            f"{layers.steps(rec)} steps")
    else:
        vals = {"setup_s": setup_s, "solves_per_s": len(done_in) / seconds}
    result["metrics"] = {k: {"value": v, "unit": units[k]}
                         for k, v in vals.items()
                         if k in units and v is not None}
    result["device"] = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        result["device"].update(busy_s=summary["busy_s"],
                                window_s=summary["window_s"])
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}

    t_check = time.perf_counter()
    judge = Judge(cfg, cell.reference, device)
    rng = np.random.default_rng([seed & 0xFFFFFFFF, 7])
    n = min(int(cfg["check"]["sample"]), len(done_in))
    sample = sorted(rng.choice(len(done_in), n, replace=False).tolist())
    position = {i: k for k, i in enumerate(done_in)}
    stalls = [position[i] for i in stopped]
    n_stalls = min(int(cfg["check"]["stall_checks"]), len(stalls))
    stalls = sorted(rng.choice(stalls, n_stalls, replace=False).tolist()
                    if stalls else [])
    numbers = judge.numbers([answers[i] for i in done_in], sample, budget,
                            stalls)
    correct, pairs = judge.verdict(numbers)
    correct = correct and failed == 0 and len(done_in) > 0
    log(f"[check] {len(done_in)} answers, {n} followed through "
        f"{numbers['states']} parents, {len(stalls)} stops checked, "
        f"{time.perf_counter() - t_check:.2f} s")
    for k, (v, lim) in pairs.items():
        log(f"{k} {v!r} limit {lim!r}")
    result["correct"] = bool(correct)
    result["check"] = {k: {"value": v, "limit": lim}
                       for k, (v, lim) in pairs.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        log(f"the program (src/repro_torch) is not beside the benchmark "
            f"in {ROOT}")
        return 2
    sys.path.insert(0, str(src))
    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"the cell needs {cell.chips} CUDA card(s); this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    log(f"[card] {card_line()}")
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    bad = loaded_forbidden()
    if bad:
        log(f"loaded what the benchmark must not load: {', '.join(bad)}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
