"""Fleet launcher of the port, the twin of ``repro.launch.launcher``:
assemble the environment, then run the target.

    python -m repro_torch.launch.launcher --devices 16 -- \\
        python -m repro_torch.launch.serve --dgo --problems rastrigin:2 ...

``--devices N`` is the number of virtual shards a process holds
(``DGO_DEVICES``): ``repro_torch.core.resolve_mesh()`` reads it, so a
default mesh is ``(("data", N),)``.  ``--processes K`` spawns K workers,
each ``python -m repro_torch.launch.launcher --worker -- <payload>``,
that join one ``torch.distributed`` group (rank ``i`` of K, the
coordinator a free ``127.0.0.1`` port) before running the python
payload in-process; a default mesh then spans ``K * N`` shards and each
worker steps its own ``N`` (``core/distributed.py``: the shards' (value,
child id) pairs are all-gathered every step).  Where the box has a GPU
for every worker, worker ``i`` takes GPU ``i`` and the group is NCCL
beside gloo (:func:`worker_backend`), so DTensor meshes are on the cards;
where the workers share a GPU, or there is none, it is gloo alone: their
pairs travel as host copies (NCCL takes no two ranks on one GPU).

The environment also gets tcmalloc through ``LD_PRELOAD`` when the box
has it (silently skipped when absent) and ``TORCH_CPP_LOG_LEVEL`` from
``--log-level``.  This module imports no torch at module level: the
worker joins its group before the payload imports anything.
"""
from __future__ import annotations

import os
import runpy
import socket
import subprocess
import sys
from pathlib import Path

# well-known tcmalloc locations, most specific first (the probe takes the
# first that exists; none existing is the documented fallback)
TCMALLOC_CANDIDATES = (
    "/usr/lib/x86_64-linux-gnu/libtcmalloc.so.4",
    "/usr/lib/x86_64-linux-gnu/libtcmalloc_minimal.so.4",
    "/usr/lib/libtcmalloc.so.4",
    "/usr/lib/libtcmalloc_minimal.so.4",
)

# worker-coordination env vars (set by the parent, read by the worker)
ENV_DEVICES = "DGO_DEVICES"
ENV_COORDINATOR = "DGO_COORDINATOR"
ENV_NUM_PROCESSES = "DGO_NUM_PROCESSES"
ENV_PROCESS_ID = "DGO_PROCESS_ID"
# process-global marker that the fleet was joined: ``python -m`` runs this
# module as ``__main__`` while a payload imports it by its dotted name,
# and the two copies share no globals
ENV_FLEET_JOINED = "DGO_FLEET_JOINED"

LOG_LEVELS = ("INFO", "WARNING", "ERROR", "FATAL")


def find_tcmalloc(candidates=TCMALLOC_CANDIDATES) -> str | None:
    """First existing tcmalloc shared object, or None (fallback: skip)."""
    for path in candidates:
        if os.path.exists(path):
            return path
    return None


def build_env(base_env: dict | None = None, *, devices: int | None = None,
              log_level: int = 2, tcmalloc: bool = True,
              tcmalloc_path: str | None = None,
              coordinator: str | None = None,
              num_processes: int | None = None,
              process_id: int | None = None) -> dict:
    """Assemble the child environment (pure: no process state touched).

    ``devices`` sets the virtual shards a process holds (``DGO_DEVICES``,
    replacing an inherited value); ``log_level`` indexes
    :data:`LOG_LEVELS` for ``TORCH_CPP_LOG_LEVEL``; ``tcmalloc`` prepends
    the probed allocator to ``LD_PRELOAD`` (no-op when the probe finds
    nothing); the ``coordinator``/``num_processes``/``process_id`` triple
    exports the worker-coordination variables for
    :func:`maybe_initialize_from_env`."""
    env = dict(os.environ if base_env is None else base_env)
    if devices is not None:
        env[ENV_DEVICES] = str(devices)
    env["TORCH_CPP_LOG_LEVEL"] = LOG_LEVELS[
        max(0, min(log_level, len(LOG_LEVELS) - 1))]
    if tcmalloc:
        path = tcmalloc_path if tcmalloc_path is not None else find_tcmalloc()
        if path is not None:
            parts = [p for p in env.get("LD_PRELOAD", "").split(":") if p]
            if path not in parts:
                env["LD_PRELOAD"] = ":".join([path] + parts)
    if coordinator is not None:
        env[ENV_COORDINATOR] = coordinator
        env[ENV_NUM_PROCESSES] = str(num_processes)
        env[ENV_PROCESS_ID] = str(process_id)
        # a fresh worker must join, even if this parent's environment
        # carries the joined marker of an enclosing fleet
        env.pop(ENV_FLEET_JOINED, None)
    return env


def worker_backend(num_processes: int, gpus: int) -> str:
    """The fleet's backend: NCCL beside gloo when each of the
    ``num_processes`` workers has one of the box's ``gpus`` to itself,
    else gloo."""
    from repro_torch.core.distributed import CARD_BACKEND
    return CARD_BACKEND if 0 < num_processes <= gpus else "gloo"


def maybe_initialize_from_env(env=None) -> bool:
    """Join the ``torch.distributed`` group the launcher exported
    (:func:`worker_backend`; a worker with a GPU of its own takes GPU
    ``rank``).

    Reads the ``DGO_COORDINATOR`` / ``DGO_NUM_PROCESSES`` /
    ``DGO_PROCESS_ID`` triple.  Returns True when this process is part of
    a fleet, False for plain single-process runs.  Idempotent: the worker
    joins before the payload runs, and a payload that calls this itself
    (so it also works when launched directly) does not join twice."""
    env = os.environ if env is None else env
    coordinator = env.get(ENV_COORDINATOR)
    if not coordinator:
        return False
    if os.environ.get(ENV_FLEET_JOINED):
        return True
    import torch
    import torch.distributed as dist

    if not dist.is_initialized():
        world, rank = int(env[ENV_NUM_PROCESSES]), int(env[ENV_PROCESS_ID])
        gpus = torch.cuda.device_count() if torch.cuda.is_available() else 0
        backend = worker_backend(world, gpus)
        if "nccl" in backend:
            torch.cuda.set_device(rank)
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator}", world_size=world,
            rank=rank)
    os.environ[ENV_FLEET_JOINED] = "1"
    return True


def pick_coordinator(host: str = "127.0.0.1") -> str:
    """A free ``host:port`` for the fleet's rendezvous (best effort)."""
    with socket.socket() as s:
        s.bind((host, 0))
        return f"{host}:{s.getsockname()[1]}"


def split_python_payload(target: list[str]) -> list[str] | None:
    """The interpreter arguments of a ``python ...`` target, else None.
    A fleet re-runs the payload inside each worker's interpreter, so only
    python targets are spawnable across a fleet."""
    if not target:
        return None
    head = os.path.basename(target[0])
    if head.startswith("python") or target[0] == sys.executable:
        return target[1:]
    return None


def run_payload(payload: list[str]) -> None:
    """Execute interpreter-style arguments in this process: ``-c code
    [args...]``, ``-m module [args...]`` or ``script.py [args...]``."""
    if not payload:
        raise ValueError("empty python payload")
    if payload[0] == "-c":
        if len(payload) < 2:
            raise ValueError("python -c needs a program string")
        sys.argv = ["-c"] + payload[2:]
        exec(compile(payload[1], "<launcher -c>", "exec"),
             {"__name__": "__main__"})
    elif payload[0] == "-m":
        if len(payload) < 2:
            raise ValueError("python -m needs a module name")
        sys.argv = [payload[1]] + payload[2:]
        runpy.run_module(payload[1], run_name="__main__", alter_sys=True)
    else:
        sys.argv = list(payload)
        runpy.run_path(payload[0], run_name="__main__")


def _split_argv(argv: list[str]) -> tuple[list[str], list[str]]:
    """(launcher args, target command) around the ``--`` separator."""
    if "--" in argv:
        i = argv.index("--")
        return argv[:i], argv[i + 1:]
    return argv, []


def _parse_args(own: list[str]):
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.launcher",
        description="Assemble the fleet environment, then run the target "
                    "(separate launcher args from the target with --).")
    ap.add_argument("--devices", type=int, default=None, metavar="N",
                    help="virtual shards per process (DGO_DEVICES=N)")
    ap.add_argument("--processes", type=int, default=1, metavar="K",
                    help="spawn K workers in one torch.distributed "
                         "group (target must be a python command)")
    ap.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                    help="the group's rendezvous address "
                         "(default: a free local port)")
    ap.add_argument("--log-level", type=int, default=2,
                    help="TORCH_CPP_LOG_LEVEL index into "
                         f"{LOG_LEVELS} (default 2)")
    ap.add_argument("--no-tcmalloc", action="store_true",
                    help="skip the tcmalloc LD_PRELOAD probe")
    ap.add_argument("--worker", action="store_true",
                    help=argparse.SUPPRESS)  # internal: fleet worker
    return ap, ap.parse_args(own)


def _run_worker(target: list[str]) -> int:
    """Fleet worker: join the group, run the payload, leave the group."""
    maybe_initialize_from_env()
    payload = split_python_payload(target)
    if payload is None:
        payload = target  # already interpreter-style args
    try:
        run_payload(payload)
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


def _spawn_fleet(args, target: list[str]) -> int:
    """Spawn K workers sharing one rendezvous; wait for all."""
    coordinator = args.coordinator or pick_coordinator()
    # workers import this module before the payload, so the package root
    # must survive into their interpreter
    src_root = str(Path(__file__).resolve().parents[2])
    procs = []
    for pid in range(args.processes):
        env = build_env(devices=args.devices, log_level=args.log_level,
                        tcmalloc=not args.no_tcmalloc,
                        coordinator=coordinator,
                        num_processes=args.processes, process_id=pid)
        pypath = env.get("PYTHONPATH", "")
        if src_root not in pypath.split(os.pathsep):
            env["PYTHONPATH"] = (f"{src_root}{os.pathsep}{pypath}"
                                 if pypath else src_root)
        cmd = [sys.executable, "-m", "repro_torch.launch.launcher",
               "--worker", "--"] + target
        procs.append(subprocess.Popen(cmd, env=env))
    try:
        rcs = [p.wait() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return max(rcs) if rcs else 0


def main(argv: list[str] | None = None) -> int:
    own, target = _split_argv(sys.argv[1:] if argv is None else list(argv))
    ap, args = _parse_args(own)
    if args.worker:
        return _run_worker(target)
    if not target:
        ap.error("no target command (separate it with --)")
    if args.devices is not None and args.devices < 1:
        ap.error(f"--devices must be >= 1, got {args.devices}")
    if args.processes < 1:
        ap.error(f"--processes must be >= 1, got {args.processes}")
    if args.processes > 1:
        if split_python_payload(target) is None:
            ap.error("--processes > 1 needs a python target "
                     "(each worker re-runs the payload in its own "
                     "interpreter): got " + repr(target[0]))
        return _spawn_fleet(args, target)
    env = build_env(devices=args.devices, log_level=args.log_level,
                    tcmalloc=not args.no_tcmalloc)
    os.execvpe(target[0], target, env)  # no return


if __name__ == "__main__":
    raise SystemExit(main())
