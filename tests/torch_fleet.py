"""Helpers for the port's multi-process tests: a ``torch.distributed``
fleet through ``repro_torch.launch.launcher`` (gloo, ranks on the CPU)
and a reference run on N host devices, each in a subprocess of its own,
since a process group (and JAX's device count) is global to a process."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# prepended to every payload: ``emit(obj)`` writes one JSON line in one
# write(2) call, so the ranks' lines do not interleave on the shared pipe
EMIT = ("import json as _json, os as _os\n"
        "def emit(obj):\n"
        "    _os.write(1, (_json.dumps(obj) + '\\n').encode())\n")


def env(threads: int = 1, **extra) -> dict:
    """The subprocess environment: the packages on the path, the CPU, and
    few threads a process (a fleet's ranks share the machine)."""
    out = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS=str(threads))
    for k in ("DGO_COORDINATOR", "DGO_NUM_PROCESSES", "DGO_PROCESS_ID",
              "DGO_FLEET_JOINED", "DGO_DEVICES"):
        out.pop(k, None)
    out.update(extra)
    return out


def launch(args, timeout: int = 300, threads: int = 1) -> str:
    """``python -m repro_torch.launch.launcher <args>``; its stdout."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.launcher"] + list(args),
        capture_output=True, text=True, env=env(threads), cwd=ROOT,
        timeout=timeout)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-4000:])
    return out.stdout


def fleet(code: str, processes: int, devices: int | None = None,
          timeout: int = 300, threads: int = 1) -> str:
    """Run python ``code`` in each rank of a gloo fleet (it joins the
    group before the code runs); the ranks' stdout."""
    args = ["--processes", str(processes)]
    if devices is not None:
        args += ["--devices", str(devices)]
    return launch(args + ["--", sys.executable, "-c",
                          EMIT + textwrap.dedent(code)], timeout, threads)


def reference(code: str, devices: int, timeout: int = 300) -> str:
    """Run python ``code`` with the JAX package on ``devices`` host
    devices; its stdout."""
    flags = f"--xla_force_host_platform_device_count={devices}"
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)], capture_output=True,
        text=True, env=env(4, XLA_FLAGS=flags), cwd=ROOT, timeout=timeout)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-4000:])
    return out.stdout


def json_lines(out: str) -> list:
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def by_rank(out: str, key: str = "rank") -> dict:
    rows = json_lines(out)
    return {row.pop(key): row for row in rows}
