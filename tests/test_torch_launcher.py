"""The port's fleet front door (``repro_torch.launch.launcher``): the
environment is assembled purely and exactly, ``--devices N`` sizes the
default mesh, a fleet joins NCCL only where every worker owns a GPU,
and a ``--processes`` fleet of ``torch.distributed`` gloo ranks takes
the trajectory of one process holding every shard, bit for bit, and the
reference's 8-device trajectory under the near-tie rule
(``tests/test_torch_solver.py``).  The cases mirror
``tests/test_launcher.py``; fleets run in subprocesses."""
import sys

import pytest

from repro_torch.launch import launcher
from repro_torch.launch.launcher import (
    ENV_COORDINATOR,
    ENV_DEVICES,
    ENV_FLEET_JOINED,
    ENV_NUM_PROCESSES,
    ENV_PROCESS_ID,
    build_env,
    find_tcmalloc,
    maybe_initialize_from_env,
    pick_coordinator,
    run_payload,
    split_python_payload,
    worker_backend,
)
from test_torch_solver import near_tie_step
from torch_fleet import EMIT, by_rank, fleet, json_lines, launch, reference


def test_build_env_devices_and_log_level():
    env = build_env({"HOME": "/h"}, devices=16, tcmalloc=False)
    assert env[ENV_DEVICES] == "16"
    assert env["TORCH_CPP_LOG_LEVEL"] == "ERROR"
    assert env["HOME"] == "/h"          # base env passes through
    env2 = build_env({ENV_DEVICES: "4"}, tcmalloc=False, log_level=9)
    assert env2[ENV_DEVICES] == "4"     # no devices requested: untouched
    assert env2["TORCH_CPP_LOG_LEVEL"] == "FATAL"
    # an inherited count is replaced: the launcher's --devices wins
    assert build_env({ENV_DEVICES: "4"}, devices=8,
                     tcmalloc=False)[ENV_DEVICES] == "8"


def test_build_env_is_pure():
    base = {ENV_DEVICES: "2"}
    build_env(base, devices=8, tcmalloc=False, log_level=0)
    assert base == {ENV_DEVICES: "2"}


def test_build_env_tcmalloc_prepends_and_dedupes(tmp_path):
    so = tmp_path / "libtcmalloc.so.4"
    so.write_bytes(b"")
    env = build_env({"LD_PRELOAD": "/other.so"}, tcmalloc_path=str(so))
    assert env["LD_PRELOAD"] == f"{so}:/other.so"
    env2 = build_env({"LD_PRELOAD": str(so)}, tcmalloc_path=str(so))
    assert env2["LD_PRELOAD"] == str(so)


def test_build_env_tcmalloc_probe_fallback_is_silent(monkeypatch):
    monkeypatch.setattr(launcher, "find_tcmalloc", lambda *a, **k: None)
    env = build_env({"LD_PRELOAD": "/x.so"})
    assert env["LD_PRELOAD"] == "/x.so"
    assert find_tcmalloc(("/no/such/lib.so",)) is None


def test_build_env_fleet_variables():
    env = build_env({ENV_FLEET_JOINED: "1"}, tcmalloc=False,
                    coordinator="127.0.0.1:1234", num_processes=2,
                    process_id=1)
    assert env[ENV_COORDINATOR] == "127.0.0.1:1234"
    assert env[ENV_NUM_PROCESSES] == "2" and env[ENV_PROCESS_ID] == "1"
    assert ENV_FLEET_JOINED not in env   # a fresh worker joins


def test_maybe_initialize_without_a_fleet_is_a_no_op():
    assert maybe_initialize_from_env({}) is False


@pytest.mark.parametrize("processes, gpus, backend", [
    (2, 0, "gloo"),                   # no card: the CPU
    (2, 1, "gloo"),                   # two ranks share one GPU
    (4, 3, "gloo"),
    (1, 1, "cpu:gloo,cuda:nccl"),
    (2, 2, "cpu:gloo,cuda:nccl"),     # a GPU each: NCCL beside gloo
    (4, 8, "cpu:gloo,cuda:nccl"),
])
def test_worker_backend(processes, gpus, backend):
    """A fleet joins NCCL only where every worker owns a GPU."""
    assert worker_backend(processes, gpus) == backend


def test_meshes_default_to_the_card(monkeypatch):
    """``make_host_mesh`` and ``ensure_process_group`` with no device
    take the card, as every entry point: without one they raise before
    joining any group."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import ensure_process_group, make_host_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (make_host_mesh, ensure_process_group):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    assert not dist.is_initialized()


def test_pick_coordinator_is_a_local_port():
    host, port = pick_coordinator().rsplit(":", 1)
    assert host == "127.0.0.1" and 0 < int(port) < 65536


def test_split_python_payload():
    assert split_python_payload(["python", "-c", "x"]) == ["-c", "x"]
    assert split_python_payload(["python3.12", "a.py"]) == ["a.py"]
    assert split_python_payload([sys.executable, "-m", "m"]) == ["-m", "m"]
    assert split_python_payload(["bash", "-c", "x"]) is None
    assert split_python_payload([]) is None


def test_run_payload_shapes(tmp_path, capsys):
    run_payload(["-c", "import sys; print('c', sys.argv[1:])", "a"])
    script = tmp_path / "s.py"
    script.write_text("import sys; print('s', sys.argv[1:])\n")
    run_payload([str(script), "b"])
    out = capsys.readouterr().out
    assert "c ['a']" in out and "s ['b']" in out
    with pytest.raises(ValueError):
        run_payload([])
    with pytest.raises(ValueError):
        run_payload(["-c"])
    with pytest.raises(ValueError):
        run_payload(["-m"])


def test_cli_rejects_bad_invocations():
    with pytest.raises(SystemExit):        # no target
        launcher.main(["--devices", "8"])
    with pytest.raises(SystemExit):        # nonsensical device count
        launcher.main(["--devices", "0", "--", "true"])
    with pytest.raises(SystemExit):        # K < 1
        launcher.main(["--processes", "0", "--", "python", "-c", "pass"])
    with pytest.raises(SystemExit):        # fleets need a python payload
        launcher.main(["--processes", "2", "--", "bash", "-c", "exit"])


def test_devices_16_sizes_the_default_mesh_end_to_end():
    """``--devices 16`` yields a 16-shard data mesh through
    ``resolve_mesh`` with no further plumbing."""
    out = launch(["--devices", "16", "--", sys.executable, "-c",
                  "import json\n"
                  "from repro_torch.core.solver import resolve_mesh\n"
                  "from repro_torch.launch.mesh import mesh_geometry\n"
                  "print(json.dumps({'geom': mesh_geometry(resolve_mesh())}))"])
    assert json_lines(out)[-1] == {"geom": [["data", 16]]}


_SOLVE = """
import json
from repro_torch.launch.launcher import maybe_initialize_from_env
maybe_initialize_from_env()
from repro_torch.core.distributed import fleet
from repro_torch.core.solver import Distributed, resolve_mesh, solve
from repro_torch.launch.mesh import mesh_geometry
r = solve("rastrigin", Distributed(max_bits=9), x0=[3.1, -2.2],
          max_iters=24, device="cpu")
fl = fleet()
emit({"rank": fl[0] if fl else 0, "geom": mesh_geometry(resolve_mesh()),
      "best_f": float(r.best_f),
      "history": [float(v) for v in r.extras["history"]]})
"""

_REF_SOLVE = """
import json, jax, jax.numpy as jnp
from repro.core.solver import Distributed, solve
r = solve("rastrigin", Distributed(max_bits=9),
          x0=jnp.asarray([3.1, -2.2]), max_iters=24)
print(json.dumps({"n_dev": jax.device_count(), "best_f": float(r.best_f),
                  "history": [float(v) for v in r.extras["history"]]}))
"""


def test_fleet_of_two_matches_single_process_bitwise():
    """--processes 2 x --devices 4 spans one 8-shard mesh, each rank
    stepping its 4 shards, and takes the exact trajectory of a single
    8-shard process; both follow the reference's 8 devices."""
    single = by_rank(launch(["--devices", "8", "--", sys.executable, "-c",
                             EMIT + _SOLVE]))
    two = by_rank(fleet(_SOLVE, processes=2, devices=4))
    assert set(two) == {0, 1}
    assert single[0]["geom"] == [["data", 8]]
    for rank in (0, 1):
        assert two[rank] == single[0]        # bitwise: == on float lists
    ref = json_lines(reference(_REF_SOLVE, devices=8))[-1]
    assert ref["n_dev"] == 8
    near_tie_step(single[0]["history"], ref["history"])
    assert abs(single[0]["best_f"] - ref["best_f"]) <= 1e-5 * max(
        1.0, abs(ref["best_f"]))
