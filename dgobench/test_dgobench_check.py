"""The comparison that decides ``correct``, on the CPU at small sizes:
whole runs of the harness (the look for a card skipped) come out correct
on the sound program and not correct with the timed path broken
underneath; the control (the reference in the precision below) comes
out not correct; the reference and the check import nothing of the
program, and a run loads neither JAX nor the JAX package."""
import ast
import dataclasses
import json
import subprocess
import sys

import pytest
import torch

from dgobench import run
from dgobench.control import control_numbers
from dgobench.spec import HERE, ROOT, load_cell

SEED = 2**33 + 11


def quantities(res: dict) -> dict:
    """A result's metrics by quantity, the part of a name before its
    first dot (``bucket_fill.host_paced`` and ``bucket_fill.closed`` are
    ``bucket_fill``)."""
    return {k.split(".")[0]: v["value"] for k, v in res["metrics"].items()}


def small(cell: str, in_flight: int | None = None, **over):
    """A cell cut to a size a test run holds: the same files and code,
    waves of 2, ``in_flight`` of them in flight (None: as many as the
    cell's mix) and one queued."""
    c = load_cell(cell)
    cfg = dict(c.config)
    if cfg["problem"] == "rastrigin":
        cfg.update(n_vars=12, problem_spec={"n": 12}, max_iters=6)
    else:
        cfg.update(n_per_class=2, max_iters=2)
    cfg["check"] = dict(cfg["check"], sample=2)
    cfg.update(over)
    depth = int(c.traffic["max_in_flight"] if in_flight is None
                else in_flight)
    traffic = dict(c.traffic, clients=2 * (depth + 1), wave_size=2,
                   max_in_flight=depth, warmup_waves=1)
    return dataclasses.replace(c, config=cfg, traffic=traffic)


def test_a_sound_run_is_correct():
    cell = small("r1000.closed")
    res = run.run_cell(cell, SEED, 1.0, False, device="cpu")
    assert res["correct"], res["check"]
    assert list(res)[-1] == "check" and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert set(quantities(res)) == {"setup_s", "solves_per_s"}
    answered = quantities(res)["solves_per_s"] * 1.0
    assert answered == pytest.approx(round(answered))
    assert 0 < round(answered) <= res["attempted"]


def test_a_traced_run_reads_the_program_counters():
    res = run.run_cell(small("r1000.closed"), SEED, 1.0, True, device="cpu")
    assert res["correct"], res["check"]
    q = quantities(res)
    assert q["bucket_fill"] == 100.0
    assert "wave_ms" in q
    assert q["solve_p95_ms"] > 0
    # no card: nothing to read for the device's metrics
    assert "popstep_roofline" not in q


def _unchanged_state(monkeypatch):
    from repro_torch.core import distributed

    build = distributed._build_shard_step

    def broken(*args, **kwargs):
        prepare = build(*args, **kwargs)

        def prep(quorum_mask=None):
            step = prepare(quorum_mask)

            def unchanged(parents, vals, it, live):
                _, _, improved = step(parents, vals, it, live)
                return parents, vals, torch.zeros_like(improved)
            return unchanged
        return prep
    monkeypatch.setattr(distributed, "_build_shard_step", broken)


def _half_the_wave(monkeypatch):
    from repro_torch.core import distributed

    live_of = distributed._batched_live

    def half(*args):
        live = live_of(*args)
        keep = torch.arange(live.shape[0], device=live.device)
        return live & (keep < (live.shape[0] + 1) // 2)
    monkeypatch.setattr(distributed, "_batched_live", half)


def _early_stop(monkeypatch):
    """Slot 1 of every wave stops moving after its first step, and so
    stops as a stall would, with a flat trace."""
    from repro_torch.core import distributed

    build = distributed._build_shard_step

    def broken(*args, **kwargs):
        prepare = build(*args, **kwargs)

        def prep(quorum_mask=None):
            step = prepare(quorum_mask)

            def early(parents, vals, it, live):
                nb, nv, improved = step(parents, vals, it, live)
                if it < 1:
                    return nb, nv, improved
                stop = torch.arange(live.shape[0], device=live.device) == 1
                return (torch.where(stop[:, None], parents, nb),
                        torch.where(stop, vals, nv), improved & ~stop)
            return early
        return prep
    monkeypatch.setattr(distributed, "_build_shard_step", broken)


def _value_altered(monkeypatch):
    from repro_torch.core import distributed

    fold = distributed._block_fold

    def altered(vals, ids, pop):
        v, i = fold(vals, ids, pop)
        return v * (1 + 1e-3), i
    monkeypatch.setattr(distributed, "_block_fold", altered)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_the_wave,
                                   _value_altered, _early_stop],
                         ids=["state_unchanged", "half_the_wave",
                              "answer_altered", "early_stop"])
@pytest.mark.parametrize("cell", ["r1000.closed", "rs680.closed"])
def test_a_broken_step_is_not_correct(monkeypatch, fault, cell):
    fault(monkeypatch)
    seconds = 1.0 if cell.startswith("r1000") else 3.0
    # the sample followed step by step is none of the answers: what
    # fails has to fail over every answer
    c = small(cell, max_iters=3) if fault is _early_stop else small(cell)
    if fault is _early_stop:
        c.config["check"] = dict(c.config["check"], sample=0)
    res = run.run_cell(c, SEED, seconds, False, device="cpu")
    assert not res["correct"], res["check"]
    # a number of the check fails, not merely an empty window
    failing = {k for k, v in res["check"].items()
               if not v["value"] <= v["limit"]}
    assert failing
    if fault is _early_stop:
        assert failing == {"stall_gap"}


@pytest.mark.parametrize("fault", [None, "early_stop"])
@pytest.mark.parametrize("cell", ["r1000.closed", "rs680.closed"])
def test_the_control_is_not_correct(cell, fault):
    c = small(cell, max_iters=3)
    for seed in (1, 2, 3):
        out = control_numbers(c, seed, "cpu", fault)
        assert not out["correct"], out
        if fault:
            assert out["check"]["stall_gap"]["value"] > out["check"][
                "stall_gap"]["limit"], out


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


REFERENCE = [HERE / "reference.py", HERE / "control.py",
             *sorted((HERE / "configs").glob("*.py"))]


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax",
                       "benchmarks"}


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_import_in_the_benchmark(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"repro", "jax", "jaxlib", "flax", "benchmarks"}


def test_a_run_loads_no_jax():
    code = (
        "import dataclasses, json, sys\n"
        "sys.path.insert(0, 'src')\n"
        "from dgobench import run, test_dgobench_check as t\n"
        "res = run.run_cell(t.small('r1000.closed'), 5, 1.0, True,"
        " device='cpu')\n"
        "print(json.dumps([res['correct'], run.loaded_forbidden()]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [True, []]


def test_without_the_program_the_run_refuses(tmp_path):
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "dgobench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "dgobench.run", "--workload", "rs680.closed",
         "--seed", "1", "--seconds", "1"], cwd=tmp_path,
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["rs680.closed", "r1000.closed"])
def test_a_short_run_on_the_card(card, cell):
    out = subprocess.run(
        [sys.executable, "-m", "dgobench.run", "--workload", cell,
         "--seed", str(SEED), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
