"""BENCHMARK.json against the contract's shape, and every cell's files
found by name."""
import json
import re

import pytest

from dgobench.spec import HERE, ROOT, load_cell

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["dgobench"]
    assert BENCH["command"][:2] == ["python3", "-m"]
    assert BENCH["command"][2].split(".")[0] == "dgobench"
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_units_and_lines():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in BENCH["workloads"]]
                 + [c["source"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_its_files_by_name(cell):
    c = load_cell(cell)
    assert c.config["name"] == next(w["config"] for w in BENCH["workloads"]
                                    if w["name"] == cell)
    assert callable(c.reference.values) and callable(c.reference.state)
    assert callable(c.loop.Loop) and c.loop.parse(c.traffic).wave_size >= 1
    assert callable(c.count.ops_per_restart_step)
    assert {"setup_s"} < {m["name"] for m in c.end_to_end}
    assert c.per_layer and set(c.readers) == {m["name"] for m in c.per_layer}
    for name in c.readers:
        assert (HERE / "metrics" / f"{name}.py").is_file()
        assert callable(c.readers[name].read)


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    d = json.loads((ROOT / cfg["file"]).read_text())
    assert d["name"] == cfg["name"] and d["source"] == cfg["source"]
    assert set(d["check"]["limits"]) == {
        "start_gap", "final_gap", "step_gap", "iters_off", "off_path",
        "stall_gap"}
    assert d["check"]["stall_checks"] >= 1
    assert set(cfg["reduced"]) <= set(d)
