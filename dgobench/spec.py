"""Find what a cell of ``BENCHMARK.json`` runs, by the names it gives.

A cell names a configuration and a traffic mix; each is a file of its
own (``configs/<config>.json``, ``traffic/<traffic>.json``), and the
configuration's plain reference sits beside it (``configs/<config>.py``),
and the mix's ``kind`` names the loop that drives it (``loops/<kind>.py``).
The per-layer metrics a cell reports are those whose ``workloads`` list
it, or, without that key, those whose ``moves`` metric the cell reports;
each is read by ``metrics/<name>.py``.  The operation count of a
configuration's objective is ``counts/<problem>.py``.  Adding a cell,
configuration, mix or metric is adding files and entries: nothing here
changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_module(path: Path) -> ModuleType:
    """Import a file of the benchmark by its path (names such as
    ``bucket_fill.closed.py`` are not Python identifiers)."""
    if not path.is_file():
        raise FileNotFoundError(f"the benchmark has no file {path}")
    name = "dgobench._by_name." + path.relative_to(HERE).with_suffix(
        "").as_posix().replace("/", "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module      # dataclasses look their module up
    spec.loader.exec_module(module)
    return module


def read_json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"the benchmark has no file {path}")
    return json.loads(path.read_text())


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names
    loaded."""

    name: str
    chips: int
    config: dict            # configs/<config>.json
    traffic: dict           # traffic/<traffic>.json
    loop: ModuleType        # loops/<kind>.py: the loop that reads it
    reference: ModuleType   # configs/<config>.py: the plain reference
    count: ModuleType       # counts/<problem>.py
    end_to_end: list        # the BENCHMARK.json entries this cell reports
    per_layer: list
    readers: dict           # per-layer metric name -> its reader module


def _reports(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name: str) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``."""
    bench = read_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(there are {', '.join(sorted(cells))})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = read_json(ROOT / configs[w["config"]]["file"])
    traffic = read_json(HERE / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if _reports(m, name) and m["moves"] in moved]
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic,
        loop=load_module(HERE / "loops" / f"{traffic['kind']}.py"),
        reference=load_module(HERE / "configs" / f"{config['name']}.py"),
        count=load_module(HERE / "counts" / f"{config['problem']}.py"),
        end_to_end=e2e, per_layer=layer,
        readers={m["name"]: load_module(HERE / "metrics" / f"{m['name']}.py")
                 for m in layer})
