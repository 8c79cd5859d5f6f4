"""Meta-device dry run: every (arch x shape x mesh) cell's step, run once
on meta tensors under torch's ``fake`` process group, the twin of
``repro.launch.dryrun``.

The reference lowers and compiles each cell for 256 or 512 placeholder
devices and reads the compiler's analyses.  The port has no compiler to
ask: one process joins a ``fake`` group of 256 (``pod16x16``) or 512
(``pod2x16x16``) ranks, builds the production ``DeviceMesh``, places the
cell's arguments as DTensors of meta tensors (shapes, no storage) and
runs the step eagerly as rank 0.  Per cell it writes a JSON record under
``build/repro_torch/dryrun/`` (gitignored) with:

  - ``memory_analysis``: ``argument_size_in_bytes`` and
    ``output_size_in_bytes`` a device, exact, from each DTensor's local
    shape (no peak: nothing here measures one);
  - ``cost_analysis``: ``flops`` of rank 0's local compute
    (``torch.utils.flop_counter.FlopCounterMode``);
  - ``collectives``: every collective the step issued, seen at the
    dispatcher (``"collectives_from": "torch_dispatch"``), by kind, with
    bytes and the reference's ``WIRE`` ring models;  a step runs
    eagerly, so ``count`` equals ``executed_count``.  A CPU mesh's
    DTensor spells an all-to-all as an all-gather and a chunk, so MoE's
    dispatch and return (``models.moe._a2a``, wrapped while a step is
    measured) are counted as the all-to-alls they stand for;
  - ``meta``: the cell's (microbatching, policy).

There is no HLO, so the reference's ``parse_collectives`` has no twin.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--skip-done]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --dgo-cell
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

ARTIFACTS = Path(__file__).resolve().parents[3] / "build" / "repro_torch" \
    / "dryrun"

# ring wire-byte models, bytes on the wire per participating device for
# a tensor of `size` bytes in a group of k (the reference's)
WIRE = {
    "all-gather": lambda size, k: size * (k - 1) / k,
    "all-reduce": lambda size, k: 2 * size * (k - 1) / k,
    "reduce-scatter": lambda size, k: size * (k - 1) / k,
    "all-to-all": lambda size, k: size * (k - 1) / k,
    "collective-permute": lambda size, k: size,
}

# dispatcher op name fragment -> kind
_KINDS = (("all_gather", "all-gather"), ("allgather", "all-gather"),
          ("reduce_scatter", "reduce-scatter"),
          ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
          ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
          ("broadcast", "collective-permute"))


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


def _group_size(args) -> int:
    """The group size of a collective's arguments: a process group object
    (``c10d`` ops) or a group name (functional collectives)."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in args:
        if isinstance(a, torch.ScriptObject):
            return dist.ProcessGroup.unbox(a).size()
        if isinstance(a, dist.ProcessGroup):
            return a.size()
        if isinstance(a, str):
            try:
                return _resolve_process_group(a).size()
            except Exception:  # noqa: BLE001 — not a group name
                continue
    return 1


def _first(x):
    while isinstance(x, (list, tuple)):
        x = x[0]
    return x


def _size(name: str, kind: str, args, k: int) -> int:
    """The reference's size of a collective: an all-gather's output, a
    reduce-scatter's input, an all-reduce's or all-to-all's tensor.
    ``c10d.*`` ops take (output, input, ...) or lists; the functional
    ones (input, ...)."""
    functional = "_c10d_functional" in name
    if kind == "all-gather":
        if functional:
            return k * _nbytes(args[0])
        if "_base" in name:
            return _nbytes(args[0])
        return k * _nbytes(_first(args[1]))
    if kind == "reduce-scatter":
        if functional:
            return _nbytes(args[0])
        if "_base" in name:
            return _nbytes(args[1])
        return k * _nbytes(_first(args[0]))
    if kind == "all-to-all" and not functional:
        return _nbytes(_first(args[1]))
    return _nbytes(_first(args[0]))


class CollectiveLog(TorchDispatchMode):
    """Records each collective op (kind, bytes, group size) that reaches
    the dispatcher, but those issued inside MoE's all-to-all
    (:meth:`a2a`), which it records as one all-to-all each."""

    def __init__(self):
        super().__init__()
        self.records: list[dict] = []
        self._inside = 0

    def a2a(self, inner):
        """``moe._a2a`` recording its all-to-all."""
        def wrapped(x, shard, what):
            self._inside += 1
            try:
                out = inner(x, shard, what)
            finally:
                self._inside -= 1
            local = x.to_local()
            self.records.append({
                "kind": "all-to-all", "op": "moe." + what,
                "bytes": float(local.numel() * local.element_size()),
                "group": math.prod(dict(zip(x.device_mesh.mesh_dim_names,
                                            x.device_mesh.mesh.shape))[a]
                                   for a in shard)})
            return out
        return wrapped

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func)
        kind = next((k for frag, k in _KINDS if frag in name), None)
        if kind is None or "wait" in name or self._inside:
            return out
        flat = list(args) + list((kwargs or {}).values())
        k = _group_size(flat)
        self.records.append({"kind": kind,
                             "bytes": float(_size(name, kind, args, k)),
                             "group": k, "op": name})
        return out


def summarize_collectives(colls: list[dict]) -> dict:
    summary: dict = {}
    for c in colls:
        s = summary.setdefault(c["kind"], {"count": 0, "bytes": 0.0,
                                           "wire_bytes": 0.0,
                                           "executed_count": 0,
                                           "executed_wire_bytes": 0.0})
        k = c["group"]
        wire = WIRE[c["kind"]](c["bytes"], max(k, 2)) if k > 1 else 0.0
        s["count"] += 1
        s["bytes"] += c["bytes"]
        s["wire_bytes"] += wire
        s["executed_count"] += 1
        s["executed_wire_bytes"] += wire
    return summary


def join_fake_group(world_size: int) -> None:
    """One process standing for every rank of a ``fake`` group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _tree_bytes(values, layouts) -> int:
    from repro_torch.launch.sharding import Layout
    if isinstance(layouts, Layout):
        return layouts.nbytes(values) if isinstance(values, torch.Tensor) \
            else 0
    if isinstance(values, dict):
        return sum(_tree_bytes(v, layouts[k]) for k, v in values.items())
    if isinstance(values, (list, tuple)):
        return sum(_tree_bytes(v, s) for v, s in zip(values, layouts))
    return 0


def cell_bytes(cell) -> dict:
    """Argument and output bytes a device of a cell (exact)."""
    return {"argument_size_in_bytes": _tree_bytes(cell.arg_specs,
                                                  cell.in_shardings),
            "output_size_in_bytes": _tree_bytes(cell.out_specs,
                                                cell.out_shardings)}


def measure(step, args) -> tuple[dict, dict, float]:
    """Run ``step(*args)`` once; (collectives summary, flops, seconds)."""
    from repro_torch.models import moe
    log = CollectiveLog()
    flops = FlopCounterMode(display=False)
    inner, moe._a2a = moe._a2a, log.a2a(moe._a2a)
    t0 = time.time()
    try:
        with flops, log:
            step(*args)
    finally:
        moe._a2a = inner
    return (summarize_collectives(log.records),
            {"flops": float(flops.get_total_flops())}, time.time() - t0)


def _mesh_tag(multi_pod: bool, policy=None) -> str:
    tag = "pod2x16x16" if multi_pod else "pod16x16"
    return f"{tag}__{policy}" if policy and policy != "fsdp" else tag


def run_cell(arch_name: str, shape_name: str, multi_pod: bool,
             out_dir: Path = ARTIFACTS, arch_override=None, policy=None,
             mesh=None, shape_override=None) -> dict:
    """One cell's record.  ``mesh`` overrides the production mesh (the
    process group must then hold its ranks), ``shape_override`` the
    input shape of ``shape_name``."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.shapes import SHAPES, skip_reason
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import build_cell, place
    from repro_torch.optim.gradient import AdamWConfig

    arch = arch_override or get_arch(arch_name)
    shape = shape_override or SHAPES[shape_name]
    mesh_tag = _mesh_tag(multi_pod, policy)
    record: dict = {"arch": arch_name, "shape": shape_name, "mesh": mesh_tag}
    out_dir.mkdir(parents=True, exist_ok=True)
    fname = out_dir / f"{arch_name}__{shape_name}__{mesh_tag}.json"
    reason = skip_reason(arch, shape)
    if reason:
        record.update(status="skipped", reason=reason)
        fname.write_text(json.dumps(record, indent=1))
        return record
    if mesh is None:
        join_fake_group(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod)
    opt = AdamWConfig(moment_dtype="bfloat16")
    cell = build_cell(arch, shape, mesh, opt_cfg=opt, policy=policy)
    args = place(cell.arg_specs, cell.in_shardings)
    colls, cost, secs = measure(cell.step, args)
    record.update({
        "status": "ok",
        "mesh_shape": dict(zip(mesh.mesh_dim_names,
                               (int(n) for n in mesh.mesh.shape))),
        "step_s": round(secs, 1),
        "memory_analysis": cell_bytes(cell),
        "cost_analysis": cost,
        "collectives": colls,
        "collectives_from": "torch_dispatch",
        "meta": cell.meta,
    })
    fname.write_text(json.dumps(record, indent=1))
    return record


def run_dgo_cell(multi_pod: bool, out_dir: Path = ARTIFACTS, mesh=None,
                 arch_override=None, batch: int = 8, seq: int = 512) -> dict:
    """The paper's technique at production scale: one subspace-DGO
    iteration of xlstm-125m with the population over every mesh axis
    (pod x data x model: the MP-1 'PE array'); parameters and batch
    replicated, each shard evaluating ceil((2N-1)/P) children (NCUBE
    virtual processing).  The collective table shows the paper's
    property: an iteration's only traffic is the all-gathers of (value,
    child id) pairs, O(P x 8 bytes), whatever the model's size."""
    from repro_torch.configs import get_arch
    from repro_torch.core import prng
    from repro_torch.core.encoding import Encoding
    from repro_torch.core.subspace import make_dgo_train_step
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.layers import abstract_params
    from repro_torch.models.lm import lm_loss, model_spec

    arch = arch_override or get_arch("xlstm-125m")
    mesh_tag = _mesh_tag(multi_pod) + "__dgo"
    if mesh is None:
        join_fake_group(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod)
    pop_axes = tuple(a for a in ("pod", "data", "model")
                     if a in mesh.mesh_dim_names)
    enc = Encoding(n_vars=64, bits=4, lo=-1.0, hi=1.0)

    def loss_fn(params, b):
        return lm_loss(params, arch, b, dtype=torch.bfloat16)

    step_fn = make_dgo_train_step(loss_fn, enc, mesh, pop_axes=pop_axes,
                                  alpha=2.0)
    params_abs = abstract_params(model_spec(arch), dtype=torch.bfloat16)
    meta = {"device": "meta"}
    batch_abs = {"tokens": torch.zeros((batch, seq), dtype=torch.long,
                                       **meta),
                 "labels": torch.zeros((batch, seq), dtype=torch.long,
                                       **meta)}
    args = (params_abs, batch_abs,
            torch.zeros((enc.n_bits,), dtype=torch.int8, **meta),
            torch.zeros((), dtype=torch.float32, **meta),
            prng.PRNGKey(0))
    colls, cost, secs = measure(step_fn, args)
    n_shards = math.prod(int(mesh.mesh.shape[mesh.mesh_dim_names.index(a)])
                         for a in pop_axes)
    record = {
        "arch": "xlstm-125m+subspace-dgo", "shape": f"b{batch}xs{seq}",
        "mesh": mesh_tag, "status": "ok",
        "population": enc.population, "subspace_dims": enc.n_vars,
        "shards": n_shards,
        "children_per_shard": -(-enc.population // n_shards),
        "step_s": round(secs, 1),
        "collectives": colls,
        "collectives_from": "torch_dispatch",
        "cost_analysis": cost,
    }
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"dgo-subspace-xlstm__{mesh_tag}.json").write_text(
        json.dumps(record, indent=1))
    return record


def main(argv=None) -> None:
    from repro_torch.configs import REGISTRY
    from repro_torch.configs.shapes import SHAPES

    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--policy", default="fsdp",
                    choices=["fsdp", "zero1", "dp", "auto"])
    ap.add_argument("--dgo-cell", action="store_true",
                    help="run the subspace-DGO production cell instead")
    args = ap.parse_args(argv)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    if args.dgo_cell:
        for mp in meshes:
            rec = run_dgo_cell(mp)
            w = sum(v["executed_wire_bytes"]
                    for v in rec["collectives"].values())
            print(f"[ok] dgo-subspace-xlstm {rec['mesh']}: "
                  f"pop={rec['population']} shards={rec['shards']} "
                  f"children/shard={rec['children_per_shard']} "
                  f"step={rec['step_s']}s wire={w / 1e9:.9f}GB "
                  f"collectives={json.dumps(rec['collectives'])}")
        return

    archs = list(REGISTRY) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    failures = []
    for mp in meshes:
        for a in archs:
            for s in shapes:
                pol = None if args.policy == "auto" else args.policy
                tag = _mesh_tag(mp, pol)
                f = ARTIFACTS / f"{a}__{s}__{tag}.json"
                if args.skip_done and f.exists():
                    print(f"[skip-done] {a} {s} {tag}")
                    continue
                try:
                    rec = run_cell(a, s, mp, policy=pol)
                    if rec["status"] == "ok":
                        ma = rec["memory_analysis"]
                        print(f"[ok] {a:20s} {s:12s} {tag}: "
                              f"step={rec['step_s']}s "
                              f"args/device={ma['argument_size_in_bytes']} "
                              f"flops={rec['cost_analysis']['flops']:.3e} "
                              f"meta={json.dumps(rec['meta'])} "
                              f"collectives={json.dumps({k: v['count'] for k, v in rec['collectives'].items()})}")
                    else:
                        print(f"[skipped] {a} {s}: {rec['reason'][:60]}")
                except Exception as e:  # noqa: BLE001 — report and continue
                    failures.append((a, s, tag, repr(e)))
                    print(f"[FAIL] {a} {s} {tag}: {e!r}")
                    traceback.print_exc()
    if failures:
        raise SystemExit(f"{len(failures)} cells failed: "
                         f"{[(a, s, t) for a, s, t, _ in failures]}")


if __name__ == "__main__":
    main()
