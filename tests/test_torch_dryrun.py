"""The port's meta-device dry run (``repro_torch.launch.dryrun``) under
torch's ``fake`` process group, at small fake meshes (2 x 2 and
2 x 2 x 2) and ``reduced()`` widths: each cell's argument bytes a device
equal the reference cell's (its ``build_cell`` on an abstract mesh of the
same shape), the train cells' tables hold the FSDP collectives
(all-gathers forward, reduce-scatters of the gradients), deepseek's MoE
its all-to-alls, and the subspace-DGO cell's table holds only the
all-gathers of (value, child id) pairs: 8 bytes a shard.  The fake group
is global to a process, so the port runs in a subprocess."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import pytest

from repro.compat import abstract_mesh
from repro.configs import get_arch as jget, reduced as jreduced
from repro.configs.shapes import SHAPES as JSHAPES
from repro.launch.steps import build_cell as jbuild
from repro.optim.gradient import AdamWConfig
from torch_fleet import EMIT, json_lines, reference

NAMES = ("qwen2-1.5b", "deepseek-v3-671b", "whisper-medium")
# the shapes cut to (seq, global batch) that a CPU runs in seconds
SHAPES = {"train_4k": (64, 16), "decode_32k": (256, 8)}
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}

_CODE = """
import dataclasses, logging
import torch.distributed as dist
from repro_torch.configs.shapes import SHAPES as FULL_SHAPES
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_arch, reduced
from repro_torch.launch import dryrun
logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
    logging.ERROR)
out = {}
for tag, (shape, axes) in __MESHES__.items():
    dryrun.join_fake_group(len(axes) and __import__("math").prod(shape))
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=axes)
    for name in __NAMES__:
        for s, (seq, batch) in __SHAPES__.items():
            cut = dataclasses.replace(FULL_SHAPES[s], seq_len=seq,
                                      global_batch=batch)
            rec = dryrun.run_cell(name, s, len(shape) == 3,
                                  out_dir=__OUT__ / tag,
                                  arch_override=reduced(get_arch(name)),
                                  mesh=mesh, shape_override=cut)
            out[f"{name}:{s}:{tag}"] = rec
    arch = dataclasses.replace(reduced(get_arch("xlstm-125m")), n_layers=2)
    out[f"dgo:{tag}"] = dryrun.run_dgo_cell(len(shape) == 3,
                                            out_dir=__OUT__ / tag,
                                            mesh=mesh, arch_override=arch,
                                            batch=2, seq=8)
emit(out)
"""


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("dryrun")
    code = EMIT + _CODE.replace("__MESHES__", repr(MESHES)).replace(
        "__NAMES__", repr(NAMES)).replace("__SHAPES__", repr(SHAPES)).replace(
        "__OUT__", f"__import__('pathlib').Path({str(out_dir)!r})")
    return json_lines(reference(code, devices=1, timeout=420))[-1]


def _ref_arg_bytes(name, shape_name, tag) -> int:
    shape, axes = MESHES[tag]
    seq, batch = SHAPES[shape_name]
    cut = dataclasses.replace(JSHAPES[shape_name], seq_len=seq,
                              global_batch=batch)
    # the reference's dry run keeps its moments in bfloat16, as the port's
    cell = jbuild(jreduced(jget(name)), cut, abstract_mesh(shape, axes),
                  opt_cfg=AdamWConfig(moment_dtype="bfloat16"))
    total = 0
    leaves = jax.tree_util.tree_flatten_with_path(cell.arg_specs)[0]
    shards = jax.tree.leaves(cell.in_shardings,
                             is_leaf=lambda x: hasattr(x, "shard_shape"))
    for (path, s), sh in zip(leaves, shards):
        if s.ndim == 0 and getattr(path[-1], "key", None) == "pos":
            continue            # the port's cache position is a host int
        total += math.prod(sh.shard_shape(s.shape)) * jnp.dtype(
            s.dtype).itemsize
    return total


@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("name", NAMES)
def test_cell_argument_bytes_are_the_references(records, name, tag):
    for s in SHAPES:
        rec = records[f"{name}:{s}:{tag}"]
        assert rec["status"] == "ok"
        assert rec["collectives_from"] == "torch_dispatch"
        assert rec["memory_analysis"]["argument_size_in_bytes"] == \
            _ref_arg_bytes(name, s, tag), (s, tag)
        assert rec["cost_analysis"]["flops"] > 0


@pytest.mark.parametrize("tag", list(MESHES))
def test_train_tables_hold_the_fsdp_and_expert_collectives(records, tag):
    for name in NAMES:
        colls = records[f"{name}:train_4k:{tag}"]["collectives"]
        assert colls["all-gather"]["count"] > 0, name
        assert colls["reduce-scatter"]["count"] > 0, name
        for c in colls.values():
            assert c["executed_count"] == c["count"]
            assert c["wire_bytes"] > 0
    moe = records[f"deepseek-v3-671b:train_4k:{tag}"]["collectives"]
    assert moe["all-to-all"]["count"] > 0
    for name in ("qwen2-1.5b", "whisper-medium"):
        assert "all-to-all" not in records[f"{name}:train_4k:{tag}"][
            "collectives"]


@pytest.mark.parametrize("tag", list(MESHES))
def test_dgo_cell_exchanges_only_value_id_pairs(records, tag):
    rec = records[f"dgo:{tag}"]
    shape, _ = MESHES[tag]
    n = math.prod(shape)
    assert rec["shards"] == n
    assert rec["children_per_shard"] == -(-rec["population"] // n)
    assert set(rec["collectives"]) == {"all-gather"}
    gathers = rec["collectives"]["all-gather"]
    assert gathers["count"] == len(shape)         # one a population axis
    # the gathered pairs: 8 bytes a shard, axis after axis
    want, held = 0, 1
    for size in shape:
        held *= size
        want += 8 * held
    assert gathers["bytes"] == want
