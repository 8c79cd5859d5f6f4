"""Logical-axis sharding rules of the port (``repro_torch.launch.
sharding``): the reference's nine cases of ``tests/test_sharding.py`` on
``spec_for`` (DTensor placements, spelled back as partition specs), over
plain ``{axis: size}`` meshes; the layout arithmetic; the cache
heuristics; and a dim split over ``("pod", "data")``, which DTensor must
give to the same mesh coordinate as JAX does (pod-major)."""

import pytest
import torch
from torch.distributed.tensor import Shard
from torch.distributed.tensor._utils import (
    _compute_local_shape_and_global_offset)

from repro.compat import abstract_mesh
from repro.launch import sharding as jsh
from repro_torch.launch.sharding import (
    SERVE_RULES, TRAIN_RULES, Layout, batch_sharding, cache_shardings,
    replicated, spec_for)
from torch_fleet import json_lines, reference

MESH1 = {"data": 16, "model": 16}
MESH2 = {"pod": 2, "data": 16, "model": 16}
JMESH = {id(MESH1): abstract_mesh((16, 16), ("data", "model")),
         id(MESH2): abstract_mesh((2, 16, 16), ("pod", "data", "model"))}

# (shape, logical axes, mesh, rules, the reference test's spec)
CASES = {
    "mlp_weight_fsdp_tp": ((4096, 13440), ("embed", "mlp"), MESH1,
                           "TRAIN", ("data", "model")),
    "multi_pod_fsdp_uses_both_axes": ((7168, 2048), ("embed", "mlp"), MESH2,
                                      "TRAIN", (("pod", "data"), "model")),
    "qwen2_heads_fallback_to_replicated": (
        (1536, 12, 128), ("embed", "heads", "head_dim"), MESH1, "TRAIN",
        ("data",)),
    "whisper_odd_vocab_falls_back": ((51865, 1024), ("vocab", "embed"),
                                     MESH1, "TRAIN", (None, "data")),
    "mesh_axis_used_at_most_once_per_tensor": (
        (2048, 2048), ("embed", "embed"), MESH1, "TRAIN", ("data",)),
    "mqa_single_kv_head_replicated": (
        (6144, 1, 128), ("embed", "kv_heads", "head_dim"), MESH1, "TRAIN",
        ("data",)),
    "experts_ep_over_batch_axes_tp_over_model": (
        (256, 7168, 2048), ("experts", "embed", "expert_mlp"), MESH1,
        "TRAIN", ("data", None, "model")),
    "experts_multi_pod": (
        (256, 7168, 2048), ("experts", "embed", "expert_mlp"), MESH2,
        "TRAIN", (("pod", "data"), None, "model")),
    "serve_rules_keep_params_dp_replicated": (
        (4096, 13440), ("embed", "mlp"), MESH1, "SERVE", (None, "model")),
    "partial_divisibility_prefix": ((2050 * 2, 64), ("embed", None), MESH2,
                                    "TRAIN", ("pod",)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_spec_for_matches_the_reference(case):
    shape, logical, mesh, rules, want = CASES[case]
    placements = spec_for(shape, logical, mesh,
                          TRAIN_RULES if rules == "TRAIN" else SERVE_RULES)
    got = Layout(mesh, placements).spec(len(shape))
    assert got == want
    jrules = jsh.TRAIN_RULES if rules == "TRAIN" else jsh.SERVE_RULES
    assert got == tuple(jsh.spec_for(shape, logical, JMESH[id(mesh)],
                                     jrules))


def test_rules_are_the_references():
    assert TRAIN_RULES == jsh.TRAIN_RULES
    assert SERVE_RULES == jsh.SERVE_RULES


def test_layout_arithmetic():
    lay = Layout(MESH2, (Shard(0), Shard(0), Shard(1)))
    assert lay.spec(2) == (("pod", "data"), "model")
    assert lay.shard_shape((7168, 2048)) == (224, 128)
    t = torch.empty((7168, 2048), dtype=torch.bfloat16, device="meta")
    assert lay.nbytes(t) == 224 * 128 * 2
    assert replicated(MESH1).spec(3) == ()
    assert batch_sharding(MESH2, 3, batch_dim=1).spec(3) == (
        None, ("pod", "data"))
    assert lay == Layout(dict(MESH2), (Shard(0), Shard(0), Shard(1)))


def test_cache_heuristics():
    meta = {"device": "meta", "dtype": torch.bfloat16}
    cache = {"seg": [(torch.empty((128, 4096, 16, 128), **meta),) * 2],
             "long": [torch.empty((1, 524288, 16, 128), **meta)],
             "pos": 7}
    got = cache_shardings(cache, MESH1, batch=128, cache_len=4096,
                          head_counts=(16,))
    assert got["seg"][0][0].spec(4) == ("data", None, "model")
    # batch 1: the sequence dim takes the batch axes (sequence parallel)
    got = cache_shardings(cache, MESH1, batch=1, cache_len=524288,
                          head_counts=(16,))
    assert got["long"][0].spec(4) == (None, "data", "model")


_JAX_POD_MAJOR = """
import json, jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.compat import make_mesh
mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
sh = NamedSharding(mesh, P(("pod", "data"), "model"))
idx = sh.devices_indices_map((8, 4))
coords = {}
for c, d in zip(__import__("itertools").product(range(2), range(2), range(2)),
                mesh.devices.flat):
    rows, cols = idx[d]
    coords[str(list(c))] = [rows.start, cols.start]
print(json.dumps(coords))
"""


def test_pod_data_split_is_pod_major_as_in_jax():
    want = json_lines(reference(_JAX_POD_MAJOR, devices=8))[-1]
    placements = (Shard(0), Shard(0), Shard(1))
    for p in range(2):
        for d in range(2):
            for m in range(2):
                shape, off = _compute_local_shape_and_global_offset(
                    (8, 4), (2, 2, 2), [p, d, m], placements)
                assert shape == (2, 2)
                assert list(off) == want[str([p, d, m])]


@pytest.mark.parametrize("mesh", [MESH1, MESH2, {"data": 4, "model": 2},
                                  {"pod": 2, "data": 3, "model": 1}])
@pytest.mark.parametrize("experts,tokens", [(160, 4096), (256, 512),
                                            (8, 96), (6, 100)])
def test_expert_parallel_axes_and_groups_are_the_references(mesh, experts,
                                                            tokens):
    """``moe._ep_axes`` / ``_group_count`` under a mesh: the reference's
    (its contextvar mesh an abstract one of the same shape)."""
    from repro.models import moe as jmoe
    from repro_torch.models import moe as tmoe
    jm = abstract_mesh(tuple(mesh.values()), tuple(mesh))
    tok = jmoe.CURRENT_MESH.set(jm)
    try:
        want = (jmoe._ep_axes(experts), jmoe._group_count(experts, tokens))
    finally:
        jmoe.CURRENT_MESH.reset(tok)
    got = (tmoe._ep_axes(experts, mesh),
           tmoe._group_count(experts, tokens, mesh))
    assert got == want
    assert tmoe._ep_axes(experts) is None            # no mesh: one group
    assert tmoe._group_count(experts, tokens) == 1


def test_moe_without_expert_parallelism_is_the_single_group():
    """No mesh, or a mesh whose EP axes give one group: moe_forward is
    the single-group forward, bit for bit."""
    from repro_torch.models import moe as tmoe
    cfg = tmoe.MoEConfig(d_model=16, n_experts=4, top_k=2, d_ff_expert=8,
                         n_shared=1, capacity_factor=1.0)
    g = torch.Generator().manual_seed(0)
    from repro_torch.models.layers import init_params
    p = init_params(tmoe.moe_spec(cfg), g).tree()
    x = torch.randn((2, 6, 16), generator=g)
    want = tmoe.moe_forward(p, cfg, x)
    for mesh in ({"data": 1, "model": 4}, {"pod": 1, "data": 1, "model": 1}):
        tok = tmoe.CURRENT_MESH.set(mesh)
        try:
            got = tmoe.moe_forward(p, cfg, x)
        finally:
            tmoe.CURRENT_MESH.reset(tok)
        assert not tmoe.ep_active(cfg.n_experts, mesh)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
