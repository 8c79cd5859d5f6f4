"""The port across processes, on a 4-rank gloo fleet
(``repro_torch.launch.launcher --processes 4``), against the reference
on 4 host devices: int8 gradient compression with error feedback
(``runtime/compress.py``), MoE's expert-parallel token groups
(``models/moe.py``), subspace DGO's production step
(``core/subspace.make_dgo_train_step``), ``runtime.elastic.remesh`` /
``reshard_tree`` and ``launch.sharding.reshard_fwd_bwd``'s gradient
layout.  One fleet run and one reference run serve every test; inputs
come from numpy seeds through an ``.npz`` file.

Bars: compressed gradients and error states within one quantum
(``max_scale / n``) an element of the reference's, and the reference's
own ``rel < 0.05`` against the exact gradient; MoE outputs rtol = atol =
1e-5 with the same kept pairs; the DGO step's 25 iterations the same
bits (the near-tie rule of ``tests/test_torch_solver.py``) and values
within rtol 1e-5."""
import numpy as np
import pytest

from test_torch_solver import near_tie_step
from torch_fleet import by_rank, fleet, json_lines, reference

MOE = dict(d_model=64, n_experts=8, top_k=2, d_ff_expert=32, n_shared=1)


def _inputs(path):
    rng = np.random.default_rng(0)
    f32 = np.float32
    d = {
        # compression: a linear model, batch 32 over 4 ranks
        "cw": rng.standard_normal((16, 4)).astype(f32),
        "cx": rng.standard_normal((32, 16)).astype(f32),
        "cy": rng.standard_normal((32, 4)).astype(f32),
        # MoE: 8 sequences of 6 tokens, 4 groups of 12 tokens
        "mx": rng.standard_normal((8, 6, 64)).astype(f32),
        "router": (0.3 * rng.standard_normal((64, 8))).astype(f32),
        "gate": (rng.standard_normal((8, 64, 32)) / 8).astype(f32),
        "up": (rng.standard_normal((8, 64, 32)) / 8).astype(f32),
        "down": (rng.standard_normal((8, 32, 64)) / 6).astype(f32),
        "sh_gate": (rng.standard_normal((64, 32)) / 8).astype(f32),
        "sh_up": (rng.standard_normal((64, 32)) / 8).astype(f32),
        "sh_down": (rng.standard_normal((32, 64)) / 6).astype(f32),
        # subspace DGO: the reference test's regression model
        "dx": rng.standard_normal((64, 8)).astype(f32),
        "dwt": rng.standard_normal((8, 1)).astype(f32),
    }
    np.savez(path, **d)


_REF = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map
from repro.core.encoding import Encoding, decode, encode
from repro.core.subspace import apply_subspace, make_dgo_train_step
from repro.launch.mesh import make_host_mesh
from repro.models import moe as jmoe
from repro.runtime.compress import init_error_state, make_compressed_dp_grad_fn
d = np.load(sys.argv[1])
out = {}
mesh = make_host_mesh(model=1)
# compression, two steps of error feedback
w = {"w": jnp.asarray(d["cw"])}
batch = (jnp.asarray(d["cx"]), jnp.asarray(d["cy"]))
def closs(p, b):
    return jnp.mean((b[0] @ p["w"] - b[1]) ** 2)
fn = make_compressed_dp_grad_fn(closs, mesh)
err = init_error_state(w)
steps = []
for _ in range(2):
    g, err, l = fn(w, batch, err)
    steps.append({"g": np.asarray(g["w"]).tolist(),
                  "err": np.asarray(err["w"]).tolist(), "loss": float(l)})
out["compress"] = steps
out["exact"] = np.asarray(jax.grad(lambda p: closs(p, batch))(w)["w"]).tolist()
# MoE with 4 expert-parallel groups
cfg = jmoe.MoEConfig(**{MOE}, capacity_factor=1.0)
p = {k: jnp.asarray(d[k]) for k in ("router", "gate", "up", "down")}
p["shared"] = {k: {"w": jnp.asarray(d["sh_" + k])}
               for k in ("gate", "up", "down")}
def moe_fn(p, x):
    tok = jmoe.CURRENT_MESH.set(mesh)
    try:
        return jmoe.moe_forward(p, cfg, x)
    finally:
        jmoe.CURRENT_MESH.reset(tok)
with mesh:
    y, aux = jax.jit(moe_fn)(p, jnp.asarray(d["mx"]))
out["moe_y"] = np.asarray(y).tolist()
out["moe_aux"] = float(aux)
xg = jnp.asarray(d["mx"]).reshape(4, -1, 64)
cap = int(1.0 * 2 * xg.shape[1] / 8) + 1
out["moe_keep"] = [np.asarray(jmoe._route_group(p, cfg, xg[i], cap)[1][4]
                              ).tolist() for i in range(4)]
# subspace DGO, 25 steps on 4 devices
from repro.compat import AxisType, make_mesh
dmesh = make_mesh((4,), ("data",), axis_types=(AxisType.Auto,))
w0 = {"w": jnp.zeros((8, 1))}
xs = jnp.asarray(d["dx"]); ys = xs @ jnp.asarray(d["dwt"])
def dloss(p, b):
    return jnp.mean((b[0] @ p["w"] - b[1]) ** 2)
enc = Encoding(n_vars=8, bits=6, lo=-2.0, hi=2.0)
key = jax.random.PRNGKey(7)
mapped = jax.jit(shard_map(make_dgo_train_step(dloss, enc, dmesh, alpha=4.0),
                           mesh=dmesh, in_specs=(P(),) * 5,
                           out_specs=(P(),) * 3, check_vma=False))
bits = encode(jnp.zeros(8), enc)
val = dloss(apply_subspace(w0, decode(bits, enc), key, 4.0), (xs, ys))
hist = [[float(val), np.asarray(bits).tolist(), False]]
for _ in range(25):
    bits, val, imp = mapped(w0, (xs, ys), bits, val, key)
    hist.append([float(val), np.asarray(bits).tolist(), bool(imp)])
out["dgo"] = hist
print(json.dumps(out))
"""

_PORT = """
import sys
import numpy as np, torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.debug import CommDebugMode
from repro_torch.core import prng
from repro_torch.core.encoding import Encoding, decode, encode
from repro_torch.core.subspace import apply_subspace, make_dgo_train_step
from repro_torch.launch.mesh import (
    make_host_mesh, mesh_geometry, replicate_to_mesh, spans_processes)
from repro_torch.launch.sharding import Layout, reshard_fwd_bwd
from repro_torch.launch.steps import gathered
from repro_torch.models import moe as tmoe
from repro_torch.runtime import init_error_state, make_compressed_dp_grad_fn, remesh, reshard_tree
d = np.load(sys.argv[1])
r, world = dist.get_rank(), dist.get_world_size()
mesh = make_host_mesh(model=1, device="cpu")
out = {"rank": r, "spans": spans_processes(mesh),
       "geometry": mesh_geometry(mesh)}
rep_t = replicate_to_mesh(torch.arange(6.0), mesh)
out["replicated"] = [[str(pl) for pl in rep_t.placements],
                     rep_t.to_local().tolist()]
T = torch.from_numpy
def shard(a):
    n = a.shape[0] // world
    return a[r * n:(r + 1) * n]
# compression
w = {"w": T(d["cw"])}
batch = (T(shard(d["cx"])), T(shard(d["cy"])))
def closs(p, b):
    return torch.mean((b[0] @ p["w"] - b[1]) ** 2)
fn = make_compressed_dp_grad_fn(closs, mesh)
err = init_error_state(w)
steps = []
for _ in range(2):
    g, err, l = fn(w, batch, err)
    steps.append({"g": g["w"].tolist(), "err": err["w"].tolist(),
                  "loss": float(l)})
out["compress"] = steps
# MoE expert-parallel groups: this rank's 2 sequences are its group
cfg = tmoe.MoEConfig(**{MOE}, capacity_factor=1.0)
p = {"router": T(d["router"])}
for k in ("gate", "up", "down"):
    p[k] = distribute_tensor(T(d[k]), mesh, [Shard(0), Replicate()])
p["shared"] = {k: {"w": T(d["sh_" + k])} for k in ("gate", "up", "down")}
x = T(shard(d["mx"]))
tok = tmoe.CURRENT_MESH.set(mesh)
with CommDebugMode() as comm:
    y, aux = tmoe.moe_forward(p, cfg, x)
tmoe.CURRENT_MESH.reset(tok)
out["moe_y"] = y.tolist()
out["moe_aux"] = float(aux)
cap = tmoe.capacity_of(cfg, x.shape[0] * x.shape[1])
out["moe_keep"] = tmoe._route_group(p, cfg, x.reshape(-1, 64), cap)[1][4].tolist()
out["moe_comm"] = sum(comm.get_comm_counts().values())
# subspace DGO: 25 steps on the (4, 1) mesh, and on one rank alone
w0 = {"w": torch.zeros((8, 1))}
xs = T(d["dx"]); ys = xs @ T(d["dwt"])
def dloss(p, b):
    return torch.mean((b[0] @ p["w"] - b[1]) ** 2)
enc = Encoding(n_vars=8, bits=6, lo=-2.0, hi=2.0)
key = prng.PRNGKey(7)
def run(m):
    step = make_dgo_train_step(dloss, enc, m, alpha=4.0)
    bits = encode(torch.zeros(8), enc)
    val = dloss(apply_subspace(w0, decode(bits, enc), key, 4.0), (xs, ys))
    hist = [[float(val), bits.tolist(), False]]
    for _ in range(25):
        bits, val, imp = step(w0, (xs, ys), bits, val, key)
        hist.append([float(val), bits.tolist(), bool(imp)])
    return hist
out["dgo"] = run(mesh)
if r == 0:
    out["dgo_alone"] = run(None)
# remesh onto the first 3 ranks, and reshard a tree onto it
full = torch.arange(24, dtype=torch.float32).reshape(6, 4)
tree = {"a": distribute_tensor(full, mesh, [Shard(0), Replicate()])}
small = remesh(3)
moved = reshard_tree(tree, {"a": Layout(small, (Shard(0), Replicate()))})
out["remesh"] = [list(small.mesh.shape), small.get_coordinate()]
if r < 3:
    out["reshard_local"] = moved["a"].to_local().tolist()
# reshard_fwd_bwd: storage Shard(0), use Replicate; the gradient comes
# back sharded, through a reduce-scatter
wt = distribute_tensor(T(d["cw"]), mesh, [Shard(0), Replicate()])
wt.requires_grad_()
with CommDebugMode() as comm:
    use = reshard_fwd_bwd(wt, Layout(mesh, (Replicate(), Replicate())),
                          Layout(mesh, (Shard(0), Replicate())))
    loss = ((batch[0] @ gathered(use, ("data",))) ** 2).sum()
    loss.backward()
out["rs_placements"] = [str(pl) for pl in wt.grad.placements]
out["rs_grad_local"] = wt.grad.to_local().tolist()
out["rs_comm"] = {str(k): v for k, v in comm.get_comm_counts().items()}
emit(out)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    path = tmp_path_factory.mktemp("fleet") / "in.npz"
    _inputs(path)
    def fill(code, head):
        return code.replace("**{MOE}", "**" + repr(MOE)).replace(
            head, f"{head}; sys.argv = ['', {str(path)!r}]", 1)
    ref = json_lines(reference(fill(_REF, "import json, sys"),
                               devices=4))[-1]
    code = fill(_PORT, "import sys")
    ranks = by_rank(fleet(code, processes=4, timeout=420))
    return ref, ranks, np.load(path)


def test_fleet_mesh_spans_the_processes(runs):
    _, ranks, _ = runs
    assert sorted(ranks) == [0, 1, 2, 3]
    for r in ranks:
        assert ranks[r]["spans"]
        assert ranks[r]["geometry"] == [["data", 4], ["model", 1]]
        assert ranks[r]["replicated"] == [["R", "R"],
                                          [0.0, 1.0, 2.0, 3.0, 4.0, 5.0]]


def _max_scales(d, ranks) -> list:
    """Each step's shared int8 scale: the largest over the ranks of
    max|local gradient + error| / 127 (the error each rank carried)."""
    w, out = d["cw"].astype(np.float64), []
    errs = [np.zeros_like(w)] * 4
    for step in range(2):
        scales = []
        for r in range(4):
            x, y = d["cx"][8 * r:8 * r + 8], d["cy"][8 * r:8 * r + 8]
            g = 2.0 / y.size * x.T @ (x @ w - y)
            scales.append(np.abs(g + errs[r]).max() / 127.0)
        out.append(max(scales))
        errs = [np.asarray(ranks[r]["compress"][step]["err"])
                for r in range(4)]
    return out


def test_compressed_gradients_match_the_reference(runs):
    """Within one quantum (max_scale / n) an element: the gradients on
    every rank, the error state on rank 0 (the reference's shard_map
    returns shard 0's)."""
    ref, ranks, d = runs
    quanta = [s / 4 for s in _max_scales(d, ranks)]
    for r in ranks:
        for q, got, want in zip(quanta, ranks[r]["compress"],
                                ref["compress"]):
            g, wg = np.asarray(got["g"]), np.asarray(want["g"])
            assert np.abs(g - wg).max() <= q, r
            if r == 0:
                e, we = np.asarray(got["err"]), np.asarray(want["err"])
                assert np.abs(e - we).max() <= q
            assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(
                want["loss"])
    exact = np.asarray(ref["exact"])
    g0 = np.asarray(ranks[0]["compress"][0]["g"])
    assert np.linalg.norm(g0 - exact) / np.linalg.norm(exact) < 0.05


def test_moe_expert_parallel_groups_match_the_reference(runs):
    ref, ranks, _ = runs
    y = np.concatenate([np.asarray(ranks[r]["moe_y"]) for r in range(4)])
    np.testing.assert_allclose(y, np.asarray(ref["moe_y"]), rtol=1e-5,
                               atol=1e-5)
    for r in range(4):
        assert ranks[r]["moe_keep"] == ref["moe_keep"][r], r
        assert abs(ranks[r]["moe_aux"] - ref["moe_aux"]) <= 1e-5 * max(
            1.0, abs(ref["moe_aux"]))
        assert ranks[r]["moe_comm"] > 0          # the tokens travelled


def test_subspace_dgo_step_across_ranks_matches_the_reference(runs):
    ref, ranks, _ = runs
    want = ref["dgo"]
    for r in range(4):
        got = ranks[r]["dgo"]
        assert len(got) == len(want) == 26
        t = near_tie_step([v for v, _, _ in got], [v for v, _, _ in want])
        n = len(got) if t is None else t
        for (gv, gb, gi), (wv, wb, wi) in zip(got[:n], want[:n]):
            assert gb == wb and gi == wi
            assert abs(gv - wv) <= 1e-5 * max(abs(wv), 1e-30)
    assert want[-1][0] < 0.5 * want[0][0]             # it descends
    # one rank alone takes the 4-rank trajectory
    assert ranks[0]["dgo_alone"] == ranks[0]["dgo"]


def test_remesh_and_reshard_tree(runs):
    _, ranks, _ = runs
    full = np.arange(24, dtype=np.float32).reshape(6, 4)
    for r in range(4):
        shape, coord = ranks[r]["remesh"]
        assert shape == [3, 1]
        assert coord == ([r, 0] if r < 3 else None)
    for r in range(3):
        np.testing.assert_array_equal(
            np.asarray(ranks[r]["reshard_local"]), full[2 * r:2 * r + 2])


def test_reshard_fwd_bwd_lands_the_gradient_in_the_storage_layout(runs):
    _, ranks, d = runs
    x, w = d["cx"], d["cw"]
    exact = 2 * x.T @ (x @ w)                # d/dw sum((x w)^2), all ranks
    for r in range(4):
        assert ranks[r]["rs_placements"] == ["S(0)", "R"]
        np.testing.assert_allclose(np.asarray(ranks[r]["rs_grad_local"]),
                                   exact[4 * r:4 * r + 4], rtol=1e-5,
                                   atol=1e-4)
        comm = ranks[r]["rs_comm"]
        assert any("reduce_scatter" in k for k in comm), comm
        assert any("all_gather" in k for k in comm), comm
