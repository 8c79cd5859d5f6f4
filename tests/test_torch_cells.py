"""``build_cell`` of the port (``repro_torch.launch.steps``) against the
reference's on both production meshes, at full width, for every
architecture and input shape: each argument's and output's layout (its
partition spec, spelled from the DTensor placements) and its bytes per
device, and the cell's ``meta`` (microbatching and policy).  Neither side
needs devices: the reference runs on ``repro.compat.abstract_mesh``, the
port states its placements over a plain ``{axis: size}`` mesh.

The port loops its layers, so a reference leaf stacked over L layers is
the port's L per-layer leaves: the same spec after the reference's
leading (unsharded) layer axis, and L times the bytes.  The port's caches
are per-layer entries too; they are compared by their bytes per device
in all.  The reference carries a cache's position as an int32 device
scalar, the port as a host int, so those 0-d leaves are left out of the
reference's count."""
import math

import jax
import jax.numpy as jnp
import pytest

from repro.compat import abstract_mesh
from repro.configs import REGISTRY
from repro.configs import get_arch as jget
from repro.configs.shapes import SHAPES as JSHAPES, skip_reason
from repro.launch.steps import build_cell as jbuild
from repro_torch.configs import get_arch as tget
from repro_torch.configs.shapes import SHAPES as TSHAPES
from repro_torch.launch.dryrun import _tree_bytes
from repro_torch.launch.sharding import Layout
from repro_torch.launch.steps import build_cell as tbuild

MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _is_sharding(x):
    return hasattr(x, "spec") and hasattr(x, "shard_shape")


def _ref_leaves(specs, shards) -> dict:
    """path -> (spec tuple, bytes a device) of a reference tree."""
    out = {}
    sp = jax.tree_util.tree_flatten_with_path(specs)[0]
    sh = jax.tree.leaves(shards, is_leaf=_is_sharding)
    for (path, s), lay in zip(sp, sh):
        key = tuple(getattr(p, "key", getattr(p, "name",
                                               getattr(p, "idx", None)))
                    for p in path)
        spec = tuple(lay.spec) + (None,) * (len(s.shape) - len(lay.spec))
        out[key] = (spec, math.prod(lay.shard_shape(s.shape))
                    * jnp.dtype(s.dtype).itemsize)
    return out


def _port_leaves(values, layouts, path=()) -> dict:
    """path -> (spec tuple, bytes a device) of a port tree, a layer
    list's leaves folded into one stacked leaf (spec with a leading None,
    bytes summed); every layer must have the same spec."""
    if isinstance(layouts, Layout):
        spec = layouts.spec(values.ndim)
        spec = spec + (None,) * (values.ndim - len(spec))
        return {path: (spec, layouts.nbytes(values))}
    if isinstance(values, dict):
        out = {}
        for k, v in values.items():
            out.update(_port_leaves(v, layouts[k], path + (k,)))
        return out
    if hasattr(values, "_fields"):
        out = {}
        for f, v, lay in zip(values._fields, values, layouts):
            out.update(_port_leaves(v, lay, path + (f,)))
        return out
    layers = [_port_leaves(v, lay, path) for v, lay in zip(values, layouts)]
    out = {}
    for key in layers[0]:
        specs = {lay[key][0] for lay in layers}
        assert len(specs) == 1, (key, specs)
        out[key] = ((None,) + specs.pop(),
                    sum(lay[key][1] for lay in layers))
    return out


def _ref_bytes_without_scalars(specs, shards) -> int:
    """Bytes a device of a reference tree but its caches' 0-d ``pos``."""
    return sum(b for key, (spec, b) in _ref_leaves(specs, shards).items()
               if not (spec == () and key and key[-1] == "pos"))


@pytest.mark.parametrize("mesh_tag", list(MESHES))
@pytest.mark.parametrize("name", list(REGISTRY))
def test_cells_match_the_reference(name, mesh_tag):
    shape, axes = MESHES[mesh_tag]
    jmesh = abstract_mesh(shape, axes)
    tmesh = dict(zip(axes, shape))
    for sname, jshape in JSHAPES.items():
        if skip_reason(jget(name), jshape):
            continue
        jc = jbuild(jget(name), jshape, jmesh)
        tc = tbuild(tget(name), TSHAPES[sname], tmesh)
        assert tc.meta == jc.meta, sname
        assert tc.donate_argnums == jc.donate_argnums
        # parameters (and the optimizer's moments, the batch) leaf by leaf
        n_exact = 3 if jshape.kind == "train" else 1
        for i in range(n_exact):
            want = _ref_leaves(jc.arg_specs[i], jc.in_shardings[i])
            got = _port_leaves(tc.arg_specs[i], tc.in_shardings[i])
            assert set(got) == set(want), (sname, i,
                                           set(got) ^ set(want))
            for key in want:
                assert got[key] == want[key], (sname, i, key)
        # every argument and output, bytes a device in all
        args = _ref_bytes_without_scalars(jc.arg_specs, jc.in_shardings)
        assert _tree_bytes(tc.arg_specs, tc.in_shardings) == args, sname
        if jshape.kind == "train":
            outs = _ref_bytes_without_scalars(jc.arg_specs[:2],
                                              jc.out_shardings[:2])
            assert _tree_bytes(tc.out_specs[:2], tc.out_shardings[:2]) \
                == outs, sname
        # the logits' layout
        if jshape.kind != "train":
            lay = tc.out_shardings[0]
            want_spec = tuple(jc.out_shardings[0].spec)
            want_spec += (None,) * (2 - len(want_spec))
            got_spec = lay.spec(2) + (None,) * (2 - len(lay.spec(2)))
            assert got_spec == want_spec, sname
        if jshape.kind == "decode":
            # the cache in and out: the same layouts both ways
            assert _tree_bytes(tc.out_specs[1], tc.out_shardings[1]) == \
                _tree_bytes(tc.arg_specs[2], tc.in_shardings[2])
