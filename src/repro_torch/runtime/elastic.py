"""Elastic re-meshing, the twin of ``repro.runtime.elastic``.

DGO is natively elastic: the population has no fixed-size requirement, so
when shards are lost the survivors take ceil((2N-1)/P') children each —
the paper's NCUBE virtual-processing mechanism, applied dynamically.
Gradient training re-meshes by re-sharding the latest checkpoint onto
the survivors' mesh (:func:`remesh`, :func:`reshard_tree`: ranks of the
default ``torch.distributed`` group).
"""
from __future__ import annotations

import math

import numpy as np


def drop_shard(quorum_mask, victim: int | None = None) -> np.ndarray:
    """Remove one shard from a DGO quorum mask (lowest alive index by
    default) — the elastic response to an injected or observed shard
    failure in ``Distributed(driver="host")``: no re-mesh, no restart; the
    survivors regenerate the lost children next round.  Returns a new
    bool array.

    Raises ``RuntimeError`` when the drop would leave an empty quorum.
    """
    alive = np.array(quorum_mask, dtype=bool).reshape(-1)
    if victim is None:
        if not alive.any():
            raise RuntimeError("quorum already empty")
        victim = int(np.argmax(alive))
    alive[victim] = False
    if not alive.any():
        raise RuntimeError("dropping shard %d empties the quorum" % victim)
    return alive


def elastic_population_plan(n_bits: int, n_shards: int) -> dict:
    """Re-plan DGO population distribution for a new shard count."""
    pop = 2 * n_bits - 1
    virtual = math.ceil(pop / n_shards)
    return {"population": pop, "shards": n_shards,
            "children_per_shard": virtual,
            "idle_slots": virtual * n_shards - pop}


def remesh(n_devices: int, model_parallel: int = 1):
    """The largest (data, model) ``DeviceMesh`` over the first
    ``n_devices`` ranks of the default group (the survivors); every rank
    of the group calls it, and a rank left out has no coordinate."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.core.distributed import cuda_collectives

    usable = (n_devices // model_parallel) * model_parallel
    ranks = torch.arange(usable).reshape(usable // model_parallel,
                                         model_parallel)
    dev = "cuda" if cuda_collectives() else "cpu"
    return DeviceMesh(dev, ranks, mesh_dim_names=("data", "model"))


def reshard_tree(tree, shardings):
    """Move a (checkpointed) tree onto a new mesh's layouts
    (``launch.sharding.Layout``s): a plain tensor is distributed, a
    DTensor of another mesh gathered whole and distributed, one of the
    same mesh redistributed."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def one(x, lay):
        if isinstance(x, DTensor):
            if x.device_mesh == lay.mesh:
                return x.redistribute(lay.mesh, list(lay.placements))
            x = x.full_tensor()
        return distribute_tensor(x, lay.mesh, list(lay.placements))

    def walk(x, lay):
        if isinstance(x, dict):
            return {k: walk(v, lay[k]) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v, s) for v, s in zip(x, lay))
        return one(x, lay)

    return walk(tree, shardings)
