"""Elastic population planning (``repro.runtime.elastic`` without the
re-mesh: ``remesh`` and ``reshard_tree`` need device meshes, which the
port does not have yet).

DGO is natively elastic: the population has no fixed-size requirement, so
when shards are lost the survivors take ceil((2N-1)/P') children each —
the paper's NCUBE virtual-processing mechanism, applied dynamically.
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
