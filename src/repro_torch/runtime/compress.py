"""Gradient compression: int8 quantized data-parallel reduction with error
feedback, the twin of ``repro.runtime.compress``.

DGO's inter-iteration traffic is an N-bit string and needs no compression
(the algorithm is its own compressor).  The gradient trainer gets the
classic treatment instead: per-tensor symmetric int8 quantization, a sum
of the int8 payload (as int32 accumulators against overflow), dequantize,
and the quantization residual carried into the next step (error feedback
keeps the compression unbiased over time).  Wire volume: 1 byte and a
shared scale an element against 4 (float32).

The reductions are ``torch.distributed`` all-reduces over one axis of a
``DeviceMesh`` (the default group when the mesh is None).  ``torch.round``
rounds halves to even, as ``jnp.round`` does.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.tree import tree_leaves, tree_map


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _group(mesh, axis: str):
    return None if mesh is None else mesh.get_group(axis)


def compressed_psum(x: torch.Tensor, err: torch.Tensor, group=None):
    """Error-feedback int8 mean of one tensor over ``group``'s ranks.

    Returns (mean-reduced float32 tensor, new error state).  The ranks'
    scales differ, so the payload is requantized at their maximum (an
    all-reduce MAX) before the int32 sum."""
    target = x + err
    _, scale = quantize_int8(target)
    max_scale = scale.clone()
    dist.all_reduce(max_scale, op=dist.ReduceOp.MAX, group=group)
    requant = torch.clamp(torch.round(target / max_scale), -127, 127)
    new_err = target - requant * max_scale
    summed = requant.to(torch.int32)
    dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
    n = dist.get_world_size(group)
    return summed.to(torch.float32) * max_scale / n, new_err


def make_compressed_dp_grad_fn(loss_fn, mesh=None, axis: str = "data"):
    """Data-parallel gradient with the int8 error-feedback all-reduce.

    ``loss_fn(params, batch) -> 0-d tensor``.  Returns
    ``grad_step(params, batch, err_tree) -> (grads, new_err_tree, loss)``
    where every rank holds the same ``params`` and its own shard of the
    batch (a DTensor batch is taken as its local shard); the loss is the
    mean over the ranks."""
    group = _group(mesh, axis)

    def local(x):
        return x.to_local() if hasattr(x, "to_local") else x

    def grad_step(params, batch, err):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss = loss_fn(live, tree_map(local, batch))
        leaves = tree_leaves(live)
        grads = torch.autograd.grad(loss, leaves)
        reduced, new_err = [], []
        for g, e in zip(grads, tree_leaves(err)):
            r, ne = compressed_psum(g.to(torch.float32), e, group)
            reduced.append(r)
            new_err.append(ne)
        loss = loss.detach().clone()
        dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=group)
        loss = loss / dist.get_world_size(group)
        it_r, it_e = iter(reduced), iter(new_err)
        return (tree_map(lambda _: next(it_r), params),
                tree_map(lambda _: next(it_e), params), loss)

    return grad_step


def init_error_state(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
