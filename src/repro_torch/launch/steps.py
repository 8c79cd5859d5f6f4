"""Step builders: train / prefill / decode with production layouts, the
twins of ``repro.launch.steps``.

``build_cell(arch, shape, mesh, ...)`` returns everything the dry run,
trainer and server need for one (architecture x input shape x mesh)
cell: the step callable, abstract argument specs (meta tensors, no
allocation) and the matching in/out :class:`~repro_torch.launch.sharding.
Layout` trees.  ``place(values, layouts)`` turns values (real or meta)
into DTensors of those layouts; the steps take and return DTensors.

The steps run eagerly.  The port's model code computes on plain local
tensors, so every parameter is brought to its compute form at its use
site: storage layout -> use layout (``SERVE_RULES``: the FSDP shards
gathered, one layer at a time, inside the layer's checkpointed body) ->
whole (the model axis gathered too: the port's layers do not split heads
across ranks, so every rank of a model group computes the whole layer on
its batch shard).  Its gradient comes back as a partial sum over the
batch axes and lands in the storage layout as a reduce-scatter.  Expert
weights under expert parallelism (``models.moe``) are never gathered:
their storage is their compute layout, and the tokens travel instead.

Training memory policy: bf16 parameters and optimizer moments, f32
gradient accumulation, microbatches sized by an activation-budget
heuristic.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch
from torch.distributed.tensor import (
    DTensor, Partial, Replicate, Shard, distribute_tensor)
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.launch.mesh import _shape, data_shards
from repro_torch.launch.sharding import (
    SERVE_RULES,
    TRAIN_RULES,
    Layout,
    batch_sharding,
    cache_shardings,
    param_shardings,
    placements_of,
    replicated,
    reshard_fwd_bwd,
    spec_for,
)
from repro_torch.models import moe
from repro_torch.models.layers import abstract_params, is_spec, logical_axes
from repro_torch.models.lm import (
    ArchConfig, lm_decode, lm_loss, lm_prefill, model_spec, n_params)
from repro_torch.optim.gradient import AdamWConfig, AdamWState, adamw_update


def choose_microbatch(arch: ArchConfig, seq: int, local_batch: int,
                      budget_bytes: int = 2 << 30) -> int:
    """Largest power-of-2 microbatch whose remat carry fits the budget."""
    per_item = seq * arch.d_model * 2 * max(arch.n_layers, 1)
    mb = max(1, budget_bytes // max(per_item, 1))
    mb = 1 << (mb.bit_length() - 1)
    return max(1, min(mb, local_batch))


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_struct(arch: ArchConfig, batch: int, seq: int,
                 dtype=torch.bfloat16, with_labels: bool = True,
                 n_micro: int = 0) -> dict:
    """Meta tensors of a batch; ``n_micro > 0`` prepends the accumulation
    axis: (n_micro, batch, ...).  Tokens and labels are int32, as the
    reference's."""
    lead = (n_micro,) if n_micro else ()
    s: dict[str, Any] = {"tokens": _meta(lead + (batch, seq), torch.int32)}
    if with_labels:
        s["labels"] = _meta(lead + (batch, seq), torch.int32)
    if arch.vision_tokens:
        s["images"] = _meta(lead + (batch, arch.vision_tokens,
                                    arch.d_frontend), dtype)
    if arch.enc_dec:
        s["frames"] = _meta(lead + (batch, arch.n_frames, arch.d_model),
                            dtype)
    return s


def batch_shardings(arch: ArchConfig, mesh, spec: dict, batch_dim: int = 0):
    return {k: batch_sharding(mesh, v.ndim, batch_dim)
            for k, v in spec.items()}


def _with_layouts(fn, values, layouts):
    """``fn(tensor, layout)`` over a tree and the matching
    :class:`Layout` tree; other leaves (ints) pass through."""
    if isinstance(layouts, Layout):
        return fn(values, layouts) if isinstance(values, torch.Tensor) \
            else values
    if isinstance(values, dict):
        return {k: _with_layouts(fn, v, layouts[k])
                for k, v in values.items()}
    if isinstance(values, (list, tuple)):
        out = [_with_layouts(fn, v, lay) for v, lay in zip(values, layouts)]
        return (type(values)(*out) if hasattr(values, "_fields")
                else type(values)(out))
    return values


def place(values, layouts):
    """``values`` (tensors, real or meta) as DTensors of the matching
    :class:`Layout` tree."""
    return _with_layouts(lambda t, lay: distribute_tensor(
        t, lay.mesh, list(lay.placements)), values, layouts)


def to_layouts(values, layouts):
    """DTensors redistributed to the matching :class:`Layout` tree."""
    return _with_layouts(lambda t, lay: t.redistribute(
        t.device_mesh, list(lay.placements)) if isinstance(t, DTensor)
        else t, values, layouts)


def _grad_placements(mesh, partial_axes) -> list:
    return [Partial() if a in partial_axes else Replicate()
            for a in _shape(mesh)]


class _Gather(torch.autograd.Function):
    """Forward: a DTensor gathered whole, as a plain tensor.  Backward:
    the local gradient as a DTensor that is a partial sum over the batch
    axes, left for the next layout change to reduce (a reduce-scatter
    into a sharded storage layout, where DTensor's own backward would
    all-reduce it into the replicated intermediate first)."""

    @staticmethod
    def forward(ctx, t, grad_placements):
        ctx.mesh, ctx.grad_placements = t.device_mesh, grad_placements
        return t.redistribute(t.device_mesh,
                              [Replicate()] * t.device_mesh.ndim).to_local()

    @staticmethod
    def backward(ctx, g):
        return DTensor.from_local(g, ctx.mesh, ctx.grad_placements,
                                  run_check=False), None


def gathered(t, partial_axes=()):
    """A DTensor's whole value as a plain tensor for local compute; its
    gradient is a partial sum over ``partial_axes`` (the mesh axes the
    batch is split over).  A plain tensor passes through."""
    if not isinstance(t, DTensor):
        return t
    return _Gather.apply(t, tuple(_grad_placements(t.device_mesh,
                                                   partial_axes)))


def materialize(params, mesh):
    """Every DTensor leaf of ``params`` whole (:func:`gathered`, for a
    serve step), but the expert weights of an expert-parallel mesh
    (``moe.ep_active``), which stay sharded."""
    def walk(tree):
        if isinstance(tree, dict):
            if "router" in tree and isinstance(
                    tree.get("gate"), DTensor) and moe.ep_active(
                        tree["gate"].shape[0], mesh):
                return {k: (v if k in ("gate", "up", "down") else walk(v))
                        for k, v in tree.items()}
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(t) for t in tree]
        return gathered(tree)
    return walk(params)


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------

def mesh_scoped(fn, mesh):
    """Run ``fn`` with the expert-parallel mesh (``moe.CURRENT_MESH``)
    set."""
    def wrapped(*a, **k):
        tok = moe.CURRENT_MESH.set(mesh)
        try:
            return fn(*a, **k)
        finally:
            moe.CURRENT_MESH.reset(tok)
    return wrapped


def _node(spec_tree, path):
    node = spec_tree
    for k in path:
        node = node[k]
    return node


def _spec_map(fn, node, sub):
    """``fn(spec, leaf)`` over a ParamSpec tree and the matching tree."""
    if is_spec(node):
        return fn(node, sub)
    if isinstance(node, list):
        return [_spec_map(fn, n, s) for n, s in zip(node, sub)]
    return {k: _spec_map(fn, n, sub[k]) for k, n in node.items()}


def make_constrainer(arch: ArchConfig, mesh, partial_axes=None,
                     fsdp: bool = True):
    """The use-site hook of ``lm_loss``.  ``fsdp``: storage is
    (pod, data)-sharded (``TRAIN_RULES``); at each use a parameter is
    redistributed to the TP-only layout (``SERVE_RULES``: a per-layer
    all-gather forward, a reduce-scatter of its gradient backward,
    :func:`~repro_torch.launch.sharding.reshard_fwd_bwd`) and then
    gathered whole for the port's local compute.  Without ``fsdp`` a
    parameter is gathered whole from whatever layout it is stored in.
    Expert tensors of an expert-parallel mesh are never gathered (their
    storage is the compute layout).  ``partial_axes``: the mesh axes the
    batch is split over (default: pod, data)."""
    spec_tree = model_spec(arch)
    msh = _shape(mesh)
    if partial_axes is None:
        partial_axes = tuple(a for a in ("pod", "data") if a in msh)

    def layout(sp, rules):
        # expert tensors keep the training (EP x TP) layout at use
        if "experts" in sp.axes:
            rules = TRAIN_RULES
        return Layout(mesh, spec_for(sp.shape, sp.axes, mesh, rules))

    def one(sp, t):
        if not isinstance(t, DTensor):
            return t
        if "experts" in sp.axes and moe.ep_active(sp.shape[0], mesh):
            return t
        if fsdp:
            t = reshard_fwd_bwd(t, layout(sp, SERVE_RULES),
                                layout(sp, TRAIN_RULES))
        return gathered(t, partial_axes)

    def constrain(path, sub):
        return _spec_map(one, _node(spec_tree, path), sub)

    return constrain


def _local(x: torch.Tensor) -> torch.Tensor:
    return x.to_local() if isinstance(x, DTensor) else x


def _global_mean(loss: torch.Tensor, mesh, partial_axes, n: int):
    """The mean over the batch shards of each shard's loss."""
    if mesh is None or not partial_axes:
        return loss
    d = DTensor.from_local(loss.detach().float() / n, mesh,
                           _grad_placements(mesh, partial_axes),
                           run_check=False)
    return d.full_tensor()


def make_train_step(arch: ArchConfig, opt_cfg: AdamWConfig, n_micro: int,
                    dtype=torch.bfloat16, constrain=None,
                    grad_shardings=None, param_shardings=None,
                    moment_shardings=None, mesh=None, partial_axes=()):
    """(params, opt_state, batch) -> (params, opt_state, loss).

    ``batch`` tensors are shaped (n_micro, micro_batch, ...): the
    accumulation loop takes the leading axis, and each rank computes on
    its shard of the batch axis.  A rank's loss is divided by the number
    of batch shards, so the gradients' partial sums over the batch axes
    are the global mean's gradient; they are pinned to ``grad_shardings``
    as they leave the backward (a reduce-scatter into the moments'
    layout), accumulated in float32 over microbatches, and AdamW updates
    the parameters, which return to ``param_shardings``."""
    n_shards = (math.prod(_shape(mesh)[a] for a in partial_axes)
                if mesh is not None else 1)

    def shard_grads(g):
        if grad_shardings is None:
            return g
        return to_layouts(g, grad_shardings)

    def micro(params, mb):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss = lm_loss(live, arch, mb, dtype=dtype, constrain=constrain)
        leaves = tree_leaves(live)
        grads = iter(torch.autograd.grad(loss / n_shards, leaves))
        grads = tree_map(lambda _: next(grads), live)
        return loss.detach(), shard_grads(grads)

    def train_step(params, opt_state, batch):
        local = {k: _local(v) for k, v in batch.items()}
        mbs = [{k: (v[i].long() if k in ("tokens", "labels") else v[i])
                for k, v in local.items()} for i in range(n_micro)]
        if n_micro == 1:
            lsum, grads = micro(params, mbs[0])
        else:
            gacc, lsum = None, 0.0
            for mb in mbs:
                loss, g = micro(params, mb)
                g = tree_map(lambda x: x.float(), g)
                gacc = g if gacc is None else tree_map(torch.add, gacc, g)
                lsum = lsum + loss
            grads = tree_map(lambda g: g / n_micro, gacc)
            lsum = lsum / n_micro
        loss = _global_mean(lsum, mesh, partial_axes, n_shards) \
            if n_shards > 1 else lsum
        step = opt_state.step
        plain = AdamWState(step=_local(step), mu=opt_state.mu,
                           nu=opt_state.nu)
        with implicit_replication():
            params, opt_state = adamw_update(opt_cfg, grads, plain, params)
        if isinstance(step, DTensor):
            opt_state = opt_state._replace(step=DTensor.from_local(
                opt_state.step, step.device_mesh, step.placements,
                run_check=False))
        if param_shardings is not None:
            params = to_layouts(params, param_shardings)
        if moment_shardings is not None:
            opt_state = AdamWState(
                step=opt_state.step,
                mu=to_layouts(opt_state.mu, moment_shardings),
                nu=to_layouts(opt_state.nu, moment_shardings))
        return params, opt_state, loss

    return train_step


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------

def _compute_placements(names, placements) -> list:
    """The layout a rank computes a serve tensor in: its batch dim (dim 0)
    kept split over the batch axes where it is, everything else whole."""
    return [pl if (isinstance(pl, Shard) and pl.dim == 0
                   and a in ("pod", "data")) else Replicate()
            for a, pl in zip(names, placements)]


def _to_compute(t):
    if not isinstance(t, DTensor):
        return t
    mesh = t.device_mesh
    return t.redistribute(mesh, _compute_placements(
        mesh.mesh_dim_names, t.placements)).to_local()


def _from_compute(local, layout: Layout | None):
    """A rank's computed tensor back as a DTensor of ``layout``."""
    if layout is None or not isinstance(local, torch.Tensor):
        return local
    mesh = layout.mesh
    pl = _compute_placements(mesh.mesh_dim_names, layout.placements)
    return DTensor.from_local(local, mesh, pl, run_check=False).redistribute(
        mesh, list(layout.placements))


def _outputs(logits, cache, layouts):
    if layouts is None:
        return logits, cache
    lay_logits, lay_cache = layouts

    def walk(c, lay):
        if isinstance(c, dict):
            return {k: walk(v, lay[k]) for k, v in c.items()}
        if isinstance(c, (list, tuple)):
            return type(c)(walk(v, s) for v, s in zip(c, lay))
        return _from_compute(c, lay)

    return _from_compute(logits, lay_logits), walk(cache, lay_cache)


def make_prefill_step(arch: ArchConfig, cache_len: int, dtype=torch.bfloat16,
                      mesh=None, out_layouts=None):
    """(params, batch) -> (logits, cache), computed on this rank's batch
    shard with the parameters gathered whole (:func:`materialize`);
    with ``out_layouts`` (the cell's) the outputs are DTensors of them."""
    def prefill_step(params, batch):
        local = {k: (_to_compute(v).long() if k == "tokens"
                     else _to_compute(v)) for k, v in batch.items()}
        with torch.no_grad():
            logits, cache = lm_prefill(materialize(params, mesh), arch,
                                       local, cache_len=cache_len,
                                       dtype=dtype)
        return _outputs(logits, cache, out_layouts)
    return prefill_step


def make_decode_step(arch: ArchConfig, dtype=torch.bfloat16, mesh=None,
                     out_layouts=None):
    """(params, token, cache) -> (logits, cache) on this rank's batch
    shard: the cache's other splits (heads over "model", the sequence of
    a batch too small to split) gathered for the step and split again
    after it."""
    def decode_step(params, token, cache):
        local = tree_map(_to_compute, cache)
        with torch.no_grad():
            logits, new = lm_decode(materialize(params, mesh), arch,
                                    _to_compute(token).long(), local,
                                    dtype=dtype)
        return _outputs(logits, new, out_layouts)
    return decode_step


# ---------------------------------------------------------------------------
# cell assembly
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Cell:
    name: str
    step: Any
    arg_specs: tuple
    in_shardings: tuple
    out_shardings: Any
    donate_argnums: tuple = ()
    meta: dict = dataclasses.field(default_factory=dict)
    out_specs: Any = None            # meta tensors of the outputs


def _head_counts(arch: ArchConfig) -> tuple[int, ...]:
    counts = {arch.n_heads, arch.n_kv_heads}
    counts.add(2 * arch.d_model // 64)       # mamba2 value heads
    return tuple(counts)


@functools.lru_cache(maxsize=32)
def _abstract_cache(arch: ArchConfig, batch: int, cache_len: int, dtype,
                    prompt_len: int):
    """The cache tree of a prefill at ``cache_len`` as meta tensors (a
    cache's shapes do not depend on the prompt's length, so a short
    prompt stands in for a long one).  The tree is shared between calls:
    callers do not modify it."""
    params_abs = abstract_params(model_spec(arch), dtype=dtype)
    bspec = batch_struct(arch, batch, min(prompt_len, cache_len), dtype,
                         with_labels=False)
    bspec["tokens"] = bspec["tokens"].long()
    plain = dataclasses.replace(arch, use_flash_attention=False)  # meta
    with torch.no_grad():
        _, cache = lm_prefill(params_abs, plain, bspec, cache_len=cache_len,
                              dtype=dtype)
    return cache


def choose_policy(arch: ArchConfig, mesh, policy: str | None) -> str:
    """fsdp | zero1 | dp, by parameter bytes (the reference's rule)."""
    if policy is not None:
        return policy
    p_bytes = 2 * n_params(arch)
    model_size = _shape(mesh)["model"]
    if arch.moe_experts or p_bytes / 256 > 5e9:
        return "fsdp"
    if p_bytes <= 1.5e9:
        return "dp"
    if p_bytes / model_size <= 5e9:
        return "zero1"
    return "fsdp"


def build_cell(arch: ArchConfig, shape, mesh, *, dtype=torch.bfloat16,
               opt_cfg: AdamWConfig | None = None, prompt_len: int = 128,
               policy: str | None = None) -> Cell:
    """shape: ``configs.shapes.ShapeSpec``; policy: fsdp | zero1 | dp |
    None (chosen by parameter bytes)."""
    spec_tree = model_spec(arch)
    axes_tree = logical_axes(spec_tree)
    params_abs = abstract_params(spec_tree, dtype=dtype)
    msh = _shape(mesh)

    if shape.kind == "train":
        opt_cfg = opt_cfg or AdamWConfig()
        # fsdp : params FSDP-stored, per-layer gather at the use site
        #        (mandatory for MoE/giant models)
        # zero1: params TP-resident (replicated over the batch axes), only
        #        the optimizer moments FSDP-sharded; grads reduce-scatter,
        #        updated params all-gather once per step
        # dp   : small models: everything replicated, the batch sharded
        #        over every divisible mesh axis
        policy = choose_policy(arch, mesh, policy)
        moment_shard = param_shardings(axes_tree, params_abs, mesh,
                                       TRAIN_RULES)
        if policy == "fsdp":
            pshard = moment_shard
            batch_axes_used = None          # default (pod, data)
        elif policy == "zero1":
            pshard = param_shardings(axes_tree, params_abs, mesh,
                                     SERVE_RULES)
            batch_axes_used = None
        else:                               # dp
            pshard = tree_map(lambda _: replicated(mesh), moment_shard)
            axes, prod = [], 1
            for a in ("pod", "data", "model"):
                if a in msh and shape.global_batch % (prod * msh[a]) == 0:
                    axes.append(a)
                    prod *= msh[a]
            batch_axes_used = tuple(axes)

        mdt = getattr(torch, opt_cfg.moment_dtype)
        opt_abs = AdamWState(
            step=_meta((), torch.int32),
            mu=tree_map(lambda p: _meta(p.shape, mdt), params_abs),
            nu=tree_map(lambda p: _meta(p.shape, mdt), params_abs))
        oshard = AdamWState(step=replicated(mesh), mu=moment_shard,
                            nu=moment_shard)
        used = (tuple(a for a in ("pod", "data") if a in msh)
                if batch_axes_used is None else batch_axes_used)
        n_batch_shards = (data_shards(mesh) if batch_axes_used is None
                          else math.prod(msh[a] for a in batch_axes_used))
        local_b = max(shape.global_batch // n_batch_shards, 1)
        mb = choose_microbatch(arch, shape.seq_len, local_b)
        n_micro = max(1, local_b // mb)
        mb_global = shape.global_batch // n_micro
        bspec = batch_struct(arch, mb_global, shape.seq_len, dtype,
                             n_micro=n_micro)
        if batch_axes_used is None:
            bshard = batch_shardings(arch, mesh, bspec, batch_dim=1)
        else:
            part = (batch_axes_used if len(batch_axes_used) > 1
                    else batch_axes_used[0])
            bshard = {k: Layout(mesh, placements_of(
                [None, part] + [None] * (v.ndim - 2), msh))
                for k, v in bspec.items()}
        constrain = make_constrainer(arch, mesh, used,
                                     fsdp=(policy == "fsdp"))
        step = mesh_scoped(
            make_train_step(arch, opt_cfg, n_micro, dtype,
                            constrain=constrain, grad_shardings=moment_shard,
                            param_shardings=pshard,
                            moment_shardings=moment_shard, mesh=mesh,
                            partial_axes=used), mesh)
        return Cell(
            name=f"{arch.name}:{shape.name}",
            step=step,
            arg_specs=(params_abs, opt_abs, bspec),
            in_shardings=(pshard, oshard, bshard),
            out_shardings=(pshard, oshard, replicated(mesh)),
            donate_argnums=(0, 1),
            meta={"n_micro": n_micro, "microbatch": mb,
                  "local_batch": local_b, "policy": policy},
            out_specs=(params_abs, opt_abs, _meta((), torch.float32)),
        )

    pshard = param_shardings(axes_tree, params_abs, mesh, SERVE_RULES)
    if shape.kind == "prefill":
        bspec = batch_struct(arch, shape.global_batch, shape.seq_len, dtype,
                             with_labels=False)
        bshard = batch_shardings(arch, mesh, bspec)
        cache_abs = _abstract_cache(arch, shape.global_batch, shape.seq_len,
                                    dtype, prompt_len)
        cshard = cache_shardings(cache_abs, mesh, batch=shape.global_batch,
                                 cache_len=shape.seq_len,
                                 head_counts=_head_counts(arch))
        logit_shard = batch_sharding(mesh, 2)
        step = mesh_scoped(
            make_prefill_step(arch, cache_len=shape.seq_len, dtype=dtype,
                              mesh=mesh, out_layouts=(logit_shard, cshard)),
            mesh)
        return Cell(
            name=f"{arch.name}:{shape.name}",
            step=step,
            arg_specs=(params_abs, bspec),
            in_shardings=(pshard, bshard),
            out_shardings=(logit_shard, cshard),
            meta={},
            out_specs=(_meta((shape.global_batch, arch.vocab_size),
                             torch.float32), cache_abs),
        )

    # decode: one new token against a cache of shape.seq_len
    cache_abs = _abstract_cache(arch, shape.global_batch, shape.seq_len,
                                dtype, prompt_len)
    tok_spec = _meta((shape.global_batch,), torch.int32)
    cshard = cache_shardings(cache_abs, mesh, batch=shape.global_batch,
                             cache_len=shape.seq_len,
                             head_counts=_head_counts(arch))
    even = shape.global_batch % data_shards(mesh) == 0
    tshard = batch_sharding(mesh, 1) if even else replicated(mesh)
    logit_shard = batch_sharding(mesh, 2) if even else replicated(mesh)
    out_logits = replicated(mesh) if shape.global_batch == 1 else logit_shard
    step = mesh_scoped(make_decode_step(arch, dtype, mesh=mesh,
                                        out_layouts=(out_logits, cshard)),
                       mesh)
    return Cell(
        name=f"{arch.name}:{shape.name}",
        step=step,
        arg_specs=(params_abs, tok_spec, cache_abs),
        in_shardings=(pshard, tshard, cshard),
        out_shardings=(out_logits, cshard),
        donate_argnums=(2,),
        meta={},
        out_specs=(_meta((shape.global_batch, arch.vocab_size),
                         torch.float32), cache_abs),
    )
