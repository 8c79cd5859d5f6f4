"""LM assembly: ArchConfig -> parameter spec -> train / prefill / decode,
the twin of ``repro.models.lm`` for every architecture of the zoo:
dense attention models, whisper's encoder-decoder, the vision-prefix
model, xLSTM, the Mamba2 hybrid and the MLA + MoE models.

A model is a *plan*: an ordered list of segments, each a run of
identical layers.  The reference scans stacked parameters; the port keeps
each segment, and the encoder's layers, as a list of per-layer
:class:`~repro_torch.models.layers.Params` modules and loops over them in
Python.

Paths:
  lm_loss(params, arch, batch)                -> scalar (train objective)
  lm_prefill(params, arch, batch, cache_len)  -> (logits_last, cache)
  lm_decode(params, arch, token, cache)       -> (logits, cache)

``batch`` holds ``tokens`` (and ``labels`` for the loss), plus the
frontend stubs' inputs: ``frames`` (B, F, d_model) for an encoder-decoder
(``arch.enc_dec``: whisper), ``images`` (B, vision_tokens, d_frontend)
for a vision model (phi-3-vision), projected by ``img_proj`` and
prepended to the tokens: the prefix shifts positions and the cache's
length, and takes no labels.

The vocabulary readout of ``lm_loss`` is sequence-chunked
(:func:`chunked_ce`): the (B, S, V) logits tensor is never materialised.
With ``arch.remat`` each layer, and always each readout chunk, runs under
``torch.utils.checkpoint`` (non-reentrant) when gradients are taken: its
activations are recomputed in the backward pass, as ``jax.checkpoint``
does in the reference.  ``params`` may be a :class:`~repro_torch.models.
layers.Params` module or its plain tree (:meth:`Params.tree`).

Where ``arch.window`` is None every attention layer is global and is
given no window, and a windowed arch's global layers (gemma3's every
sixth) are given None too, so ``use_flash_attention`` routes their
full-sequence attention, and the encoder's bidirectional attention,
through the CUDA kernel, as does zamba2's shared attention block, which
is given no window in the reference too.  (The reference passes every
other decoder layer a window of 0, which keeps its Pallas kernel off
those decoders: ROADMAP queue 3.)  The kernel has no backward pass, so
training keeps ``use_flash_attention=False`` (the reference's default,
and its trainer's).

Hybrid patterns become several segments: zamba2's shared attention
block (one parameter tree, ``shared_attn``, applied before every
``shared_attn_every`` Mamba layers, its output delta re-projected by
``shared_proj``, with a KV cache of its own at each application,
``shared<i>``), xLSTM's sLSTM interleave and DeepSeek's leading dense
layers.  MoE layers add their load-balance loss to the objective, and
deepseek-v3's depth-1 multi-token-prediction head (``mtp``) adds its
weighted loss.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.distributed import resolve_device
from repro_torch.models import blocks as blk
from repro_torch.models.attention import cross_kv
from repro_torch.models.layers import (
    ParamSpec,
    Params,
    dense,
    dense_spec,
    embed,
    embedding_spec,
    init_params,
    param_count,
    unembed,
)

@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None
    qkv_bias: bool = False
    qk_norm: bool = False
    tie_embeddings: bool = False
    embed_scale: bool = False        # gemma: embeddings * sqrt(d)
    use_rope: bool = True
    rope_theta: float = 10_000.0
    mlp_kind: str = "swiglu"
    norm_kind: str = "rmsnorm"
    # sliding-window pattern
    window: int | None = None
    global_every: int | None = None  # layer i global iff (i+1) % global_every == 0
    # MLA
    use_mla: bool = False
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_shared: int = 0
    moe_dense_layers: int = 0
    moe_d_ff_dense: int = 0
    moe_capacity: float = 1.25
    # SSM / hybrid
    block_pattern: str = "attn"      # attn | xlstm | mamba | zamba
    ssm_state: int = 64
    slstm_every: int = 0
    shared_attn_every: int = 0
    # enc-dec / frontends (stubs provide precomputed embeddings)
    enc_dec: bool = False
    n_enc_layers: int = 0
    n_frames: int = 1500
    vision_tokens: int = 0
    d_frontend: int = 1024           # CLIP embedding width (vlm stub)
    # MTP
    mtp: bool = False
    mtp_weight: float = 0.3
    # compute
    remat: bool = True
    use_flash_attention: bool = False   # the CUDA flash-attention kernel
    attn_chunk_q: int = 512
    mamba_chunk: int = 256
    loss_chunk: int = 512
    sub_quadratic: bool = False      # qualifies for long_500k

    @property
    def head_dim_v(self) -> int:
        return self.head_dim or self.d_model // self.n_heads


@dataclasses.dataclass(frozen=True)
class Segment:
    kind: str                        # attn | mla | mamba | mlstm | slstm | shared
    n: int
    moe: bool = False
    d_ff: int | None = None          # dense-FFN override
    cross: bool = False
    name: str = "seg0"


def build_plan(arch: ArchConfig) -> list[Segment]:
    if arch.block_pattern == "xlstm":
        segs, run, idx = [], 0, 0
        for i in range(arch.n_layers):
            if arch.slstm_every and (i + 1) % arch.slstm_every == 0:
                if run:
                    segs.append(Segment("mlstm", run, name=f"seg{idx}"))
                    idx += 1
                    run = 0
                segs.append(Segment("slstm", 1, name=f"seg{idx}"))
                idx += 1
            else:
                run += 1
        if run:
            segs.append(Segment("mlstm", run, name=f"seg{idx}"))
        return segs
    if arch.block_pattern == "zamba":
        segs, idx, i = [], 0, 0
        while i < arch.n_layers:
            segs.append(Segment("shared", 1, name=f"shared{idx}"))
            n = min(arch.shared_attn_every, arch.n_layers - i)
            segs.append(Segment("mamba", n, name=f"seg{idx}"))
            i += n
            idx += 1
        return segs
    if arch.block_pattern == "mamba":
        return [Segment("mamba", arch.n_layers)]
    kind = "mla" if arch.use_mla else "attn"
    if arch.moe_experts:
        segs = []
        if arch.moe_dense_layers:
            segs.append(Segment(kind, arch.moe_dense_layers, moe=False,
                                d_ff=arch.moe_d_ff_dense, name="dense"))
        segs.append(Segment(kind, arch.n_layers - arch.moe_dense_layers,
                            moe=True, name="moe"))
        return segs
    return [Segment(kind, arch.n_layers, cross=arch.enc_dec)]


def layer_windows(arch: ArchConfig, seg_start: int, n: int
                  ) -> list[int | None]:
    """Per-layer windows of an attention segment: None where the layer is
    global (every layer when ``arch.window`` is None), else its size."""
    if arch.window is None:
        return [None] * n
    idx = range(seg_start, seg_start + n)
    if arch.global_every:
        return [None if (i + 1) % arch.global_every == 0 else arch.window
                for i in idx]
    return [arch.window] * n


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _layer_spec(arch: ArchConfig, seg: Segment):
    if seg.kind == "attn":
        return blk.attn_block_spec(arch, moe=seg.moe, cross=seg.cross,
                                   d_ff=seg.d_ff)
    if seg.kind == "mla":
        return blk.mla_block_spec(arch, moe=seg.moe, d_ff=seg.d_ff)
    return {"mamba": blk.mamba_block_spec, "mlstm": blk.mlstm_block_spec,
            "slstm": blk.slstm_block_spec}[seg.kind](arch)


def model_spec(arch: ArchConfig) -> dict:
    spec: dict[str, Any] = {"embed": embedding_spec(arch.vocab_size,
                                                    arch.d_model)}
    spec["segments"] = {seg.name: [_layer_spec(arch, seg)] * seg.n
                        for seg in build_plan(arch) if seg.kind != "shared"}
    if arch.block_pattern == "zamba":
        spec["shared_attn"] = blk.attn_block_spec(arch)
        spec["shared_proj"] = dense_spec(arch.d_model, arch.d_model,
                                         scale=0.02)
    if arch.enc_dec:
        spec["encoder"] = {
            "pos": ParamSpec((arch.n_frames, arch.d_model), scale=0.02),
            "layers": [blk.attn_block_spec(arch)] * arch.n_enc_layers,
            "norm": blk._norm_spec(arch),
        }
    if arch.vision_tokens:
        spec["img_proj"] = dense_spec(arch.d_frontend, arch.d_model)
    spec["final_norm"] = blk._norm_spec(arch)
    if not arch.tie_embeddings:
        spec["lm_head"] = ParamSpec((arch.d_model, arch.vocab_size),
                                    scale=0.02)
    if arch.mtp:
        spec["mtp"] = {
            "proj": dense_spec(2 * arch.d_model, arch.d_model),
            "block": (blk.mla_block_spec(arch, d_ff=arch.moe_d_ff_dense
                                         or arch.d_ff)
                      if arch.use_mla else blk.attn_block_spec(arch)),
            "norm": blk._norm_spec(arch),
        }
    return spec


def init_model(arch: ArchConfig, source, dtype=torch.float32,
               device=None) -> Params:
    """Random weights.  ``source`` a ``torch.Generator``: drawn from it on
    its device.  ``source`` a JAX key (``(2,)`` uint32, e.g.
    ``prng.PRNGKey(seed)``): the reference's ``init_model(arch, key)``
    weights, drawn on ``device`` by the threefry twin (None is the CUDA
    card, ``RuntimeError`` without one; ``"cpu"`` the CPU)."""
    if isinstance(source, torch.Generator):
        return init_params(model_spec(arch), source, dtype)
    return init_params(model_spec(arch), source, dtype,
                       resolve_device(device))


def n_params(arch: ArchConfig) -> int:
    return param_count(model_spec(arch))


def load_reference_params(tree, device=None) -> Params:
    """The port's parameters from the JAX package's parameter tree as
    numpy arrays (``jax.tree.map(np.asarray, params)``), so that both
    packages compute the same thing.  The reference stacks each segment's
    layers, and the encoder's, on a leading axis
    (``segments/seg0/attn/wq`` is (L, d, Hq, hd)); here they become lists
    of L per-layer trees.  The other keys (``shared_attn``,
    ``shared_proj``, ``mtp``, ...) come across whole: zamba2's shared
    block stays one tree.  ``device``: None is the CUDA card
    (``RuntimeError`` without one), ``"cpu"`` the CPU."""
    dev = resolve_device(device)

    def convert(t, i=None):
        if isinstance(t, dict):
            return {k: convert(v, i) for k, v in t.items()}
        a = np.asarray(t)
        return torch.tensor(a if i is None else a[i], device=dev)

    def layers(stacked):
        first = stacked
        while isinstance(first, dict):
            first = next(iter(first.values()))
        return [convert(stacked, i) for i in range(len(first))]

    out = {k: convert(v) for k, v in tree.items()
           if k not in ("segments", "encoder")}
    out["segments"] = {name: layers(seg)
                       for name, seg in tree["segments"].items()}
    if "encoder" in tree:
        enc = tree["encoder"]
        out["encoder"] = {k: convert(v) for k, v in enc.items()
                          if k != "layers"}
        out["encoder"]["layers"] = layers(enc["layers"])
    return Params(out)


# ---------------------------------------------------------------------------
# encoder (whisper backbone; frame embeddings from the stub frontend)
# ---------------------------------------------------------------------------

def encode_frames(params, arch: ArchConfig, frames):
    """frames: (B, F, D) precomputed frame embeddings -> the encoder's
    output (B, F, D): learned positions, then bidirectional attention
    blocks (global: ``use_flash_attention`` routes them to the kernel),
    then the encoder's norm."""
    enc = params["encoder"]
    x = frames + enc["pos"].to(frames.dtype)[None, :frames.shape[1]]
    for pl in enc["layers"]:
        def body(xc, pl=pl):
            return blk.attn_block_train(pl, arch, xc, causal=False)[0]
        x = _grad_checkpoint(body, x) if arch.remat else body(x)
    return blk._norm(arch, enc["norm"], x)


# ---------------------------------------------------------------------------
# hidden-state forward (train path)
# ---------------------------------------------------------------------------

def _grad_checkpoint(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward pass when
    gradients are being taken."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _cross_kvs(params, arch: ArchConfig, seg: Segment, enc_out):
    """Each layer's cross-attention k/v of ``enc_out`` (None per layer
    when the segment has no cross-attention or there is no encoder
    output)."""
    layers = params["segments"][seg.name]
    if not seg.cross or enc_out is None:
        return [None] * len(layers)
    cfg = blk.attn_cfg(arch, causal=False)
    return [cross_kv(pl["xattn"], cfg, enc_out) for pl in layers]


# a recurrent cell kind's (train, prefill, decode) block functions
_CELLS = {"mamba": (blk.mamba_block_train, blk.mamba_block_prefill,
                    blk.mamba_block_decode),
          "mlstm": (blk.mlstm_block_train, blk.mlstm_block_prefill,
                    blk.mlstm_block_decode),
          "slstm": (blk.slstm_block_train, blk.slstm_block_prefill,
                    blk.slstm_block_decode)}


def _layer_train(arch: ArchConfig, seg: Segment, pl, x, window, enc_kv):
    """One layer of a segment on the train path: (x, aux)."""
    if seg.kind == "attn":
        return blk.attn_block_train(pl, arch, x, window=window, moe=seg.moe,
                                    enc_kv=enc_kv)
    if seg.kind == "mla":
        return blk.mla_block_train(pl, arch, x, moe=seg.moe)
    return _CELLS[seg.kind][0](pl, arch, x)


def _layer_prefill(arch: ArchConfig, seg: Segment, pl, x, cache_len,
                   window, enc_kv):
    """One layer of a segment on the prefill: (x, aux, cache entry)."""
    if seg.kind == "attn":
        return blk.attn_block_prefill(pl, arch, x, cache_len, window=window,
                                      moe=seg.moe, enc_kv=enc_kv)
    if seg.kind == "mla":
        return blk.mla_block_prefill(pl, arch, x, cache_len, moe=seg.moe)
    return _CELLS[seg.kind][1](pl, arch, x)


def _layer_decode(arch: ArchConfig, seg: Segment, pl, x, entry, pos,
                  window, enc_kv):
    """One layer of a segment on a decode step: (x, cache entry)."""
    if seg.kind == "attn":
        return blk.attn_block_decode(pl, arch, x, entry, pos, window=window,
                                     moe=seg.moe, enc_kv=enc_kv)
    if seg.kind == "mla":
        return blk.mla_block_decode(pl, arch, x, entry, pos, moe=seg.moe)
    return _CELLS[seg.kind][2](pl, arch, x, entry, pos)


def _shared(params, arch: ArchConfig, x, y):
    """zamba2's shared block output y folded in: x + proj(y - x)."""
    return x + dense(params["shared_proj"], y - x)


def forward_hidden(params, arch: ArchConfig, x, enc_out=None):
    """(B, S, D) -> (B, S, D) through all segments and the final norm,
    cross-attending to ``enc_out`` (B, F, D) in a cross segment.  Returns
    (h, aux); ``aux`` is the MoE layers' summed balance loss (0.0
    without MoE)."""
    aux_total = 0.0
    layer_idx = 0
    for seg in build_plan(arch):
        if seg.kind == "shared":
            y, _ = blk.attn_block_train(params["shared_attn"], arch, x)
            x = _shared(params, arch, x, y)
            continue
        wins = layer_windows(arch, layer_idx, seg.n)
        for pl, w, ekv in zip(params["segments"][seg.name], wins,
                              _cross_kvs(params, arch, seg, enc_out)):
            def body(xc, pl=pl, w=w, ekv=ekv):
                return _layer_train(arch, seg, pl, xc, w, ekv)
            x, aux = _grad_checkpoint(body, x) if arch.remat else body(x)
            aux_total = aux_total + aux
        layer_idx += seg.n
    return blk._norm(arch, params["final_norm"], x), aux_total


# ---------------------------------------------------------------------------
# chunked cross-entropy (never materialises (B, S, V))
# ---------------------------------------------------------------------------

def chunked_ce(h, table, labels, chunk: int, transpose: bool):
    """h: (B, S, D); labels: (B, S) with -1 = ignore.  Mean CE over the
    valid labels.  ``S`` is padded up to a multiple of the chunk with
    label -1; each chunk's logits and ``logsumexp`` are float32 (float64
    for a float64 ``h``)."""
    b, s, _ = h.shape
    cs = min(chunk, s)
    nc = -(-s // cs)
    if nc * cs != s:
        pad = nc * cs - s
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    ct = torch.promote_types(h.dtype, torch.float32)

    def blk_fn(hb, lb):
        t = table.to(ct)
        logits = hb.to(ct) @ (t.T if transpose else t)
        logz = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, lb.clamp_min(0)[..., None])[..., 0]
        valid = lb >= 0
        return torch.where(valid, logz - ll, 0.0).sum(), valid.sum()

    total, count = 0.0, 0
    for c in range(nc):
        loss_c, n_c = _grad_checkpoint(blk_fn, h[:, c * cs:(c + 1) * cs],
                                       labels[:, c * cs:(c + 1) * cs])
        total, count = total + loss_c, count + n_c
    return total / torch.clamp_min(count, 1).to(ct)


# ---------------------------------------------------------------------------
# training objective
# ---------------------------------------------------------------------------

def lm_loss(params, arch: ArchConfig, batch, dtype=torch.bfloat16):
    """batch: tokens (B, S), labels (B, S) integer tensors (-1 = ignore),
    plus ``frames`` / ``images`` for the frontend stubs (the image
    prefix takes label -1).  Activations in ``dtype``; the readout in
    float32 (float64 when ``dtype`` is float64).  Returns a 0-d tensor:
    the cross-entropy, plus ``mtp_weight`` times the MTP head's loss
    (``arch.mtp``), plus the MoE balance loss."""
    x, prefix = _embed_inputs(params, arch, batch, dtype)
    enc_out = None
    if arch.enc_dec:
        enc_out = encode_frames(params, arch, batch["frames"].to(dtype))
    h, aux = forward_hidden(params, arch, x, enc_out)
    labels = batch["labels"]
    if prefix:
        labels = F.pad(labels, (prefix, 0), value=-1)
    tie = arch.tie_embeddings or "lm_head" not in params
    table = params["embed"]["table"] if tie else params["lm_head"]
    loss = chunked_ce(h, table, labels, arch.loss_chunk, transpose=tie)
    if arch.mtp:
        loss = loss + arch.mtp_weight * _mtp_loss(
            params, arch, h[:, prefix:], batch, dtype, table, tie)
    return loss + aux


def _mtp_loss(params, arch: ArchConfig, h, batch, dtype, table, tie):
    """DeepSeek-V3-style depth-1 multi-token prediction: one extra block
    predicts label t+1 (token t+2) from (h_t, emb(token_{t+1}))."""
    mtp = params["mtp"]
    emb_next = embed(params["embed"], batch["tokens"][:, 1:]).to(dtype)
    x = dense(mtp["proj"], torch.cat([h[:, :-1].to(dtype), emb_next],
                                     dim=-1))
    if arch.use_mla:
        x, _ = blk.mla_block_train(mtp["block"], arch, x)
    else:
        x, _ = blk.attn_block_train(mtp["block"], arch, x)
    x = blk._norm(arch, mtp["norm"], x)
    return chunked_ce(x, table, batch["labels"][:, 1:], arch.loss_chunk,
                      transpose=tie)


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

def _embed_tokens(params, arch: ArchConfig, tokens, dtype):
    x = embed(params["embed"], tokens).to(dtype)
    if arch.embed_scale:
        x = x * torch.sqrt(torch.tensor(arch.d_model, dtype=dtype,
                                        device=x.device))
    return x


def _embed_inputs(params, arch: ArchConfig, batch, dtype):
    """(x, prefix): token embeddings in ``dtype``, after the projected
    image tokens when ``arch.vision_tokens`` (then ``prefix`` is their
    number, else 0)."""
    x = _embed_tokens(params, arch, batch["tokens"], dtype)
    prefix = 0
    if arch.vision_tokens:
        img = dense(params["img_proj"], batch["images"].to(dtype))
        x = torch.cat([img, x], dim=1)
        prefix = img.shape[1]
    return x, prefix


def _readout(params, arch: ArchConfig, h):
    """float32 logits of the final-normed hidden states h (B, 1, D)."""
    if arch.tie_embeddings or "lm_head" not in params:
        return unembed(params["embed"], h.float())
    return h.float() @ params["lm_head"].float()


def lm_prefill(params, arch: ArchConfig, batch, cache_len: int,
               dtype=torch.bfloat16):
    """Prompt forward; returns (last-position logits (B, V) float32, cache).
    The cache holds each segment's list of per-layer entries: an
    attention layer's (k, v), each (B, cache_len + prefix, Hkv, hd) with
    ``prefix`` the image tokens; an MLA layer's compressed latents
    (B, cache_len, kv_lora + rope_dim); a Mamba layer's (ssm, conv_tail),
    an mLSTM's (C, n, m, conv_tail), an sLSTM's (c, n, h, m).  Each
    application of zamba2's shared block has its (k, v) under
    ``shared<i>``, a cross segment its per-layer cross-attention (k, v)
    of the encoder output under ``<segment>_cross``; ``"pos"`` is the
    prefix and prompt length."""
    x, prefix = _embed_inputs(params, arch, batch, dtype)
    enc_out = None
    if arch.enc_dec:
        enc_out = encode_frames(params, arch, batch["frames"].to(dtype))
    cache: dict[str, Any] = {}
    layer_idx = 0
    total_len = cache_len + prefix
    for seg in build_plan(arch):
        if seg.kind == "shared":
            y, _, kv = blk.attn_block_prefill(params["shared_attn"], arch, x,
                                              total_len)
            x = _shared(params, arch, x, y)
            cache[seg.name] = kv
            continue
        wins = layer_windows(arch, layer_idx, seg.n)
        ekvs = _cross_kvs(params, arch, seg, enc_out)
        entries = []
        for pl, w, ekv in zip(params["segments"][seg.name], wins, ekvs):
            x, _, c = _layer_prefill(arch, seg, pl, x, total_len, w, ekv)
            entries.append(c)
        cache[seg.name] = entries
        if seg.cross and enc_out is not None:
            cache[seg.name + "_cross"] = ekvs
        layer_idx += seg.n
    h = blk._norm(arch, params["final_norm"], x[:, -1:])
    cache["pos"] = x.shape[1]
    return _readout(params, arch, h)[:, 0], cache


def lm_decode(params, arch: ArchConfig, token, cache, dtype=torch.bfloat16):
    """One decode step. token: (B,) integers.  Returns (logits (B, V)
    float32, cache); attention and MLA caches are updated in place, the
    recurrent states replaced."""
    pos = cache["pos"]
    x = _embed_tokens(params, arch, token[:, None], dtype)
    new_cache: dict[str, Any] = {"pos": pos + 1}
    layer_idx = 0
    for seg in build_plan(arch):
        if seg.kind == "shared":
            y, kv = blk.attn_block_decode(params["shared_attn"], arch, x,
                                          cache[seg.name], pos)
            x = _shared(params, arch, x, y)
            new_cache[seg.name] = kv
            continue
        wins = layer_windows(arch, layer_idx, seg.n)
        cross = seg.name + "_cross"
        ekvs = cache.get(cross, [None] * seg.n)
        entries = []
        for pl, c, w, ekv in zip(params["segments"][seg.name],
                                 cache[seg.name], wins, ekvs):
            x, c = _layer_decode(arch, seg, pl, x, c, pos, w, ekv)
            entries.append(c)
        new_cache[seg.name] = entries
        if cross in cache:
            new_cache[cross] = ekvs
        layer_idx += seg.n
    h = blk._norm(arch, params["final_norm"], x)
    return _readout(params, arch, h)[:, 0], new_cache
