"""The port's zoo beyond qwen2 (``repro_torch.configs``, ``models``) held
against the JAX package on ``reduced()`` of codeqwen1.5-7b, gemma3-27b,
granite-34b, whisper-medium and phi-3-vision-4.2b: configs and parameter
counts, layernorm, the GELU MLP, cross-attention, the encoder, and
``lm_loss`` / ``lm_prefill`` / ``lm_decode`` with the reference's weights
carried across by ``load_reference_params``.  Inputs and weight
perturbations come from numpy seeds.

Bars: layers and the encoder rtol = atol = 1e-5 (float32 in another
order); whole models 2e-4 (``LM_TOL``, tests/test_models.py:127)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro.configs import shapes as jshapes
from repro.models import attention as jatt
from repro.models import init_model as jax_init_model
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch.configs import ARCH_NAMES, get_arch, reduced
from repro_torch.configs import shapes as tshapes
from repro_torch.core import prng
from repro_torch.core.tree import entries
from repro_torch.kernels.flash_attention import ops as flash
from repro_torch.models import attention as tatt
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm

NEW = ("codeqwen1.5-7b", "gemma3-27b", "granite-34b", "whisper-medium",
       "phi-3-vision-4.2b")
LATER = ("xlstm-125m", "zamba2-1.2b", "deepseek-v3-671b",
         "deepseek-v2-236b")         # tests/test_torch_{xlstm,mamba2,deepseek}.py
TOL = 1e-5            # layers: float32 in another order
LM_TOL = 2e-4         # whole models: tests/test_models.py:127
NORMAL_ULP = 4        # tests/test_torch_prng.py


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _archs(name, flash_on=False, **kw):
    """The reference's and the port's ``reduced(name)``, both with ``kw``
    replaced; the port's with ``use_flash_attention=flash_on``."""
    j = dataclasses.replace(jax_reduced(jax_get_arch(name)), **kw)
    t = dataclasses.replace(reduced(get_arch(name)), **kw,
                            use_flash_attention=flash_on)
    return j, t


def _fan_in(key, spec):
    """A matrix's fan-in in one layer: its first axis (an attention
    output's first two, heads x head_dim; an expert's second, after the
    expert axis)."""
    if key.endswith(("['wo']", "['w_o']")):
        return int(np.prod(spec.shape[:2]))
    if len(spec.shape) == 3 and key.endswith(("['gate']", "['up']",
                                               "['down']")):
        return spec.shape[1]
    return spec.shape[0]


@functools.lru_cache(maxsize=None)
def weights(name, **kw):
    """Weights of ``reduced(name)`` (with ``kw``) in the reference's tree:
    each normal matrix drawn at its own layer's fan-in (the reference's
    init takes a stacked layer axis as the fan-in, std 1/2 for 4 layers,
    which makes activations of ~40 at this width: ROADMAP queue 3), every
    leaf then moved off its init value (biases and norms are zeros and
    ones there) by seeded numpy noise: (JAX tree, the port's Params)."""
    ja, ta = _archs(name, **kw)
    specs = {k: v[0] if isinstance(v, list) else v
             for k, v in entries(tlm.model_spec(ta))}
    rng = np.random.default_rng(0)

    def leaf(path, a):
        key = "/".join(str(k) for k in path)
        spec = specs[key]
        a = np.asarray(a)
        if spec.init == "normal" and spec.scale is None:
            a = rng.standard_normal(a.shape) / np.sqrt(_fan_in(key, spec))
        return (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(
        leaf, jax_init_model(ja, jax.random.PRNGKey(0)))
    return (jax.tree.map(jnp.asarray, tree),
            tlm.load_reference_params(tree, device="cpu"))


def batch_of(arch, seed, b, s, labels=False):
    """Tokens (and labels) from a numpy seed, with the frontend stubs'
    ``frames`` / ``images`` as 0.02 x normal: (JAX batch, port batch)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, arch.vocab_size, (b, s))}
    if labels:
        lab = np.concatenate([out["tokens"][:, 1:], np.full((b, 1), -1)],
                             axis=1)
        lab[0, s // 3] = -1
        out["labels"] = lab
    if arch.enc_dec:
        out["frames"] = (0.02 * rng.standard_normal(
            (b, arch.n_frames, arch.d_model))).astype(np.float32)
    if arch.vision_tokens:
        out["images"] = (0.02 * rng.standard_normal(
            (b, arch.vision_tokens, arch.d_frontend))).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: _t(v) if v.dtype == np.float32 else _t(v).long()
             for k, v in out.items()})


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCH_NAMES)
def test_config_and_parameter_count_match_the_reference(name):
    """Field for field, at full width and ``reduced()``, and ``n_params``
    of both."""
    t, j = get_arch(name), jax_get_arch(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(reduced(t)) == dataclasses.asdict(
        jax_reduced(j))
    assert tlm.n_params(t) == jlm.n_params(j)
    assert tlm.n_params(reduced(t)) == jlm.n_params(jax_reduced(j))


def test_the_port_registers_six_architectures():
    """All ten of the reference's architectures, in its order."""
    from repro.configs import ARCH_NAMES as JAX_ARCH_NAMES

    assert ARCH_NAMES == JAX_ARCH_NAMES == [
        "xlstm-125m", "whisper-medium", "phi-3-vision-4.2b",
        "codeqwen1.5-7b", "gemma3-27b", "granite-34b", "qwen2-1.5b",
        "deepseek-v3-671b", "deepseek-v2-236b", "zamba2-1.2b"]
    assert tlm.n_params(get_arch("phi-3-vision-4.2b")) == 3_824_225_280
    assert tlm.n_params(get_arch("whisper-medium")) == 759_784_448


@pytest.mark.parametrize("name", LATER)
def test_unported_architectures_still_raise(name):
    """The four architectures ported last plan the reference's segments
    (kind, layers, MoE, dense d_ff, name) at full width and reduced; an
    unknown name still raises."""
    for t, j in ((get_arch(name), jax_get_arch(name)),
                 (reduced(get_arch(name)), jax_reduced(jax_get_arch(name)))):
        assert ([dataclasses.asdict(s) for s in tlm.build_plan(t)]
                == [dataclasses.asdict(s) for s in jlm.build_plan(j)])
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch(name.upper())


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_shapes_match_the_reference(name):
    assert tshapes.SHAPES.keys() == jshapes.SHAPES.keys()
    for key, shape in tshapes.SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(
            jshapes.SHAPES[key])
        arch, jarch = get_arch(name), jax_get_arch(name)
        assert tshapes.applicable(arch, shape) == jshapes.applicable(
            jarch, jshapes.SHAPES[key])
        assert tshapes.skip_reason(arch, shape) == jshapes.skip_reason(
            jarch, jshapes.SHAPES[key])


# ---------------------------------------------------------------------------
# layers, cross-attention and the encoder
# ---------------------------------------------------------------------------

def test_layernorm_matches_the_reference():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 40, 64)) * 3 + 1.5).astype(np.float32)
    p = {"scale": rng.standard_normal(64).astype(np.float32),
         "bias": rng.standard_normal(64).astype(np.float32)}
    _close(tlayers.layernorm({k: _t(v) for k, v in p.items()}, _t(x)),
           jlayers.layernorm(jax.tree.map(jnp.asarray, p), jnp.asarray(x)),
           TOL)


def test_gelu_mlp_and_dense_with_bias_match_the_reference():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 24, 16)).astype(np.float32)
    p = {"up": {"w": rng.standard_normal((16, 40)).astype(np.float32) / 4,
                "b": rng.standard_normal(40).astype(np.float32)},
         "down": {"w": rng.standard_normal((40, 16)).astype(np.float32) / 6,
                  "b": rng.standard_normal(16).astype(np.float32)}}
    tp = jax.tree.map(_t, p)
    jp = jax.tree.map(jnp.asarray, p)
    _close(tlayers.gelu_mlp(tp, _t(x)), jlayers.gelu_mlp(jp, jnp.asarray(x)),
           TOL)
    _close(tlayers.dense(tp["up"], _t(x)), jlayers.dense(jp["up"],
                                                         jnp.asarray(x)), TOL)
    spec = tlayers.gelu_mlp_spec(16, 40)
    assert spec["up"]["b"].init == "zeros" and spec["down"]["w"].shape == (
        40, 16)
    assert tlayers.param_count(spec) == jlayers.param_count(
        jlayers.gelu_mlp_spec(16, 40))


@pytest.mark.parametrize("hkv,bias", [(4, True), (2, False), (1, True)])
def test_cross_attn_and_cross_kv_match_the_reference(hkv, bias):
    """Queries (B, 12, D) against encoder output (B, 20, D): MHA, GQA and
    MQA, with and without QKV bias."""
    rng = np.random.default_rng(3 + hkv)
    kw = dict(d_model=64, n_heads=4, n_kv_heads=hkv, head_dim=16,
              qkv_bias=bias, causal=False, chunk_q=8)
    jcfg, tcfg = jatt.AttnConfig(**kw), tatt.AttnConfig(**kw)
    shapes = {"wq": (64, 4, 16), "wk": (64, hkv, 16), "wv": (64, hkv, 16),
              "wo": (4, 16, 64)}
    if bias:
        shapes.update(bq=(4, 16), bk=(hkv, 16), bv=(hkv, 16))
    p = {k: (rng.standard_normal(s) / 8).astype(np.float32)
         for k, s in shapes.items()}
    x = rng.standard_normal((2, 12, 64)).astype(np.float32)
    enc = rng.standard_normal((2, 20, 64)).astype(np.float32)
    jp, tp = jax.tree.map(jnp.asarray, p), jax.tree.map(_t, p)
    jkv = jatt.cross_kv(jp, jcfg, jnp.asarray(enc))
    tkv = tatt.cross_kv(tp, tcfg, _t(enc))
    for got, want in zip(tkv, jkv):
        _close(got, want, TOL)
    _close(tatt.cross_attn(tp, tcfg, _t(x), tkv),
           jatt.cross_attn(jp, jcfg, jnp.asarray(x), jkv), TOL)
    assert tlayers.param_count(tatt.cross_attn_spec(tcfg)) == \
        jlayers.param_count(jatt.cross_attn_spec(jcfg))


def test_cross_block_matches_the_reference():
    """One whisper decoder block (layernorm, self-attention, cross-
    attention, GELU MLP, residuals) in its train, prefill and decode
    forms."""
    ja, ta = _archs("whisper-medium")
    jp, tp = weights("whisper-medium")
    jl = jax.tree.map(lambda a: a[1], jp["segments"]["seg0"])
    tl = tp["segments"]["seg0"][1]
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 10, 64)).astype(np.float32)
    enc = rng.standard_normal((2, 8, 64)).astype(np.float32)
    jcfg = jlm.blk.attn_cfg(ja, causal=False)
    jkv = jatt.cross_kv(jl["xattn"], jcfg, jnp.asarray(enc))
    tkv = tatt.cross_kv(tl["xattn"], tlm.blk.attn_cfg(ta, causal=False),
                        _t(enc))
    jy, _ = jlm.blk.attn_block_train(jl, ja, jnp.asarray(x), enc_kv=jkv)
    ty, aux = tlm.blk.attn_block_train(tl, ta, _t(x), enc_kv=tkv)
    assert aux == 0.0
    _close(ty, jy, TOL)
    jy, _, (jk, jv) = jlm.blk.attn_block_prefill(jl, ja, jnp.asarray(x), 12,
                                                 enc_kv=jkv)
    ty, _, (tk, tv) = tlm.blk.attn_block_prefill(tl, ta, _t(x), 12,
                                                 enc_kv=tkv)
    for got, want in ((ty, jy), (tk, jk), (tv, jv)):
        _close(got, want, TOL)
    xd = rng.standard_normal((2, 1, 64)).astype(np.float32)
    jy, _ = jlm.blk.attn_block_decode(jl, ja, jnp.asarray(xd), (jk, jv),
                                      jnp.asarray(10, jnp.int32), enc_kv=jkv)
    ty, _ = tlm.blk.attn_block_decode(tl, ta, _t(xd), (tk, tv), 10,
                                      enc_kv=tkv)
    _close(ty, jy, TOL)


@pytest.mark.parametrize("frames,flash_on,calls", [(8, False, 0),
                                                   (200, True, 2)])
def test_encode_frames_matches_the_reference(monkeypatch, frames, flash_on,
                                             calls):
    """The encoder of reduced whisper (2 bidirectional layers) at its 8
    frames, and at 200 frames with ``use_flash_attention`` (both layers
    through the kernel route, its plain version on the CPU) against the
    reference with the flag off: its own flash wrapper would pad the 200
    keys to 256 without masking them (ROADMAP queue 3)."""
    seen = []
    real = flash.flash_sdpa
    monkeypatch.setattr(flash, "flash_sdpa", lambda *a, **k: seen.append(
        k["causal"]) or real(*a, **k))
    ja, ta = _archs("whisper-medium", flash_on, n_frames=frames)
    jp, tp = weights("whisper-medium", n_frames=frames)
    jb, tb = batch_of(ta, 5, 2, 4)
    want = jlm.encode_frames(jp, ja, jb["frames"])
    got = tlm.encode_frames(tp, ta, tb["frames"])
    assert seen == [False] * calls
    _close(got, want, TOL)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NEW)
def test_init_model_from_key_is_the_references(name):
    """Leaf for leaf in the reference's flatten order, under its key
    strings (the encoder's layer list stacked as the reference stacks
    ``encoder/layers``): zeros and ones exactly, normals within the
    twin's ulps."""
    ja, ta = _archs(name)
    want = {"/".join(str(k) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                jax_init_model(ja, jax.random.PRNGKey(2)))[0]}
    got = {k: (v.stacked() if hasattr(v, "stacked") else v).numpy()
           for k, v in entries(tlm.init_model(ta, prng.PRNGKey(2),
                                              device="cpu").tree())}
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == w.dtype, k
        ulps = np.abs(g.view(np.int32).astype(np.int64)
                      - w.view(np.int32).astype(np.int64))
        assert ulps.max() <= NORMAL_ULP + 1, k


def test_load_reference_params_splits_the_encoder():
    jp, tp = weights("whisper-medium")
    layers = tp["encoder"]["layers"]
    assert len(layers) == 2 and len(tp["segments"]["seg0"]) == 4
    np.testing.assert_array_equal(
        layers[1]["attn"]["wq"].numpy(),
        np.asarray(jp["encoder"]["layers"]["attn"]["wq"][1]))
    np.testing.assert_array_equal(tp["encoder"]["pos"].numpy(),
                                  np.asarray(jp["encoder"]["pos"]))
    assert sum(v.numel() for v in tp.parameters()) == tlm.n_params(
        _archs("whisper-medium")[1])


@pytest.mark.parametrize("name", NEW)
def test_lm_loss_matches_the_reference(name):
    """S = 20 over chunks of 16 (a padded last chunk); phi-3's four image
    tokens take label -1, whisper's frames go through the encoder."""
    ja, ta = _archs(name)
    jp, tp = weights(name)
    jb, tb = batch_of(ta, 6, 2, 20, labels=True)
    want = float(jlm.lm_loss(jp, ja, jb, dtype=jnp.float32))
    got = tlm.lm_loss(tp, ta, tb, dtype=torch.float32)
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=LM_TOL)


def _prefill_decode(name, s, flash_on=False, steps=4, **kw):
    """Last-position logits of a prompt of ``s`` tokens (after any image
    prefix), then ``steps`` teacher-forced decode steps, in both packages
    (the reference with its flag off); returns the flash wrapper's
    calls."""
    ja, ta = _archs(name, flash_on, **kw)
    jp, tp = weights(name, **kw)
    jb, tb = batch_of(ta, s, 2, s + steps)
    prompt = {k: v[:, :s] if k == "tokens" else v for k, v in jb.items()}
    jl, jc = jlm.lm_prefill(jp, ja, prompt, cache_len=s + steps,
                            dtype=jnp.float32)
    calls = []
    real = flash.flash_sdpa
    flash.flash_sdpa = lambda *a, **k: calls.append(k) or real(*a, **k)
    try:
        tl, tc = tlm.lm_prefill(
            tp, ta, {k: v[:, :s] if k == "tokens" else v
                     for k, v in tb.items()},
            cache_len=s + steps, dtype=torch.float32)
    finally:
        flash.flash_sdpa = real
    _close(tl, jl, LM_TOL)
    prefix = ta.vision_tokens
    assert tc["pos"] == int(jc["pos"]) == prefix + s
    assert tc["seg0"][0][0].shape[1] == jc["seg0"][0].shape[2] \
        == prefix + s + steps
    assert ("seg0_cross" in tc) == ("seg0_cross" in jc) == ta.enc_dec
    for t in range(s, s + steps):
        tok = jb["tokens"][:, t]
        jl, jc = jlm.lm_decode(jp, ja, tok.astype(jnp.int32), jc,
                               dtype=jnp.float32)
        tl, tc = tlm.lm_decode(tp, ta, tb["tokens"][:, t], tc,
                               dtype=torch.float32)
        _close(tl, jl, LM_TOL)
    return calls


@pytest.mark.parametrize("name", NEW)
def test_lm_prefill_and_decode_match_the_reference(name):
    """S = 24 (gemma's 8-token windows bite), the chunked path, then four
    decode steps (whisper's through its cross cache, phi-3's at
    positions after the image prefix)."""
    assert _prefill_decode(name, 24) == []


@pytest.mark.parametrize("name,kw,s,calls", [
    ("codeqwen1.5-7b", {}, 160, 4),
    ("granite-34b", {}, 160, 4),                     # MQA: 4 heads on 1
    ("gemma3-27b", {"n_layers": 6}, 160, 1),         # its global layer 6
    ("whisper-medium", {"n_frames": 200}, 130, 6),   # 2 encoder + 4 decoder
    ("phi-3-vision-4.2b", {"head_dim": 96}, 128, 4),  # hd 96, 132 positions
])
def test_flash_route_matches_the_reference(name, kw, s, calls):
    """``use_flash_attention`` on (the kernel route; its plain version on
    the CPU) against the reference with the flag off: every global
    full-sequence self-attention takes the route, windowed layers and
    cross-attention do not."""
    got = _prefill_decode(name, s, flash_on=True, steps=2, **kw)
    assert len(got) == calls
    assert all(c["window"] == 0 for c in got)
    if name == "whisper-medium":
        assert [c["causal"] for c in got] == [False, False] + [True] * 4


def test_other_block_kinds_still_raise():
    """The other block kinds grafted onto reduced codeqwen (an MTP head
    on attention blocks, MoE FFNs, MLA, a pure Mamba stack) build the
    reference's plan and parameter count."""
    for kw in ({"mtp": True}, {"moe_experts": 4, "moe_top_k": 2},
               {"use_mla": True}, {"block_pattern": "mamba"}):
        t = dataclasses.replace(reduced(get_arch("codeqwen1.5-7b")), **kw)
        j = dataclasses.replace(jax_reduced(jax_get_arch("codeqwen1.5-7b")),
                                **kw)
        assert ([dataclasses.asdict(s) for s in tlm.build_plan(t)]
                == [dataclasses.asdict(s) for s in jlm.build_plan(j)])
        assert tlm.n_params(t) == jlm.n_params(j), kw
