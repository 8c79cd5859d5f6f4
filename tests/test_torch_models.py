"""The port's model zoo slice (``repro_torch.configs``, ``models``,
``launch.serve``) held against the JAX package on ``reduced(qwen2-1.5b)``:
layers, attention, ``lm_prefill`` / ``lm_decode`` and greedy serving on
the CPU, with the reference's weights carried across by
``load_reference_params``.  Inputs and weight perturbations come from
numpy seeds."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro.models import attention as jatt
from repro.models import init_model as jax_init_model
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch.configs import get_arch, reduced
from repro_torch.kernels.flash_attention import ops as flash
from repro_torch.launch import serve
from repro_torch.models import attention as tatt
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm

NAME = "qwen2-1.5b"
TOL = 1e-5            # layers: float32 in another order
LM_TOL = 2e-4         # whole models: tests/test_models.py:127


def _t(a):
    return torch.as_tensor(np.asarray(a))


@functools.lru_cache(maxsize=None)
def _weights():
    """The reference's reduced qwen2 weights, every leaf moved off its
    init value (biases and norms are zeros and ones there) by seeded
    numpy noise: (JAX tree, numpy tree)."""
    arch = jax_reduced(jax_get_arch(NAME))
    rng = np.random.default_rng(0)
    tree = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
                   ).astype(np.float32),
        jax_init_model(arch, jax.random.PRNGKey(0)))
    return jax.tree.map(jnp.asarray, tree), tree


def _archs(flash_on=True):
    j = jax_reduced(jax_get_arch(NAME))
    t = reduced(get_arch(NAME))
    return j, dataclasses.replace(t, use_flash_attention=flash_on)


def _tokens(seed, b, s, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_config_and_reduced_match_the_reference():
    assert (dataclasses.asdict(get_arch(NAME))
            == dataclasses.asdict(jax_get_arch(NAME)))
    assert (dataclasses.asdict(reduced(get_arch(NAME)))
            == dataclasses.asdict(jax_reduced(jax_get_arch(NAME))))
    fields = [(f.name, f.default) for f in dataclasses.fields(tlm.ArchConfig)]
    assert fields == [(f.name, f.default)
                      for f in dataclasses.fields(jlm.ArchConfig)]


@pytest.mark.parametrize("name", ["xlstm-125m", "zamba2-1.2b",
                                  "deepseek-v3-671b"])
def test_unported_architectures_are_not_registered(name):
    """The last three families the port took are registered with the
    reference's fields; a name neither package has still raises."""
    assert (dataclasses.asdict(get_arch(name))
            == dataclasses.asdict(jax_get_arch(name)))
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch(name + "-nope")


def test_full_width_parameter_count():
    arch = get_arch(NAME)
    assert tlm.n_params(arch) == 1_543_714_304 == jlm.n_params(
        jax_get_arch(NAME))
    assert tlm.n_params(reduced(arch)) == jlm.n_params(
        jax_reduced(jax_get_arch(NAME)))


def test_init_model_follows_the_init_rules():
    arch = reduced(get_arch(NAME))
    p = tlm.init_model(arch, torch.Generator().manual_seed(3))
    again = tlm.init_model(arch, torch.Generator().manual_seed(3))
    layers = p["segments"]["seg0"]
    assert len(layers) == arch.n_layers
    a = layers[1]["attn"]
    assert torch.equal(a["wq"], again["segments"]["seg0"][1]["attn"]["wq"])
    assert float(a["bq"].abs().max()) == 0.0
    assert torch.equal(layers[0]["norm1"]["scale"], torch.ones(64))
    assert abs(float(a["wq"].std()) - 64 ** -0.5) < 0.02
    assert abs(float(layers[2]["ffn"]["down"]["w"].std()) - 128 ** -0.5) \
        < 0.01
    assert abs(float(p["embed"]["table"].std()) - 0.02) < 0.002
    assert "lm_head" not in p                 # tied embeddings
    assert sum(x.numel() for x in p.parameters()) == tlm.n_params(arch)


# ---------------------------------------------------------------------------
# layers and attention
# ---------------------------------------------------------------------------

def test_rmsnorm_rope_swiglu_match_the_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 40, 4, 16)).astype(np.float32) * 3
    scale = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        tlayers.rmsnorm({"scale": _t(scale)}, _t(x)).numpy(),
        jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)),
        rtol=TOL, atol=TOL)
    pos = np.arange(1000, 1040, dtype=np.int32)
    for theta in (1e4, 1e6):
        np.testing.assert_allclose(
            tlayers.apply_rope(_t(x), _t(pos), theta).numpy(),
            jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
            rtol=TOL, atol=TOL)
    p = {k: {"w": rng.standard_normal(s).astype(np.float32) / 8}
         for k, s in (("gate", (16, 24)), ("up", (16, 24)),
                      ("down", (24, 16)))}
    np.testing.assert_allclose(
        tlayers.swiglu({k: {"w": _t(v["w"])} for k, v in p.items()},
                       _t(x)).numpy(),
        jlayers.swiglu(jax.tree.map(jnp.asarray, p), jnp.asarray(x)),
        rtol=TOL, atol=TOL)


def _block_weights():
    """One block of the reduced model's shapes as numpy arrays: matrices
    drawn at the fan-in of each projection (d_model for wq/wk/wv, gate
    and up; Hq * hd for wo; d_ff for down), biases as noise, norms one
    plus noise.  (The reference's own init takes the fan-in from the
    stacked layer axis, std 1/sqrt(4) here, which makes scores ~16x
    larger than at this scale: ROADMAP queue 3.)"""
    rng = np.random.default_rng(11)

    def w(shape, fan_in):
        return (rng.standard_normal(shape) * fan_in ** -0.5).astype(
            np.float32)

    def noise(shape, base=0.0):
        return (base + 0.05 * rng.standard_normal(shape)).astype(np.float32)

    return {
        "norm1": {"scale": noise(64, 1.0)},
        "attn": {"wq": w((64, 4, 16), 64), "wk": w((64, 2, 16), 64),
                 "wv": w((64, 2, 16), 64), "wo": w((4, 16, 64), 64),
                 "bq": noise((4, 16)), "bk": noise((2, 16)),
                 "bv": noise((2, 16))},
        "norm2": {"scale": noise(64, 1.0)},
        "ffn": {"gate": {"w": w((64, 128), 64)}, "up": {"w": w((64, 128), 64)},
                "down": {"w": w((128, 64), 128)}},
    }


def _layer_attn(flash_on):
    """The block's attention weights in both packages, and the two
    AttnConfigs."""
    ja, ta = _archs(flash_on)
    jcfg = dataclasses.replace(jlm.blk.attn_cfg(ja), use_flash=flash_on)
    tcfg = tlm.blk.attn_cfg(ta)
    w = _block_weights()["attn"]
    return jcfg, tcfg, {k: jnp.asarray(v) for k, v in w.items()}, \
        {k: _t(v) for k, v in w.items()}


@pytest.mark.parametrize("flash_on", [False, True])
def test_attn_prefill_and_decode_match_the_reference(flash_on):
    """S = 160: the port's kernel route (plain version on the CPU) or its
    chunked path vs the reference layer (its own Pallas kernel in
    interpret mode, or its XLA path); then one decode step on the
    caches."""
    jcfg, tcfg, jl, tl = _layer_attn(flash_on)
    s, cache_len = 160, 170
    x = np.random.default_rng(2).standard_normal((2, s, 64)).astype(
        np.float32)
    jy, (jk, jv) = jatt.attn_prefill(jl, jcfg, jnp.asarray(x), cache_len)
    before = flash.launches
    ty, (tk, tv) = tatt.attn_prefill(tl, tcfg, _t(x), cache_len)
    assert flash.launches == before
    for got, want in ((ty, jy), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    xd = np.random.default_rng(3).standard_normal((2, 1, 64)).astype(
        np.float32)
    jy, jk, jv = jatt.attn_decode(jl, jcfg, jnp.asarray(xd), jk, jv,
                                  jnp.asarray(s, jnp.int32))
    ty, tk, tv = tatt.attn_decode(tl, tcfg, _t(xd), tk, tv, s)
    for got, want in ((ty, jy), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("flash_on", [False, True])
def test_attn_block_train_matches_the_reference(flash_on):
    """One whole block (norms, attention, SwiGLU, residuals) at S = 160."""
    ja, ta = _archs(flash_on)
    ja = dataclasses.replace(ja, use_flash_attention=flash_on)
    w = _block_weights()
    x = np.random.default_rng(5).standard_normal((2, 160, 64)).astype(
        np.float32)
    jy, _ = jlm.blk.attn_block_train(jax.tree.map(jnp.asarray, w), ja,
                                     jnp.asarray(x))
    ty, aux = tlm.blk.attn_block_train(jax.tree.map(_t, w), ta, _t(x))
    assert aux == 0.0
    np.testing.assert_allclose(ty.numpy(), jy, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("s,window,flash_on,routed", [
    (160, None, True, True), (127, None, True, False),
    (160, 0, True, False), (160, None, False, False)])
def test_sdpa_route_condition(monkeypatch, s, window, flash_on, routed):
    """The kernel route needs use_flash, no window, Sq == Sk and S >= 128."""
    calls = []
    real = flash.flash_sdpa
    monkeypatch.setattr(flash, "flash_sdpa",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _, tcfg, _, tl = _layer_attn(flash_on)
    x = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (1, s, 64)).astype(np.float32))
    tatt.attn_forward(tl, tcfg, x, window=window)
    assert len(calls) == int(routed)


# ---------------------------------------------------------------------------
# the model: prefill, decode, serving
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _port_params():
    return tlm.load_reference_params(_weights()[1], device="cpu")


@pytest.mark.parametrize("s,flash_calls", [(160, 4), (64, 0)])
def test_lm_prefill_and_decode_match_the_reference(monkeypatch, s,
                                                   flash_calls):
    """Last-position logits of the prompt (S = 160 through the kernel
    route in all 4 layers, S = 64 through the chunked path), then four
    teacher-forced decode steps."""
    calls = []
    real = flash.flash_sdpa
    monkeypatch.setattr(flash, "flash_sdpa",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    jp, _ = _weights()
    ja, ta = _archs(True)
    tp = _port_params()
    toks = _tokens(s, 2, s + 4)
    jl, jc = jlm.lm_prefill(jp, ja, {"tokens": jnp.asarray(toks[:, :s])},
                            cache_len=s + 4, dtype=jnp.float32)
    tl, tc = tlm.lm_prefill(tp, ta, {"tokens": _t(toks[:, :s])},
                            cache_len=s + 4, dtype=torch.float32)
    assert len(calls) == flash_calls
    np.testing.assert_allclose(tl.numpy(), jl, rtol=LM_TOL, atol=LM_TOL)
    assert tc["pos"] == int(jc["pos"]) == s
    for t in range(s, s + 4):
        jl, jc = jlm.lm_decode(jp, ja, jnp.asarray(toks[:, t], jnp.int32),
                               jc, dtype=jnp.float32)
        tl, tc = tlm.lm_decode(tp, ta, _t(toks[:, t]), tc,
                               dtype=torch.float32)
        np.testing.assert_allclose(tl.numpy(), jl, rtol=LM_TOL, atol=LM_TOL)


def test_reference_flag_never_reaches_its_kernel(monkeypatch):
    """A reference fault, recorded (ROADMAP queue 3): with
    use_flash_attention=True the JAX lm_prefill passes every layer a
    traced window, so its Pallas kernel is never called, where the port's
    routes all 4 layers (test above)."""
    import repro.kernels.flash_attention.ops as jflash

    calls = []
    real = jflash.flash_sdpa
    monkeypatch.setattr(jflash, "flash_sdpa",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    jp, _ = _weights()
    ja = dataclasses.replace(_archs()[0], use_flash_attention=True)
    jlm.lm_prefill(jp, ja, {"tokens": jnp.asarray(_tokens(0, 1, 128))},
                   cache_len=130, dtype=jnp.float32)
    assert calls == []


def _jax_greedy(jp, ja, prompts, gen_len):
    """The reference serve loop (launch/serve.py) on given prompts:
    (tokens (B, gen_len), logits (gen_len, B, V))."""
    cache_len = prompts.shape[1] + gen_len
    prefill = jax.jit(lambda p, b: jlm.lm_prefill(
        p, ja, b, cache_len=cache_len, dtype=jnp.float32))
    decode = jax.jit(lambda p, t, c: jlm.lm_decode(p, ja, t, c,
                                                   dtype=jnp.float32))
    logits, cache = prefill(jp, {"tokens": jnp.asarray(prompts)})
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    toks, lgs = [tok], [logits]
    for _ in range(gen_len - 1):
        logits, cache = decode(jp, tok, cache)
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        toks.append(tok)
        lgs.append(logits)
    return np.stack(toks, 1), np.stack(lgs)


def greedy_near_tie(tok_p, tok_r, logits_r):
    """Positions (row, step) where two greedy runs first part; each must
    be a near-tie: the two chosen tokens' logits in the reference within
    rtol=atol=1e-5 (the rule of tests/test_torch_solver.py).  A row is
    not compared after it parts."""
    parted = []
    for row in range(tok_r.shape[0]):
        diff = np.nonzero(tok_p[row] != tok_r[row])[0]
        if diff.size:
            t = int(diff[0])
            a, b = logits_r[t, row, tok_p[row, t]], logits_r[t, row,
                                                             tok_r[row, t]]
            assert np.isclose(a, b, rtol=1e-5, atol=1e-5), (row, t, a, b)
            parted.append((row, t))
    return parted


@pytest.mark.parametrize("prompt_len", [160, 32])
def test_serve_lm_greedy_tokens_match_the_reference(prompt_len):
    jp, _ = _weights()
    ja, ta = _archs(True)
    res = serve.serve_lm(ta, batch=3, prompt_len=prompt_len, gen_len=6,
                         waves=2, seed=5, device="cpu",
                         params=_port_params())
    assert len(res.tokens) == 2 and res.decode_tokens == 2 * 3 * 5
    assert res.decode_tokens_per_s > 0
    assert not torch.equal(res.prompts[0], res.prompts[1])
    for prompts, toks, logits in zip(res.prompts, res.tokens, res.logits):
        assert toks.shape == (3, 6) and logits.shape == (6, 3, 256)
        tok_r, logits_r = _jax_greedy(jp, ja, prompts.numpy(), 6)
        np.testing.assert_allclose(logits[0].numpy(), logits_r[0],
                                   rtol=LM_TOL, atol=LM_TOL)
        assert greedy_near_tie(toks.numpy(), tok_r, logits_r) == []


def test_serve_lm_prompts_follow_the_seed():
    ta = _archs(False)[1]
    kw = dict(batch=2, prompt_len=8, gen_len=3, waves=1, device="cpu")
    a = serve.serve_lm(ta, seed=1, **kw)
    b = serve.serve_lm(ta, seed=1, **kw)
    assert torch.equal(a.prompts[0], b.prompts[0])
    assert torch.equal(a.tokens[0], b.tokens[0])


def test_serve_main_has_no_dgo_and_needs_a_card():
    """``--dgo`` (with ``--ckpt-dir`` too) and the LM branch both need a
    card."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.main(["--dgo", "--ckpt-dir", "ckpt"])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.main(["--dgo", "--problem", "rastrigin", "--n-vars", "2"])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.main(["--arch", NAME, "--reduced"])
