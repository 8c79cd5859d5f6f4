"""Mamba2 and zamba2-1.2b on the port (``repro_torch.models.mamba2`` and
the shared attention block of ``models.lm``) held against the JAX
package: the SSD cell's full-sequence pass and its decode step, states
included, at the sequence lengths of tests/test_seqmodels.py; and
``reduced()`` zamba2 — ``lm_loss``, ``lm_prefill`` / ``lm_decode`` with
every cache entry, the flash route of its shared block against the
reference with its own flag on (its Pallas kernel in interpret mode),
its initial weights from a key and its shared block as one tree.
Weights come across by ``load_reference_params``; inputs and weight
perturbations come from numpy seeds.

Bars: cells rtol = atol = 1e-5 (float32 in another order); whole models
2e-4 (``LM_TOL``, tests/test_models.py:127)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import init_model as jax_init_model
from repro.models import lm as jlm
from repro.models import mamba2 as jm2
from repro_torch.configs import get_arch
from repro_torch.core import prng
from repro_torch.core.tree import entries, tree_map
from repro_torch.kernels.flash_attention import ops as flash
from repro_torch.models import lm as tlm
from repro_torch.models import mamba2 as tm2
from repro_torch.models.layers import ParamSpec
from test_torch_zoo import (
    LM_TOL,
    NORMAL_ULP,
    TOL,
    _archs,
    _close,
    _t,
    batch_of,
    weights,
)

NAME = "zamba2-1.2b"


def cell_params(spec, seed):
    """Weights for a port ParamSpec tree from a numpy seed: normals at
    their scale or 1/sqrt(fan-in), zeros and ones moved off their init
    value by 0.05 x normal: (JAX tree, torch tree)."""
    rng = np.random.default_rng(seed)

    def draw(s):
        if isinstance(s, dict):
            return {k: draw(v) for k, v in s.items()}
        assert isinstance(s, ParamSpec)
        if s.init == "normal":
            std = s.scale or 1.0 / np.sqrt(s.shape[0])
            a = std * rng.standard_normal(s.shape)
        else:
            a = (np.ones if s.init == "ones" else np.zeros)(s.shape)
        return (a + 0.05 * rng.standard_normal(s.shape)).astype(np.float32)

    tree = draw(spec)
    return jax.tree.map(jnp.asarray, tree), jax.tree.map(_t, tree)


def inputs(seed, shape, scale=0.5):
    x = (scale * np.random.default_rng(seed).standard_normal(shape)
         ).astype(np.float32)
    return jnp.asarray(x), _t(x)


def close_trees(got, want, tol=TOL):
    """Tuples / lists of tensors against the reference's arrays."""
    got, want = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w, tol)


def assert_init_is_the_references(name):
    """``init_model`` from a key, leaf for leaf in the reference's
    flatten order under its key strings: zeros and ones exactly, normals
    within the threefry twin's ulps."""
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


def prefill_decode(name, s, steps=3, flash_on=False, ref_flash=False,
                   **kw):
    """A prompt of ``s`` tokens prefilled and ``steps`` teacher-forced
    decode steps in both packages, logits at ``LM_TOL`` each step (the
    port with ``use_flash_attention=flash_on``, the reference with
    ``ref_flash``).  Returns (port cache, reference cache) after the
    prefill — copies, since decode updates the port's in place — and the
    flash wrapper's calls."""
    ja, ta = _archs(name, flash_on, **kw)
    ja = dataclasses.replace(ja, use_flash_attention=ref_flash)
    jp, tp = weights(name, **kw)
    jb, tb = batch_of(ta, s, 2, s + steps)
    jl, jc = jax.jit(lambda p, t: jlm.lm_prefill(
        p, ja, {"tokens": t}, cache_len=s + steps, dtype=jnp.float32))(
        jp, jb["tokens"][:, :s])
    decode = jax.jit(lambda p, t, c: jlm.lm_decode(p, ja, t, c,
                                                   dtype=jnp.float32))
    calls = []
    real = flash.flash_sdpa
    flash.flash_sdpa = lambda *a, **k: calls.append(k) or real(*a, **k)
    try:
        tl, tc = tlm.lm_prefill(tp, ta, {"tokens": tb["tokens"][:, :s]},
                                cache_len=s + steps, dtype=torch.float32)
    finally:
        flash.flash_sdpa = real
    _close(tl, jl, LM_TOL)
    assert tc["pos"] == int(jc["pos"]) == s
    first = (tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor)
                       else t, tc), jc)
    for t in range(s, s + steps):
        jl, jc = decode(jp, jb["tokens"][:, t].astype(jnp.int32), jc)
        tl, tc = tlm.lm_decode(tp, ta, tb["tokens"][:, t], tc,
                               dtype=torch.float32)
        _close(tl, jl, LM_TOL)
    return first, calls


def stacked_entries(layers):
    """A port segment's per-layer cache entries as the reference's
    stacked ones."""
    return jax.tree.map(lambda *ts: torch.stack(ts), *layers)


# ---------------------------------------------------------------------------
# the SSD cell
# ---------------------------------------------------------------------------

CFG = dict(d_model=32, d_state=16, head_dim=16, chunk=8)


@pytest.mark.parametrize("seq", [24, 32, 31, 2])
def test_mamba2_forward_and_decode_match_the_reference(seq):
    """The full-sequence pass (a padded last chunk at 31; 2 tokens, fewer
    than the conv's tail) with its final (ssm, conv_tail), then three
    decode steps from it, and a step from ``mamba2_init_state``."""
    jcfg, tcfg = jm2.Mamba2Config(**CFG), tm2.Mamba2Config(**CFG)
    jp, tp = cell_params(tm2.mamba2_spec(tcfg), seq)
    jx, tx = inputs(100 + seq, (2, seq, 32))
    jy, jst = jax.jit(lambda p, x: jm2.mamba2_forward(
        p, jcfg, x, return_state=True))(jp, jx)
    ty, tst = tm2.mamba2_forward(tp, tcfg, tx, return_state=True)
    _close(ty, jy, TOL)
    close_trees(tst, jst)
    _close(tm2.xbc_tail(tcfg, tx, tp), jm2.xbc_tail(jcfg, jx, jp), TOL)
    _close(tm2.mamba2_forward(tp, tcfg, tx), jy, TOL)
    decode = jax.jit(lambda p, x, st: jm2.mamba2_decode(p, jcfg, x, st))
    jd, td = inputs(7, (2, 3, 32))
    for t in range(3):
        jy, jst = decode(jp, jd[:, t:t + 1], jst)
        ty, tst = tm2.mamba2_decode(tp, tcfg, td[:, t:t + 1], tst)
        _close(ty, jy, TOL)
        close_trees(tst, jst)
    jy, jst = decode(jp, jd[:, :1], jm2.mamba2_init_state(jcfg, 2))
    ty, tst = tm2.mamba2_decode(tp, tcfg, td[:, :1],
                                tm2.mamba2_init_state(tcfg, 2, device="cpu"))
    _close(ty, jy, TOL)
    close_trees(tst, jst)


def test_segsum_and_causal_conv_match_the_reference():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((2, 3, 8)).astype(np.float32)
    got, want = tm2._segsum(_t(a)).numpy(), np.asarray(jm2._segsum(
        jnp.asarray(a)))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[~np.isinf(got)], want[~np.isinf(want)],
                               rtol=TOL, atol=TOL)
    jcfg, tcfg = jm2.Mamba2Config(**CFG), tm2.Mamba2Config(**CFG)
    jp, tp = cell_params(tm2.mamba2_spec(tcfg), 4)
    jx, tx = inputs(5, (2, 11, tcfg.conv_dim))
    _close(tm2._causal_conv(tcfg, tp, tx), jm2._causal_conv(jcfg, jp, jx),
           TOL)


def test_mamba2_gradients_are_finite_and_match_the_reference():
    """Through the padded chunked pass (31 tokens, chunks of 8): the
    gradient of a scalar of the output with respect to every weight,
    against ``jax.grad`` of the same scalar."""
    jcfg, tcfg = jm2.Mamba2Config(**CFG), tm2.Mamba2Config(**CFG)
    jp, tp = cell_params(tm2.mamba2_spec(tcfg), 6)
    jx, tx = inputs(8, (2, 31, 32))
    jg = jax.jit(jax.grad(lambda p: jnp.sum(
        jm2.mamba2_forward(p, jcfg, jx) ** 2)))(jp)
    live = {k: v.clone().requires_grad_() for k, v in tp.items()}
    (tm2.mamba2_forward(live, tcfg, tx) ** 2).sum().backward()
    for k, v in live.items():
        assert bool(torch.isfinite(v.grad).all()), k
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(jg[k]),
                                   rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# zamba2-1.2b, reduced: the shared block and the whole model
# ---------------------------------------------------------------------------

def test_init_model_from_key_is_the_references():
    assert_init_is_the_references(NAME)


def test_shared_block_is_one_tree():
    """``shared_attn`` and ``shared_proj`` come across whole, once; each
    Mamba segment is a list of its layers; the parameter count is the
    reference's."""
    jp, tp = weights(NAME)
    assert tp["shared_attn"]["attn"]["wq"].shape == (64, 4, 16)
    np.testing.assert_array_equal(tp["shared_proj"]["w"].numpy(),
                                  np.asarray(jp["shared_proj"]["w"]))
    assert [len(tp["segments"][k]) for k in ("seg0", "seg1")] == [2, 2]
    assert sum(v.numel() for v in tp.parameters()) == tlm.n_params(
        _archs(NAME)[1]) == jlm.n_params(_archs(NAME)[0])
    assert tlm.n_params(get_arch(NAME)) == jlm.n_params(
        jax_get_arch(NAME)) == 1_174_668_160


def test_lm_loss_matches_the_reference():
    ja, ta = _archs(NAME)
    jp, tp = weights(NAME)
    jb, tb = batch_of(ta, 6, 2, 20, labels=True)
    want = float(jax.jit(lambda p, b: jlm.lm_loss(p, ja, b,
                                                  dtype=jnp.float32))(jp, jb))
    got = tlm.lm_loss(tp, ta, tb, dtype=torch.float32)
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=LM_TOL)


def test_lm_prefill_and_decode_match_the_reference():
    """S = 21 (Mamba chunks of 8, the last padded), three decode steps;
    after the prefill each shared application's (k, v) under
    ``shared<i>`` and each Mamba layer's (ssm, conv_tail)."""
    (tc, jc), calls = prefill_decode(NAME, 21)
    assert calls == []
    assert sorted(tc) == sorted(jc) == ["pos", "seg0", "seg1", "shared0",
                                        "shared1"]
    for name in ("shared0", "shared1"):
        assert tc[name][0].shape == (2, 24, 4, 16)
        close_trees(tc[name], jc[name], LM_TOL)
    for name in ("seg0", "seg1"):
        assert len(tc[name]) == 2
        close_trees(stacked_entries(tc[name]), jc[name], LM_TOL)


def test_flash_route_matches_the_reference_with_its_flag_on():
    """``use_flash_attention`` on in both packages: a prompt of 128
    tokens sends the shared block's two applications through the
    kernel route (its plain version here) and the reference's through
    its Pallas kernel in interpret mode."""
    _, calls = prefill_decode(NAME, 128, steps=2, flash_on=True,
                              ref_flash=True)
    assert [(c["causal"], c["window"]) for c in calls] == [(True, 0)] * 2
