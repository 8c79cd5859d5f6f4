"""MLA, MoE and the MTP head — deepseek-v2-236b and deepseek-v3-671b on
the port (``repro_torch.models.mla``, ``models.moe``, ``models.lm``) held
against the JAX package: MoE's routing (the sorted pairs, their
positions and the keep mask) before its outputs, at a capacity factor
that drops tokens and at one that does not, with ties in the router;
MLA's expanded prefill with its compressed latent cache and its absorbed
decode; and ``reduced()`` of both models — ``lm_loss`` (the balance
loss, and deepseek-v3's MTP term), ``lm_prefill`` / ``lm_decode`` (the
decode's MoE capacity of 1 slot at batch 2 drops tokens by design) and
their initial weights from a key.  Inputs and weight perturbations come
from numpy seeds.

Bars: cells rtol = atol = 1e-5 (float32 in another order), the routing
exactly; gradients 1e-4; whole models 2e-4 (``LM_TOL``,
tests/test_models.py:127)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as jlm
from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro_torch.configs import get_arch
from repro_torch.models import blocks as tblk
from repro_torch.models import lm as tlm
from repro_torch.models import mla as tmla
from repro_torch.models import moe as tmoe
from test_torch_mamba2 import (
    assert_init_is_the_references,
    cell_params,
    close_trees,
    inputs,
    prefill_decode,
)
from test_torch_zoo import LM_TOL, TOL, _archs, _close, _t, batch_of, weights

NAMES = ("deepseek-v2-236b", "deepseek-v3-671b")


def _moe(cf, seed=0, **kw):
    cfg = dict(d_model=64, n_experts=8, top_k=2, d_ff_expert=32,
               n_shared=1, capacity_factor=cf, **kw)
    jcfg, tcfg = jmoe.MoEConfig(**cfg), tmoe.MoEConfig(**cfg)
    jp, tp = cell_params(tmoe.moe_spec(tcfg), seed)
    return jcfg, tcfg, jp, tp


def assert_same_routing(jp, jcfg, tp, tcfg, xt, capacity):
    """The two packages' dispatch of one token group: the pairs in
    expert order, their tokens, positions and keep mask exactly; their
    weights, the buffer and the balance statistics at 1e-5.  Returns
    the number of pairs dropped."""
    jbuf, jmeta, jfe, jpe = jmoe._route_group(jp, jcfg, jnp.asarray(xt),
                                              capacity)
    tbuf, tmeta, tfe, tpe = tmoe._route_group(tp, tcfg, _t(xt), capacity)
    for name, g, w in zip(("e_sort", "t_sort", "pos", "keep"),
                          (tmeta[0], tmeta[1], tmeta[3], tmeta[4]),
                          (jmeta[0], jmeta[1], jmeta[3], jmeta[4])):
        assert np.array_equal(g.numpy(), np.asarray(w)), name
    for g, w in ((tmeta[2], jmeta[2]), (tbuf, jbuf), (tfe, jfe),
                 (tpe, jpe)):
        _close(g, w, TOL)
    return int((~tmeta[4]).sum())


@pytest.mark.parametrize("cf,drops", [(1.0, True), (4.0, False)])
def test_moe_routing_and_output_match_the_reference(cf, drops):
    """24 tokens over 8 experts, top 2, one shared expert: at capacity
    factor 1.0 (7 slots an expert) some pairs are dropped, at 4.0 (25
    slots) none; routing first, then the output and the balance loss."""
    jcfg, tcfg, jp, tp = _moe(cf)
    jx, tx = inputs(1, (2, 12, 64), scale=1.0)
    capacity = tmoe.capacity_of(tcfg, 24)
    assert capacity == int(cf * 2 * 24 / 8) + 1
    dropped = assert_same_routing(jp, jcfg, tp, tcfg,
                                  np.array(jx).reshape(24, 64), capacity)
    assert (dropped > 0) == drops
    jy, jaux = jax.jit(lambda p, x: jmoe.moe_forward(p, jcfg, x))(jp, jx)
    ty, taux = tmoe.moe_forward(tp, tcfg, tx)
    _close(ty, jy, TOL)
    _close(taux, jaux, TOL)


def test_moe_ties_drop_the_references_tokens():
    """A router of two equal columns, the largest for every token (its
    probabilities tie, the lower expert first, as ``jax.lax.top_k``
    orders them) and then all zeros (every probability ties: experts 0
    and 1 for every token): each token's pairs and which of them the
    capacity drops are the reference's."""
    jcfg, tcfg, jp, tp = _moe(1.25, seed=2)
    xt = np.abs(np.random.default_rng(3).standard_normal((24, 64))
                ).astype(np.float32)
    router = np.asarray(jp["router"]).copy()
    router[:, 5] = router[:, 3] = 1.0
    for r in (router, np.zeros_like(router)):
        jp["router"], tp["router"] = jnp.asarray(r), _t(r)
        dropped = assert_same_routing(jp, jcfg, tp, tcfg, xt,
                                      tmoe.capacity_of(tcfg, 24))
        assert dropped == 24 * 2 - 2 * 8
    _, tmeta, _, _ = tmoe._route_group(tp, tcfg, _t(xt), 8)
    assert tmeta[0][:24].tolist() == [0] * 24        # experts 0 and 1
    assert tmeta[1][:8].tolist() == list(range(8))   # the first 8 kept


def test_moe_gradients_match_the_reference():
    """Through dispatch, experts and combine with drops (capacity factor
    1.0): the gradient of a scalar of the output and the balance loss
    with respect to every weight and the input, finite and within 1e-4
    of ``jax.grad``'s."""
    jcfg, tcfg, jp, tp = _moe(1.0, seed=4)
    jx, tx = inputs(5, (2, 12, 64), scale=1.0)

    def jloss(p, x):
        y, aux = jmoe.moe_forward(p, jcfg, x)
        return jnp.sum(jnp.tanh(y)) + aux

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jx)
    live = jax.tree.map(lambda t: t.clone().requires_grad_(), tp)
    lx = tx.clone().requires_grad_()
    y, aux = tmoe.moe_forward(live, tcfg, lx)
    leaves = jax.tree.leaves(live) + [lx]
    grads = torch.autograd.grad(torch.tanh(y).sum() + aux, leaves)
    for g, w in zip(grads, jax.tree.leaves(jgp) + [jgx]):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_moe_decode_capacity_is_one_slot():
    """deepseek-v3's decode at batch B <= 20 has one slot an expert:
    int(1.25 x 8 x B / 256) + 1."""
    cfg = tblk.moe_cfg(get_arch("deepseek-v3-671b"))
    assert [tmoe.capacity_of(cfg, b) for b in (1, 4, 20, 26)] == [1, 1, 1,
                                                                   2]


@pytest.mark.parametrize("q_lora", [48, 0])
def test_mla_prefill_and_decode_match_the_reference(q_lora):
    """24 tokens in query chunks of 16, with and without the low-rank
    query: the expanded prefill's output and compressed cache (the
    prompt's latents, zeros after), ``mla_forward``, then three absorbed
    decode steps, output and cache each step."""
    kw = dict(d_model=64, n_heads=4, kv_lora_rank=32, q_lora_rank=q_lora,
              chunk_q=16)
    jcfg, tcfg = jmla.MLAConfig(**kw), tmla.MLAConfig(**kw)
    jp, tp = cell_params(tmla.mla_spec(tcfg), 7 + q_lora)
    jx, tx = inputs(8, (2, 24, 64), scale=1.0)
    jy, jc = jax.jit(lambda p, x: jmla.mla_prefill(p, jcfg, x, 27))(jp, jx)
    ty, tc = tmla.mla_prefill(tp, tcfg, tx, 27)
    assert tc.shape == (2, 27, 32 + 64)
    _close(ty, jy, TOL)
    _close(tc, jc, TOL)
    _close(tmla.mla_forward(tp, tcfg, tx), jy, TOL)
    decode = jax.jit(lambda p, x, c, pos: jmla.mla_decode(p, jcfg, x, c, pos))
    jd, td = inputs(9, (2, 3, 64), scale=1.0)
    for t in range(3):
        jy, jc = decode(jp, jd[:, t:t + 1], jc, jnp.int32(24 + t))
        ty, tc = tmla.mla_decode(tp, tcfg, td[:, t:t + 1], tc, 24 + t)
        _close(ty, jy, TOL)
        _close(tc, jc, TOL)


# ---------------------------------------------------------------------------
# the two models, reduced
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_init_model_from_key_is_the_references(name):
    assert_init_is_the_references(name)


@pytest.mark.parametrize("name", NAMES)
def test_lm_loss_matches_the_reference(name):
    """S = 20: the cross-entropy plus the summed balance loss of the
    three MoE layers (equal to the reference's at 1e-5) and, for v3,
    0.3 times the MTP head's loss."""
    ja, ta = _archs(name)
    jp, tp = weights(name)
    jb, tb = batch_of(ta, 6, 2, 20, labels=True)
    want = float(jax.jit(lambda p, b: jlm.lm_loss(
        p, ja, b, dtype=jnp.float32))(jp, jb))
    got = tlm.lm_loss(tp, ta, tb, dtype=torch.float32)
    np.testing.assert_allclose(float(got), want, rtol=LM_TOL)
    x = tlm._embed_inputs(tp, ta, tb, torch.float32)[0]
    _, aux = tlm.forward_hidden(tp, ta, x)
    _, jaux = jax.jit(lambda p, t: jlm.forward_hidden(
        p, ja, jlm.embed(p["embed"], t).astype(jnp.float32)))(
        jp, jb["tokens"])
    assert float(aux) > 0
    _close(aux, jaux, TOL)


def test_mtp_term_is_in_deepseek_v3s_loss():
    """The MTP head adds mtp_weight x its loss: the difference from the
    loss without it is the reference's."""
    import dataclasses

    ja, ta = _archs("deepseek-v3-671b")
    jp, tp = weights("deepseek-v3-671b")
    jb, tb = batch_of(ta, 12, 2, 20, labels=True)
    assert "mtp" in tp and ta.mtp and ta.mtp_weight == 0.3

    def both(arch_j, arch_t):
        return (float(jax.jit(lambda p, b: jlm.lm_loss(
            p, arch_j, b, dtype=jnp.float32))(jp, jb)),
            float(tlm.lm_loss(tp, arch_t, tb, dtype=torch.float32)))

    (j1, t1) = both(ja, ta)
    (j0, t0) = both(dataclasses.replace(ja, mtp=False),
                    dataclasses.replace(ta, mtp=False))
    assert t1 - t0 > 0.3
    np.testing.assert_allclose(t1 - t0, j1 - j0, rtol=1e-4)


@pytest.mark.parametrize("name", NAMES)
def test_lm_prefill_and_decode_match_the_reference(name):
    """S = 21, three decode steps; after the prefill each MLA layer's
    compressed cache (B, S + steps, kv_lora + rope_dim)."""
    (tc, jc), calls = prefill_decode(name, 21)
    assert calls == []
    assert sorted(tc) == sorted(jc) == ["dense", "moe", "pos"]
    assert [len(tc["dense"]), len(tc["moe"])] == [1, 3]
    assert tc["moe"][0].shape == (2, 24, 32 + 64)
    for seg in ("dense", "moe"):
        close_trees(list(tc[seg]), list(jc[seg]), LM_TOL)
