"""xLSTM and xlstm-125m on the port (``repro_torch.models.xlstm``) held
against the JAX package: the chunked mLSTM with its replayed prefill
state and its decode step, the sLSTM recurrence and its step, at the
sequence lengths of tests/test_seqmodels.py, states included; the
stabilisers' sentinels (-inf, -1e30) forward and backward; and
``reduced()`` xlstm-125m (mLSTM / sLSTM interleaved) — ``lm_loss``,
``lm_prefill`` / ``lm_decode`` with every cache entry and its initial
weights from a key.  Inputs and weight perturbations come from numpy
seeds.

Bars: cells rtol = atol = 1e-5 (float32 in another order); gradients
1e-4; whole models 2e-4 (``LM_TOL``, tests/test_models.py:127)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as jlm
from repro.models import xlstm as jxl
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.models import mamba2 as tm2
from repro_torch.models import lm as tlm
from repro_torch.models import xlstm as txl
from test_torch_mamba2 import (
    assert_init_is_the_references,
    cell_params,
    close_trees,
    inputs,
    prefill_decode,
    stacked_entries,
)
from test_torch_zoo import LM_TOL, TOL, _archs, _close, _t, batch_of, weights

NAME = "xlstm-125m"
MCFG = dict(d_model=32, n_heads=4, chunk=8)
SCFG = dict(d_model=32, n_heads=4)


@pytest.mark.parametrize("seq", [24, 32, 31])
def test_mlstm_forward_and_decode_match_the_reference(seq):
    """The chunked pass (a padded last chunk at 31) with the replayed
    state (C, n, m, conv_tail), then three decode steps from it, and a
    step from ``mlstm_init_state``."""
    jcfg, tcfg = jxl.MLSTMConfig(**MCFG), txl.MLSTMConfig(**MCFG)
    jp, tp = cell_params(txl.mlstm_spec(tcfg), seq)
    jx, tx = inputs(200 + seq, (2, seq, 32))
    jy, jst = jax.jit(lambda p, x: jxl.mlstm_forward(
        p, jcfg, x, return_state=True))(jp, jx)
    ty, tst = txl.mlstm_forward(tp, tcfg, tx, return_state=True)
    _close(ty, jy, TOL)
    close_trees(tst, jst)
    decode = jax.jit(lambda p, x, st: jxl.mlstm_decode(p, jcfg, x, st))
    jd, td = inputs(9, (2, 3, 32))
    for t in range(3):
        jy, jst = decode(jp, jd[:, t:t + 1], jst)
        ty, tst = txl.mlstm_decode(tp, tcfg, td[:, t:t + 1], tst)
        _close(ty, jy, TOL)
        close_trees(tst, jst)
    jy, jst = decode(jp, jd[:, :1], jxl.mlstm_init_state(jcfg, 2))
    ty, tst = txl.mlstm_decode(tp, tcfg, td[:, :1],
                               txl.mlstm_init_state(tcfg, 2, device="cpu"))
    _close(ty, jy, TOL)
    close_trees(tst, jst)


@pytest.mark.parametrize("seq", [24, 32, 31])
def test_slstm_forward_and_decode_match_the_reference(seq):
    """The recurrence over the sequence with its final (c, n, h, m), then
    three decode steps from it, and a step from ``slstm_init_state``."""
    jcfg, tcfg = jxl.SLSTMConfig(**SCFG), txl.SLSTMConfig(**SCFG)
    jp, tp = cell_params(txl.slstm_spec(tcfg), seq)
    jx, tx = inputs(300 + seq, (2, seq, 32))
    jy, jst = jax.jit(lambda p, x: jxl.slstm_forward(
        p, jcfg, x, return_state=True))(jp, jx)
    ty, tst = txl.slstm_forward(tp, tcfg, tx, return_state=True)
    _close(ty, jy, TOL)
    close_trees(tst, jst)
    decode = jax.jit(lambda p, x, st: jxl.slstm_decode(p, jcfg, x, st))
    jd, td = inputs(10, (2, 3, 32))
    for t in range(3):
        jy, jst = decode(jp, jd[:, t:t + 1], jst)
        ty, tst = txl.slstm_decode(tp, tcfg, td[:, t:t + 1], tst)
        _close(ty, jy, TOL)
        close_trees(tst, jst)
    jy, jst = decode(jp, jd[:, :1], jxl.slstm_init_state(jcfg, 2))
    ty, tst = txl.slstm_decode(tp, tcfg, td[:, :1],
                               txl.slstm_init_state(tcfg, 2, device="cpu"))
    _close(ty, jy, TOL)
    close_trees(tst, jst)


@pytest.mark.parametrize("make", ["mamba2", "mlstm", "slstm"])
def test_decode_states_default_to_the_card(make):
    """``device=None`` is the card, as for every entry point of the port:
    it raises without one; ``device="cpu"`` gives CPU tensors."""
    cfg, init = {
        "mamba2": (tm2.Mamba2Config(d_model=32, d_state=8, head_dim=16),
                   tm2.mamba2_init_state),
        "mlstm": (txl.MLSTMConfig(**MCFG), txl.mlstm_init_state),
        "slstm": (txl.SLSTMConfig(**SCFG), txl.slstm_init_state),
    }[make]
    if torch.cuda.is_available():
        assert all(t.is_cuda for t in init(cfg, 2))
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init(cfg, 2)
    assert all(t.device.type == "cpu" for t in init(cfg, 2, device="cpu"))


@pytest.mark.parametrize("case", ["chunk", "first"])
def test_mlstm_cell_sentinels_forward_and_backward(case):
    """The chunked cell over 29 tokens (chunks of 8, 3 padded with
    li = -1e30), with input gates of -1e30 (no input) on a whole chunk
    of one row ("chunk") or at the first token of each row ("first"):
    outputs, and the gradients of a scalar of them with respect to q, k,
    v, li and lf, against the reference's (``jax.grad``), where the
    sentinels meet ``exp`` and the joint stabiliser.  With "chunk" every
    gradient is finite.  With "first" the stabiliser of the first token
    is -1e30 and exp(-m) overflows in both packages: the li and lf
    gradients are NaN in the reference, and in the port at the same
    places."""
    rng = np.random.default_rng(11)
    b, s, h, hd = 2, 29, 2, 8
    q, k, v = (rng.standard_normal((b, s, h, hd)).astype(np.float32)
               for _ in range(3))
    li = rng.standard_normal((b, s, h)).astype(np.float32)
    if case == "first":
        li[:, 0] = -1e30
    else:
        li[1, 8:16] = -1e30
    lf = np.log(1 / (1 + np.exp(-rng.standard_normal((b, s, h))))).astype(
        np.float32)
    args = (q, k, v, li, lf)

    def jloss(*a):
        return jnp.sum(jnp.tanh(jxl.mlstm_cell_chunked(*a, 8)))

    want = np.asarray(jxl.mlstm_cell_chunked(*map(jnp.asarray, args), 8))
    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3, 4)))(
        *map(jnp.asarray, args))
    live = [_t(a).requires_grad_() for a in args]
    out = txl.mlstm_cell_chunked(*live, 8)
    assert bool(torch.isfinite(out).all())
    _close(out, want, TOL)
    torch.tanh(out).sum().backward()
    for name, t, g in zip("q k v li lf".split(), live, jg):
        got, g = t.grad.numpy(), np.asarray(g)
        ok = np.isfinite(g)
        assert np.array_equal(np.isfinite(got), ok), name
        assert ok.all() == (case == "chunk" or name in "qkv"), name
        np.testing.assert_allclose(got[ok], g[ok], rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def test_init_model_from_key_is_the_references():
    assert_init_is_the_references(NAME)


def test_lm_loss_and_gradients_match_the_reference():
    """S = 20 over mLSTM chunks of 256 and an sLSTM per two layers: the
    loss at ``LM_TOL`` and its gradient, every leaf finite, the
    embedding's within 1e-4 of the reference's."""
    ja, ta = _archs(NAME)
    jp, tp = weights(NAME)
    jb, tb = batch_of(ta, 6, 2, 20, labels=True)
    want, jg = jax.jit(jax.value_and_grad(lambda p, b: jlm.lm_loss(
        p, ja, b, dtype=jnp.float32)))(jp, jb)
    live = tree_map(lambda t: t.detach().requires_grad_(), tp.tree())
    got = tlm.lm_loss(live, ta, tb, dtype=torch.float32)
    grads = torch.autograd.grad(got, tree_leaves(live))
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=LM_TOL)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    table = next(g for g, t in zip(grads, tree_leaves(live))
                 if t is live["embed"]["table"])
    np.testing.assert_allclose(table.numpy(), np.asarray(jg["embed"]["table"]),
                               rtol=1e-4, atol=1e-4)


def test_lm_prefill_and_decode_match_the_reference():
    """S = 21, three decode steps; after the prefill each mLSTM layer's
    (C, n, m, conv_tail) and each sLSTM layer's (c, n, h, m)."""
    (tc, jc), calls = prefill_decode(NAME, 21)
    assert calls == []
    assert sorted(tc) == sorted(jc) == ["pos", "seg0", "seg1", "seg2",
                                        "seg3"]
    for name in ("seg0", "seg1", "seg2", "seg3"):
        assert len(tc[name]) == 1 and len(tc[name][0]) == 4
        close_trees(stacked_entries(tc[name]), jc[name], LM_TOL)
    assert tc["seg0"][0][0].shape == (2, 4, 32, 32)    # C: (B, H, hd, hd)
