"""The paper's comparison baselines in the port (``repro_torch.optim``:
GA, simulated annealing, Nelder-Mead, gradient descent): the four cases
of the reference's ``tests/test_optim.py``, and the same key gives the
reference's result within objective rounding (rtol = atol = 1e-5 on the
value; GA's bits exactly).  The port's objectives are batched
(``(B, n) -> (B,)``); the reference's per point."""
import jax
import numpy as np
import pytest
import torch

from repro.core import objectives as jobj
from repro.optim import (
    ga_minimize as jga, gd_minimize as jgd, nelder_mead_minimize as jnm,
    sa_minimize as jsa)
from repro_torch.core import objectives as tobj
from repro_torch.core import prng
from repro_torch.optim import (
    AdamWConfig, SGDConfig, ga_minimize, gd_minimize, make_optimizer,
    nelder_mead_minimize, sa_minimize)

CPU = {"device": "cpu"}


def _close(a, b):
    return np.isclose(float(a), float(b), rtol=1e-5, atol=1e-5)


def test_adamw_and_sgd_converge():
    params = {"w": torch.ones((4, 4)), "b": torch.zeros((4,))}

    def loss(p):
        return torch.sum(p["w"] ** 2) + torch.sum((p["b"] - 1.0) ** 2)

    for cfg, steps in ((AdamWConfig(lr=0.05, warmup_steps=1,
                                    total_steps=200, weight_decay=0.0), 200),
                       (SGDConfig(lr=0.05, momentum=0.9), 400)):
        p = dict(params)
        init, update = make_optimizer(cfg)
        state = init(p)
        for _ in range(steps):
            live = {k: v.detach().requires_grad_() for k, v in p.items()}
            grads = dict(zip(live, torch.autograd.grad(loss(live),
                                                       list(live.values()))))
            p, state = update(grads, state, p)
        assert float(loss(p)) < 1e-3


def test_gd_stalls_on_rastrigin_but_not_quadratic():
    """The paper's central comparison, and the reference's values."""
    key, tkey = jax.random.PRNGKey(0), prng.PRNGKey(0)
    for name in ("quadratic_nd", "rastrigin"):
        jo, to = getattr(jobj, name)(2), getattr(tobj, name)(2)
        _, want, _ = jgd(jo.fn, jo.encoding, key, steps=2000)
        x, got, trace = gd_minimize(to.fn, to.encoding, tkey, steps=2000,
                                    **CPU)
        assert _close(got, want), (name, float(got), float(want))
        assert trace.shape == (2000,)
        if name == "quadratic_nd":
            assert abs(float(got) - to.f_opt) < 1e-2
        else:
            assert float(got) > 1.0        # stuck in a local minimum


def test_sa_matches_the_reference_on_shekel():
    jo, to = jobj.shekel(5), tobj.shekel(5)
    jx, want, _ = jsa(jo.fn, jo.encoding, jax.random.PRNGKey(0), steps=4000)
    x, got, trace = sa_minimize(to.fn, to.encoding, prng.PRNGKey(0),
                                steps=4000, **CPU)
    assert torch.isfinite(got)
    assert _close(got, want)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-5,
                               atol=1e-5)
    assert trace.shape == (4000,)


def test_ga_matches_the_reference_on_shekel():
    jo, to = jobj.shekel(5), tobj.shekel(5)
    jx, want, jtrace = jga(jo.fn, jo.encoding, jax.random.PRNGKey(0),
                           generations=100)
    x, got, trace = ga_minimize(to.fn, to.encoding, prng.PRNGKey(0),
                                generations=100, **CPU)
    assert torch.isfinite(got)
    assert _close(got, want)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_allclose(trace.numpy(), np.asarray(jtrace),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,n", [("shekel", 5), ("rastrigin", 3)])
def test_nelder_mead_matches_the_reference(name, n):
    jo, to = getattr(jobj, name)(n), getattr(tobj, name)(n)
    _, want, _ = jnm(jo.fn, jo.encoding, jax.random.PRNGKey(0))
    x, got, none = nelder_mead_minimize(to.fn, to.encoding, prng.PRNGKey(0),
                                        **CPU)
    assert none is None and torch.isfinite(got)
    assert _close(got, want)


def test_baselines_run_on_the_card_by_default():
    to = tobj.shekel(5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            nelder_mead_minimize(to.fn, to.encoding, prng.PRNGKey(0))
