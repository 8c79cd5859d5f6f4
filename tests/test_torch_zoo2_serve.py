"""Serving of xlstm-125m, zamba2-1.2b, deepseek-v2-236b and
deepseek-v3-671b on the port, held against the JAX package on
``reduced()``: ``serve_lm``'s greedy tokens (zamba2's shared block
through the flash route) and the ``serve --arch zamba2-1.2b --reduced``
CLI.  Training and the tuning objectives are in
tests/test_torch_zoo2_train.py, the README's tuning example in
tests/test_torch_zoo2_readme.py (files of their own, so that
``--dist loadfile`` spreads the reference's compilations).

Bars: prefill logits ``LM_TOL`` (tests/test_models.py:127), tokens equal
but at near-ties (``greedy_near_tie``)."""
import jax.numpy as jnp
import numpy as np
import pytest

from repro_torch.launch import serve
from test_torch_models import greedy_near_tie
from test_torch_zoo import LATER, LM_TOL, _archs, weights
from test_torch_zoo_serve import _jax_greedy

# (name, prompt length): zamba2's prompts reach the flash route
SERVE = (("xlstm-125m", 20), ("zamba2-1.2b", 130), ("deepseek-v2-236b", 20),
         ("deepseek-v3-671b", 20))


def _assert_greedy_matches(res, jp, ja, gen_len):
    for prompts, toks, logits in zip(res.prompts, res.tokens, res.logits):
        tok_r, logits_r = _jax_greedy(
            jp, ja, {"tokens": jnp.asarray(prompts.numpy())}, gen_len)
        np.testing.assert_allclose(logits[0].numpy(), logits_r[0],
                                   rtol=LM_TOL, atol=LM_TOL)
        assert greedy_near_tie(toks.numpy(), tok_r, logits_r) == []


@pytest.mark.parametrize("name,prompt_len", SERVE)
def test_serve_lm_greedy_tokens_match_the_reference(name, prompt_len):
    """Two waves of 2 prompts, 5 tokens generated, the flash route on
    (its plain version here; only zamba2's shared block takes it), held
    against the reference's jitted serve loop with its flag off."""
    ja, ta = _archs(name, flash_on=True)
    _, tp = weights(name)
    res = serve.serve_lm(ta, batch=2, prompt_len=prompt_len, gen_len=5,
                         waves=2, seed=3, device="cpu", params=tp)
    assert res.decode_tokens == 2 * 2 * 4 and res.extras == [{}, {}]
    _assert_greedy_matches(res, weights(name)[0], ja, 5)


def test_serve_cli_serves_reduced_zamba2(monkeypatch, capsys):
    """``serve --arch zamba2-1.2b --reduced --batch 4 --prompt-len 32
    --gen-len 16`` through the CLI's ``main`` (``serve_lm`` on the CPU
    with the reference's weights): its report, and every wave's greedy
    tokens the reference's."""
    ja, ta = _archs("zamba2-1.2b")
    jp, tp = weights("zamba2-1.2b")
    runs = []
    real = serve.serve_lm

    def on_cpu(arch, **kw):
        assert arch == ta
        runs.append(real(arch, device="cpu", params=tp, **kw))
        return runs[-1]

    monkeypatch.setattr(serve, "serve_lm", on_cpu)
    serve.main(["--arch", "zamba2-1.2b", "--reduced", "--batch", "4",
                "--prompt-len", "32", "--gen-len", "16"])
    out = capsys.readouterr().out.splitlines()
    assert out[-1].startswith("{") and '"total_tokens": 120' in out[-1]
    (res,) = runs
    assert [tuple(t.shape) for t in res.tokens] == [(4, 16)] * 2
    _assert_greedy_matches(res, jp, ja, 16)


def test_serve_cli_takes_the_new_archs():
    choices = next(a.choices for a in serve.build_parser()._actions
                   if a.dest == "arch")
    assert set(LATER) <= set(choices)
