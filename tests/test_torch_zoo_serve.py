"""Serving, training and subspace tuning of the zoo beyond qwen2 on the
port, held against the JAX package on ``reduced()`` of codeqwen1.5-7b,
gemma3-27b, granite-34b, whisper-medium and phi-3-vision-4.2b:
``serve_lm``'s greedy tokens (with its stub frames and images fed to the
reference's serve loop), ``run_training`` of whisper and phi-3 resuming
from the reference's checkpoint and writing one the reference restores,
and the ``subspace-lm:<arch>`` objectives.

Bars: prefill logits ``LM_TOL`` (tests/test_models.py:127), tokens equal
but at near-ties (``greedy_near_tie``); the trainer's losses as
tests/test_torch_train.py holds them; objective values rtol 1e-5
(tests/test_torch_subspace.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import latest_step as jax_latest
from repro.checkpoint import restore_checkpoint as jax_restore
from repro.checkpoint import save_checkpoint as jax_save
from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro.core import objectives as jobj
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticTokenPipeline as JPipeline
from repro.launch import train as jtrain
from repro.models import init_model as jax_init_model
from repro.models import lm as jlm
from repro.optim import gradient as jopt
from repro_torch.core import objectives as tobj
from repro_torch.core.tree import entries
from repro_torch.launch import serve
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm
from test_torch_models import greedy_near_tie
from test_torch_zoo import LM_TOL, NEW, _archs, weights

VALUE_RTOL = 1e-5
TINY = dict(d=4, bits=3, batch=2, seq=8, layers=1)


def _jax_greedy(jp, ja, batch, gen_len):
    """The reference serve loop (launch/serve.py) on a given batch:
    (tokens (B, gen_len), logits (gen_len, B, V))."""
    cache_len = batch["tokens"].shape[1] + gen_len
    prefill = jax.jit(lambda p, b: jlm.lm_prefill(
        p, ja, b, cache_len=cache_len, dtype=jnp.float32))
    decode = jax.jit(lambda p, t, c: jlm.lm_decode(p, ja, t, c,
                                                   dtype=jnp.float32))
    logits, cache = prefill(jp, batch)
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    toks, lgs = [tok], [logits]
    for _ in range(gen_len - 1):
        logits, cache = decode(jp, tok, cache)
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        toks.append(tok)
        lgs.append(logits)
    return np.stack(toks, 1), np.stack(lgs)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NEW)
def test_serve_lm_greedy_tokens_match_the_reference(name):
    """Two waves of 2 prompts of 130 tokens, 5 generated, the flash route
    on (its plain version here): the port's stub frames / images drawn
    after each wave's prompts, then the same batch through the
    reference's jitted loop with its flag off."""
    ja, ta = _archs(name, flash_on=True)
    jp, tp = weights(name)
    res = serve.serve_lm(ta, batch=2, prompt_len=130, gen_len=5, waves=2,
                         seed=3, device="cpu", params=tp)
    assert res.decode_tokens == 2 * 2 * 4
    assert set(res.extras[0]) == ({"frames"} if ta.enc_dec else
                                  {"images"} if ta.vision_tokens else set())
    for prompts, extras, toks, logits in zip(res.prompts, res.extras,
                                             res.tokens, res.logits):
        assert toks.shape == (2, 5) and logits.shape == (5, 2, 256)
        batch = {"tokens": jnp.asarray(prompts.numpy())}
        batch.update({k: jnp.asarray(v.numpy()) for k, v in extras.items()})
        tok_r, logits_r = _jax_greedy(jp, ja, batch, 5)
        np.testing.assert_allclose(logits[0].numpy(), logits_r[0],
                                   rtol=LM_TOL, atol=LM_TOL)
        assert greedy_near_tie(toks.numpy(), tok_r, logits_r) == []


def test_frontend_inputs_follow_the_seed_and_the_config():
    """Shapes, scale and the generator's order: the images or frames of a
    wave come after its prompts, from the same generator."""
    arch = _archs("phi-3-vision-4.2b")[1]
    gen = torch.Generator().manual_seed(7)
    x = serve.frontend_inputs(arch, 3, gen)
    assert list(x) == ["images"] and x["images"].shape == (3, 4, 32)
    assert x["images"].dtype == torch.float32
    assert torch.equal(x["images"], 0.02 * torch.randn(
        (3, 4, 32), generator=torch.Generator().manual_seed(7)))
    whisper = _archs("whisper-medium")[1]
    assert serve.frontend_inputs(whisper, 2, gen)["frames"].shape == (2, 8,
                                                                      64)
    assert serve.frontend_inputs(_archs("granite-34b")[1], 2, gen) == {}


def test_serve_cli_takes_every_registered_arch():
    from repro_torch.configs import REGISTRY

    choices = next(a.choices for a in serve.build_parser()._actions
                   if a.dest == "arch")
    assert list(choices) == list(REGISTRY) and "whisper-medium" in choices


# ---------------------------------------------------------------------------
# training and checkpoints across the packages
# ---------------------------------------------------------------------------

def _reference_losses(name, steps, seed, ckpt_dir):
    """The reference trainer's step, looped, with every loss kept; its
    step-0 state written to ``ckpt_dir`` first."""
    ja = jax_reduced(jax_get_arch(name))
    cfg = jopt.AdamWConfig(lr=3e-3, warmup_steps=max(steps // 20, 1),
                           total_steps=steps, weight_decay=0.01)
    data = JPipeline(JDataConfig(vocab_size=ja.vocab_size, seq_len=16,
                                 global_batch=2, seed=seed),
                     extras=jtrain._extras(ja, jnp.float32))

    @jax.jit
    def step(params, opt_state, batch):
        loss, grads = jax.value_and_grad(
            lambda p: jlm.lm_loss(p, ja, batch, dtype=jnp.float32))(params)
        params, opt_state = jopt.adamw_update(cfg, grads, opt_state, params)
        return params, opt_state, loss

    params = jax_init_model(ja, jax.random.PRNGKey(seed))
    state = jopt.adamw_init(params)
    jax_save(ckpt_dir, 0, (params, state))
    losses = []
    try:
        for k in range(steps):
            params, state, loss = step(params, state, data.batch_at(k))
            losses.append(float(loss))
    finally:
        data.close()
    return np.asarray(losses)


@pytest.mark.parametrize("name", ["whisper-medium", "phi-3-vision-4.2b"])
def test_run_training_crosses_checkpoints_with_the_reference(tmp_path, name):
    """The port resumes from the reference's step-0 checkpoint (its
    encoder layers or image projection among the leaves) and trains 3
    steps on batches with the stub frames / images: per-step losses
    within the bars of tests/test_torch_train.py; then the reference
    restores the port's step-3 checkpoint into its stacked tree, every
    leaf bit for bit the port's final state."""
    want = _reference_losses(name, 3, 2, tmp_path)
    args = ttrain.build_argparser().parse_args(
        ["--arch", name, "--reduced", "--global-batch", "2", "--seq-len",
         "16", "--log-every", "100", "--steps", "3", "--ckpt-every", "100",
         "--seed", "2", "--ckpt-dir", str(tmp_path)])
    out = ttrain.run_training(args, device="cpu", keep_state=True)
    got = np.asarray(out["losses"])
    assert out["steps"] == 3 and len(got) == 3
    rel = np.abs(got - want) / want
    assert rel[0] <= 1e-6 and rel[1:].max() <= 1e-3, rel
    assert jax_latest(tmp_path) == 3
    ja = jax_reduced(jax_get_arch(name))
    like = jax_init_model(ja, jax.random.PRNGKey(0))
    restored = jax_restore(tmp_path, 3, (like, jopt.adamw_init(like)))
    flat = {"/".join(str(k) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                restored)[0]}
    port = [(k, (v.stacked() if hasattr(v, "stacked") else v).numpy())
            for k, v in entries(out["state"])]
    assert [k for k, _ in port] == list(flat)
    for k, v in port:
        assert np.array_equal(v, flat[k]), k
    key = ("[0]/['encoder']/['layers']/['attn']/['wq']" if ja.enc_dec
           else "[0]/['img_proj']/['w']")
    assert flat[key].shape[0] == (2 if ja.enc_dec else 32)


# ---------------------------------------------------------------------------
# subspace tuning
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NEW)
def test_subspace_objective_values_match_the_reference(name):
    """``subspace-lm:<arch>`` at a tiny spec (whisper's objective encodes
    the reference's frames, phi-3's projects its images) over 20 points
    of the box, point by point."""
    spec = "subspace-lm:" + name
    ref, port = jobj.get(spec, **TINY), tobj.get(spec, **TINY)
    assert port.signature == ref.signature
    zs = np.random.default_rng(5).uniform(-1, 1, (20, 4)).astype(np.float32)
    zs[0] = 0.0
    want = np.asarray(jax.jit(jax.vmap(ref.fn))(jnp.asarray(zs)))
    got = port.fn(torch.from_numpy(zs))
    assert got.shape == (20,) and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=VALUE_RTOL)


def test_subspace_materialize_carries_the_encoder():
    """The tuned whisper's parameters keep the encoder's layer list and
    every parameter of the one-layer model."""
    port = tobj.get("subspace-lm:whisper-medium", **TINY)
    params = port.materialize(torch.tensor([0.5, -0.5, 0.25, 0.0]))
    assert len(params["encoder"]["layers"]) == 2
    arch = dataclasses.replace(_archs("whisper-medium")[1], n_layers=1)
    assert sum(sum(t.numel() for t in v) if isinstance(v, list)
               else v.numel() for _, v in entries(params)) \
        == tlm.n_params(arch)
