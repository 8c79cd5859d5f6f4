"""Training and subspace tuning of xlstm-125m, zamba2-1.2b,
deepseek-v2-236b and deepseek-v3-671b on the port, held against the JAX
package on ``reduced()``: ``run_training`` of zamba2 (its shared block
one tree among the leaves) and deepseek-v3 (its MTP head) resuming from
the reference's checkpoint and writing one the reference restores; the
``subspace-lm:<arch>`` objectives' values.

Bars: the trainer's losses as tests/test_torch_train.py holds them;
objective values rtol 1e-5 (tests/test_torch_subspace.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import latest_step as jax_latest
from repro.checkpoint import restore_checkpoint as jax_restore
from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro.core import objectives as jobj
from repro.models import init_model as jax_init_model
from repro.optim import gradient as jopt
from repro_torch.configs import get_arch, reduced
from repro_torch.core import objectives as tobj
from repro_torch.core import prng
from repro_torch.core.subspace import apply_subspace
from repro_torch.core.tree import entries, tree_map
from repro_torch.data import lm_synthetic_batch
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm
from test_torch_zoo import LATER
from test_torch_zoo_serve import VALUE_RTOL, _reference_losses


@pytest.mark.parametrize("name,key,shape", [
    ("zamba2-1.2b", "[0]/['shared_attn']/['attn']/['wq']", (64, 4, 16)),
    ("deepseek-v3-671b", "[0]/['mtp']/['proj']/['w']", (128, 64)),
])
def test_run_training_crosses_checkpoints_with_the_reference(tmp_path, name,
                                                             key, shape):
    """The port resumes from the reference's step-0 checkpoint and
    trains 3 steps (zamba2's loss through its seven-segment plan and its
    shared block; deepseek-v3's with its balance and MTP terms): per-step
    losses within the bars of tests/test_torch_train.py; then the
    reference restores the port's step-3 checkpoint, every leaf bit for
    bit the port's final state, the shared block and the MTP head one
    leaf each, not stacked."""
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
    assert flat[key].shape == shape


def _loss64(name, kw, z):
    """The objective's loss at ``z`` in float64: the port's subspace
    parameters (``apply_subspace``, float32) and batch, the model run in
    float64."""
    arch = dataclasses.replace(reduced(get_arch(name)), n_layers=kw["layers"])
    params0 = tlm.init_model(arch, prng.PRNGKey(0), device="cpu").tree()
    theta = apply_subspace(params0, torch.from_numpy(z), prng.PRNGKey(3),
                           3.0)
    tokens, labels = lm_synthetic_batch(prng.PRNGKey(1), kw["batch"],
                                        kw["seq"], arch.vocab_size)
    batch = {"tokens": torch.from_numpy(tokens).long(),
             "labels": torch.from_numpy(labels).long()}
    return float(tlm.lm_loss(tree_map(lambda t: t.double(), theta), arch,
                             batch, dtype=torch.float64))


@pytest.mark.parametrize("name", LATER)
def test_subspace_objective_values_match_the_reference(name):
    """``subspace-lm:<arch>`` over two layers (xlstm's mLSTM and sLSTM;
    zamba2's shared block and two Mamba layers; deepseek's leading dense
    layer and one MoE layer) at 12 points of the box, point by point,
    within 1e-5 of the reference's value.  A point past that bar must be
    one where float32 rounding alone parts the two: both packages'
    values within 1e-5 of the float64 loss there.  (xlstm's one-layer
    segments are drawn at std 1 — the reference's init takes the stacked
    layer axis as the fan-in — its loss reaches 60-150, and at one of
    these points the two packages' float32 losses of one parameter set
    differ by 1.04e-5, each about 5e-6 from the float64 loss.)"""
    spec = "subspace-lm:" + name
    kw = dict(d=4, bits=3, batch=2, seq=8, layers=2)
    ref, port = jobj.get(spec, **kw), tobj.get(spec, **kw)
    assert port.signature == ref.signature
    zs = np.random.default_rng(6).uniform(-1, 1, (12, 4)).astype(np.float32)
    zs[0] = 0.0
    want = np.asarray(jax.jit(jax.vmap(ref.fn))(jnp.asarray(zs)))
    got = port.fn(torch.from_numpy(zs)).numpy()
    assert got.shape == (12,) and np.isfinite(got).all()
    for z, g, w in zip(zs, got, want):
        if not np.isclose(g, w, rtol=VALUE_RTOL, atol=0):
            exact = _loss64(name, kw, z)
            np.testing.assert_allclose([g, w], [exact, exact],
                                       rtol=VALUE_RTOL, atol=0)
