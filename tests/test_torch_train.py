"""The port's train path against the JAX package on ``reduced(qwen2-1.5b)``:
``init_model`` from a JAX key, ``lm_loss`` and its gradients (the
reference's weights carried across by ``load_reference_params``), the
AdamW / SGD updates and the trainer ``launch/train.py``.

Bars: the loss within rtol 1e-5 (float32 in another order); gradients
leaf by leaf within 2e-4 of the leaf's largest |gradient|, the
whole-model bar of tests/test_models.py (measured up to 5.7e-5 over four
batches: XLA's float32 cos and rsqrt part from PyTorch's by an ulp, and
that carries through four layers and back); an optimizer
update from the same gradients within 1e-6 of the leaf's largest
|update|.  A whole run is compared from the same state (the port resumes
from a checkpoint the reference wrote): the first step's loss within
1e-6, the next three within 1e-3.  AdamW's first steps are m/sqrt(v),
which turns the rounding of a gradient near zero into an update of full
size, so two runs part a little more with every step (measured: 2.6e-7,
3e-6 to 1.3e-5, 2e-5 to 5e-5 at steps 2-4, 3e-4 by step 6, seeds 0-3)."""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_checkpoint as jax_save
from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticTokenPipeline as JPipeline
from repro.launch import train as jtrain
from repro.models import init_model as jax_init_model
from repro.models import lm as jlm
from repro.optim import gradient as jopt
from repro_torch.configs import get_arch, reduced
from repro_torch.core import prng
from repro_torch.core.tree import entries, tree_map
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm
from repro_torch.models.layers import stacked_spec
from repro_torch.optim import gradient as topt

NAME = "qwen2-1.5b"
LOSS_RTOL = 1e-5
GRAD_BAR = 2e-4
UPDATE_BAR = 1e-6
NORMAL_ULP = 4            # tests/test_torch_prng.py


def _archs(**kw):
    j = dataclasses.replace(jax_reduced(jax_get_arch(NAME)), **kw)
    t = dataclasses.replace(reduced(get_arch(NAME)), **kw)
    return j, t


@functools.lru_cache(maxsize=None)
def _weights():
    """The reference's reduced qwen2 weights moved off their init values
    (biases and norms are zeros and ones there) by seeded numpy noise."""
    rng = np.random.default_rng(0)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
                   ).astype(np.float32),
        jax_init_model(jax_reduced(jax_get_arch(NAME)),
                       jax.random.PRNGKey(0)))


def _batch(seed, b, s, vocab=256):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((b, 1), -1, np.int32)],
                            axis=1)
    labels[0, s // 3] = -1                       # an ignored label inside
    return ({"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)},
            {"tokens": torch.as_tensor(tokens).long(),
             "labels": torch.as_tensor(labels).long()})


def _flat(tree) -> dict:
    """A port tree as {reference key: stacked numpy array}."""
    out = {}
    for k, v in entries(tree):
        v = (v.stacked() if hasattr(v, "stacked") else v).detach()
        out[k] = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return out


def _jflat(tree) -> dict:
    return {"/".join(str(k) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


# ---------------------------------------------------------------------------
# init_model from a JAX key
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_init_model_from_key_is_the_references(seed):
    """Leaf i of the reference's stacked flatten order is std *
    normal(fold_in(key, i)) with std from the stacked shape: zeros and
    ones exactly, each normal leaf bitwise the numpy twin's draw and
    within its ulps of jax's."""
    ja, ta = _archs()
    want = _jflat(jax_init_model(ja, jax.random.PRNGKey(seed)))
    got = _flat(tlm.init_model(ta, prng.PRNGKey(seed), device="cpu").tree())
    assert list(got) == list(want)
    stacked = {k: stacked_spec(v) for k, v in entries(tlm.model_spec(ta))}
    key = prng.PRNGKey(seed)
    for i, (k, w) in enumerate(want.items()):
        g = got[k]
        assert g.shape == w.shape and g.dtype == w.dtype
        spec = stacked[k]
        if spec.init in ("zeros", "ones"):
            assert np.array_equal(g, w)
            continue
        std = np.float32(0.02 if spec.init == "embed"
                         else 1 / np.sqrt(spec.shape[0]))
        twin = std * prng.normal(prng.fold_in(key, i), spec.shape)
        assert np.array_equal(g.view(np.int32), twin.view(np.int32)), k
        assert _ulps(g, w).max() <= NORMAL_ULP + 1, k


def test_init_model_layers_are_per_layer_views():
    _, ta = _archs()
    params = tlm.init_model(ta, prng.PRNGKey(1), device="cpu")
    layers = params.tree()["segments"]["seg0"]
    assert len(layers) == ta.n_layers
    assert layers[0]["attn"]["wq"].shape == (64, 4, 16)
    assert sum(v.numel() for v in params.parameters()) == tlm.n_params(ta)


# ---------------------------------------------------------------------------
# lm_loss and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq,chunk", [(16, 16), (20, 16), (40, 16),
                                       (24, 7)])
def test_lm_loss_matches_reference(seq, chunk):
    """One chunk, a padded last chunk (S not a multiple of the chunk),
    several chunks."""
    ja, ta = _archs(loss_chunk=chunk)
    jb, tb = _batch(seq, 2, seq)
    want = float(jlm.lm_loss(jax.tree.map(jnp.asarray, _weights()), ja, jb,
                             dtype=jnp.float32))
    params = tlm.load_reference_params(_weights(), device="cpu")
    got = tlm.lm_loss(params, ta, tb, dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), want, rtol=LOSS_RTOL)


def test_lm_loss_all_labels_ignored_is_zero():
    _, ta = _archs()
    _, tb = _batch(0, 2, 16)
    tb["labels"] = torch.full_like(tb["labels"], -1)
    params = tlm.load_reference_params(_weights(), device="cpu")
    assert float(tlm.lm_loss(params, ta, tb, dtype=torch.float32)) == 0.0


def _grads_port(ta, tb, remat):
    ta = dataclasses.replace(ta, remat=remat)
    live = tree_map(lambda p: p.detach().requires_grad_(),
                    tlm.load_reference_params(_weights(), device="cpu")
                    .tree())
    loss = tlm.lm_loss(live, ta, tb, dtype=torch.float32)
    loss.backward()
    return float(loss.detach()), _flat(tree_map(lambda p: p.grad, live))


def test_lm_loss_gradients_match_reference():
    ja, ta = _archs(loss_chunk=16)
    jb, tb = _batch(1, 2, 20)
    want = _jflat(jax.grad(lambda p: jlm.lm_loss(p, ja, jb,
                                                 dtype=jnp.float32))(
        jax.tree.map(jnp.asarray, _weights())))
    _, got = _grads_port(ta, tb, remat=False)
    assert list(got) == list(want)
    for k, w in want.items():
        bar = GRAD_BAR * np.abs(w).max()
        assert np.abs(got[k] - w).max() <= bar, k


def test_remat_recomputes_exactly():
    """``torch.utils.checkpoint`` around each layer: the same loss and
    gradients, bit for bit."""
    _, ta = _archs(loss_chunk=16)
    _, tb = _batch(2, 2, 20)
    loss_a, ga = _grads_port(ta, tb, remat=False)
    loss_b, gb = _grads_port(ta, tb, remat=True)
    assert loss_a == loss_b
    for k in ga:
        assert np.array_equal(ga[k], gb[k]), k


def test_lm_loss_bf16_matches_reference():
    """The reference's default activation type, bfloat16: within 2e-2
    (tests/test_models.py's bar for a whole model in bf16)."""
    ja, ta = _archs()
    jb, tb = _batch(3, 2, 16)
    want = float(jlm.lm_loss(jax.tree.map(jnp.asarray, _weights()), ja, jb))
    params = tlm.load_reference_params(_weights(), device="cpu")
    got = float(tlm.lm_loss(params, ta, tb))
    np.testing.assert_allclose(got, want, rtol=2e-2)


def test_lm_loss_float64():
    """The float64 loss (the card's reference for the trainer) agrees
    with the float32 one within float32's rounding of a whole model."""
    _, ta = _archs()
    _, tb = _batch(4, 2, 24)
    params = tlm.load_reference_params(_weights(), device="cpu")
    l32 = tlm.lm_loss(params, ta, tb, dtype=torch.float32)
    l64 = tlm.lm_loss(params, ta, tb, dtype=torch.float64)
    assert l64.dtype == torch.float64
    np.testing.assert_allclose(float(l32), float(l64), rtol=1e-5)


def test_lm_loss_other_blocks_raise():
    """An MTP head on attention blocks (reduced qwen2 with ``mtp=True``):
    its weighted loss is in the objective, as the reference's."""
    ja, ta = _archs(mtp=True)
    jb, tb = _batch(0, 2, 12)
    rng = np.random.default_rng(1)
    jp = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
                   ).astype(np.float32),
        jax_init_model(ja, jax.random.PRNGKey(0)))
    tp = tlm.load_reference_params(jp, device="cpu")
    want = float(jlm.lm_loss(jax.tree.map(jnp.asarray, jp), ja, jb,
                             dtype=jnp.float32))
    got = tlm.lm_loss(tp, ta, tb, dtype=torch.float32)
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    base = tlm.lm_loss(tp, dataclasses.replace(ta, mtp=False), tb,
                       dtype=torch.float32)
    assert float(got) > float(base) + 0.1 * ta.mtp_weight


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def _grad_trees(rng, k):
    g = {"w": rng.standard_normal((4, 5)).astype(np.float32) * 10.0**-k,
         "b": rng.standard_normal(5).astype(np.float32) * 1e-9,
         "layers": rng.standard_normal((3, 2, 2)).astype(np.float32)}
    return (jax.tree.map(jnp.asarray, g),
            {"w": torch.tensor(g["w"]), "b": torch.tensor(g["b"]),
             "layers": [torch.tensor(a) for a in g["layers"]]})


def _assert_tree_close(jtree, ttree, bar):
    want, got = _jflat(jtree), _flat(ttree)
    assert list(got) == list(want)
    for k, w in want.items():
        assert np.abs(got[k].astype(np.float32) - w.astype(np.float32)
                      ).max() <= bar * max(np.abs(w).max(), 1e-30), k


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(moments):
    """Five steps from the same parameters and gradients (tiny, large and
    near-zero ones, clipped): parameters and both moments within 1e-6 of
    each leaf's size; the step counter an int32 0-d tensor."""
    rng = np.random.default_rng(0)
    p0 = {"w": rng.standard_normal((4, 5)).astype(np.float32),
          "b": rng.standard_normal(5).astype(np.float32),
          "layers": rng.standard_normal((3, 2, 2)).astype(np.float32)}
    jp = jax.tree.map(jnp.asarray, p0)
    tp = {"w": torch.tensor(p0["w"]), "b": torch.tensor(p0["b"]),
          "layers": [torch.tensor(a) for a in p0["layers"]]}
    kw = dict(lr=0.01, warmup_steps=2, total_steps=10, grad_clip=1.0,
              moment_dtype=moments)
    jcfg, tcfg = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    js, ts = jopt.adamw_init(jp), topt.adamw_init(tp)
    for k in range(5):
        jg, tg = _grad_trees(rng, k)
        jp, js = jopt.adamw_update(jcfg, jg, js, jp)
        tp, ts = topt.adamw_update(tcfg, tg, ts, tp)
    _assert_tree_close(jp, tp, UPDATE_BAR)
    _assert_tree_close(js.mu, ts.mu, UPDATE_BAR)
    _assert_tree_close(js.nu, ts.nu, UPDATE_BAR)
    assert ts.mu["w"].dtype == getattr(torch, moments)
    assert ts.step.dtype == torch.int32 and ts.step.shape == ()
    assert int(ts.step) == int(js.step) == 5


def test_sgd_update_matches_reference():
    rng = np.random.default_rng(1)
    p0 = rng.standard_normal((4, 5)).astype(np.float32)
    jp, tp = {"w": jnp.asarray(p0)}, {"w": torch.tensor(p0)}
    jcfg = jopt.SGDConfig(lr=0.05, momentum=0.9, grad_clip=0.5)
    tcfg = topt.SGDConfig(lr=0.05, momentum=0.9, grad_clip=0.5)
    js, ts = jopt.sgd_init(jp), topt.sgd_init(tp)
    for _ in range(4):
        g = rng.standard_normal((4, 5)).astype(np.float32)
        jp, js = jopt.sgd_update(jcfg, {"w": jnp.asarray(g)}, js, jp)
        tp, ts = topt.sgd_update(tcfg, {"w": torch.tensor(g)}, ts, tp)
    _assert_tree_close(jp, tp, UPDATE_BAR)
    _assert_tree_close(js.velocity, ts.velocity, UPDATE_BAR)


def test_schedule_matches_reference():
    cfg = dict(lr=3e-3, warmup_steps=5, total_steps=40, min_lr_frac=0.1)
    for step in (0, 1, 4, 5, 6, 20, 40, 55):
        want = float(jopt._schedule(jopt.AdamWConfig(**cfg),
                                    jnp.float32(step)))
        got = float(topt._schedule(topt.AdamWConfig(**cfg),
                                   torch.tensor(float(step))))
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_adamw_converges_quadratic():
    params = {"w": torch.ones((4, 4)), "b": torch.zeros((4,))}

    def loss(p):
        return (p["w"] ** 2).sum() + ((p["b"] - 1.0) ** 2).sum()

    init, update = topt.make_optimizer(topt.AdamWConfig(
        lr=0.05, warmup_steps=1, total_steps=200, weight_decay=0.0))
    state = init(params)
    for _ in range(200):
        live = tree_map(lambda t: t.detach().requires_grad_(), params)
        grads = torch.autograd.grad(loss(live), [live["w"], live["b"]])
        params, state = update({"w": grads[0], "b": grads[1]}, state,
                               params)
    assert float(loss(params)) < 1e-3


def test_sgd_momentum_converges():
    params = {"w": 5.0 * torch.ones((3,))}
    init, update = topt.make_optimizer(topt.SGDConfig(lr=0.05, momentum=0.9))
    state = init(params)
    for _ in range(400):      # momentum ring-down on the quadratic
        params, state = update({"w": 2 * params["w"]}, state, params)
    assert float((params["w"] ** 2).sum()) < 1e-3
    with pytest.raises(TypeError, match="unknown optimizer"):
        topt.make_optimizer(object())


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

TRAIN = ["--arch", NAME, "--reduced", "--global-batch", "2", "--seq-len",
         "16", "--log-every", "100"]


def _reference_losses(steps, seed, ckpt_dir):
    """The reference trainer's step, looped, with every loss kept; its
    step-0 state written to ``ckpt_dir`` first."""
    ja = jax_reduced(jax_get_arch(NAME))
    cfg = jopt.AdamWConfig(lr=3e-3, warmup_steps=max(steps // 20, 1),
                           total_steps=steps, weight_decay=0.01)
    data = JPipeline(JDataConfig(vocab_size=ja.vocab_size, seq_len=16,
                                 global_batch=2, seed=seed))

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


def test_run_training_follows_the_reference(tmp_path):
    """The port resumes from the reference's step-0 checkpoint and trains
    4 steps: per-step losses within the bars of the module docstring."""
    want = _reference_losses(4, 3, tmp_path)
    args = ttrain.build_argparser().parse_args(
        TRAIN + ["--steps", "4", "--ckpt-every", "100", "--seed", "3",
                 "--ckpt-dir", str(tmp_path)])
    out = ttrain.run_training(args, device="cpu")
    got = np.asarray(out["losses"])
    assert out["steps"] == 4 and len(got) == 4 and len(out["step_s"]) == 4
    rel = np.abs(got - want) / want
    assert rel[0] <= 1e-6 and rel[1:].max() <= 1e-3, rel


def test_run_training_from_its_seed(tmp_path):
    """From ``--seed`` alone the port starts from the reference's weights
    (within the normal twin's ulps) and batches: the first loss within
    1e-5 of the reference trainer's."""
    argv = TRAIN + ["--steps", "2", "--ckpt-every", "100", "--seed", "1"]
    want = jtrain.run_training(jtrain.build_argparser().parse_args(
        argv + ["--ckpt-dir", str(tmp_path / "ref")]))
    got = ttrain.run_training(ttrain.build_argparser().parse_args(
        argv + ["--ckpt-dir", str(tmp_path / "port")]), device="cpu")
    np.testing.assert_allclose(got["first_loss"], want["first_loss"],
                               rtol=1e-5)
    assert got["steps"] == want["steps"] == 2


def test_failure_injection_and_training_restart(tmp_path):
    """The reference's restart case on the port: the injector draws the
    same failures (its seeded numpy stream), the run restarts from its
    checkpoints and finishes every step."""
    argv = TRAIN + ["--steps", "12", "--ckpt-every", "4",
                    "--inject-failure-rate", "0.25", "--seed", "3"]
    want = jtrain.run_training(jtrain.build_argparser().parse_args(
        argv + ["--ckpt-dir", str(tmp_path / "ref")]))
    out = ttrain.run_training(ttrain.build_argparser().parse_args(
        argv + ["--ckpt-dir", str(tmp_path / "port")]), device="cpu")
    assert out["steps"] == 12
    assert out["injected_failures"] > 0
    assert out["injected_failures"] == want["injected_failures"]
    assert out["restarts"] == want["restarts"]
    assert out["final_loss"] is not None and np.isfinite(out["final_loss"])


def test_model_shards_raise(tmp_path):
    """One process cannot hold a (data, model=2) mesh: the error names
    the fleet it needs."""
    args = ttrain.build_argparser().parse_args(
        TRAIN + ["--steps", "1", "--model-shards", "2", "--ckpt-dir",
                 str(tmp_path)])
    with pytest.raises(ValueError, match="--processes 2"):
        ttrain.run_training(args, device="cpu")


_SHARDED = """
import json, sys
from repro_torch.launch import train
import torch.distributed as dist
args = train.build_argparser().parse_args(ARGV)
out = train.run_training(args, device="cpu")
emit({"rank": dist.get_rank(), "losses": out["losses"],
      "steps": out["steps"]})
"""


def test_model_shards_fleet_matches_one_shard(tmp_path):
    """A 2-rank gloo fleet trains ``--model-shards 2`` on a (1, 2) mesh
    (parameters and moments sharded over "model", checkpointed whole by
    rank 0 at step 2) with the losses of one process training
    ``--model-shards 1``, within the train bars."""
    from torch_fleet import by_rank, fleet
    argv = TRAIN + ["--steps", "4", "--ckpt-every", "2", "--seed", "1"]
    one = ttrain.run_training(ttrain.build_argparser().parse_args(
        argv + ["--ckpt-dir", str(tmp_path / "one")]), device="cpu")
    code = _SHARDED.replace("ARGV", repr(
        argv + ["--model-shards", "2", "--ckpt-dir", str(tmp_path / "two")]))
    two = by_rank(fleet(code, processes=2, timeout=300, threads=2))
    assert set(two) == {0, 1}
    want = np.asarray(one["losses"])
    for rank in (0, 1):
        got = np.asarray(two[rank]["losses"])
        assert two[rank]["steps"] == 4 and got.shape == want.shape
        assert np.isclose(got[0], want[0], rtol=1e-6, atol=0)
        np.testing.assert_allclose(got[1:], want[1:], rtol=1e-3, atol=0)
    assert (tmp_path / "two" / "step_00000004").exists()


def test_train_main_prints_the_summary(tmp_path, capsys, monkeypatch):
    """``main`` (the CLI) trains on the card by default; here it is
    pointed at the CPU and prints one JSON line."""
    real = ttrain.run_training
    monkeypatch.setattr(ttrain, "run_training",
                        lambda args: real(args, device="cpu"))
    ttrain.main(TRAIN + ["--steps", "2", "--ckpt-every", "2",
                         "--ckpt-dir", str(tmp_path)])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["steps"] == 2 and len(out["losses"]) == 2
    assert (tmp_path / "step_00000002" / "manifest.json").exists()
