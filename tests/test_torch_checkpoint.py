"""The port's checkpoint store (``repro_torch.checkpoint``) on the
reference's four cases, and checkpoints crossing between the packages
both ways, bit for bit: the reference's trainer state restored by the
port, the port's restored by the reference (the same leaf keys, order,
stacked shapes, dtypes and CRCs)."""
import json
from pathlib import Path

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
from repro.launch import train as jtrain
from repro.models import init_model as jax_init_model
from repro.optim.gradient import adamw_init as jax_adamw_init
from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import get_arch, reduced
from repro_torch.core import prng
from repro_torch.core.tree import entries
from repro_torch.launch import train as ttrain
from repro_torch.models.lm import init_model
from repro_torch.optim import adamw_init

NAME = "qwen2-1.5b"
TRAIN = ["--arch", NAME, "--reduced", "--global-batch", "2", "--seq-len",
         "16", "--log-every", "100", "--steps", "2", "--ckpt-every", "2",
         "--seed", "5"]


def make_tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((4, 8), generator=g),
            "nested": {"b": torch.arange(5, dtype=torch.int32)},
            "t": (torch.ones(3), torch.zeros((2, 2))),
            "layers": [{"w": torch.randn((2, 3), generator=g)}
                       for _ in range(3)]}


def _leaves(tree):
    return [(k, v.stacked() if hasattr(v, "stacked") else v)
            for k, v in entries(tree)]


def _assert_same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), k


def test_roundtrip(tmp_path):
    tree = make_tree()
    save_checkpoint(tmp_path, 7, tree)
    assert latest_step(tmp_path) == 7
    out = restore_checkpoint(tmp_path, 7, make_tree(1))
    _assert_same(out, tree)
    assert isinstance(out["t"], tuple) and len(out["layers"]) == 3


def test_keep_last_k(tmp_path):
    tree = make_tree()
    for s in range(6):
        save_checkpoint(tmp_path, s, tree, keep_last=2)
    kept = sorted(p.name for p in Path(tmp_path).glob("step_*"))
    assert kept == ["step_00000004", "step_00000005"]


def test_corruption_detected(tmp_path):
    tree = make_tree()
    d = save_checkpoint(tmp_path, 1, tree)
    target = next(d.glob("leaf_*.npy"))
    arr = np.load(target)
    flat = arr.reshape(-1).copy()
    flat[0] += 1.0
    np.save(target, flat.reshape(arr.shape))
    with pytest.raises(IOError, match="corrupt"):
        restore_checkpoint(tmp_path, 1, tree)


def test_tmp_dir_never_visible(tmp_path):
    save_checkpoint(tmp_path, 3, make_tree())
    # a stale .tmp from a crashed writer must be invisible to latest_step
    (Path(tmp_path) / "step_00000009.tmp").mkdir()
    assert latest_step(tmp_path) == 3
    assert latest_step(tmp_path / "missing") is None


def test_manifest_is_the_references(tmp_path):
    """The same tree written by both packages: the same keys (layer lists
    as the reference's stacked leaves), shapes, dtypes and CRCs."""
    tree = make_tree()
    jtree = {"a": jnp.asarray(tree["a"].numpy()),
             "nested": {"b": jnp.arange(5, dtype=jnp.int32)},
             "t": (jnp.ones(3), jnp.zeros((2, 2))),
             "layers": {"w": jnp.asarray(np.stack(
                 [t["w"].numpy() for t in tree["layers"]]))}}
    save_checkpoint(tmp_path / "port", 1, tree)
    jax_save(tmp_path / "ref", 1, jtree)

    def manifest(d):
        return json.loads((d / "step_00000001" / "manifest.json")
                          .read_text())
    assert manifest(tmp_path / "port") == manifest(tmp_path / "ref")
    assert manifest(tmp_path / "port")["leaves"][0]["key"] == \
        "['a']" and manifest(tmp_path / "port")["leaves"][1]["shape"] == \
        [3, 2, 3]


def test_bfloat16_leaf_crosses(tmp_path):
    """bfloat16 is written as the reference writes it (its raw 2-byte
    words, ``"bfloat16"`` in the manifest, the same CRC) and the port
    reads the reference's."""
    vals = np.array([1.0, -2.5, 3.140625, 0.0078125], np.float32)
    jax_save(tmp_path / "ref", 1, {"m": jnp.asarray(vals, jnp.bfloat16)})
    port = torch.tensor(vals).to(torch.bfloat16)
    save_checkpoint(tmp_path / "port", 1, {"m": port})
    mp, mr = (json.loads((tmp_path / d / "step_00000001" / "manifest.json")
                         .read_text())["leaves"][0] for d in ("port", "ref"))
    assert mp == mr and mp["dtype"] == "bfloat16"
    out = restore_checkpoint(tmp_path / "ref", 1, {"m": port})
    assert out["m"].dtype == torch.bfloat16 and torch.equal(out["m"], port)


def _port_state(seed=0):
    params = init_model(reduced(get_arch(NAME)), prng.PRNGKey(seed),
                        device="cpu").tree()
    return params, adamw_init(params)


def _jax_state(seed=0):
    params = jax_init_model(jax_reduced(jax_get_arch(NAME)),
                            jax.random.PRNGKey(seed))
    return params, jax_adamw_init(params)


def _same_as_jax(port_tree, jax_tree):
    want = {"/".join(str(k) for k in path): np.asarray(leaf) for path, leaf
            in jax.tree_util.tree_flatten_with_path(jax_tree)[0]}
    got = _leaves(port_tree)
    assert [k for k, _ in got] == list(want)
    for k, v in got:
        w = want[k]
        assert v.numpy().dtype == w.dtype and v.shape == w.shape, k
        assert np.array_equal(v.numpy(), w), k


def test_reference_trainer_checkpoint_restores_in_the_port(tmp_path):
    """The reference trains 2 steps and writes (params, AdamW state); the
    port restores it into its own tree (per-layer lists, ``step`` a 0-d
    int32 tensor) bit for bit."""
    jtrain.run_training(jtrain.build_argparser().parse_args(
        TRAIN + ["--ckpt-dir", str(tmp_path)]))
    assert latest_step(tmp_path) == 2
    want = jax_restore(tmp_path, 2, _jax_state())
    got = restore_checkpoint(tmp_path, 2, _port_state())
    params, state = got
    assert isinstance(params["segments"]["seg0"], list)
    assert state.step.dtype == torch.int32 and int(state.step) == 2
    _same_as_jax(got, want)


def test_port_trainer_checkpoint_restores_in_the_reference(tmp_path):
    """The port trains 2 steps and writes its state; the reference
    restores it into its stacked tree bit for bit."""
    out = ttrain.run_training(ttrain.build_argparser().parse_args(
        TRAIN + ["--ckpt-dir", str(tmp_path)]), device="cpu",
        keep_state=True)
    assert jax_latest(tmp_path) == 2
    restored = jax_restore(tmp_path, 2, _jax_state())
    _same_as_jax(out["state"], restored)
    assert int(restored[1].step) == 2
