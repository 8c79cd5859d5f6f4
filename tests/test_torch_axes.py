"""Logical axes in the port's parameter specs: every leaf of every
architecture's ``model_axes`` equals the reference's ``model_spec`` axes
(the reference's stacked "layers" axis dropped: the port loops its
layers), the ``models.layers`` helpers (``is_spec``, ``abstract_params``,
``logical_axes``), and ``lm_loss``'s ``constrain`` hook: given, it is
called on every parameter before its use and changes nothing; not given,
nothing changes."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget
from repro.models import lm as jlm
from repro_torch.configs import ARCH_NAMES, get_arch, reduced
from repro_torch.core import prng
from repro_torch.models import model_axes
from repro_torch.models.layers import (
    ParamSpec, abstract_params, is_spec, logical_axes)
from repro_torch.models.lm import init_model, lm_loss, model_spec


def _port_axes(tree, path=()):
    if isinstance(tree, tuple):
        yield path, tree
    elif isinstance(tree, list):
        first = list(_port_axes(tree[0], path))
        for layer in tree[1:]:
            assert list(_port_axes(layer, path)) == first
        for p, axes in first:
            yield p, ("layers",) + axes
    else:
        for k, v in tree.items():
            yield from _port_axes(v, path + (k,))


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_axes_are_the_references(name):
    want = {tuple(k.key for k in path): axes for path, axes in
            jax.tree_util.tree_flatten_with_path(
                jlm.model_axes(jget(name)),
                is_leaf=lambda x: isinstance(x, tuple))[0]}
    got = dict(_port_axes(model_axes(get_arch(name))))
    assert got == want


def test_layer_helpers():
    spec = {"w": ParamSpec((4, 3), ("embed", "mlp")),
            "layers": [{"b": ParamSpec((3,), ("mlp",), init="zeros")}] * 2}
    assert is_spec(spec["w"]) and not is_spec(spec)
    assert logical_axes(spec) == {"w": ("embed", "mlp"),
                                  "layers": [{"b": ("mlp",)}] * 2}
    abs_ = abstract_params(spec, dtype=torch.bfloat16)
    assert abs_["w"].device.type == "meta"
    assert abs_["w"].shape == (4, 3) and abs_["w"].dtype == torch.bfloat16
    assert abs_["layers"][1]["b"].shape == (3,)
    with pytest.raises(AssertionError):
        ParamSpec((4, 3), ("embed",))


@pytest.mark.parametrize("name", ["qwen2-1.5b", "whisper-medium",
                                  "zamba2-1.2b", "deepseek-v3-671b"])
def test_constrain_hook_sees_every_parameter_and_changes_nothing(name):
    arch = reduced(get_arch(name))
    params = init_model(arch, prng.PRNGKey(0), device="cpu").tree()
    rng = np.random.default_rng(0)
    b, s = 2, 16
    batch = {"tokens": torch.from_numpy(rng.integers(0, arch.vocab_size,
                                                     (b, s))),
             "labels": torch.from_numpy(rng.integers(0, arch.vocab_size,
                                                     (b, s)))}
    if arch.enc_dec:
        batch["frames"] = torch.from_numpy(0.02 * rng.standard_normal(
            (b, arch.n_frames, arch.d_model)).astype(np.float32))
    seen = []

    def constrain(path, sub):
        node = model_spec(arch)
        for k in path:
            node = node[k]
        seen.append(path)
        return sub

    want = lm_loss(params, arch, batch, dtype=torch.float32)
    got = lm_loss(params, arch, batch, dtype=torch.float32,
                  constrain=constrain)
    assert torch.equal(got, want)
    tops = {p[0] for p in seen}
    assert tops == set(params), (tops, set(params))
    n_layers = sum(len(v) for v in params["segments"].values())
    assert sum(p[0] == "segments" for p in seen) == n_layers
