"""``build_cell``'s steps of the port run on a one-rank ``(1, 1)`` gloo
mesh (``launch.mesh.make_host_mesh``), against the reference's
``build_cell`` steps on its one-device ``(1, 1)`` mesh, at ``reduced()``
width in float32: the train step's losses over two steps at S = 16 (the train
bars: 1e-6 at step 1, 1e-3 at step 2), under each policy (fsdp, zero1,
dp) and with microbatches accumulated; the prefill's logits and the
decode's (rtol = atol = 2e-4, the whole-model bar).  The parameters come
from one key through the threefry twin.  The mesh is global to a
process, so the cells run in a subprocess."""

import numpy as np
import pytest

from torch_fleet import json_lines, reference

_CODE = """
import dataclasses, json
import numpy as np, jax, jax.numpy as jnp, torch
from repro.configs import get_arch as jget, reduced as jreduced
from repro.configs.shapes import ShapeSpec as JShape
from repro.launch.mesh import make_host_mesh as jmesh_of
from repro.launch.steps import build_cell as jbuild
from repro.models.lm import init_model as jinit
from repro.optim.gradient import AdamWConfig as JAdam, adamw_init as jadam_init
from repro_torch.configs import get_arch, reduced
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.core import prng
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import build_cell, choose_microbatch, place
from repro_torch.models.lm import init_model
from repro_torch.optim.gradient import AdamWConfig, AdamWState, adamw_init
out = {}
tmesh, jm = make_host_mesh(model=1, device="cpu"), jmesh_of(model=1)
rng = np.random.default_rng(0)
for name in NAMES:
    arch, jarch = reduced(get_arch(name)), jreduced(jget(name))
    params = init_model(arch, prng.PRNGKey(0), device="cpu").tree()
    jparams = jinit(jarch, jax.random.PRNGKey(0), jnp.float32)
    res = {}
    for policy, batch, mb_budget in POLICIES[name]:
        shape = ShapeSpec("t", 16, batch, "train")
        cell = build_cell(arch, shape, tmesh, dtype=torch.float32,
                          opt_cfg=AdamWConfig(lr=3e-3), policy=policy)
        jcell = jbuild(jarch, JShape("t", 16, batch, "train"), jm,
                       dtype=jnp.float32, opt_cfg=JAdam(lr=3e-3),
                       policy=policy)
        assert cell.meta == jcell.meta, (cell.meta, jcell.meta)
        n_micro = cell.meta["n_micro"]
        toks = rng.integers(0, arch.vocab_size, (2, n_micro, batch // n_micro,
                                                 16)).astype(np.int32)
        p = place(params, cell.in_shardings[0])
        o = place(adamw_init(params), cell.in_shardings[1])
        jp, jo = jparams, jadam_init(jparams)
        losses, jlosses = [], []
        for i in range(2):
            b = {"tokens": torch.from_numpy(toks[i]),
                 "labels": torch.from_numpy(np.roll(toks[i], -1, -1))}
            p, o, loss = cell.step(p, o, place(b, cell.in_shardings[2]))
            jb = {k: jnp.asarray(v.numpy()) for k, v in b.items()}
            with jm:
                jp, jo, jloss = jax.jit(jcell.step)(jp, jo, jb)
            losses.append(float(loss)); jlosses.append(float(jloss))
        moved = float((p["final_norm"]["scale"].full_tensor() - 1).abs().max())
        res[policy + str(n_micro)] = {"losses": losses, "ref": jlosses,
                                      "moved": moved}
    # prefill and decode
    for kind, batch in (("prefill", 2), ("decode", 2)):
        shape = ShapeSpec("s", 48, batch, kind)
        cell = build_cell(arch, shape, tmesh, dtype=torch.float32,
                          prompt_len=16)
        jcell = jbuild(jarch, JShape("s", 48, batch, kind), jm,
                       dtype=jnp.float32, prompt_len=16)
        toks = rng.integers(0, arch.vocab_size, (batch, 16)).astype(np.int32)
        pp = place(params, cell.in_shardings[0])
        from repro_torch.launch.steps import make_prefill_step
        if kind == "prefill":
            b = {"tokens": torch.from_numpy(np.pad(toks, ((0, 0), (0, 32))))}
            logits, cache = cell.step(pp, place(b, cell.in_shardings[1]))
            with jm:
                jl, _ = jax.jit(jcell.step)(jparams, {"tokens": jnp.asarray(
                    b["tokens"].numpy())})
        else:
            pre = make_prefill_step(arch, 48, torch.float32, mesh=tmesh)
            _, cache = pre(pp, {"tokens": torch.from_numpy(toks)})
            tok = torch.from_numpy(toks[:, -1].copy())
            logits, _ = cell.step(pp, tok, cache)
            from repro.launch.steps import make_prefill_step as jpre
            _, jc = jax.jit(jpre(jarch, 48, jnp.float32))(
                jparams, {"tokens": jnp.asarray(toks)})
            with jm:
                jl, _ = jax.jit(jcell.step)(jparams, jnp.asarray(toks[:, -1]),
                                            jc)
        res[kind] = {"got": logits.full_tensor().tolist(),
                     "want": np.asarray(jl).tolist()}
    out[name] = res
emit(out)
"""

NAMES = ("qwen2-1.5b", "deepseek-v3-671b")
POLICIES = {"qwen2-1.5b": (("fsdp", 4, None), ("zero1", 4, None),
                           ("dp", 4, None)),
            "deepseek-v3-671b": (("fsdp", 4, None),)}


@pytest.fixture(scope="module")
def cells():
    from torch_fleet import EMIT
    code = EMIT + _CODE.replace("NAMES", repr(NAMES)).replace(
        "POLICIES", repr(POLICIES))
    return json_lines(reference(code, devices=1, timeout=420))[-1]


@pytest.mark.parametrize("name", NAMES)
def test_train_steps_match_the_reference(cells, name):
    for tag, r in cells[name].items():
        if tag in ("prefill", "decode"):
            continue
        got, want = np.asarray(r["losses"]), np.asarray(r["ref"])
        assert np.isclose(got[0], want[0], rtol=1e-6, atol=0), (tag, got,
                                                               want)
        assert np.isclose(got[1], want[1], rtol=1e-3, atol=0), (tag, got,
                                                               want)
        assert r["moved"] > 0, tag            # the parameters moved


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_serve_steps_match_the_reference(cells, name, kind):
    r = cells[name][kind]
    np.testing.assert_allclose(np.asarray(r["got"]), np.asarray(r["want"]),
                               rtol=2e-4, atol=2e-4)
