"""The port's popstep (its plain PyTorch version, on CPU tensors) vs the
JAX package's popstep kernel (interpret mode, as tests/test_popstep.py
runs it) and its oracles.

Selection follows ``ref.py`` and the engines, not the TPU kernel's fold:
a NaN wins its block (the TPU kernel hides a NaN in a non-first tile)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import objectives as jobj
from repro.core.encoding import Encoding as JEnc
from repro.kernels.popstep import ops as jops
from repro.kernels.popstep import ref as jref
from repro_torch.core import objectives as tobj
from repro_torch.core.encoding import Encoding as TEnc
from repro_torch.core.encoding import levels_of
from repro_torch.core.population import segment_patterns, segment_table
from repro_torch.kernels.popstep import ops as tops
from repro_torch.kernels.popstep import ref as tref

TOL = dict(rtol=1e-5, atol=1e-5)


def _parent(n_bits, seed):
    return np.random.default_rng(seed).integers(0, 2, n_bits).astype(np.int8)


def _pair(name, **kw):
    return jobj.get(name, **kw), tobj.get(name, **kw)


def _tenc(enc):
    return TEnc(enc.n_vars, enc.bits, enc.lo, enc.hi)


@pytest.mark.parametrize("n_vars,bits", [(1, 4), (4, 7), (9, 7), (3, 16),
                                         (17, 9)])
def test_plain_step_matches_reference_kernel_shapes(n_vars, bits):
    jo, to = _pair("quadratic", n=n_vars)
    je = JEnc(n_vars, bits, -4.0, 4.0)
    parent = _parent(je.n_bits, n_vars * 31 + bits)
    v, i = jops.population_step(jax.vmap(jo.fn), jnp.asarray(parent), je,
                                tile_p=32, interpret=True)
    tv, ti = tops.population_step(to, torch.as_tensor(parent), _tenc(je))
    assert np.isclose(float(tv), float(v), **TOL)
    assert int(ti) == int(i)


@pytest.mark.parametrize("name", ["rastrigin", "shekel", "xor", "sample2d"])
def test_plain_step_matches_reference_oracle(name):
    jo, to = _pair(name)
    enc = jo.encoding
    parent = _parent(enc.n_bits, 7)
    rv, ri = jax.jit(jref.popstep_ref, static_argnums=(0, 2))(
        jax.vmap(jo.fn), jnp.asarray(parent), enc)
    tv, ti = tops.population_step(to, torch.as_tensor(parent), _tenc(enc))
    ov, oi = tref.popstep_ref(to.fn, torch.as_tensor(parent), _tenc(enc))
    assert np.isclose(float(tv), float(rv), **TOL)
    assert int(ti) == int(ri) == int(oi)
    assert float(ov) == float(tv)


def test_subset_and_quorum_mask_match_reference():
    jo, to = _pair("ackley", n=3)
    enc = jo.encoding
    parent = _parent(enc.n_bits, 3)
    ids = np.asarray([0, 5, 11, 40, enc.population - 1])
    f = jax.vmap(jo.fn)
    rv, ri = jops.population_step_ids(f, jnp.asarray(parent),
                                      jnp.asarray(ids), enc, interpret=True)
    tv, ti = tops.population_step_ids(to, torch.as_tensor(parent),
                                      torch.as_tensor(ids), _tenc(enc))
    assert np.isclose(float(tv), float(rv), **TOL) and int(ti) == int(ri)
    valid = np.asarray([False, True, True, True, False])
    rv, ri = jops.population_step_ids(f, jnp.asarray(parent),
                                      jnp.asarray(ids), enc,
                                      valid=jnp.asarray(valid),
                                      interpret=True)
    tv, ti = tops.population_step_ids(to, torch.as_tensor(parent),
                                      torch.as_tensor(ids), _tenc(enc),
                                      valid=torch.as_tensor(valid))
    assert np.isclose(float(tv), float(rv), **TOL) and int(ti) == int(ri)


def test_all_rows_masked_is_inf_at_the_first_id():
    jo, to = _pair("quadratic", n=2)
    enc = jo.encoding
    parent = _parent(enc.n_bits, 1)
    ids = np.asarray([3, 1, 2, 0])
    rv, ri = jops.population_step_ids(
        jax.vmap(jo.fn), jnp.asarray(parent), jnp.asarray(ids), enc,
        valid=jnp.zeros(4, bool), interpret=True)
    tv, ti = tops.population_step_ids(
        to, torch.as_tensor(parent), torch.as_tensor(ids), _tenc(enc),
        valid=torch.zeros(4, dtype=torch.bool))
    assert np.isinf(float(tv)) and np.isinf(float(rv))
    assert int(ti) == int(ri) == 3


def test_ties_go_to_the_smallest_id():
    enc = JEnc(3, 5, -1.0, 1.0)
    parent = _parent(enc.n_bits, 4)
    ids = np.asarray([9, 2, 17, 5])

    def flat_j(x):
        return jnp.zeros(x.shape[:1], jnp.float32)

    def flat_t(x):
        return torch.zeros(x.shape[:1], dtype=torch.float32)

    rv, ri = jref.popstep_subset_ref(flat_j, jnp.asarray(parent),
                                     jnp.asarray(ids), enc)
    tv, ti = tops.population_step_ids(flat_t, torch.as_tensor(parent),
                                      torch.as_tensor(ids), _tenc(enc))
    assert float(tv) == float(rv) == 0.0 and int(ti) == int(ri) == 9
    v, i = tops.population_step(flat_t, torch.as_tensor(parent), _tenc(enc))
    assert int(i) == 0


def _nan_at(child_x, nan_rows):
    """A batched objective that is NaN exactly at the given decoded rows."""
    marks = {tuple(np.asarray(child_x[r]).tolist()) for r in nan_rows}

    def fn_np(x):
        x = np.asarray(x)
        v = (x * x).sum(-1).astype(np.float32)
        for r in range(x.shape[0]):
            if tuple(x[r].tolist()) in marks:
                v[r] = np.nan
        return v
    return fn_np


def test_nan_in_a_non_first_tile_wins_like_the_oracle():
    """The reference TPU kernel's fold hides a NaN in any tile after the
    first; the port follows popstep_ref (jnp.argmin): the first NaN wins."""
    enc = JEnc(4, 8, -2.0, 2.0)            # pop 63: tiles of 32 -> 2 tiles
    parent = _parent(enc.n_bits, 11)
    from repro.core.encoding import decode
    from repro.core.population import generate_population
    xs = np.asarray(decode(generate_population(jnp.asarray(parent)), enc))
    fn_np = _nan_at(xs, [40, 50])

    def fj(x):
        return jax.pure_callback(
            fn_np, jax.ShapeDtypeStruct(x.shape[:1], jnp.float32), x)

    def ft(x):
        return torch.as_tensor(fn_np(x.numpy()))

    rv, ri = jref.popstep_ref(fj, jnp.asarray(parent), enc)
    tv, ti = tops.population_step(ft, torch.as_tensor(parent), _tenc(enc))
    assert np.isnan(float(rv)) and np.isnan(float(tv))
    assert int(ti) == int(ri) == 40


def test_remote_sensing_256_id_subset_of_the_full_step():
    """The paper's largest step (680 variables, 5,439 children) on a
    256-id subset, with the reference's own data carried over."""
    x, y = jobj.make_remote_sensing_data(jax.random.PRNGKey(42))
    to = tobj.load_reference_state("remote_sensing",
                                   {"x": np.asarray(x), "y": np.asarray(y)})
    jo = jobj.remote_sensing_objective()
    enc = jo.encoding
    assert enc.population == 5439
    parent = _parent(enc.n_bits, 5)
    ids = np.sort(np.random.default_rng(6).choice(enc.population, 256,
                                                  replace=False))
    rv, ri = jax.jit(jref.popstep_subset_ref, static_argnums=(0, 3))(
        jax.vmap(jo.fn), jnp.asarray(parent), jnp.asarray(ids), enc)
    tv, ti = tops.population_step_ids(to, torch.as_tensor(parent),
                                      torch.as_tensor(ids), _tenc(enc))
    assert np.isclose(float(tv), float(rv), **TOL)
    assert int(ti) == int(ri)


@pytest.mark.parametrize("n_bits,bits", [(5, 5), (16, 4), (63, 7), (99, 9)])
def test_closed_form_child_levels_match_the_xor_patterns(n_bits, bits):
    """Stage 1 of the kernel: child level = parent level XOR the
    variable's slice of the binary-space pattern."""
    enc = TEnc(n_bits // bits, bits, -1.0, 1.0)
    n = enc.n_bits
    parent = torch.as_tensor(_parent(n, n_bits))
    table = torch.as_tensor(segment_table(n)).to(torch.int64)
    lv = tops.child_levels(levels_of(parent, enc), table[:, 0], table[:, 1],
                           enc)
    children = parent.numpy()[None, :] ^ segment_patterns(n)
    assert np.array_equal(lv.numpy(),
                          levels_of(torch.as_tensor(children), enc).numpy())


def _scan_fold(blocks, pop):
    """distributed.py:246-253, literally: NaN blocks never win."""
    best_v, best_id = np.float32(np.inf), pop
    for v, gid in blocks:
        if v < best_v or (v == best_v and gid < best_id):
            best_v, best_id = v, gid
    return best_v, best_id


def test_virtual_blocks_fold_like_the_engine():
    """``virtual_block`` cuts the ids into the engine's blocks: each is
    selected like popstep_subset_ref, and the blocks fold as the engine's
    scan does (a NaN block is hidden; one block keeps its NaN)."""
    enc = TEnc(5, 6, -3.0, 3.0)
    parent = torch.as_tensor(_parent(enc.n_bits, 21))
    ids = torch.arange(48)
    xs = tops.child_values_plain(lambda x: (x * x).sum(-1), parent, ids, enc)
    nan_rows = {7, 30}

    def fn(x):
        v = (x * x).sum(-1)
        hit = torch.zeros_like(v, dtype=torch.bool)
        for r in nan_rows:
            hit |= (v == xs[r])
        return torch.where(hit, torch.nan, v)

    vals = tops.child_values_plain(fn, parent, ids, enc)
    assert torch.isnan(vals[sorted(nan_rows)]).all()
    for vb in (8, 12, 16, 48):
        blocks = []
        for b in range(48 // vb):
            bv, bi = tref.popstep_subset_ref(fn, parent,
                                             ids[b * vb:(b + 1) * vb], enc)
            blocks.append((np.float32(bv), int(bi)))
        v, i = tops.population_step_ids(fn, parent, ids, enc,
                                        virtual_block=vb)
        if vb == 48:            # one block: its NaN is the answer
            assert np.isnan(float(v)) and int(i) == blocks[0][1]
        else:
            want = _scan_fold(blocks, enc.population)
            assert np.isfinite(want[0])
            assert float(v) == want[0] and int(i) == want[1]
    with pytest.raises(ValueError, match="virtual blocks"):
        tops.population_step_ids(fn, parent, ids, enc, virtual_block=10)


def test_fold_partials_rule():
    nan, inf = float("nan"), float("inf")
    vals = torch.tensor([3.0, 2.0, 2.0, nan, 1.0, nan, 2.0, 5.0, 2.0,
                         inf, inf, inf])
    rows = torch.tensor([5, 1, 0, 9, 8, 4, 3, 6, 2, 10, 11, 7],
                        dtype=torch.int32)
    ids = torch.tensor([40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51])
    v, i = tops.fold_partials_plain(vals, rows, ids, 4, sentinel=99)
    # blocks: (2.0, row 0 -> 40), NaN, (2.0, row 2 -> 42), (inf, row 7)
    assert float(v) == 2.0 and int(i) == 40
    v, i = tops.fold_partials_plain(vals[3:6], rows[3:6], ids, 1, sentinel=99)
    assert np.isnan(float(v)) and int(i) == int(ids[4])
    v, i = tops.fold_partials_plain(torch.full((4,), nan),
                                    torch.arange(4, dtype=torch.int32), ids,
                                    2, sentinel=99)
    assert float(v) == inf and int(i) == 99
    v, i = tops.fold_partials(vals, rows, ids, 4, sentinel=99)
    assert float(v) == 2.0 and int(i) == 40


class _FakeCuda:
    """Stands in for CUDA ids: only what the dispatch reads."""

    shape = (4,)
    is_cuda = True


def test_cuda_ids_never_reach_the_plain_version(monkeypatch):
    calls = []
    monkeypatch.setattr(tops, "_prepare_cuda",
                        lambda *a: calls.append(a) or (lambda p: "kernel"))
    monkeypatch.setattr(tops, "population_step_ids_plain",
                        lambda *a, **k: pytest.fail("plain version reached"))
    enc = TEnc(2, 8, -1.0, 1.0)
    assert tops.population_step_ids(tobj.get("quadratic"), None, _FakeCuda(),
                                    enc) == "kernel"
    assert len(calls) == 1


def test_kernel_wrapper_refuses_an_objective_without_device_form():
    enc = TEnc(2, 8, -1.0, 1.0)
    with pytest.raises(ValueError, match="inner='fused'"):
        tops._prepare_cuda(lambda x: x.sum(-1), torch.arange(4), enc, None, 1)
    with pytest.raises(ValueError, match="does not fit"):
        tops._prepare_cuda(tobj.get("xor"), torch.arange(4), enc, None, 1)
