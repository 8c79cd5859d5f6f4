"""The generator: the seed changes the start points and nothing else;
the rates and tails are taken over every request of a window; the
remote-sensing count."""
import numpy as np
import pytest

from dgobench.reference import Lattice, child_masks, segment_table
from dgobench.spec import HERE, load_cell, load_module
from dgobench.traffic import Starts


@pytest.mark.parametrize("cell", ["rs680.closed", "r1000.closed"])
def test_two_seeds_differ_only_in_their_starts(cell):
    c = load_cell(cell)
    lat = Lattice.of(c.config)
    mixes = [c.loop.parse(c.traffic) for _ in range(2)]
    assert mixes[0] == mixes[1] and mixes[0].wave_size >= 32
    assert mixes[0].clients == 3 * mixes[0].wave_size
    a, b = Starts(lat, 5, 1), Starts(lat, 2**31 + 77, 1)
    for _ in range(600):                 # past one block of draws
        (la, xa), (lb, xb) = a.next(), b.next()
        assert la.shape == lb.shape == (lat.n_vars,)
        assert xa.dtype == np.float32
        assert (lat.levels_np(xa) == la).all()
    assert not np.array_equal(xa, xb)
    again = Starts(lat, 2**31 + 77, 1)
    first = again.next()[0]
    assert np.array_equal(first, Starts(lat, 2**31 + 77, 1).next()[0])
    assert not np.array_equal(first, Starts(lat, 2**31 + 77, 0).next()[0])
    assert Starts(lat, -3, 1).next()[0].shape == (lat.n_vars,)


def test_tails_are_over_every_request():
    p95 = load_module(HERE / "metrics" / "solve_p95_ms.closed.py").read
    lat = list(np.linspace(0.1, 1.0, 10_000))      # more than any ring
    assert p95({"latencies_s": lat}) == pytest.approx(
        1e3 * np.percentile(lat, 95))
    assert p95({"latencies_s": []}) is None


def test_rates_are_over_every_wave():
    fill = load_module(HERE / "metrics" / "bucket_fill.closed.py").read
    wave = load_module(HERE / "metrics" / "wave_ms.closed.py").read
    rec = {"counters": {"slots": 1280, "padded_slots": 128, "waves": 10,
                        "busy_s": 2.5}}
    assert fill(rec) == pytest.approx(90.0)
    assert wave(rec) == pytest.approx(250.0)
    empty = {"counters": {"slots": 0, "padded_slots": 0, "waves": 0,
                          "busy_s": 0.0}}
    assert fill(empty) is None and wave(empty) is None


@pytest.mark.parametrize("cell", ["rs680.closed", "r1000.closed"])
def test_every_wave_leaves_full(cell):
    c = load_cell(cell)
    mix = c.loop.parse(c.traffic)
    assert mix.clients % mix.wave_size == 0
    assert mix.clients // mix.wave_size == mix.max_in_flight + 1
    # the warm-up puts a wave on every stream the window uses
    assert mix.warmup_waves == mix.max_in_flight


def test_remote_sensing_count_is_the_needed_work():
    c = load_cell("rs680.closed")
    assert c.count.ops_per_restart_step(c.config) == pytest.approx(
        1.2262e9, rel=1e-4)


def test_counts_follow_the_program_masks_and_segments():
    from repro_torch.core.population import segment_patterns
    from repro_torch.core import population
    from repro_torch.kernels.popstep.ops import hidden_unit_masks

    c = load_cell("rs680.closed")
    units = ((hidden_unit_masks(2720, 4)[:, None] >> np.arange(42)) & 1)
    assert (units.sum(1) == c.count.unit_counts(2720, 4)).all()
    for n in (1, 2, 5, 8, 48):
        assert (segment_table(n) == population.segment_table(n)).all()
    lat = Lattice(3, 4, -1.0, 1.0)
    pats = segment_patterns(lat.n_bits).reshape(-1, 3, 4).astype(np.int64)
    want = (pats * (1 << np.arange(3, -1, -1))).sum(-1)
    assert (child_masks(lat, "cpu", chunk=5).numpy() == want).all()


def test_lattice_points_are_the_programs_decode():
    import torch
    from repro_torch.core.encoding import Encoding, decode_levels

    for cfg in ("rs680.closed", "r1000.closed"):
        c = load_cell(cfg).config
        lat = Lattice.of(c)
        lv = np.arange(lat.levels)
        enc = Encoding(lat.n_vars, lat.bits, lat.lo, lat.hi)
        assert np.array_equal(
            lat.points_np(lv),
            decode_levels(torch.as_tensor(lv), enc).numpy())
        assert np.array_equal(
            lat.points(torch.as_tensor(lv)).numpy(), lat.points_np(lv))


def test_remote_sensing_state_is_the_configurations():
    c = load_cell("rs680.closed")
    st = c.reference.state(c.config)
    assert st["x"].shape == (256, 7) and st["x"].dtype == np.float32
    assert np.bincount(st["y"]).tolist() == [32] * 8
    small = dict(c.config, n_per_class=4)
    assert c.reference.state(small)["x"].shape == (32, 7)
