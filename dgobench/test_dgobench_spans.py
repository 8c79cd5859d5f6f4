"""The readers of the program's spans (``metrics/<name>.py`` over
``repro_torch.core.spans``): each gives its number from a recorder built
by hand, None where the program has no such module (as an older program
has not) or it holds no traced wave, and a traced run on the CPU reports
all five."""
import sys

import pytest

from dgobench import run
from dgobench.spec import HERE, load_module

SEED = 2**33 + 17
READERS = ("queue_wait_ms.closed", "submit_ms.closed", "finalize_ms.closed",
           "engine_host_us.closed", "rebuilds.closed")
MS = 1_000_000


def reader(name):
    return load_module(HERE / "metrics" / f"{name}.py")


@pytest.fixture
def recorder():
    from repro_torch.core import spans

    spans.clear()
    yield spans
    spans.clear()


def _hand_built(spans):
    """Two waves, every time chosen: queue waits 10 and 30 ms, submits 4
    and 6 ms, loops ending 20 and 50 ms before their finalize ends, loops
    of 100 ms each with 10 ms of stall reads and 2 of fetch over 16
    steps, one binding."""
    for w, (wait, sub, gap) in enumerate([(10, 4, 20), (30, 6, 50)], 1):
        t = 1_000 * MS * w
        with spans.wave(spans.Wave(w, t)):
            spans.record("serving.queue_wait", t - wait * MS, t, request=w)
            spans.record("serving.submit", t, t + sub * MS)
            loop_end = t + 100 * MS
            spans.record("engine.loop", t, loop_end)
            spans.record("engine.stall_read", t + 50 * MS, t + 55 * MS)
            spans.record("engine.fetch", loop_end - 2 * MS, loop_end - MS)
            spans.count("engine.steps", 16)
            spans.record("serving.finalize", loop_end + MS,
                         loop_end + gap * MS)
    with spans.wave(spans.Wave(2, 0)):
        spans.record("popstep.bind", 0, MS)


def test_each_reader_reads_a_hand_built_recorder(recorder):
    _hand_built(recorder)
    got = {name: reader(name).read({}) for name in READERS}
    assert got["queue_wait_ms.closed"] == pytest.approx(20.0)
    assert got["submit_ms.closed"] == pytest.approx(5.0)
    assert got["finalize_ms.closed"] == pytest.approx(35.0)
    # (200 - 10 - 2) ms over 32 steps
    assert got["engine_host_us.closed"] == pytest.approx(188e3 / 32)
    assert got["rebuilds.closed"] == 1


@pytest.mark.parametrize("name", READERS)
def test_a_reader_finds_nothing_without_traced_waves(recorder, name,
                                                     monkeypatch):
    assert reader(name).read({}) is None
    _hand_built(recorder)
    monkeypatch.delitem(sys.modules, "repro_torch.core.spans")
    assert reader(name).read({}) is None


def test_a_traced_cpu_run_reports_the_spans(recorder):
    from dgobench.test_dgobench_check import small

    res = run.run_cell(small("r1000.closed"), SEED, 1.0, True, device="cpu")
    assert res["correct"], res["check"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(READERS) <= set(m)
    assert m["rebuilds.closed"] == 0
    assert m["queue_wait_ms.closed"] > 0 and m["submit_ms.closed"] > 0
    assert m["finalize_ms.closed"] > 0 and m["engine_host_us.closed"] > 0
