"""The serving path's spans (``repro_torch.core.spans``) on the CPU: the
profiler is the one switch, the span tree of three waves with its wave
and request ids and parent links, self times, the profiler's clock, and
the Chrome-trace export."""
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.core import cache, spans
from repro_torch.core.solver import Problem, SolveRequest
from repro_torch.serving import pipeline as serving_pipeline
from repro_torch.serving import scheduler as serving_scheduler

pytestmark = pytest.mark.timeout(300)

WAVE, WAVES, ITERS = 4, 3, 20
WINDOW = "test.window"
SCHEDULERS = pytest.mark.parametrize("pipelined", [True, False],
                                     ids=["pipelined", "synchronous"])


def _serve(pipelined: bool, problem):
    """Three full waves of ``problem`` on the CPU, drained and closed."""
    if pipelined:
        sched = serving_pipeline.PipelinedScheduler(wave_size=WAVE,
                                                    device="cpu")
    else:
        sched = serving_scheduler.Scheduler(wave_size=WAVE, device="cpu")
    handles = [sched.submit(SolveRequest(problem, seed=i, max_iters=ITERS))
               for i in range(WAVE * WAVES)]
    sched.drain(120)
    sched.close()
    assert all(h.done() and h.error is None for h in handles)
    return handles


@pytest.fixture(scope="module")
def problem():
    return Problem.get("rastrigin", n=2)


@pytest.fixture
def traced(problem):
    """``serve(pipelined)``: three waves under a CPU profiler session, the
    engine cache cold; returns (handles, snapshot, window on the
    profiler's clock)."""
    def serve(pipelined: bool):
        cache.clear()
        spans.clear()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function(WINDOW):
                handles = _serve(pipelined, problem)
        (win,) = [e for e in prof.profiler.kineto_results.events()
                  if e.name() == WINDOW]
        return handles, spans.snapshot(), (win.start_ns(), win.end_ns())

    yield serve
    spans.clear()


@SCHEDULERS
def test_without_a_profiler_nothing_is_recorded(problem, pipelined):
    spans.clear()
    assert not spans.profiling()
    _serve(pipelined, problem)
    snap = spans.snapshot()
    assert snap == {"spans": {}, "counters": {}, "records": [],
                    "dropped": 0}


@SCHEDULERS
def test_three_waves_yield_the_span_tree(traced, pipelined):
    handles, snap, _ = traced(pipelined)
    recs = snap["records"]
    by_id = {r["id"]: r for r in recs}
    assert snap["dropped"] == 0 and len(by_id) == len(recs)
    waves = set(range(1, WAVES + 1))
    assert {r["wave"] for r in recs} == waves

    def named(name):
        return [r for r in recs if r["name"] == name]

    # one queue wait a request, each in the wave that popped it
    waits = named("serving.queue_wait")
    assert sorted(r["request"] for r in waits) == sorted(
        h.seq for h in handles)
    for w in waves:
        assert sum(r["wave"] == w for r in waits) == WAVE
    for name in ("serving.submit", "engine.starts", "engine.loop",
                 "engine.fetch", "serving.finalize"):
        assert sorted(r["wave"] for r in named(name)) == sorted(waves), name
    # the engine cache was cold: one build and one binding, in wave 1
    assert [r["wave"] for r in named("engine.build")] == [1]
    assert [r["wave"] for r in named("popstep.bind")] == [1]
    assert named("engine.stall_read")
    roots = {"serving.queue_wait", "serving.submit", "serving.finalize"}
    parent_of = {"engine.starts": "serving.submit",
                 "engine.build": "serving.submit",
                 "engine.stall_read": "engine.loop",
                 "engine.fetch": "engine.loop",
                 "popstep.bind": "engine.loop",
                 # the synchronous scheduler runs the loop in its submit
                 "engine.loop": None if pipelined else "serving.submit"}
    for r in recs:
        if r["request"] is None:
            assert r["name"] != "serving.queue_wait"
        if r["name"] in roots or parent_of[r["name"]] is None:
            assert r["parent"] is None, r
            continue
        parent = by_id[r["parent"]]
        assert parent["name"] == parent_of[r["name"]], r
        assert parent["wave"] == r["wave"] and parent["thread"] == r["thread"]
        assert parent["start_ns"] <= r["start_ns"] <= r["end_ns"] \
            <= parent["end_ns"]
    # the wave thread and the dispatch worker record their own spans
    thread_of = {r["name"]: r["thread_name"] for r in recs}
    assert thread_of["serving.submit"] == "MainThread"
    if pipelined:
        assert thread_of["engine.loop"] == "dgo-wave"
        assert thread_of["serving.finalize"] == "dgo-dispatch-worker"
    assert snap["counters"]["engine.steps"] >= WAVES
    assert 0 < snap["counters"]["engine.slot_steps"] <= (
        WAVE * snap["counters"]["engine.steps"])
    assert snap["counters"]["engine.slot_steps"] == sum(
        h.result().iterations for h in handles)


def test_self_time_is_duration_less_the_children(traced):
    _, snap, _ = traced(True)
    recs = snap["records"]
    child_ns = {}
    for r in recs:
        if r["parent"] is not None:
            child_ns[r["parent"]] = (child_ns.get(r["parent"], 0)
                                     + r["end_ns"] - r["start_ns"])
    for name, agg in snap["spans"].items():
        mine = [r for r in recs if r["name"] == name]
        total = sum(r["end_ns"] - r["start_ns"] for r in mine)
        own = total - sum(child_ns.get(r["id"], 0) for r in mine)
        assert agg["count"] == len(mine)
        assert agg["total_s"] == pytest.approx(total / 1e9, abs=1e-12)
        assert agg["self_s"] == pytest.approx(own / 1e9, abs=1e-12)
    sub = snap["spans"]["serving.submit"]
    assert 0 < sub["self_s"] < sub["total_s"]


@SCHEDULERS
def test_spans_lie_inside_the_window_on_the_profilers_clock(traced,
                                                            pipelined):
    _, snap, (w0, w1) = traced(pipelined)
    assert snap["records"]
    for r in snap["records"]:
        assert w0 <= r["start_ns"] <= r["end_ns"] <= w1, r


def test_export_chrome_writes_one_view(traced, tmp_path):
    _, snap, _ = traced(True)
    alone = tmp_path / "spans.json"
    assert spans.export_chrome(alone) == len(snap["records"])
    doc = json.loads(alone.read_text())
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert len(xs) == len(snap["records"])
    assert doc["baseTimeNanoseconds"] == 0
    first = min(r["start_ns"] for r in snap["records"])
    assert min(e["ts"] for e in xs) == pytest.approx(first / 1e3)
    # a track for each thread, and lanes for the queue waits
    names = {e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M"}
    assert {"MainThread", "dgo-wave", "dgo-dispatch-worker",
            "queue waits 0"} <= names
    # into the profiler's own trace, on its time base
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(4).sum()
    both = tmp_path / "trace.json"
    prof.export_chrome_trace(str(both))
    before = len(json.loads(both.read_text())["traceEvents"])
    spans.export_chrome(both)
    doc = json.loads(both.read_text())
    base = doc["baseTimeNanoseconds"]
    mine = [e for e in doc["traceEvents"]
            if e.get("cat") == "repro_torch.spans"]
    assert len(doc["traceEvents"]) >= before + len(mine)
    assert len(mine) == len(snap["records"])
    assert min(e["ts"] for e in mine) == pytest.approx((first - base) / 1e3)


def test_perf_counter_readings_convert_to_the_profilers_clock():
    import time

    t = time.perf_counter()
    assert abs(spans.from_perf(t) - time.time_ns()) < 5e6
    assert spans.now() <= time.time_ns()


def test_serve_trace_writes_the_profile_with_the_spans(tmp_path):
    from repro_torch.launch import serve

    def args(*argv):
        return serve.build_parser().parse_args(
            ["--dgo", "--problem", "rastrigin", "--n-vars", "2",
             "--restarts", "4", "--max-iters", "8", *argv])

    out = tmp_path / "trace"
    rep = serve.serve_dgo(args("--waves", "2", "--trace", str(out)),
                          device="cpu")
    assert rep["completed"] == 8 and rep["failed"] == 0
    doc = json.loads((out / "trace.json").read_text())
    mine = {e["name"] for e in doc["traceEvents"]
            if e.get("cat") == "repro_torch.spans"}
    assert {"serving.queue_wait", "serving.submit", "engine.starts",
            "engine.loop", "engine.fetch", "serving.finalize"} <= mine
    # the profiler's own host records share the file
    assert any(e.get("ph") == "X" and e.get("cat") != "repro_torch.spans"
               for e in doc["traceEvents"])
    snap = json.loads((out / "spans.json").read_text())
    assert snap["spans"]["serving.submit"]["count"] == 2
    assert snap["spans"]["serving.queue_wait"]["count"] == 8
    spans.clear()
    with pytest.raises(SystemExit, match="not a sweep"):
        serve.serve_dgo(args("--sweep-rps", "100", "--trace", str(out)),
                        device="cpu")
