"""The port's recorder (``utils/timing.py``): off, a call site reads one
flag and nothing else; on, spans nest per thread, a full buffer counts what
it drops, counters and gauges land in the same store, and every pair of a
CPU run of the served path is joined by its ``seq`` from the ingest to its
last publish; the benchmark's readers of it (``stereo_bench/program.py``)."""

import threading

import numpy as np
import pytest
import torch

from ros_gpu_stereo_processor_tpu_torch import StereoPipeline
from ros_gpu_stereo_processor_tpu_torch.config import Outputs
from ros_gpu_stereo_processor_tpu_torch.models.pipeline import FrameResult
from ros_gpu_stereo_processor_tpu_torch.runtime import StreamingIngest
from ros_gpu_stereo_processor_tpu_torch.utils import timing
from ros_gpu_stereo_processor_tpu_torch.utils.calib import euroc_like_model
from ros_gpu_stereo_processor_tpu_torch.utils.msgs import Header
from stereo_bench import program, run, spec

H, W = 80, 160
OUTPUTS = Outputs.of("disparity", "pointcloud")


@pytest.fixture(autouse=True)
def _recorder_off():
    timing.disable()
    yield
    timing.disable()


def _names(snap):
    return [snap.names[k] for k in snap.records["name"]]


def _serve(pipe, ing, pairs: int, batch: int = 4) -> None:
    """A producer thread feeds ``pairs`` pairs; this thread stages them,
    steps them in batches and publishes every pair."""
    rng = np.random.default_rng(5)
    left = rng.integers(0, 255, (H, W), np.uint8)
    right = np.roll(left, -3, axis=1)

    def produce():
        for i in range(pairs):
            ing.feed("left", left, float(i))
            ing.feed("right", right, float(i))

    producer = threading.Thread(target=produce, name="producer")
    producer.start()
    pending = []
    for l, r, _, seq in ing.frames_prefetch(timeout=2.0, depth=3, stacked=True):
        pending.append((l, r, seq))
        if len(pending) == batch:
            out = pipe.process_batch(torch.stack([p[0] for p in pending]),
                                     torch.stack([p[1] for p in pending]), OUTPUTS)
            for b, (_, _, seq) in enumerate(pending):
                res = FrameResult({k: v[b] for k, v in out.items()},
                                  Header(stamp=float(seq), seq=seq))
                pipe.enqueue_send(res, OUTPUTS)
            pending.clear()
    pipe.senders.wait_all()
    producer.join(timeout=30)
    assert not producer.is_alive()


def _node():
    pipe = StereoPipeline(euroc_like_model(W, H), device="cpu")
    ing = StreamingIngest((H, W), capacity=4, drop_on_full=False, device="cpu")
    return pipe, ing


def test_off_records_nothing_and_reads_no_clock(monkeypatch):
    timing.enable(capacity=64)
    timing.disable()
    pipe, ing = _node()

    def no_clock():
        raise AssertionError("the recorder's clock was read while it was off")

    monkeypatch.setattr(timing, "_clock", no_clock)
    monkeypatch.setattr(timing, "_thread_clock", no_clock)
    _serve(pipe, ing, pairs=8)
    with timing.StageTimer().stage("x"):
        pass
    monkeypatch.undo()
    snap = timing.snapshot()
    assert len(snap.records["name"]) == 0 and snap.lost == 0


def test_spans_nest_per_thread_and_a_full_buffer_counts_what_it_drops():
    outer, inner = timing.intern("t.outer"), timing.intern("t.inner")
    mark = timing.intern("t.mark", timing.INSTANT)
    depth = timing.intern("t.depth", timing.GAUGE)
    hits = timing.intern("t.hits", timing.COUNTER)
    tag = timing.intern("t.variant", timing.TAG)
    timing.enable(capacity=6)
    stale = timing.begin(outer)
    timing.enable(capacity=6)
    timing.end(stale)                       # a token of the last recording: ignored
    timing.end(-1)
    a = timing.begin(outer, seq=3, cpu=True)
    b = timing.begin(inner, n=8)

    def other():
        s = timing.begin(inner, seq=9)
        timing.end(s)

    t = threading.Thread(target=other, name="other")
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    timing.instant(mark, seq=3)
    timing.end(b)
    timing.end(a)
    timing.gauge(depth, 5)
    timing.count(hits, tag=tag)
    timing.count(hits, by=2, tag=tag)
    for _ in range(3):                     # past the capacity of 6
        timing.instant(mark)
    snap = timing.snapshot()
    r = snap.records
    names = _names(snap)
    assert snap.lost == 3 and len(names) == 7
    assert snap.threads == ("MainThread", "other")
    main = [k for k in range(len(names)) if r["thread"][k] == 0]
    ko, ki, km = (next(k for k in main if names[k] == n) for n in ("t.outer", "t.inner", "t.mark"))
    assert r["parent"][ko] == -1 and r["parent"][ki] == ko and r["parent"][km] == ki
    assert r["seq"][ko] == 3 and r["n"][ki] == 8 and r["cpu"][ko] >= 0 and r["cpu"][ki] == -1
    assert r["t0"][ko] <= r["t0"][ki] <= r["t0"][km] <= r["t1"][ki] <= r["t1"][ko]
    ko2 = next(k for k in range(len(names)) if r["thread"][k] == 1)
    assert names[ko2] == "t.inner" and r["parent"][ko2] == -1 and r["seq"][ko2] == 9
    kg = names.index("t.depth")
    assert r["n"][kg] == 5 and r["t0"][kg] == r["t1"][kg] and r["parent"][kg] == -1
    assert snap.counters["t.hits[t.variant]"] == 3
    assert list(snap.of("t.inner")) == sorted([ki, ko2])


def test_served_path_joins_every_pair_by_seq():
    pipe, ing = _node()
    timing.enable(capacity=4096)
    _serve(pipe, ing, pairs=16)
    snap = timing.snapshot()
    timing.disable()
    r, names = snap.records, _names(snap)
    assert snap.lost == 0
    assert {"producer", "ingest-uploader", "MainThread"} <= set(snap.threads)
    p = program.pairs(snap)
    assert len(p["pair"]) == 16 and (p["sends"] == 2).all() and (p["publishes"] == 2).all()
    for key in ("pair", "deliver", "enqueue", "landing", "published", "feed_s"):
        assert np.isfinite(p[key]).all(), key
    assert (p["pair"] <= p["deliver"]).all() and (p["deliver"] <= p["enqueue"]).all()
    assert (p["enqueue"] <= p["landing"]).all() and (p["landing"] <= p["published"]).all()
    for child, parent in (("ingest.ring_push", "ingest.feed"), ("publish.wire", "publish.enqueue"),
                          ("publish.copy_start", "publish.enqueue"),
                          ("publish.submit", "publish.enqueue")):
        for k in snap.of(child):
            assert names[r["parent"][k]] == parent and r["seq"][r["parent"][k]] == r["seq"][k]
    assert sorted(r["n"][snap.of("step.batch")]) == [4, 4, 4, 4]
    assert (r["cpu"][snap.of("ingest.feed")] >= 0).all()
    assert (r["cpu"][snap.of("sender.copy_wait")] >= 0).all()
    tags = {snap.names[t] for t in r["tag"][snap.of("sender.publish")]}
    assert tags == {"disparity", "pointcloud"}
    for key in ("ring.pushed", "ring.popped", "pairer.paired"):
        assert snap.counters[key] == 16, key
    assert snap.counters["ring.dropped"] == 0
    assert len(snap.of("ring.depth")) == 16 + 17 and len(snap.of("sender.depth")) == 32


def test_stage_timer_records_its_stage_while_on():
    timer = timing.StageTimer()
    with timer.stage("dense"):
        pass
    timing.enable(capacity=16)
    with timer.stage("dense"):
        with timer.stage("vo"):
            pass
    snap = timing.snapshot()
    assert _names(snap) == ["stage.dense", "stage.vo"]
    assert snap.records["parent"][1] == 0
    assert timer.as_dict()["dense"]["count"] == 2 and "vo(" in timer.timing_line()


def test_gaps_named_by_the_consumer_then_the_uploader(monkeypatch):
    """A gap inside the consumer's step is the step's; inside its wait for
    a staged pair, the uploader's open span; outside both, between spans."""
    ticks = iter(range(1_000_000_000, 10 ** 12, 1_000_000_000))   # one second a read
    monkeypatch.setattr(timing, "_clock", lambda: next(ticks))
    step, wait = timing.intern("step.batch"), timing.intern("ingest.staged_wait")
    stage, pin = timing.intern("upload.stage"), timing.intern("upload.pin_wait")
    timing.enable(capacity=16)
    s = timing.begin(step, n=8)                # t = 1
    timing.end(s)                              # 2
    w = timing.begin(wait)                     # 3

    def uploader():
        k = timing.begin(pin)                  # 4
        timing.end(k)                          # 5
        k = timing.begin(stage)                # 6
        timing.end(k)                          # 7

    t = threading.Thread(target=uploader, name="ingest-uploader")
    t.start()
    t.join(timeout=10)
    timing.end(w)                              # 8
    snap = timing.snapshot()
    gaps = [(1.4, 1.6), (4.4, 4.5), (3.2, 3.4), (8.5, 8.9)]
    got = dict(program.label_gaps(snap, gaps))
    assert got.keys() == {"step.batch", "upload.pin_wait", "ingest.staged_wait", "between_spans"}
    assert got["step.batch"] == pytest.approx(0.2) and got["upload.pin_wait"] == pytest.approx(0.1)
    assert got["between_spans"] == pytest.approx(0.4)
    assert program.label_gaps(snap, []) == [] and program.label_gaps(None, gaps) == []


def _cell():
    return {"name": "euroc-bm.replay-b8", "config": "euroc-bm", "traffic": "replay-b8",
            "chips": 1,
            "config_data": dict(spec.load_json("configs", "euroc-bm"), check={"sample_pairs": 4}),
            "traffic_data": dict(spec.load_json("traffic", "replay-b8"), pool_pairs=8,
                                 warmup_s=0.3)}


@pytest.mark.parametrize("traced", [False, True])
def test_run_reads_the_recorder_only_where_asked(traced):
    """A run inside ``program.recording()`` carries the recorder's snapshot
    and gives the five per-layer numbers; a plain run leaves the recorder
    off and reports the end-to-end keys it always has."""
    if not traced:
        timing.enable(capacity=64)
        timing.disable()
        out = run.execute(_cell(), 2**33 + 1, 2.0, False, torch.device("cpu"), shape=(H, W))
        assert not timing.ON and len(timing.snapshot().records["name"]) == 0
        assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
        assert set(out["metrics"]) == {"pairs_per_s", "latency_ms_p95", "setup_s"}
        return
    with program.recording() as runs:
        out = run.execute(_cell(), 2**33 + 1, 2.0, True, torch.device("cpu"), shape=(H, W))
    assert out["correct"] and not timing.ON and len(runs) == 1
    got = program.metrics(runs[0])
    assert set(got) == set(program.METRICS)
    assert all(np.isfinite(v) and v >= 0 for v in got.values()), got
    chains = program.chains(runs[0])
    assert chains["published"] >= 8 and chains["whole"] == chains["published"], chains
    assert program.metrics(type("Plain", (), {})()) == {}

