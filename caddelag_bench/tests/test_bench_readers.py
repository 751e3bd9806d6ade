"""The per-layer readers and the trace reader: numbers from readings, nothing where none."""

import pytest

from caddelag_bench import devtrace, harness, yardstick
from caddelag_bench.tests.cases import REPO

METRICS = ["chain_ms", "ingest_ms", "solve_ms", "score_ms", "sequence_self_ms",
           "chain_roofline_share", "score_roofline_share", "device_idle_share"]


def _readings(**kw):
    r = harness.Readings(n=10512, k=17, d=6, on_card=True, transitions=4, push_seconds=1.0,
                         phase_seconds={"chain": 0.94, "ingest": 0.004, "solve": 0.028,
                                        "score": 0.002},
                         phase_calls={"chain": 4, "ingest": 4, "solve": 4, "score": 4},
                         profile={"busy_s": 0.95, "window_s": 1.0})
    for k, v in kw.items():
        setattr(r, k, v)
    return r


@pytest.mark.parametrize("name", METRICS)
def test_reader_reads_nothing_from_nothing(name):
    read = harness.load_reader(REPO, name)
    empty = harness.Readings(n=10512, k=17, d=6, on_card=True)
    assert read(empty) is None


@pytest.mark.parametrize("name", ["chain_roofline_share", "score_roofline_share",
                                  "device_idle_share"])
def test_device_readers_read_nothing_off_the_card(name):
    read = harness.load_reader(REPO, name)
    assert read(_readings(on_card=False, profile=None)) is None


def test_reader_values():
    r = _readings()
    val = {m: harness.load_reader(REPO, m)(r) for m in METRICS}
    assert val["chain_ms"] == pytest.approx(235.0)
    assert val["ingest_ms"] == pytest.approx(1.0)
    assert val["solve_ms"] == pytest.approx(7.0)
    assert val["score_ms"] == pytest.approx(0.5)
    assert val["sequence_self_ms"] == pytest.approx(250.0 - 243.5)
    chain_bound = 11 * 2 * 10512**3 / 495e12
    assert val["chain_roofline_share"] == pytest.approx(100 * chain_bound / 0.235)
    assert 0 < val["chain_roofline_share"] < 100
    assert val["score_roofline_share"] == pytest.approx(
        100 * 4 * (2 * 10512**2 + 2 * 10512 * 17 + 10512) / 3.35e12 / 0.0005)
    assert val["device_idle_share"] == pytest.approx(5.0)


def test_yardstick_counts():
    assert yardstick.chain_flops(10512, 6) == pytest.approx(2.5555e13, rel=1e-3)
    assert yardstick.score_bytes(2, 1) == 4 * (8 + 4 + 2)


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_trace_summary_merges_busy_time_and_names_gaps():
    events = [
        _ev(devtrace.WINDOW, "user_annotation", 0, 1000),
        _ev("bench.push", "user_annotation", 0, 1000),
        _ev("aten::sort", "cpu_op", 100, 200),
        _ev("cudaStreamSynchronize", "cuda_runtime", 700, 250),
        _ev("gemm", "kernel", 0, 100),
        _ev("gemm", "kernel", 50, 100),  # overlaps the first
        _ev("score", "kernel", 400, 300),
        _ev("late", "kernel", 990, 50),  # runs past the window's end
    ]
    got = devtrace.summarize(events)
    assert got["window_s"] == pytest.approx(1e-3)
    assert got["busy_s"] == pytest.approx((150 + 300 + 10) * 1e-6)
    ops = dict(got["device_ops"])
    assert ops["gemm"] == pytest.approx(200e-6) and ops["score"] == pytest.approx(300e-6)
    gaps = dict(got["idle_gaps"])
    assert gaps["aten::sort"] == pytest.approx(250e-6)  # 150..400, midpoint 275
    assert gaps["cudaStreamSynchronize"] == pytest.approx(290e-6)  # 700..990


def test_trace_summary_without_a_window_or_device_ops_is_none():
    assert devtrace.summarize([_ev("gemm", "kernel", 0, 10)]) is None
    assert devtrace.summarize([_ev(devtrace.WINDOW, "user_annotation", 0, 10)]) is None
