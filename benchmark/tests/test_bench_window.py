"""The end-to-end readers over synthetic windows: a stall moves both the
rate and the tail."""

import pytest

from benchmark import harness


def _window(latencies):
    w = harness.Window()
    w.latencies_s = list(latencies)
    w.frames = len(latencies)
    w.wall_s = sum(latencies)
    return w


def _read(name, w):
    return harness.reader(name)(w)


@pytest.mark.parametrize("stall_s", [0.1, 0.5])
def test_stall_moves_rate_and_tail(stall_s):
    steady = [0.04] * 200
    stalled = list(steady)
    for k in range(0, 200, 15):          # a stall every 15th frame (7%)
        stalled[k] += stall_s
    a, b = _window(steady), _window(stalled)
    assert _read("frames_per_s", a) == pytest.approx(25.0)
    assert _read("frames_per_s", b) < _read("frames_per_s", a)
    assert _read("frame_ms_p95", a) == pytest.approx(40.0)
    assert _read("frame_ms_p95", b) > 40.0 + 0.5e3 * stall_s


def test_per_layer_tail_leaves_out_the_traced_frames():
    w = _window([0.5] * 20 + [0.04] * 200)
    w.traced = (0, 20)
    assert _read("frame_ms_p95", w) == pytest.approx(500.0)
    for cell in ("default.movers3", "room4_accel.movers3", "default.static"):
        assert _read(f"frame_ms_p95.{cell}", w) == pytest.approx(40.0)


def test_rate_counts_all_time():
    w = _window([0.05] * 100)
    w.wall_s += 1.0                      # time outside the frames counts
    assert _read("frames_per_s", w) == pytest.approx(100 / 6.0)


def test_phase_readers():
    w = harness.Window()
    w.phase_frames = 10
    w.phases = {"preprocess": (10.0, 10), "estep_pre": (20.0, 9),
                "estep_mid": (20.0, 9), "estep_post": (20.0, 9),
                "masks": (300.0, 3), "raycast": (30.0, 9),
                "summary": (3.0, 9)}
    assert _read("preprocess_ms", w) == pytest.approx(1.0)
    assert _read("estep_ms", w) == pytest.approx(6.0)
    assert _read("masks_ms", w) == pytest.approx(100.0)
    assert _read("raycast_ms", w) == pytest.approx(3.3)
    assert _read("track_objects_ms", w) is None      # nothing to read
    assert _read("lm_device_ms", w) is None
    assert _read("device_idle", w) is None
    assert _read("fusion_roofline", w) is None
    w.k1 = [(1e-4, 4e-4), (1e-4, 6e-4)]
    assert _read("fusion_roofline", w) == pytest.approx(20.0)


def test_trace_intervals():
    from benchmark import trace
    ev = [dict(name="a", ts=0.0, dur=10.0), dict(name="b", ts=5.0, dur=10.0),
          dict(name="a", ts=30.0, dur=5.0)]
    assert trace.union(ev) == [(0.0, 15.0), (30.0, 35.0)]
    assert trace.busy_seconds(ev) == pytest.approx(20e-6)
    notes = [dict(name="raycast", ts=14.0, dur=20.0)]
    assert trace.idle_gaps(ev, notes) == [["raycast", pytest.approx(15e-6)]]
    assert trace.top_ops(ev)[0] == ["a", pytest.approx(15e-6)]
    assert trace.kernel_seconds(ev, ("b",)) == pytest.approx(10e-6)
