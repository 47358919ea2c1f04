"""The arithmetic of the metrics on synthetic data: the union of device
intervals behind the idle share, the idle gaps named by the host's ops,
the 90th percentile over every batch and the rate over the whole
window."""
import pytest

from benchmarks import measure


def trace(device, host=(), window=(1000.0, 2000.0)):
    ev = [{"name": measure.WINDOW_MARK, "cat": "user_annotation",
           "ts": window[0], "dur": window[1] - window[0]}]
    ev += [{"name": n, "cat": "kernel", "ts": s, "dur": d}
           for n, s, d in device]
    ev += [{"name": n, "cat": "cpu_op", "ts": s, "dur": d}
           for n, s, d in host]
    ev.append({"name": "gone", "cat": "kernel", "ts": 2500.0, "dur": 10.0})
    return measure.TraceSummary(ev)


def test_busy_is_the_union_of_overlapping_operations():
    s = trace([("a", 1000, 100), ("b", 1050, 100), ("c", 1500, 100),
               ("d", 1990, 50)])
    # a and b overlap (1000..1150), c alone, d clipped to the window
    assert s.busy_s == pytest.approx((150 + 100 + 10) * 1e-6)
    assert s.window_s == pytest.approx(1000e-6)
    assert s.top_ops(2)[0] == ["a", pytest.approx(100e-6)]


def test_idle_gaps_are_named_by_the_innermost_host_op():
    s = trace([("a", 1000, 100), ("c", 1500, 100)],
              host=[("outer", 1100, 900), ("inner", 1200, 200)])
    gaps = s.idle_gaps(3)
    assert gaps[0] == ["outer", pytest.approx(400e-6)]     # 1600..2000
    assert gaps[1] == ["inner", pytest.approx(400e-6)]     # 1100..1500
    assert s.kernel_seconds("c") == [pytest.approx(100e-6)]


def test_percentile_is_over_every_batch():
    lat = list(range(1, 101))
    assert measure.percentile(lat, 90) == pytest.approx(90.1)
    assert measure.percentile([5.0] * 9 + [500.0], 90) == pytest.approx(
        54.5)


def test_rate_is_over_the_whole_window():
    assert measure.rate(16 * 90, 40.0) == 36.0
    assert measure.union_length([(0, 1), (0.5, 2), (3, 4)]) == 3
