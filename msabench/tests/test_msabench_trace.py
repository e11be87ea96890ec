"""What a trace says: device work as a union over streams, idle gaps by
host range, and the reading of Kineto's events."""

import pytest

from msabench import tracing

MS = 1_000_000  # ns


def synthetic():
    # stream 7: [0, 4) and [10, 12) ms; stream 9 overlaps: [2, 6) ms
    work = [(0, 4 * MS, "k_a", 7), (2 * MS, 6 * MS, "k_b", 9),
            (10 * MS, 12 * MS, "k_a", 7)]
    ranges = [(0, 20 * MS, "msabench.align"),
              (5 * MS, 9 * MS, "layer.tree"),
              (6 * MS, 8 * MS, "progressive.bonus"),
              (12 * MS, 20 * MS, "layer.progressive")]
    return tracing.Trace(work, ranges, (0, 20 * MS))


def test_busy_is_the_union_over_streams():
    t = synthetic()
    assert t.busy() == [[0, 6 * MS], [10 * MS, 12 * MS]]
    assert t.busy_s() == pytest.approx(0.008)
    assert t.window_s() == pytest.approx(0.020)
    assert t.kernel_s("k_a") == pytest.approx(0.006)


def test_gaps_and_what_the_host_was_doing():
    t = synthetic()
    assert t.gaps() == [(6 * MS, 10 * MS), (12 * MS, 20 * MS)]
    # the gap [6, 10) ms: its middle (8 ms) lies in layer.tree only (the
    # bonus range closes at 8 ms); [12, 20) ms under layer.progressive
    assert t.idle_gaps() == [["layer.progressive", pytest.approx(0.008)],
                             ["layer.tree", pytest.approx(0.004)]]
    assert t.device_ops() == [["k_a", pytest.approx(0.006)],
                              ["k_b", pytest.approx(0.004)]]


class Event:
    def __init__(self, name, cuda, start, dur, stream=0, thread=1):
        self._n, self._c, self._s, self._d = name, cuda, start, dur
        self._st, self._th = stream, thread

    def name(self):
        return self._n

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self._c else DeviceType.CPU

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_resource_id(self):
        return self._st

    def start_thread_id(self):
        return self._th


def test_kineto_events_are_read_by_name():
    events = [Event(tracing.WINDOW, False, 0, 100),
              Event("layer.tree", False, 10, 30),
              Event("layer.tree", True, 12, 25),        # drawn over kernels
              Event("aten::add", False, 11, 2),
              Event("gotoh_row_wave_kernel", True, 15, 10, stream=3),
              Event("Memcpy DtoH (Device -> Pageable)", True, 30, 5, 4),
              Event("progressive.merge", False, 50, 5, thread=2)]
    t = tracing.Trace.of_events(events)
    assert t.window == (0, 100)
    assert [w[2] for w in t.work] == ["gotoh_row_wave_kernel",
                                      "Memcpy DtoH (Device -> Pageable)"]
    assert t.ranges == [(10, 40, "layer.tree")]
    assert t.busy_s() == pytest.approx(15e-9)
