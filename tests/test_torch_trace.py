"""Device timing of kalign_tpu_torch (utils/devtime.py) and the CLI's
--trace: device_seconds equals kalign_tpu.utils.devtime.device_seconds on
synthetic Chrome traces (nested and overlapping events, two streams, a
host process, .gz, a file that is not JSON), reads Kineto's labelled
device processes without their annotation spans, and on a CPU run's
trace reads 0.0; busy_seconds takes the union over a card's streams."""

import glob
import gzip
import json
import os

import pytest

from kalign_tpu.utils import devtime as jdev
from kalign_tpu_torch import cli as tcli
from kalign_tpu_torch.utils import devtime as tdev

from conftest import DATA


def _meta(pid, name, labels=None):
    out = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": name}}]
    if labels is not None:
        out.append({"ph": "M", "name": "process_labels", "pid": pid,
                    "tid": 0, "args": {"labels": labels}})
    return out


def _x(pid, tid, ts, dur, **kw):
    return dict(ph="X", pid=pid, tid=tid, ts=ts, dur=dur, name="k", **kw)


def _write(path, events, gz=False):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    data = json.dumps({"traceEvents": events}).encode()
    with (gzip.open if gz else open)(path, "wb") as fh:
        fh.write(data)


# a device process with two streams (nested, overlapping and disjoint
# events), a host process whose events do not count, an event without a
# duration
DEVICE_EVENTS = (_meta(1, "/device:GPU:0") + _meta(2, "python") + [
    _x(1, 7, 0.0, 10.0), _x(1, 7, 2.0, 3.0), _x(1, 7, 8.0, 7.0),
    _x(1, 7, 40.0, 5.5), _x(1, 8, 5.0, 4.0), _x(1, 8, 9.0, 1.0),
    _x(2, 1, 0.0, 1000.0), {"ph": "X", "pid": 1, "tid": 7, "ts": 3.0},
    {"ph": "i", "pid": 1, "tid": 7, "ts": 1.0}])
DEVICE_US = 15.0 + 5.5 + 5.0


@pytest.mark.parametrize("layout", ["one", "gz", "two-files", "nested-dir"])
def test_device_seconds_equals_kalign_tpu(tmp_path, layout):
    d = str(tmp_path / "trace")
    if layout == "one":
        _write(os.path.join(d, "a.pt.trace.json"), DEVICE_EVENTS)
        want = DEVICE_US
    elif layout == "gz":
        _write(os.path.join(d, "a.trace.json.gz"), DEVICE_EVENTS, gz=True)
        want = DEVICE_US
    elif layout == "two-files":
        _write(os.path.join(d, "a.trace.json"), DEVICE_EVENTS)
        _write(os.path.join(d, "b.trace.json.gz"),
               _meta(3, "/device:GPU:1") + [_x(3, 1, 0.0, 2.0)], gz=True)
        with open(os.path.join(d, "c.trace.json"), "w") as fh:
            fh.write("{not json")
        want = DEVICE_US + 2.0
    else:
        _write(os.path.join(d, "plugins", "x", "vm.trace.json.gz"),
               DEVICE_EVENTS, gz=True)
        want = DEVICE_US
    got = tdev.device_seconds(d)
    assert got == jdev.device_seconds(d, device_substr="GPU")
    assert got == pytest.approx(want / 1e6, rel=0, abs=1e-12)
    assert tdev.device_seconds(d, device_substr="TPU") \
        == jdev.device_seconds(d) == 0.0


def test_kineto_labels_and_annotations(tmp_path):
    """Kineto names the device's process as the host's and labels it
    "GPU 0"; a record_function range's span on the device is not work."""
    d = str(tmp_path / "k")
    events = (_meta(118, "python3", "CPU") + _meta(0, "python3", "GPU 0")
              + _meta(1, "python3", "GPU 1") + [
                  _x(0, 7, 0.0, 4.0, cat="kernel"),
                  _x(0, 7, 10.0, 2.0, cat="gpu_memcpy"),
                  _x(0, 7, 0.0, 100.0, cat="gpu_user_annotation"),
                  _x(118, 118, 0.0, 500.0, cat="cpu_op")])
    _write(os.path.join(d, "host_1.123.pt.trace.json"), events)
    assert tdev.device_seconds(d) == pytest.approx(6e-6, rel=0, abs=1e-12)
    assert jdev.device_seconds(d, device_substr="GPU") == 0.0


@pytest.mark.parametrize("quiet", [False, True])
def test_cli_trace_on_the_cpu(tmp_path, capsys, quiet):
    d = tmp_path / "tr"
    out = tmp_path / "o.afa"
    args = ["-i", os.path.join(DATA, "tiny.fa"), "-o", str(out),
            "--device", "cpu", "--trace", str(d)] + ["-q"] * quiet
    assert tcli.main(args) == 0
    err = capsys.readouterr().err
    files = glob.glob(str(d / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    # the program's spans are ranges of the trace
    assert {"layer.align", "layer.input", "layer.distances", "layer.tree",
            "layer.progressive", "layer.output"} <= \
        {e.get("name") for e in events}
    assert tdev.device_seconds(str(d)) == 0.0
    assert (f"device trace written to {d}" in err) != quiet
    plain = tmp_path / "p.afa"
    assert tcli.main(["-i", os.path.join(DATA, "tiny.fa"), "-o", str(plain),
                      "--device", "cpu", "-q"]) == 0
    assert out.read_bytes() == plain.read_bytes()


@pytest.mark.parametrize("pids", [1, 2], ids=["one-card", "two-cards"])
def test_busy_seconds_takes_the_union_over_streams(tmp_path, pids):
    """Two overlapping streams of one card count once in busy_seconds and
    twice in device_seconds; annotations and host events count in
    neither; each device process is a card of its own."""
    d = str(tmp_path / "b")
    events = _meta(118, "python3", "CPU") + [
        _x(118, 118, 0.0, 500.0, cat="cpu_op")]
    for pid in range(pids):
        events += _meta(pid, "python3", f"GPU {pid}") + [
            _x(pid, 7, 0.0, 10.0, cat="kernel"),
            _x(pid, 8, 4.0, 10.0, cat="kernel"),
            _x(pid, 8, 30.0, 2.0, cat="gpu_memcpy"),
            _x(pid, 7, 0.0, 100.0, cat="gpu_user_annotation")]
    _write(os.path.join(d, "host_1.123.pt.trace.json"), events)
    assert tdev.busy_seconds(d) == pytest.approx(pids * 16e-6, rel=0,
                                                 abs=1e-12)
    assert tdev.device_seconds(d) == pytest.approx(pids * 22e-6, rel=0,
                                                   abs=1e-12)
    assert tdev.busy_seconds(d, device_substr="TPU") == 0.0
