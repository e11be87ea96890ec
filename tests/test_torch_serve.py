"""The warm alignment server of kalign_tpu_torch (serve.py) and its warmup
(warmup.py), the counterparts of tests/test_serve.py: a real unix-socket
server process answers CLI invocations in-process (--device cpu) with
the one-shot CLI's bytes, resolves relative paths against the client's
cwd, reports errors with kalign_tpu.serve's response keys; the CLI's
--server flags are stripped; --server-start spawns only when needed;
warmup runs on the CPU and raises on a failure, and a failed warmup
stops the server."""

import json
import os
import socket as socklib
import subprocess
import sys
import time

import pytest

from kalign_tpu import serve as jserve
from kalign_tpu_torch import cli as tcli
from kalign_tpu_torch import engine as tE
from kalign_tpu_torch import serve as tserve
from kalign_tpu_torch import warmup as W

from conftest import DATA

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SERVER = ("import sys\n"
           "from kalign_tpu_torch.serve import serve\n"
           "serve(sys.argv[1], warmup=False)\n")


@pytest.fixture
def server(tmp_path):
    """A server process (no warmup) in a directory of its own; yields
    its socket path, then shuts it down."""
    sock = str(tmp_path / "k.sock")
    os.makedirs(tmp_path / "srv")
    proc = subprocess.Popen([sys.executable, "-c", _SERVER, sock],
                            cwd=tmp_path / "srv",
                            env=dict(os.environ, PYTHONPATH=ROOT),
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    try:
        t0 = time.time()
        while not os.path.exists(sock):
            assert proc.poll() is None, "the server exited"
            assert time.time() - t0 < 120, "the socket never appeared"
            time.sleep(0.1)
        yield sock
        tserve.shutdown(sock)
        proc.wait(timeout=60)
        assert proc.poll() is not None and not os.path.exists(sock)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_roundtrip_matches_the_one_shot_cli(server, tmp_path, monkeypatch):
    inp = os.path.join(DATA, "BB11001.tfa")
    one = str(tmp_path / "cli.afa")
    assert tcli.main(["-i", inp, "-o", one, "-q", "--device", "cpu"]) == 0
    want = open(one).read()
    for k in range(2):  # the second request reuses the warm process
        out = str(tmp_path / f"srv{k}.afa")
        resp = tserve.request(server, ["-i", inp, "-o", out, "-q",
                                       "--device", "cpu"])
        assert resp["rc"] == 0 and resp["error"] is None, resp
        assert resp["wall_s"] >= 0.0
        assert open(out).read() == want
    # the CLI's front end (an explicit socket is =-form only)
    out = str(tmp_path / "front.afa")
    assert tcli.main([f"--server={server}", "-i", inp, "-o", out, "-q",
                      "--device", "cpu"]) == 0
    assert open(out).read() == want
    # relative paths resolve against the client's cwd, not the server's
    os.makedirs(tmp_path / "sub")
    monkeypatch.chdir(tmp_path / "sub")
    assert tcli.main([f"--server={server}", "-i", inp, "-o", "rel.afa",
                      "-q", "--device", "cpu"]) == 0
    assert open(tmp_path / "sub" / "rel.afa").read() == want


def test_errors_are_reported_and_the_server_answers_on(server, tmp_path):
    resp = tserve.request(server, ["-i", "/nonexistent/xx.fa", "-o",
                                   str(tmp_path / "y.afa"), "-q",
                                   "--device", "cpu"])
    assert resp["rc"] != 0 and "FileNotFoundError" in resp["error"]
    resp = tserve.request(server, ["--no-such-flag"])
    assert resp["rc"] == 2
    inp = os.path.join(DATA, "tiny.fa")
    resp = tserve.request(server, ["-i", inp, "-o", str(tmp_path / "t.afa"),
                                   "-q", "--device", "cpu"])
    assert resp["rc"] == 0, resp
    with socklib.socket(socklib.AF_UNIX, socklib.SOCK_STREAM) as s:
        s.connect(server)
        s.sendall(b"not json\n")
        bad = json.loads(s.makefile().readline())
    assert bad["rc"] == 2 and bad["error"].startswith("bad request")


def test_response_keys_match_kalign_tpu_serve(tmp_path):
    for line in ("not json", json.dumps({"argv": ["-i", "/nonexistent.fa",
                                                  "-o", "x", "-q"],
                                         "cwd": str(tmp_path)})):
        got, want = tserve._handle_line(line), jserve._handle_line(line)
        assert set(got) == set(want) == {"rc", "error", "wall_s"}
        assert (got["rc"] != 0) == (want["rc"] != 0)


def test_server_flags_are_stripped(monkeypatch):
    """Every --server spelling is stripped from the forwarded argv, the
    alignment flags survive, and a bare --server never takes the next
    token."""
    seen = {}

    def fake_request(sock, argv):
        seen["sock"] = sock
        seen["argv"] = list(argv)
        return {"rc": 0, "error": None}
    monkeypatch.setattr(tserve, "request", fake_request)
    monkeypatch.setattr(tcli, "_ensure_server", lambda s, timeout=900: None)
    for argv, want_sock in [
            (["--server=/tmp/y.sock", "-i", "in.fa", "-o", "o.afa"],
             "/tmp/y.sock"),
            (["-i", "in.fa", "--server-start", "--server=/tmp/z.sock",
              "-o", "o.afa"], "/tmp/z.sock")]:
        assert tcli.main(argv) == 0
        assert seen["sock"] == want_sock
        assert seen["argv"] == ["-i", "in.fa", "-o", "o.afa"], seen["argv"]
    assert tcli.main(["--server", "in.fa", "-o", "o.afa"]) == 0
    assert seen["sock"] == tserve.DEFAULT_SOCKET \
        == "/tmp/kalign_tpu_torch.sock"
    assert seen["argv"] == ["in.fa", "-o", "o.afa"], seen["argv"]


def test_server_start_skips_the_spawn_when_alive(tmp_path, monkeypatch):
    sock = str(tmp_path / "alive.sock")
    srv = socklib.socket(socklib.AF_UNIX, socklib.SOCK_STREAM)
    srv.bind(sock)
    srv.listen(1)
    try:
        def boom(*a, **k):
            raise AssertionError("spawned despite a live socket")
        monkeypatch.setattr(subprocess, "Popen", boom)
        tcli._ensure_server(sock, timeout=5)
    finally:
        srv.close()


def test_server_start_times_out_cleanly(tmp_path, monkeypatch):
    spawned = {}

    class _P:
        def __init__(self, *a, **k):
            spawned["argv"] = a[0]
    monkeypatch.setattr(subprocess, "Popen", _P)
    with pytest.raises(SystemExit):
        tcli._ensure_server(str(tmp_path / "never.sock"), timeout=1)
    assert spawned["argv"][1:3] == ["-m", "kalign_tpu_torch.serve"]


def test_warmup_runs_on_the_cpu(monkeypatch):
    seen = []
    orig = tE.align_msa

    def spy(msa, **kw):
        seen.append((msa.numseq, kw["engine"], kw["consistency_anchors"]))
        return orig(msa, **kw)
    monkeypatch.setattr(tE, "align_msa", spy)
    W.warmup(engines=("gpu-fast", "host"), sizes=[(8, 60), (12, 40)],
             quiet=True, tree_np=(64,), device="cpu")
    assert seen == [(8, "gpu-fast", 0), (12, "gpu-fast", 0),
                    (8, "host", 0), (12, "host", 0)]
    assert W.main(["--engines", "host", "--sizes", "6x50", "--tree-np",
                   "none", "--device", "cpu", "-q"]) == 0


def test_warmup_tree_programs_split_each_bucket(monkeypatch):
    from kalign_tpu_torch.gpu import kmeans
    calls = []
    orig = kmeans.fused_splits

    def spy(emb, n, Np, T, Dmax, Ca, kernel=False, trace=None):
        calls.append((tuple(emb.shape), Dmax, Ca, kernel))
        return orig(emb, n, Np, T, Dmax, Ca, kernel=kernel, trace=trace)
    monkeypatch.setattr(kmeans, "fused_splits", spy)
    W.warmup_tree_programs((64, 128), quiet=True, device="cpu")
    assert calls == [((64, 32), 1, 2, False), ((128, 32), 1, 3, False)]


def test_warmup_raises_on_a_failing_alignment(monkeypatch):
    def fail(msa, **kw):
        raise RuntimeError("launch failed")
    monkeypatch.setattr(tE, "align_msa", fail)
    with pytest.raises(RuntimeError, match="launch failed"):
        W.warmup(engines=("gpu-fast",), sizes=[(8, 60)], quiet=True,
                 tree_np=(), device="cpu")
    with pytest.raises(RuntimeError, match="launch failed"):
        W.main(["--engines", "gpu-fast", "--sizes", "8x60", "--tree-np",
                "none", "--device", "cpu", "-q"])


def test_a_failed_warmup_stops_the_server(tmp_path, monkeypatch):
    def fail(**kw):
        raise RuntimeError("build failed")
    monkeypatch.setattr(W, "warmup", fail)
    sock = str(tmp_path / "w.sock")
    ready = []
    with pytest.raises(RuntimeError, match="build failed"):
        tserve.serve(sock, warmup=True, ready_cb=lambda: ready.append(1))
    assert not ready and not os.path.exists(sock)
