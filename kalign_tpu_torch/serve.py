"""Persistent alignment server: one warm process serving many CLI
invocations (counterpart of kalign_tpu/serve.py).

Why: a one-shot ``python -m kalign_tpu_torch.cli`` pays, before it
aligns anything, the torch import, the CUDA context, the loading of the
package's CUDA and native libraries (built once per machine and source
hash, utils/build.py) and each kernel's first launch.  Within one process
every later alignment is warm.  A deployment that aligns many families
one after another keeps one resident process and streams the work
through it; this module is that process.

Protocol (newline-delimited JSON over a unix socket):
  request : {"argv": [...CLI args...], "cwd": "/client/cwd"}
  response: {"rc": int, "error": str|null, "wall_s": float}
The server runs the CLI entry point in-process, so every engine, flag and
output path behaves exactly as the one-shot CLI.  Requests are
serialized (one aligner at a time) and each runs with the process cwd
switched to the client's cwd, so relative -i/-o paths resolve as they
would in a one-shot invocation.  A request that fails is answered with
rc != 0 and its error (its traceback goes to the server's stderr), and
the server goes on serving.  The warmup before the socket opens
(warmup.py) is not caught: when it fails, the server does not start.

Usage:
  python -m kalign_tpu_torch.serve --socket /tmp/kalign.sock   # server
  python -m kalign_tpu_torch.cli --server=/tmp/kalign.sock -i in.fa -o out.afa
"""

import argparse
import json
import os
import socket
import socketserver
import sys
import threading
import time
import traceback

DEFAULT_SOCKET = "/tmp/kalign_tpu_torch.sock"

# One request at a time: the engines hold process-wide state (the native
# DP hooks, the launch counters), and the per-request chdir to the
# client's cwd is process-global.
_RUN_LOCK = threading.Lock()


def _handle_line(line: str) -> dict:
    try:
        req = json.loads(line)
        argv = req["argv"]
        cwd = req.get("cwd")
    except (ValueError, KeyError, TypeError) as e:
        return {"rc": 2, "error": f"bad request: {e}", "wall_s": 0.0}
    from kalign_tpu_torch import cli
    t0 = time.perf_counter()
    with _RUN_LOCK:
        prev_cwd = os.getcwd()
        try:
            if cwd:
                os.chdir(cwd)
            rc = cli.main(argv)
            return {"rc": int(rc), "error": None,
                    "wall_s": round(time.perf_counter() - t0, 3)}
        except SystemExit as e:
            if e.code is None or isinstance(e.code, int):
                rc, err = int(e.code or 0), None
            else:
                rc, err = 1, str(e.code)
            return {"rc": rc, "error": err,
                    "wall_s": round(time.perf_counter() - t0, 3)}
        except Exception as e:
            # the server's boundary: report the failure and keep serving
            traceback.print_exc(file=sys.stderr)
            return {"rc": 1, "error": f"{type(e).__name__}: {e}",
                    "wall_s": round(time.perf_counter() - t0, 3)}
        finally:
            os.chdir(prev_cwd)


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        for raw in self.rfile:
            line = raw.decode().strip()
            if not line:
                continue
            if line == '{"cmd": "shutdown"}':
                self.wfile.write(b'{"rc": 0, "error": null}\n')
                self.wfile.flush()
                # a threading server: shutdown must come from another
                # thread, or it waits for this one
                threading.Thread(target=self.server.shutdown,
                                 daemon=True).start()
                return
            resp = _handle_line(line)
            self.wfile.write((json.dumps(resp) + "\n").encode())
            self.wfile.flush()


def serve(sock_path: str = DEFAULT_SOCKET, warmup: bool = True,
          ready_cb=None) -> None:
    """Serve on sock_path until a shutdown request; with warmup, first
    warmup.warmup(engines=("gpu-fast",), sizes=[(16, 120)]) on the card,
    whose failure raises before the socket opens.  ready_cb() runs once
    the socket listens."""
    if os.path.exists(sock_path):
        os.unlink(sock_path)
    if warmup:
        from kalign_tpu_torch.warmup import warmup as do_warmup
        do_warmup(engines=("gpu-fast",), sizes=[(16, 120)], quiet=True)
    srv = socketserver.ThreadingUnixStreamServer(sock_path, _Handler)
    print(f"kalign_tpu_torch server listening on {sock_path}",
          file=sys.stderr)
    try:
        if ready_cb is not None:
            ready_cb()
        srv.serve_forever()
    finally:
        srv.server_close()
        if os.path.exists(sock_path):
            os.unlink(sock_path)


def request(sock_path: str, argv) -> dict:
    """Client side: send one CLI invocation to a running server."""
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.connect(sock_path)
        s.sendall((json.dumps({"argv": list(argv),
                               "cwd": os.getcwd()}) + "\n").encode())
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
    return json.loads(buf.decode())


def shutdown(sock_path: str) -> None:
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.connect(sock_path)
        s.sendall(b'{"cmd": "shutdown"}\n')
        s.recv(4096)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="persistent warm kalign_tpu_torch alignment server")
    ap.add_argument("--socket", default=DEFAULT_SOCKET)
    ap.add_argument("--no-warmup", action="store_true")
    args = ap.parse_args(argv)
    serve(args.socket, warmup=not args.no_warmup)
    return 0


if __name__ == "__main__":
    sys.exit(main())
