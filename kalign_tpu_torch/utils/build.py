"""Build-at-first-use for the package's shared libraries.

Each library is compiled from the sources in the checkout into
``kalign_tpu_torch/_build/<name>-<hash>.so``, where the hash covers the
sources and the compiler flags, so a stale build is never loaded.  The
build runs under an exclusive ``fcntl`` lock and the finished library
is renamed into place atomically: several processes that import the
package at once (test workers, for one) build it once and never load a
half-written file.  Every source compiles in its own process, all
started together.
"""

import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Callable, List, Sequence

BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")


def _digest(paths: Sequence[str], flags: Sequence[str]) -> str:
    h = hashlib.sha256()
    for p in paths:
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as fh:
            h.update(fh.read())
    h.update("\0".join(flags).encode())
    return h.hexdigest()[:16]


def build_library(name: str, sources: Sequence[str],
                  depends: Sequence[str],
                  compile_cmd: Callable[[str, str], List[str]],
                  link_cmd: Callable[[List[str], str], List[str]],
                  flags: Sequence[str]) -> str:
    """Return the path of the built library, compiling it if needed.

    compile_cmd(src, obj) and link_cmd(objs, out) give the commands;
    depends are headers whose content also keys the build.  The
    compiler's messages are kept beside the library as ``.log``.
    Raises RuntimeError with the compiler output when a step fails."""
    key = _digest(list(sources) + list(depends), flags)
    path = os.path.join(BUILD_DIR, f"{name}-{key}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f"{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):
            return path
        work = tempfile.mkdtemp(prefix=f".{name}-", dir=BUILD_DIR)
        try:
            objs = [os.path.join(work, os.path.basename(s) + ".o")
                    for s in sources]
            procs = [subprocess.Popen(compile_cmd(s, o),
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                     for s, o in zip(sources, objs)]
            log = []
            failed = []
            for src, proc in zip(sources, procs):
                out, _ = proc.communicate()
                log.append(f"== {os.path.basename(src)}\n{out}")
                if proc.returncode != 0:
                    failed.append(src)
            if failed:
                raise RuntimeError(f"building {name} failed:\n"
                                   + "\n".join(log))
            tmp_lib = os.path.join(work, os.path.basename(path))
            res = subprocess.run(link_cmd(objs, tmp_lib),
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
            log.append(f"== link\n{res.stdout}")
            if res.returncode != 0:
                raise RuntimeError(f"linking {name} failed:\n"
                                   + "\n".join(log))
            with open(path[:-3] + ".log", "w") as fh:
                fh.write("\n".join(log))
            os.replace(tmp_lib, path)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    return path


def build_log(path: str) -> str:
    """Compiler messages of a library built by build_library."""
    with open(path[:-3] + ".log") as fh:
        return fh.read()
