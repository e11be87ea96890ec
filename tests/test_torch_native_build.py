"""Build kalign_tpu's native host library once, before any test runs.

``kalign_tpu.native.lib()`` runs ``make`` when ``libkt_host.so`` is
missing.  Under pytest-xdist several workers reach that point at once on
a fresh checkout, and one of them can ``dlopen`` the library while
another is still writing it ("file too short").  Every worker imports
every test module while it collects, and ``--dist loadfile`` starts no
test until all workers have collected, so building here, at import,
under an exclusive lock, makes the first worker build the library and
the others wait and then find it up to date.

The lock is taken on the library's Makefile, opened read-only, so the
repair adds no file to the tree.  The port's own libraries need no such
step: ``kalign_tpu_torch/utils/build.py`` builds under an ``fcntl`` lock
and renames the finished library into place.
"""

import fcntl
import os

from kalign_tpu import native

NATIVE_DIR = os.path.dirname(os.path.abspath(native.__file__))
MAKEFILE = os.path.join(NATIVE_DIR, "Makefile")
LIBRARY = os.path.join(NATIVE_DIR, "libkt_host.so")


def load_under_lock():
    """native.lib(), with the build (if any) under the Makefile's lock."""
    with open(MAKEFILE, "rb") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            return native.lib()
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


load_under_lock()


def test_native_library_loads_without_a_rebuild():
    """The library built at collection loads, and loading it again finds
    it newer than every source (native/__init__.py's mtime check), so
    nothing is rebuilt."""
    before = os.stat(LIBRARY).st_mtime_ns
    src = os.path.join(NATIVE_DIR, "src")
    assert all(os.path.getmtime(os.path.join(src, f))
               <= os.path.getmtime(LIBRARY) for f in os.listdir(src))
    native.lib.cache_clear()
    lib = load_under_lock()
    assert lib.kt_edit_oracle is not None
    assert os.stat(LIBRARY).st_mtime_ns == before
