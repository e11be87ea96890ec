"""ctypes binding for the native guide-tree library (libkt_tree.so).

The library is built from ``native/src`` at first use (g++ with the
reference's float contract: no FMA contraction) into the package's
``_build`` directory; see utils/build.py for the locking.
"""

import ctypes
import os
from functools import lru_cache

import numpy as np

from kalign_tpu_torch.utils.build import build_library

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
SOURCES = [os.path.join(_SRC, f) for f in ("kt_tree.cpp", "kt_distance.cpp")]
HEADERS = [os.path.join(_SRC, "kt_api.h")]
CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-ffp-contract=off"]

_i8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")


def library_path() -> str:
    cxx = os.environ.get("CXX", "g++")
    return build_library(
        "libkt_tree", SOURCES, HEADERS,
        compile_cmd=lambda src, obj: [cxx, *CXXFLAGS, "-c", "-o", obj, src],
        link_cmd=lambda objs, out: [cxx, "-shared", "-o", out,
                                    *objs],
        flags=[cxx, *CXXFLAGS])


@lru_cache(maxsize=1)
def lib() -> ctypes.CDLL:
    L = ctypes.CDLL(library_path())
    L.kt_build_tree.restype = ctypes.c_int32
    L.kt_build_tree.argtypes = [
        _i8p, _i64p, _i32p, ctypes.c_int32, _f32p, ctypes.c_int32,
        _i32p, _f32p,
    ]
    return L


def flatten_seqs(codes_list):
    """Pack a list of uint8 arrays into (flat, offsets, lens)."""
    lens = np.array([len(c) for c in codes_list], dtype=np.int32)
    offsets = np.zeros(len(codes_list), dtype=np.int64)
    if len(lens) > 1:
        offsets[1:] = np.cumsum(lens[:-1], dtype=np.int64)
    flat = (np.concatenate([np.asarray(c, np.uint8) for c in codes_list])
            if codes_list else np.zeros(0, np.uint8))
    return np.ascontiguousarray(flat), offsets, lens


def build_tree(codes, dm: np.ndarray, n_anchors: int):
    """Guide tree of encoded sequences from their [N, stride] anchor
    distances: (tasks [N-1, 3] int32 in pre-order, seq_dist [N] f32)."""
    flat, off, lens = flatten_seqs(codes)
    n = len(codes)
    tasks = np.zeros(3 * (n - 1), dtype=np.int32)
    seq_dist = np.zeros(n, dtype=np.float32)
    cnt = lib().kt_build_tree(flat, off, lens, n,
                              np.ascontiguousarray(dm, np.float32).reshape(-1),
                              n_anchors, tasks, seq_dist)
    if cnt != n - 1:
        raise RuntimeError(f"kt_build_tree returned {cnt} tasks for {n} "
                           "sequences")
    return tasks.reshape(-1, 3), seq_dist
