"""ctypes binding for the native runtime (libkt_native.so).

The library is the Kalign 3 compute core in C++ (native/src, copied from
the reference runtime): anchor distances, the guide tree (and realign's
tree from alignment identities), the progressive alignment with
consistency and refinement (``kt_align_msa``), and the ensemble's POAR
consensus columns (``kt_consensus_columns``); whose Hirschberg DPs go through process-wide hooks
when an external backend is installed (gpu/exact.py drives them).  It is
built from ``native/src`` at first use (g++ with the reference's float
contract: no FMA contraction; no OpenMP, whose runtime the machine with
the card lacks) into the package's ``_build`` directory; see
utils/build.py for the locking.
"""

import ctypes
import os
import time
from functools import lru_cache

import numpy as np

from kalign_tpu_torch.utils.build import build_library
from kalign_tpu_torch.utils.logging import add as add_span
from kalign_tpu_torch.utils.logging import span

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
SOURCES = [os.path.join(_SRC, f) for f in
           ("kt_tree.cpp", "kt_distance.cpp", "kt_gotoh.cpp",
            "kt_profile.cpp", "kt_align.cpp", "kt_single.cpp",
            "kt_consensus.cpp")]
HEADERS = [os.path.join(_SRC, f) for f in ("kt_api.h", "kt_gotoh.h")]
CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-ffp-contract=off"]

_i8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
_vp = ctypes.c_void_p
_i32 = ctypes.c_int32
_f = ctypes.c_float


def library_path() -> str:
    cxx = os.environ.get("CXX", "g++")
    return build_library(
        "libkt_native", SOURCES, HEADERS,
        compile_cmd=lambda src, obj: [cxx, *CXXFLAGS, "-c", "-o", obj, src],
        link_cmd=lambda objs, out: [cxx, "-shared", "-o", out,
                                    *objs],
        flags=[cxx, *CXXFLAGS])


@lru_cache(maxsize=1)
def lib() -> ctypes.CDLL:
    L = ctypes.CDLL(library_path())
    L.kt_build_tree.restype = _i32
    L.kt_build_tree.argtypes = [
        _i8p, _i64p, _i32p, _i32, _f32p, _i32,
        _vp, _vp, _vp,                          # shape, members, leaf_dm
        _i32p, _f32p, _f64p,
    ]
    L.kt_tree_leaf_sets.restype = _i32
    L.kt_tree_leaf_sets.argtypes = [_f32p, _i32, _i32, _i32p, _i32p, _f64p]
    L.kt_leaf_distances.restype = None
    L.kt_leaf_distances.argtypes = [_i8p, _i64p, _i32p, _i32p, _i32, _f32p]
    L.kt_build_tree_pairwise.restype = _i32
    L.kt_build_tree_pairwise.argtypes = [_f32p, _i32, _i32p, _f32p]
    L.kt_aln_pairwise_dist.restype = None
    L.kt_aln_pairwise_dist.argtypes = [_i8p, _i32, _i32, _f32p]
    L.kt_consensus_columns.restype = _i32
    L.kt_consensus_columns.argtypes = [
        _i32p, _i32, _i64p, _i64p, _i32p, ctypes.c_int64, _i32p,
    ]
    L.kt_dist_to_anchors.restype = None
    L.kt_dist_to_anchors.argtypes = [
        _i8p, _i64p, _i32p, _i32, _i32p, _i32, _f32p, _i32,
    ]
    L.kt_align_msa.restype = _i32
    L.kt_align_msa.argtypes = [
        _i8p, _i64p, _i32p, _i32,                       # seqs
        _i32p, _i32,                                    # tasks
        _f32p, _f, _f, _f,                              # subm, gpo/gpe/tgpe
        _f, _f, _f,                                     # dist_scale, vsm, weights
        _vp,                                            # seq_distances (or None)
        _vp,                                            # cons_seq_distances
        _i32, _f,                                       # consistency
        _i32, _i32,                                     # refine, adaptive
        _i32p, _f32p, _i32,                             # gaps_out, conf_out, threads
    ]
    # the single-merge oracle of the device DP (kt_single.cpp)
    L.kt_run_align_single.restype = _i32
    L.kt_run_align_single.argtypes = [
        _i32,                                           # mode
        _vp, _vp,                                       # seq1, seq2
        _vp, _vp,                                       # prof1, prof2
        _i32, _i32, _i32,                               # len_a, len_b, sip
        _f32p, _f, _f, _f,                              # subm, gpo/gpe/tgpe
        _f,                                             # soff
        _vp, ctypes.c_int64,                            # bonus, bstride
        _f, _i32, _i32,                                 # flip thr/trial/stride
        ctypes.c_uint32,                                # flip_mask
        _i32p, _f32p,                                   # path_out, info_out
    ]
    L.kt_leaf_profile.restype = None
    L.kt_leaf_profile.argtypes = [_f32p, _f, _f, _f, _i8p, _i32, _f32p]
    L.kt_scale_gaps.restype = None
    L.kt_scale_gaps.argtypes = [_f32p, _i32, _i32]
    L.kt_merge_profiles.restype = _i32
    L.kt_merge_profiles.argtypes = [
        _f32p, _f32p, _f32p, _f, _f, _f, _i32p, _i32, _i32, _f, _f32p,
    ]
    for name in ("kt_set_dp_hook", "kt_set_pairwise_hook",
                 "kt_set_merge_batch_hook", "kt_set_trial_batch_hook"):
        fn = getattr(L, name)
        fn.restype = None
        fn.argtypes = [_vp]
    return L


# The DP hooks (kt_api.h).  Each receives raw pointers; the Python side
# wraps them with np.ctypeslib.as_array at known sizes.  A callback that
# returns nonzero stops kt_align_msa, which then returns nonzero.

# kt_dp_fn: one full-path alignment (a merge, or a refinement trial)
DP_HOOK_TYPE = ctypes.CFUNCTYPE(
    _i32,
    _i32,                                            # mode
    _vp, _vp,                                        # seq1, seq2
    _vp, _vp,                                        # prof1, prof2
    _i32, _i32, _i32,                                # len_a, len_b, sip
    _vp,                                             # subm
    _f, _f, _f, _f,                                  # gpo/gpe/tgpe, soff
    _vp, ctypes.c_int64,                             # bonus, bstride
    _f, _i32, _i32,                                  # flip thr/trial/stride
    _vp, _vp,                                        # path_out, info_out
    _vp, _i32,                                       # margins_out, margins_cap
)

# kt_pairwise_fn: the consistency pre-pass's N x K pairwise alignments
PAIRWISE_HOOK_TYPE = ctypes.CFUNCTYPE(
    _i32,
    _i32,                                            # n_pairs
    ctypes.POINTER(_vp),                             # seqs_a
    ctypes.POINTER(_i32),                            # lens_a
    ctypes.POINTER(_vp),                             # seqs_b
    ctypes.POINTER(_i32),                            # lens_b
    _vp,                                             # subm
    _f, _f, _f,                                      # gpo/gpe/tgpe
    _vp, ctypes.c_int64,                             # paths_out, stride
)

# kt_merge_batch_fn: every merge of one guide-tree level
MERGE_BATCH_HOOK_TYPE = ctypes.CFUNCTYPE(
    _i32,
    _i32,                                            # n
    ctypes.POINTER(_i32),                            # modes
    ctypes.POINTER(_vp),                             # seqs_a
    ctypes.POINTER(_vp),                             # seqs_b
    ctypes.POINTER(_vp),                             # profs_a
    ctypes.POINTER(_vp),                             # profs_b
    ctypes.POINTER(_i32),                            # lens_a
    ctypes.POINTER(_i32),                            # lens_b
    ctypes.POINTER(_i32),                            # sips
    ctypes.POINTER(_vp),                             # bonuses
    ctypes.POINTER(ctypes.c_int64),                  # bstrides
    ctypes.POINTER(_f),                              # gpos
    ctypes.POINTER(_f),                              # gpes
    ctypes.POINTER(_f),                              # tgpes
    ctypes.POINTER(_f),                              # soffs
    _vp,                                             # subm
    _vp, ctypes.c_int64,                             # paths_out, stride
    _vp, _vp,                                        # margin_sums, counts
)

# kt_trial_batch_fn: refinement trials 1..K-1 of one merge
TRIAL_BATCH_HOOK_TYPE = ctypes.CFUNCTYPE(
    _i32,
    _i32,                                            # mode
    _vp, _vp,                                        # seq1, seq2
    _vp, _vp,                                        # prof1, prof2
    _i32, _i32, _i32,                                # len_a, len_b, sip
    _vp,                                             # subm
    _f, _f, _f, _f,                                  # gpo/gpe/tgpe, soff
    _vp, ctypes.c_int64,                             # bonus, bstride
    _i32, _f, _i32,                                  # n_trials, thr, stride
    _vp, ctypes.c_int64,                             # paths_out, path_stride
    _vp, _vp,                                        # margin_sums, counts
)


def _setter(name):
    def set_hook(cb):
        """Install a callback of the hook's type, or None to clear it.
        The caller keeps a reference to the callback while it is set."""
        fn = getattr(lib(), name)
        fn(None if cb is None else ctypes.cast(cb, _vp))
    set_hook.__name__ = name.replace("kt_", "")
    return set_hook


set_dp_hook = _setter("kt_set_dp_hook")
set_pairwise_hook = _setter("kt_set_pairwise_hook")
set_merge_batch_hook = _setter("kt_set_merge_batch_hook")
set_trial_batch_hook = _setter("kt_set_trial_batch_hook")


def flatten_seqs(codes_list):
    """Pack a list of uint8 arrays into (flat, offsets, lens)."""
    lens = np.array([len(c) for c in codes_list], dtype=np.int32)
    offsets = np.zeros(len(codes_list), dtype=np.int64)
    if len(lens) > 1:
        offsets[1:] = np.cumsum(lens[:-1], dtype=np.int64)
    flat = (np.concatenate([np.asarray(c, np.uint8) for c in codes_list])
            if codes_list else np.zeros(0, np.uint8))
    return np.ascontiguousarray(flat), offsets, lens


# kt_build_tree's stats_out: the seconds of its parts, as spans under
# "tree", then its counts, as engine_stats keys
TREE_PARTS = ("tree.splits", "tree.pairs", "tree.upgma")
TREE_COUNTS = ("tree_pairs_computed", "tree_pairs_needed")


def _ptr(x):
    return None if x is None else x.ctypes.data


def tree_leaf_sets(dm: np.ndarray, n_anchors: int):
    """The guide tree's k-means splits alone (kt_tree_leaf_sets), from the
    [N, stride] anchor distances: (shape, members, seconds), the splits in
    pre-order (-1 a split, else the size of the next leaf set), the leaf
    sets' members one set after another, each in the order its UPGMA
    takes them, and the splits' seconds."""
    dm = np.ascontiguousarray(dm, np.float32)
    n = dm.shape[0]
    shape = np.zeros(max(1, 2 * n - 1), np.int32)
    members = np.zeros(n, np.int32)
    stats = np.zeros(len(TREE_PARTS) + len(TREE_COUNTS), np.float64)
    k = lib().kt_tree_leaf_sets(dm.reshape(-1), n_anchors, n, shape,
                                members, stats)
    return shape[:k], members, float(stats[0])


def leaf_sets(shape: np.ndarray, members: np.ndarray):
    """The leaf sets of tree_leaf_sets' output: one int32 array each."""
    sizes = shape[shape >= 0]
    return np.split(members, np.cumsum(sizes)[:-1])


def leaf_distances(codes, members) -> np.ndarray:
    """[ns, ns] float32 pair distances of one leaf set as the native tree
    computes them (kt_leaf_distances): for members p < q, the biased BPM
    distance of (members[q], members[p]) in both cells; the diagonal 0."""
    flat, off, lens = flatten_seqs(codes)
    members = np.ascontiguousarray(members, np.int32)
    ns = len(members)
    out = np.zeros((ns, ns), np.float32)
    lib().kt_leaf_distances(flat, off, lens, members, ns, out.reshape(-1))
    return out


def build_tree(codes, dm: np.ndarray, n_anchors: int, counts=None,
               pair_distances=None):
    """Guide tree of encoded sequences from their [N, stride] anchor
    distances: (tasks [N-1, 3] int32 in pre-order, seq_dist [N] f32).

    ``pair_distances``, when given, computes the leaf sets' pair
    distances in the native tree's place: called with the list of leaf
    sets (tree_leaf_sets), it returns (the sets' ns x ns float32
    matrices laid one after another, flat, with kt_leaf_distances'
    values off the diagonal; the pair distances it computed).  The tree
    is then the one built without it.

    The call's parts become spans of the record the thread has open
    (utils/logging.py), children of the span open there: TREE_PARTS, the
    k-means rounds, the pair distances of the leaf sets below 50
    sequences and their UPGMA joins; summed spans of the native code's
    clock, but for "tree.pairs" around ``pair_distances``, a span of its
    own.  ``counts`` (a dict), when given, takes TREE_COUNTS: the pair
    distances computed (ns (ns - 1) / 2 a leaf set, natively or by
    ``pair_distances``) and the distinct unordered pairs the UPGMA
    needed (ns (ns - 1) / 2 a leaf set)."""
    flat, off, lens = flatten_seqs(codes)
    n = len(codes)
    dm = np.ascontiguousarray(dm, np.float32)
    tasks = np.zeros(3 * (n - 1), dtype=np.int32)
    seq_dist = np.zeros(n, dtype=np.float32)
    stats = np.zeros(len(TREE_PARTS) + len(TREE_COUNTS), np.float64)
    shape = members = leaf_dm = None
    parts, computed = TREE_PARTS, 0
    t0 = time.perf_counter()
    if pair_distances is not None:
        shape, members, secs = tree_leaf_sets(dm, n_anchors)
        add_span("tree.splits", t0, secs)
        with span("tree.pairs"):
            leaf_dm, computed = pair_distances(leaf_sets(shape, members))
        leaf_dm = np.ascontiguousarray(leaf_dm, np.float32)
        sizes = shape[shape >= 0].astype(np.int64)
        if leaf_dm.size != int(np.sum(sizes * sizes)):
            raise ValueError(f"pair_distances gave {leaf_dm.size} cells for "
                             f"leaf sets of sizes {sizes.tolist()}")
        parts = TREE_PARTS[2:]
        t0 = time.perf_counter()
    cnt = lib().kt_build_tree(flat, off, lens, n, dm.reshape(-1), n_anchors,
                              _ptr(shape), _ptr(members), _ptr(leaf_dm),
                              tasks, seq_dist, stats)
    if cnt != n - 1:
        raise RuntimeError(f"kt_build_tree returned {cnt} tasks for {n} "
                           "sequences")
    secs = dict(zip(TREE_PARTS, stats.tolist()))
    for name in parts:
        add_span(name, t0, secs[name])
        t0 += secs[name]
    stats[len(TREE_PARTS)] += computed
    if counts is not None:
        counts.update(zip(TREE_COUNTS,
                          (int(c) for c in stats[len(TREE_PARTS):])))
    return tasks.reshape(-1, 3), seq_dist


def anchor_distances(codes, anchors, n_threads: int = 1) -> np.ndarray:
    """Anchor distances of the native runtime (kt_dist_to_anchors): the
    [N, ceil(K/8)*8] float32 layout of build_tree."""
    flat, off, lens = flatten_seqs(codes)
    K = len(anchors)
    out = np.zeros((len(codes), ((K + 7) // 8) * 8), dtype=np.float32)
    lib().kt_dist_to_anchors(flat, off, lens, len(codes),
                             np.asarray(anchors, dtype=np.int32), K,
                             out.reshape(-1), n_threads)
    return out


def build_tree_pairwise(dm: np.ndarray):
    """UPGMA guide tree over a full [N, N] distance matrix (realign's tree,
    kt_build_tree_pairwise): (tasks [N-1, 3] int32, seq_dist [N] f32)."""
    n = dm.shape[0]
    tasks = np.zeros(3 * (n - 1), dtype=np.int32)
    seq_dist = np.zeros(n, dtype=np.float32)
    # the native side works on its copy in place
    dmc = np.ascontiguousarray(dm.astype(np.float32).reshape(-1))
    cnt = lib().kt_build_tree_pairwise(dmc, n, tasks, seq_dist)
    if cnt != n - 1:
        raise RuntimeError(f"kt_build_tree_pairwise returned {cnt} tasks "
                           f"for {n} sequences")
    return tasks.reshape(-1, 3), seq_dist


def aln_pairwise_dist(rows) -> np.ndarray:
    """[N, N] float32 identity distances of a finalised alignment's rows
    (kt_aln_pairwise_dist)."""
    n = len(rows)
    alnlen = len(rows[0])
    buf = np.frombuffer("".join(rows).encode("ascii"), dtype=np.uint8).copy()
    dm = np.zeros(n * n, dtype=np.float32)
    lib().kt_aln_pairwise_dist(buf, n, alnlen, dm)
    return dm.reshape(n, n)
