"""Faults planted in the program underneath a run, for the tests that see
``correct`` come out false (test_msabench_faults.py): each is a
context manager that breaks one layer of the timed path and puts it
back on leaving.

* ``token``: one letter altered in a produced row (an answer altered
  where it is produced).
* ``half_batch``: the lower half of each DP launch's match rows zeroed
  (half of every launch's work left out; the launches are padded with
  problems of their own, so leaving out half of the problems would often
  leave out only pads).
* ``consistency_off``: no consistency table (the maps' DPs skipped, no
  bonus: Kalign's fast mode in the default mode's place).
* ``bonus_off``: the maps built, the anchor bonus weighed 0 in every
  merge's match preparation.
* ``tree_shuffled``: the guide tree's leaves relabelled by a permutation
  drawn from a fixed seed (a wrong tree of the right shape).
"""

from contextlib import contextmanager

import numpy as np


@contextmanager
def _patched(owner, name, value):
    raw = owner.__dict__[name]
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, raw)


def token():
    from kalign_tpu_torch.core.msa import Msa
    original = Msa.aligned_rows

    def rows(self):
        out = list(original(self))
        r = out[1]
        k = next(i for i, c in enumerate(r) if c != "-")
        out[1] = r[:k] + ("A" if r[k] != "A" else "C") + r[k + 1:]
        return out
    return _patched(Msa, "aligned_rows", rows)


def half_batch():
    from kalign_tpu_torch.gpu import engine
    original = engine.bucket_match

    def match(lhs, rhs, la, lb, eps, bonus):
        m, slope, e = original(lhs, rhs, la, lb, eps, bonus)
        m = m.clone()
        m[:, m.shape[1] // 2:] = 0
        return m, slope, e
    return _patched(engine, "bucket_match", match)


def consistency_off():
    from kalign_tpu_torch.gpu.consistency import ConsistencyTable
    return _patched(ConsistencyTable, "build",
                    classmethod(lambda cls, *a, **k: None))


def bonus_off():
    from kalign_tpu_torch.gpu.consistency import ConsistencyTable
    return _patched(ConsistencyTable, "per_weight",
                    property(lambda self: np.float32(0.0)))


def tree_shuffled(seed: int = 7):
    from kalign_tpu_torch.gpu.engine import GpuEngine
    original = GpuEngine.build_tree

    def build_tree(self, codes, dm, n_anchors):
        tasks, seq_dist = original(self, codes, dm, n_anchors)
        n = len(codes)
        perm = np.random.default_rng(seed).permutation(n)
        tasks = np.array(tasks)
        ends = tasks[:, :2]
        leaf = ends < n
        ends[leaf] = perm[ends[leaf]]
        return tasks, seq_dist
    return _patched(GpuEngine, "build_tree", build_tree)


FAULTS = {"token": token, "half_batch": half_batch,
          "consistency_off": consistency_off, "bonus_off": bonus_off,
          "tree_shuffled": tree_shuffled}
