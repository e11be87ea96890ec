"""Checkpointable pipeline artifacts (a copy of kalign_tpu/checkpoint.py:
the files are interchangeable between the two packages).

The reference's resumable artifacts are the POAR binary file
(poar.c:203-325 — handled in poar.py with the same format) and
the guide-tree task-list text serialization (task.c:60-111).  This
module reproduces the task-list format and adds distance-matrix
checkpoints so long multi-host runs can resume after the distance or
tree phase.
"""

import hashlib
from typing import Optional, Tuple

import numpy as np


def input_fingerprint(seqs) -> str:
    """Stable fingerprint of the input the artifacts were derived from:
    sha256 over the (already sorted) sequence strings.  Stored in
    distances.npz and checked at resume so a checkpoint produced from
    different input with the same sequence count is rejected instead of
    silently yielding a wrong alignment."""
    h = hashlib.sha256()
    h.update(str(len(seqs)).encode())
    for s in seqs:
        h.update(b"\x00")
        h.update(s.encode() if isinstance(s, str) else bytes(s))
    return h.hexdigest()


def write_tasks(tasks: np.ndarray, path: str,
                priorities=None, counts=None) -> None:
    """Reference task-list text format (task.c:60-81):
    first line n_tasks, then 'a,b,c,p,n' per task."""
    tasks = np.asarray(tasks).reshape(-1, 3)
    n = len(tasks)
    p = np.zeros(n, dtype=np.int64) if priorities is None else priorities
    c = np.zeros(n, dtype=np.int64) if counts is None else counts
    with open(path, "w") as fh:
        fh.write(f"{n}\n")
        for i, (a, b, cc) in enumerate(tasks):
            fh.write(f"{a},{b},{cc},{p[i]},{c[i]}\n")


def read_tasks(path: str) -> np.ndarray:
    with open(path) as fh:
        n = int(fh.readline().strip())
        out = np.zeros((n, 3), dtype=np.int32)
        for i in range(n):
            parts = fh.readline().strip().split(",")
            out[i] = [int(parts[0]), int(parts[1]), int(parts[2])]
    return out


def save_distances(path: str, dm: np.ndarray, seq_distances: np.ndarray,
                   anchors=None, fingerprint: Optional[str] = None) -> None:
    np.savez_compressed(path, dm=dm, seq_distances=seq_distances,
                        anchors=np.asarray(anchors if anchors is not None
                                           else []),
                        fingerprint=np.asarray(fingerprint or ""))


def load_distances(path: str, expect_fingerprint: Optional[str] = None,
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    z = np.load(path)
    if expect_fingerprint is not None and "fingerprint" in z:
        stored = str(z["fingerprint"])
        if stored and stored != expect_fingerprint:
            raise ValueError(
                "checkpoint was produced from different input sequences "
                "(fingerprint mismatch)")
    return z["dm"], z["seq_distances"], z["anchors"]
