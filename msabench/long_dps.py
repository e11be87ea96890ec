"""The column-sharded merges an alignment queued, as the checks
score_miss and edge_shortfall take them: each merge's operands as the
engine hands them to parallel/mesh.py::LongQueue.submit (host arrays,
fresh for each bucket, kept by reference: nothing is copied in the
timed window), the first column of each of its bands past the first,
and the queued DP, whose (steps, score) the queue leaves in
``result`` once it is walked.  Map DPs (bonus-free, their operands on
the card) are left to map_miss: they run the same bands and walk.

A check reads the merges after the window: the path rescored on the
host (reference/kalign_dp.py::step_terms, summed in float32), and at each
band edge the path's part between its cells WINDOW columns either side
against the best path between those cells (kalign_dp.window_best)."""

import numpy as np

from msabench.reference import kalign_dp

# columns of a path on either side of a band edge that a window spans
WINDOW = 64
NAMES = ("queue", "lhs", "rhs", "pc", "pr", "la", "lb", "eps", "bonus",
         "rows", "what")


def record(call, args, kwargs):
    got = dict(zip(NAMES, args))
    got.update(kwargs)
    dp = call(*args, **kwargs)
    if got.get("what", "merge") != "merge":
        return dp, None
    got.pop("queue")
    got["edges"] = [int(b["c0"]) for b in dp.bands[1:]]
    got["dp"] = dp
    return dp, got


AROUND = [("kalign_tpu_torch.parallel.mesh:LongQueue.submit", record)]


def merges(records):
    """The alignment's walked merges: [(record, steps, score)]."""
    out = []
    for rec in records:
        if rec is None or rec["dp"].result is None:
            continue
        steps, score = rec["dp"].result
        out.append((rec, steps, score))
    return out


def problem(rec):
    return (rec["lhs"], rec["rhs"], rec["pc"], rec["pr"], int(rec["la"]),
            int(rec["lb"]), float(rec["eps"]))


def rescored(rec, steps) -> float:
    """The path's score as a float32 DP adds it up: its terms
    (kalign_dp.step_terms, on its cells alone), each rounded to float32,
    added one after another in float32.  Past 2**24 a float32 sum of
    Kalign's integer-valued matches rounds the same way step after step,
    so a float64 sum of the same path drifts from the DP's by a share
    that grows with the length (7.7e-4 at 150 kb, PERF.md)."""
    lhs, rhs, pc, pr, la, lb, eps = problem(rec)
    t, _, _ = kalign_dp.step_terms(lhs, rhs, pc, pr, la, lb, eps, steps,
                                   rec["bonus"])
    return float(np.cumsum(t.astype(np.float32), dtype=np.float32)[-1])


def shortfalls(rec, steps, window: int = WINDOW) -> list:
    """At each band edge the path crosses: the best score between the
    path's last cell at or left of WINDOW columns before the edge and its
    first cell at or right of WINDOW columns past it, less the path's own
    score between them (float64; 0 where the path is the best there)."""
    lhs, rhs, pc, pr, la, lb, eps = problem(rec)
    t, i, j = kalign_dp.step_terms(lhs, rhs, pc, pr, la, lb, eps, steps,
                                   rec["bonus"])
    out = []
    for c0 in rec["edges"]:
        if c0 >= lb:
            break
        a = int((j <= c0 - window).sum()) - 1
        b = min(len(steps) - 1, int((j < c0 + window).sum()))
        start = (0, 0, kalign_dp.A) if a < 0 else \
            (int(i[a]), int(j[a]), int(steps[a]))
        end = (int(i[b]), int(j[b]), int(steps[b]))
        best = kalign_dp.window_best(lhs, rhs, pc, pr, la, lb, eps,
                                     rec["bonus"], start, end)
        out.append(best - float(t[a + 1:b + 1].sum()))
    return out
