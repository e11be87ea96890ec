"""Operations and bytes of the row Gotoh kernels, and the card's peaks.

Frozen copies of chip_smoke.py's ``bound`` and ``gotoh_bound`` (lines
2794-2816) and of its peaks (lines 227-237).  Peaks of one NVIDIA H100
SXM (NVIDIA's data sheet, at its 700 W power limit): 3.35 TB/s of HBM3;
67 TFLOP/s of fp32 outside the tensor cores, which counts a fused
multiply-add as two operations.  The kernels are built with -fmad=false
and a DP cell's 19 operations are adds, maxima and compares, one
instruction each, so the rate they can reach is 33.5e12 operations/s.
A cell needs (la x lb cells of each problem, never the padded ones) a
4-byte match read and a 1-byte decision write, 12 bytes of penalties per
row and column, 8 bytes a problem, and GOTOH_OPS_PER_CELL operations.
"""

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 33.5e12
# fp32 operations per DP cell of the Gotoh kernels (bias 3, diagonal
# candidates 4, A 1, GB 4, GA 3, decision compares 4)
GOTOH_OPS_PER_CELL = 19
MATCH_BYTES = 4
DECISION_BYTES = 1


def bound_s(bytes_: float, ops: float, ops_per_s: float = FP32_OPS_PER_S):
    """(least seconds, what bounds it) of work moving bytes_ and doing
    ops operations."""
    t_bytes = bytes_ / HBM_BYTES_PER_S
    t_ops = ops / ops_per_s
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def gotoh_launch(rows, cols) -> tuple:
    """(bytes, operations) of one launch: rows and cols the lengths (la,
    lb) of the rows and columns each of its problems needs."""
    cells = float(sum(int(r) * int(c) for r, c in zip(rows, cols)))
    bytes_ = (cells * (MATCH_BYTES + DECISION_BYTES)
              + float(sum(int(r) + int(c) for r, c in zip(rows, cols))) * 12
              + len(rows) * 8)
    return bytes_, cells * GOTOH_OPS_PER_CELL


def least_seconds(launches) -> float:
    """The least time of a list of launches, each [(rows, cols)] of its
    problems: each launch bound by its bytes or its operations."""
    total = 0.0
    for problems in launches:
        if not problems:
            continue
        rows, cols = zip(*problems)
        total += bound_s(*gotoh_launch(rows, cols))[0]
    return total
