"""Single-problem Gotoh affine-gap DP in plain PyTorch: the reference
form of the forward pass that the row kernel (gpu/gotoh_row.py) batches.

Counterpart of kalign_tpu/tpu/gotoh.py.  The DP runs as a loop over
rows; within a row the gap-in-row state GA obeys the max-plus recurrence
    GA[j] = max(GA[j-1] + ge[j], A[j-1] + go[j])
which the scan transform solves with one prefix max: with
C = cumsum(ge) and u[k] = A[k] + (go[k+1] - C[k+1]),
    GA[j] = max_{k<j} u[k] + C[j].
A and GB depend only on the previous row.  Per-cell decisions are packed
into an int8 matrix; ``traceback`` walks it on the host.

Scoring semantics follow the reference (lib/src/aln_profileprofile.c):
per-column gap penalties carried in profile columns, terminal gaps on the
four matrix edges charged at tgpe with no opening cost.
"""

import numpy as np
import torch

NEG = -3.4e38

# decision encodings
#   A-cell (bits 0-1): 0 = diagonal from A, 1 = from GA, 2 = from GB
#   GA-cell (bit 2):   set = extend (from GA), clear = open (from A)
#   GB-cell (bit 3):   set = extend (from GB), clear = open (from A)
DEC_A_MASK = 3
DEC_GA_EXT = 4
DEC_GB_EXT = 8


def gotoh_forward(match, goB, geB, tgeB, goA, geA, tgeA, la: int, lb: int):
    """Full-matrix forward DP of one problem.

    match [L1p, L2p] (match[i-1, j-1] scores row residue i against
    column residue j); goB/geB/tgeB [L2p+1] column-side penalties and
    goA/geA/tgeA [L1p+1] row-side penalties, 1-based, stored negative.
    Returns (dec [L1p+1, L2p+1] int8, score, end_state)."""
    match = torch.as_tensor(match, dtype=torch.float32)
    dev = match.device
    f32 = dict(dtype=torch.float32, device=dev)
    goB, geB, tgeB, goA, geA, tgeA = (
        torch.as_tensor(x, **f32) for x in (goB, geB, tgeB, goA, geA, tgeA))
    L1p, L2p = match.shape
    cols = torch.arange(L2p + 1, device=dev)
    col_valid = cols <= lb
    neg = torch.full((), NEG, **f32)
    zero = torch.zeros((), **f32)

    GA = torch.where(cols >= 1, torch.cumsum(torch.where(cols == 0, zero, tgeB),
                                             0), neg)
    GA = torch.where(col_valid, GA, neg)
    A = torch.where(cols == 0, zero, neg)
    GB = torch.full((L2p + 1,), NEG, **f32)
    is_term_col = (cols == 0) | (cols == lb)
    dec = torch.zeros((L1p + 1, L2p + 1), dtype=torch.int8, device=dev)
    negv = torch.full((1,), NEG, **f32)

    for i in range(1, L1p + 1):
        row_valid = i <= la
        is_last_row = i == la
        diagA = A[:-1]
        diagGA = GA[:-1] + goB[:-1]
        diagGB = GB[:-1] + goA[i - 1]
        best01 = torch.maximum(diagA, diagGA)
        # reference MAX3 keeps the LATER operand on ties (a > b ? a : b)
        dec_a = torch.where(diagGB >= best01, 2,
                            torch.where(diagGA >= diagA, 1, 0))
        A_row = torch.cat([negv, torch.maximum(best01, diagGB) + match[i - 1]])
        A_row = torch.where(col_valid & (cols > 0), A_row, neg)

        gb_e = torch.where(is_term_col, GB + tgeA[i], GB + geA[i])
        gb_o = torch.where(is_term_col, A + tgeA[i], A + goA[i])
        GB_row = torch.where(col_valid, torch.maximum(gb_e, gb_o), neg)
        dec_gb = (gb_e > gb_o).to(torch.int8)

        ge_row = tgeB if is_last_row else geB
        go_row = tgeB if is_last_row else goB
        C = torch.cumsum(torch.where(cols == 0, zero, ge_row), 0)
        u = A_row[:-1] + (go_row[1:] - C[1:])
        cmax = torch.cummax(u, 0).values
        GA_row = torch.where(col_valid, torch.cat([negv, cmax + C[1:]]), neg)
        # extend iff cm[j-1] > u[j-1]: open on ties
        dec_ga = torch.cat([torch.zeros(1, dtype=torch.int8, device=dev),
                            (cmax > u).to(torch.int8)])
        dec[i] = (torch.cat([torch.zeros(1, dtype=torch.int8, device=dev),
                             dec_a.to(torch.int8)])
                  | (dec_ga << 2) | (dec_gb << 3))
        if row_valid:
            A, GA, GB = A_row, GA_row, GB_row

    end_a, end_ga, end_gb = A[lb], GA[lb], GB[lb]
    score = torch.maximum(torch.maximum(end_a, end_ga), end_gb)
    if end_ga > end_a:
        state = 2 if end_gb > end_ga else 1
    else:
        state = 2 if end_gb > end_a else 0
    return dec, float(score), state


def traceback(dec, la: int, lb: int, end_state: int):
    """Step path (0 = match, 1 = gap in the rows / consume a column,
    2 = gap in the columns / consume a row) in forward order from the
    [L1p+1, L2p+1] decision matrix of ``gotoh_forward``."""
    dec = np.asarray(dec.cpu() if isinstance(dec, torch.Tensor) else dec)
    steps = []
    i, j = la, lb
    state = int(end_state)
    while i > 0 or j > 0:
        if state == 0:
            if i == 0 or j == 0:
                state = 1 if j > 0 else 2
                continue
            d = dec[i, j] & DEC_A_MASK
            steps.append(0)
            i -= 1
            j -= 1
            state = int(d)
        elif state == 1:
            if j == 0:
                state = 2
                continue
            ext = dec[i, j] & DEC_GA_EXT
            steps.append(1)
            j -= 1
            state = 1 if ext else 0
        else:
            if i == 0:
                state = 1
                continue
            ext = dec[i, j] & DEC_GB_EXT
            steps.append(2)
            i -= 1
            state = 2 if ext else 0
    steps.reverse()
    return steps


def steps_to_kalign_path(steps, la, lb):
    """0/1/2 steps -> the reference's annotated path array (path[0] =
    length, terminal-gap flag bit 32, sentinel 3)."""
    n = len(steps)
    path = np.zeros(n + 2, dtype=np.int32)
    path[0] = n
    for c, s in enumerate(steps, start=1):
        path[c] = s
    path[n + 1] = 3
    c = 1
    while c <= n and path[c] != 0:
        path[c] |= 32
        c += 1
    c = n
    while c >= 1 and (path[c] & 3) != 0:
        path[c] |= 32
        c -= 1
    return path
