"""Kalign's Gotoh DP of two profiles, plain: one problem, row by row over
the whole matrix in float32, on the host.

The reference that the program's column-sharded DP (a merge or a
consistency map over the mesh's cards) is held to: the same problem as
the program's row kernels take it (the profiles' product as the match,
per-position gap penalties, Kalign's terminal gaps, the centering bias
and the consistency bonus as the program adds them to a merge's match),
written from the recurrences, not from the program's scan transform, so
its scores round apart from the program's by float32 steps.

  lhs [L1, 23], rhs [L2, 23]: the match of rows i and column j is
      lhs[i - 1] . rhs[j - 1];
  pens_rows [3, L1 + 1], pens_cols [3, L2 + 1]: gap open, extend and
      terminal extend of each row and column (1-based, negative);
  la, lb: the lengths (rows and columns past them are padding);
  eps: the centering bias's strength, |j - i lb / la| eps taken from
      each cell's match;
  bonus: None, or (per_w, apos_r [K, L1], conf_r, apos_c [K, L2],
      conf_c): per_w sum_k conf_r[k, i] conf_c[k, j] added where
      apos_r[k, i] == apos_c[k, j] >= 0.

States: A (i, j matched), GA (a gap in the rows: column j against a
gap), GB (a gap in the columns: row i against a gap).

  A[i][j]  = max(A[i-1][j-1], GA[i-1][j-1] + go_c[j-1],
                 GB[i-1][j-1] + go_r[i-1]) + match(i, j)
  GB[i][j] = max(GB[i-1][j] + ge_r[i], A[i-1][j] + go_r[i])
             (tge_r[i] for both at column lb: a trailing gap)
  GA[i][j] = max(GA[i][j-1] + ge_c[j], A[i][j-1] + go_c[j])
             (tge_c[j] for both in row la: a trailing gap)

with A[0][0] = 0, GA[0][j] = tge_c[1] + .. + tge_c[j] and GB[i][0] =
tge_r[1] + .. + tge_r[i] (leading gaps), every other border -inf.  The
score is the best state at (la, lb); the path is walked back from there
on the host (a state's predecessor: GB before GA before A on ties into
A, opening before extending on ties into a gap) and returned as steps in
forward order: 0 a match, 1 a gap in the rows (a column), 2 a gap in the
columns (a row).

Imports nothing of the program; NumPy and PyTorch only.
"""

import numpy as np
import torch

NEG = float("-inf")
A, GA, GB = 0, 1, 2


def match_of(lhs, rhs, la: int, lb: int, eps: float, bonus=None):
    """The la x lb match [la, lb] float32: the profiles' product, the
    centering bias taken off, the bonus added."""
    lhs = torch.as_tensor(np.asarray(lhs, np.float32))[:la]
    rhs = torch.as_tensor(np.asarray(rhs, np.float32))[:lb]
    m = lhs @ rhs.T
    i = torch.arange(1, la + 1, dtype=torch.float64)[:, None]
    j = torch.arange(1, lb + 1, dtype=torch.float64)[None, :]
    bias = (j - i * (lb / max(la, 1))).abs() * float(eps)
    m = (m.double() - bias).float()
    if bonus is not None:
        per_w, apr, cfr, apc, cfc = (np.asarray(x) for x in bonus)
        acc = torch.zeros((la, lb), dtype=torch.float64)
        for k in range(apr.shape[0]):
            ar = torch.as_tensor(apr[k, :la].astype(np.int64))
            ac = torch.as_tensor(apc[k, :lb].astype(np.int64))
            eq = (ar[:, None] == ac[None, :]) & (ar[:, None] >= 0)
            term = torch.as_tensor(cfr[k, :la], dtype=torch.float64)[:, None] \
                * torch.as_tensor(cfc[k, :lb], dtype=torch.float64)[None, :]
            acc += torch.where(eq, term, torch.zeros((), dtype=torch.float64))
        m = (m.double() + float(per_w) * acc).float()
    return m


def dp(lhs, rhs, pens_cols, pens_rows, la: int, lb: int, eps: float,
       bonus=None):
    """(score, steps int8 in forward order) of the problem."""
    f32 = np.float32
    m = match_of(lhs, rhs, la, lb, eps, bonus).numpy()
    pr = np.asarray(pens_rows, f32)
    pc = np.asarray(pens_cols, f32)
    go_r, ge_r, tge_r = pr[0], pr[1], pr[2]
    go_c, ge_c, tge_c = pc[0], pc[1], pc[2]
    # border rows and columns
    a_prev = np.full(lb + 1, NEG, f32)
    a_prev[0] = 0.0
    ga_prev = np.full(lb + 1, NEG, f32)
    for j in range(1, lb + 1):
        ga_prev[j] = (ga_prev[j - 1] if j > 1 else f32(0.0)) + tge_c[j]
    gb_prev = np.full(lb + 1, NEG, f32)
    # predecessors: bits 0-1 A's state, bit 2 GA extends, bit 3 GB extends
    ptr = np.zeros((la + 1, lb + 1), np.uint8)
    gb_col = f32(0.0)
    for i in range(1, la + 1):
        a = np.full(lb + 1, NEG, f32)
        ga = np.full(lb + 1, NEG, f32)
        gb = np.full(lb + 1, NEG, f32)
        gb_col = f32(gb_col + tge_r[i])
        gb[0] = gb_col
        # A from the cell up and left
        d_a = a_prev[:-1]
        d_ga = ga_prev[:-1] + go_c[:lb]
        d_gb = gb_prev[:-1] + go_r[i - 1]
        best = np.maximum(np.maximum(d_a, d_ga), d_gb)
        a[1:] = best + m[i - 1]
        src = np.where(d_gb >= np.maximum(d_a, d_ga), GB,
                       np.where(d_ga >= d_a, GA, A)).astype(np.uint8)
        # GB from the cell above
        ge = np.full(lb, ge_r[i], f32)
        go = np.full(lb, go_r[i], f32)
        ge[lb - 1] = go[lb - 1] = tge_r[i]
        ext_b = gb_prev[1:] + ge
        open_b = a_prev[1:] + go
        gb[1:] = np.maximum(ext_b, open_b)
        # GA from the cell to the left, one column at a time
        e = tge_c if i == la else ge_c
        o = tge_c if i == la else go_c
        ext_a = np.zeros(lb + 1, bool)
        for j in range(1, lb + 1):
            x, y = f32(ga[j - 1] + e[j]), f32(a[j - 1] + o[j])
            ext_a[j] = x > y
            ga[j] = x if x > y else y
        ptr[i, 1:] = src | (ext_a[1:] << 2).astype(np.uint8) | \
            ((ext_b > open_b) << 3).astype(np.uint8)
        a_prev, ga_prev, gb_prev = a, ga, gb
    if lb == 0:
        return float(gb_col if la else 0.0), np.full(la, GB, np.int8)
    ends = [a_prev[lb], ga_prev[lb], gb_prev[lb]]
    state = GA if ends[GA] > ends[A] else A
    state = GB if ends[GB] > ends[state] else state
    return float(ends[state]), walk(ptr, la, lb, state)


def walk(ptr, i: int, j: int, state: int) -> np.ndarray:
    """The path from (i, j) in ``state`` back to (0, 0), in forward
    order."""
    steps = []
    while i > 0 or j > 0:
        if i == 0:
            steps.extend([GA] * j)
            break
        if j == 0:
            steps.extend([GB] * i)
            break
        code = int(ptr[i, j])
        steps.append(state)
        if state == A:
            state = code & 3
            i, j = i - 1, j - 1
        elif state == GA:
            state = GA if code & 4 else A
            j -= 1
        else:
            state = GB if code & 8 else A
            i -= 1
    return np.array(steps[::-1], np.int8)


def path_score(lhs, rhs, pens_cols, pens_rows, la: int, lb: int,
               eps: float, steps, bonus=None) -> float:
    """The score of a path (steps in forward order) under the same
    scoring, summed in float64: what a path other than dp's must reach
    to tie with it."""
    m = match_of(lhs, rhs, la, lb, eps, bonus).double().numpy()
    pr = np.asarray(pens_rows, np.float64)
    pc = np.asarray(pens_cols, np.float64)
    i = j = 0
    prev = None
    total = 0.0
    for s in np.asarray(steps):
        s = int(s)
        if s == A:
            i, j = i + 1, j + 1
            if prev == GA:
                total += pc[0, j - 1]
            elif prev == GB:
                total += pr[0, i - 1]
            total += m[i - 1, j - 1]
        elif s == GA:
            j += 1
            term = i == 0 or i == la
            if term:
                total += pc[2, j]
            else:
                total += pc[1, j] if prev == GA else pc[0, j]
        else:
            i += 1
            term = j == 0 or j == lb
            if term:
                total += pr[2, i]
            else:
                total += pr[1, i] if prev == GB else pr[0, i]
        prev = s
    return total


# ----------------------------------------------------------------------
# The same scoring in float64 over the cells a path or a window needs
# alone, for problems whose whole matrix no host holds (KHV's ~295 kb).

def _host(x):
    """A host array of an operand given as an array or a tensor."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def match_cells(lhs, rhs, la: int, lb: int, eps: float, bonus, i, j):
    """The match of the cells (i, j) (1-based arrays of one shape), in
    float64: the profiles' product, the centering bias taken off, the
    bonus added (match_of's terms, unrounded)."""
    lhs, rhs = _host(lhs), _host(rhs)
    i, j = np.asarray(i, np.int64), np.asarray(j, np.int64)
    m = np.einsum("...c,...c->...", lhs[i - 1].astype(np.float64),
                  rhs[j - 1].astype(np.float64))
    m -= np.abs(j - i * (lb / max(la, 1))) * float(eps)
    if bonus is not None:
        per_w, apr, cfr, apc, cfc = (_host(x) for x in bonus)
        for k in range(apr.shape[0]):
            ar, ac = apr[k][i - 1], apc[k][j - 1]
            m += float(per_w) * np.where(
                (ar == ac) & (ar >= 0),
                cfr[k][i - 1].astype(np.float64)
                * cfc[k][j - 1].astype(np.float64), 0.0)
    return m


def step_terms(lhs, rhs, pens_cols, pens_rows, la: int, lb: int,
               eps: float, steps, bonus=None):
    """(terms, i, j): each step's score term as path_score adds it (in
    float64, the match made on the path's cells alone) and the cell each
    step reaches; terms.sum() is path_score's."""
    steps = np.asarray(steps, np.int64)
    i = np.cumsum(steps != GA)
    j = np.cumsum(steps != GB)
    prev = np.concatenate([[-1], steps[:-1]])
    pr = _host(pens_rows).astype(np.float64)
    pc = _host(pens_cols).astype(np.float64)
    t = np.zeros(len(steps))
    a = steps == A
    ia, ja, pa = i[a], j[a], prev[a]
    t[a] = match_cells(lhs, rhs, la, lb, eps, bonus, ia, ja) + np.where(
        pa == GA, pc[0, ja - 1], np.where(pa == GB, pr[0, ia - 1], 0.0))
    g = steps == GA
    ig, jg = i[g], j[g]
    t[g] = np.where((ig == 0) | (ig == la), pc[2, jg],
                    np.where(prev[g] == GA, pc[1, jg], pc[0, jg]))
    b = steps == GB
    ib, jb = i[b], j[b]
    t[b] = np.where((jb == 0) | (jb == lb), pr[2, ib],
                    np.where(prev[b] == GB, pr[1, ib], pr[0, ib]))
    return t, i, j


def window_best(lhs, rhs, pens_cols, pens_rows, la: int, lb: int,
                eps: float, bonus, start, end) -> float:
    """The best score of a path from start = (i0, j0, state) to end =
    (i1, j1, state) under dp's recurrences, in float64, the match made
    over the window's cells alone; a state's value at start is 0.  GA
    along a row is the prefix max of the cells' openings, extended by
    the row's running sum of extensions (the same maximum as dp's column
    loop, in float64)."""
    (i0, j0, s0), (i1, j1, s1) = start, end
    pr = _host(pens_rows).astype(np.float64)
    pc = _host(pens_cols).astype(np.float64)
    jj = np.arange(j0, j1 + 1)
    C = len(jj)
    lhs, rhs = _host(lhs), _host(rhs)
    if i1 > i0 and C > 1:
        m = match_cells(lhs, rhs, la, lb, eps, bonus,
                        np.arange(i0 + 1, i1 + 1)[:, None], jj[None, 1:])
    cur = [np.full(C, NEG) for _ in range(3)]
    cur[s0][0] = 0.0
    tcol = (jj == 0) | (jj == lb)

    def along(i, a, ga0):
        """GA of row i from its A and GA at the window's first column."""
        term = i == 0 or i == la
        e = pc[2 if term else 1, jj[1:]]
        o = pc[2 if term else 0, jj[1:]]
        E = np.concatenate([[0.0], np.cumsum(e)])
        opened = np.maximum.accumulate(a[:-1] + o - E[1:])
        ga = np.empty(C)
        ga[0] = ga0
        ga[1:] = E[1:] + np.maximum(ga0, opened)
        return ga

    cur[GA] = along(i0, cur[A], cur[GA][0])
    for r, i in enumerate(range(i0 + 1, i1 + 1)):
        a_p, ga_p, gb_p = cur
        a = np.full(C, NEG)
        a[1:] = np.maximum(np.maximum(a_p[:-1], ga_p[:-1] + pc[0, jj[:-1]]),
                           gb_p[:-1] + pr[0, i - 1]) + m[r]
        gb = np.maximum(gb_p + np.where(tcol, pr[2, i], pr[1, i]),
                        a_p + np.where(tcol, pr[2, i], pr[0, i]))
        cur = [a, along(i, a, NEG), gb]
    return float(cur[s1][C - 1])
