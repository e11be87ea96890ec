"""A plain pairwise aligner: the reference put in the program's place for
the control (msabench/tests/test_msabench_control.py).

Global alignment with affine gaps (Gotoh), one row of the DP at a time
in PyTorch for a batch of pairs, every score held and every operation
rounded in ``dtype``: float32 is the precision the configurations state
(Kalign's DP scores), bfloat16 the control's.  The horizontal gap state
of a row is a running maximum: L[j] = max_{k<j} (E[k] + k gpe) - gpo -
(j - 1) gpe, with E = max(D, U) of the row.  Each cell keeps its three
states' predecessors in one byte for the traceback, which runs on the
host.  Pairs of unequal lengths share the batch padded: a row or a
column past a pair's end never reaches its cells.

Scores: +5 / -4, gap open 8, extend 6 (Kalign's DNA defaults).
"""

import numpy as np
import torch

from msabench.families import ALPHABETS

SCORES = {"dna": (5.0, -4.0, 8.0, 6.0)}
D, U, L = 0, 1, 2
NEG = -1e30


def encode(seq: str, alphabet: str) -> np.ndarray:
    table = np.zeros(256, np.int64)
    for i, c in enumerate(ALPHABETS[alphabet]):
        table[ord(c)] = i
    return table[np.frombuffer(seq.upper().encode(), np.uint8)]


def forward(a_list, b_list, alphabet: str, dtype, device):
    """The DPs of a_list[p] against b_list[p] (codes): (pointers
    [P, M + 1, N + 1] uint8 on ``device``, end states [P]).  Pointer
    bits: 0-1 D's predecessor, 2-3 U's, 4-5 L's (0 D, 1 U, 2 L)."""
    match, mismatch, gpo, gpe = SCORES[alphabet]
    na = len(ALPHABETS[alphabet])
    P = len(a_list)
    ms = [len(a) for a in a_list]
    ns = [len(b) for b in b_list]
    M, N = max(ms), max(ns)
    A = torch.zeros((P, M), dtype=torch.int64)
    B = torch.zeros((P, N), dtype=torch.int64)
    for p in range(P):
        A[p, :ms[p]] = torch.as_tensor(a_list[p])
        B[p, :ns[p]] = torch.as_tensor(b_list[p])
    A, B = A.to(device), B.to(device)
    subm = torch.full((na, na), mismatch, dtype=dtype, device=device)
    subm.fill_diagonal_(match)
    jgpe = torch.arange(N + 1, device=device).to(dtype) * gpe
    gpo_t = torch.tensor(gpo, dtype=dtype, device=device)
    gpe_t = torch.tensor(gpe, dtype=dtype, device=device)
    negcol = torch.full((P, 1), NEG, dtype=dtype, device=device)
    zcol = torch.zeros((P, 1), dtype=torch.uint8, device=device)
    # row 0: D[0][0] = 0, L[0][j] = -gpo - (j - 1) gpe
    Dr = torch.full((P, N + 1), NEG, dtype=dtype, device=device)
    Dr[:, 0] = 0
    Ur = torch.full_like(Dr, NEG)
    Lr = (-gpo_t - (jgpe - gpe_t)).expand(P, N + 1).clone()
    Lr[:, 0] = NEG
    ptr = torch.zeros((P, M + 1, N + 1), dtype=torch.uint8, device=device)
    ends = {}
    for i in range(1, M + 1):
        # D: the best state of (i - 1, j - 1) plus the match score
        mx, arg = torch.stack([Dr, Ur, Lr]).max(0)
        s = subm[A[:, i - 1]].gather(1, B)
        Dn = torch.cat([negcol, mx[:, :-1] + s], 1)
        dptr = torch.cat([zcol, arg[:, :-1].to(torch.uint8)], 1)
        # U: a[i - 1] against a gap, from the row above
        Un, uptr = torch.stack([Dr - gpo_t, Ur - gpe_t, Lr - gpo_t]).max(0)
        if i == 1:
            Un[:, 0] = -gpo_t
        # L: b[j - 1] against a gap, a running maximum along the row
        E = torch.maximum(Dn, Un)
        earg = (Un > Dn).to(torch.uint8)          # E's state: D 0, U 1
        c = torch.cummax(E + jgpe, 1).values
        Ln = torch.cat([negcol, c[:, :-1] - gpo_t - (jgpe[1:] - gpe_t)], 1)
        # L's predecessor: extend from L[j - 1], or open from E[j - 1]
        ext = (Ln[:, 1:-1] - gpe_t) > (E[:, 1:-1] - gpo_t)
        lptr = torch.where(ext, L, earg[:, 1:-1])
        lptr = torch.cat([zcol, earg[:, :1], lptr], 1)
        ptr[:, i] = dptr | (uptr.to(torch.uint8) << 2) | (lptr << 4)
        Dr, Ur, Lr = Dn, Un, Ln
        for p in range(P):
            if ms[p] == i:
                ends[p] = torch.stack([Dr[p, ns[p]], Ur[p, ns[p]],
                                       Lr[p, ns[p]]]).argmax()
    return ptr, [int(ends[p]) for p in range(P)]


def traceback(ptr, end: int):
    """(columns of a's residues, columns of b's residues, width) of the
    path through one pair's pointers [m + 1, n + 1] (host array)."""
    i, j = ptr.shape[0] - 1, ptr.shape[1] - 1
    state = end
    steps = []
    while i > 0 or j > 0:
        if i == 0:
            state = L
        elif j == 0:
            state = U
        steps.append(state)
        code = int(ptr[i, j])
        if state == D:
            nxt = code & 3
            i -= 1
            j -= 1
        elif state == U:
            nxt = (code >> 2) & 3
            i -= 1
        else:
            nxt = (code >> 4) & 3
            j -= 1
        state = nxt
    steps = np.array(steps[::-1], np.int8)
    cols = np.arange(len(steps))
    return cols[steps != L], cols[steps != U], len(steps)


def align_pairs(pairs, alphabet: str, dtype=torch.float32, device="cpu"):
    """[(columns of a's residues, of b's, width)] of each (a, b) of
    sequence pairs, aligned together in one batch."""
    a = [encode(x, alphabet) for x, _ in pairs]
    b = [encode(y, alphabet) for _, y in pairs]
    ptr, ends = forward(a, b, alphabet, dtype, device)
    out = []
    for p, end in enumerate(ends):
        host = ptr[p, :len(a[p]) + 1, :len(b[p]) + 1].cpu().numpy()
        out.append(traceback(host, end))
        del host
    return out
