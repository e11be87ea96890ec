"""POAR consensus alignment: union-find over residues with conflict and
cycle rejection, then a cycle-tolerant DFS topological sort of columns.

Host-side by design: output-dependent pointer-chasing graph algorithm
with negligible runtime relative to the DP (reference:
lib/src/consensus_msa.c:12-554).  A copy of kalign_tpu/consensus.py:
build_consensus runs the native runtime's kt_consensus_columns
(native/src/kt_consensus.cpp) and has no other route; build_consensus_py
is the Python model the tests hold it against.  Merge order (descending support,
stable within equal support) and the DFS stack discipline replicate the
reference exactly, including its bounded (4096) BFS queue during cycle
checks.
"""

from typing import List, Tuple

import numpy as np

from kalign_tpu_torch import native
from kalign_tpu_torch.poar import PoarTable, pos_matrix, pair_index


class _UnionFind:
    def __init__(self, n: int, elem_seq: List[int], numseq: int):
        self.parent = list(range(n))
        self.rank = [0] * n
        self.elem_seq = elem_seq
        # python int bitmask per root
        self.seq_mask = [1 << elem_seq[i] for i in range(n)]
        self.set_head = list(range(n))
        self.next_in_set = [-1] * n

    def find(self, x: int) -> int:
        p = self.parent
        while p[x] != x:
            p[x] = p[p[x]]
            x = p[x]
        return x


def _dag_reachable(uf: _UnionFind, start: int, target: int,
                   seq_offsets, seq_lengths, visited, visit_id) -> bool:
    if start == target:
        return True
    queue = [0] * 4096
    head = tail = 0
    queue[tail] = start
    tail += 1
    visited[start] = visit_id
    while head < tail:
        cur = queue[head]
        head += 1
        elem = uf.set_head[cur]
        while elem >= 0:
            s = uf.elem_seq[elem]
            pos = elem - seq_offsets[s]
            if pos + 1 < seq_lengths[s]:
                succ_root = uf.find(seq_offsets[s] + pos + 1)
                if succ_root == target:
                    return True
                if succ_root != cur and visited[succ_root] != visit_id:
                    visited[succ_root] = visit_id
                    if tail < 4096:  # bounded queue, same as reference
                        queue[tail] = succ_root
                        tail += 1
            elem = uf.next_in_set[elem]
    return False


def _union_safe(uf: _UnionFind, a: int, b: int, seq_offsets, seq_lengths,
                visited, visit_counter) -> int:
    ra = uf.find(a)
    rb = uf.find(b)
    if ra == rb:
        return visit_counter
    if uf.seq_mask[ra] & uf.seq_mask[rb]:
        return visit_counter  # same-sequence conflict
    visit_counter += 1
    if _dag_reachable(uf, ra, rb, seq_offsets, seq_lengths, visited,
                      visit_counter):
        return visit_counter
    visit_counter += 1
    if _dag_reachable(uf, rb, ra, seq_offsets, seq_lengths, visited,
                      visit_counter):
        return visit_counter
    if uf.rank[ra] < uf.rank[rb]:
        new_root, old_root = rb, ra
        uf.parent[ra] = rb
    elif uf.rank[ra] > uf.rank[rb]:
        new_root, old_root = ra, rb
        uf.parent[rb] = ra
    else:
        new_root, old_root = ra, rb
        uf.parent[rb] = ra
        uf.rank[ra] += 1
    uf.seq_mask[new_root] |= uf.seq_mask[old_root]
    if uf.set_head[old_root] >= 0:
        tail = uf.set_head[new_root]
        if tail < 0:
            uf.set_head[new_root] = uf.set_head[old_root]
        else:
            while uf.next_in_set[tail] >= 0:
                tail = uf.next_in_set[tail]
            uf.next_in_set[tail] = uf.set_head[old_root]
    uf.set_head[old_root] = -1
    return visit_counter


def _topo_sort(col_id, seq_offsets, seq_lengths, numseq, n_cols):
    """DFS topological sort skipping back edges (consensus_msa.c:247-370)."""
    adj = [[] for _ in range(n_cols)]
    for s in range(numseq):
        off = seq_offsets[s]
        for pos in range(seq_lengths[s] - 1):
            ca = col_id[off + pos]
            cb = col_id[off + pos + 1]
            if ca != cb and cb not in adj[ca]:
                adj[ca].append(cb)
    out = [0] * n_cols
    out_idx = n_cols - 1
    state = [0] * n_cols
    for start in range(n_cols):
        if state[start]:
            continue
        stack = [(start, 0)]
        state[start] = 1
        while stack:
            node, edge_idx = stack.pop()
            pushed = False
            for e in range(edge_idx, len(adj[node])):
                nxt = adj[node][e]
                if state[nxt] == 0:
                    stack.append((node, e + 1))
                    stack.append((nxt, 0))
                    state[nxt] = 1
                    pushed = True
                    break
            if not pushed:
                state[node] = 2
                out[out_idx] = node
                out_idx -= 1
    return out


def build_consensus(table: PoarTable, ungapped_rows: List[str],
                    min_support: int) -> List[str]:
    """Build consensus alignment rows from the POAR table
    (build_consensus, consensus_msa.c:372-554).  The union-find/topo-sort
    core runs in the native library (build_consensus_py is its Python
    model, for the tests)."""
    numseq = len(ungapped_rows)
    seq_lengths = np.array([len(r) for r in ungapped_rows], dtype=np.int32)
    seq_offsets = np.zeros(numseq, dtype=np.int64)
    seq_offsets[1:] = np.cumsum(seq_lengths[:-1])
    total = int(seq_lengths.sum())

    cand_ei, cand_ej, cand_sup = [], [], []
    for i in range(numseq - 1):
        for j in range(i + 1, numseq):
            p = pair_index(i, j, numseq)
            sup = table._sup(p)
            sel = sup >= min_support
            keys = table.keys[p][sel]
            cand_ei.append(seq_offsets[i] + (keys >> 20))
            cand_ej.append(seq_offsets[j] + (keys & 0xFFFFF))
            cand_sup.append(sup[sel])
    cand_ei = np.concatenate(cand_ei) if cand_ei else np.empty(0, np.int64)
    cand_ej = np.concatenate(cand_ej) if cand_ej else np.empty(0, np.int64)
    cand_sup = np.concatenate(cand_sup) if cand_sup else np.empty(0, np.int32)

    colpos = np.zeros(total, dtype=np.int32)
    n_cols = native.lib().kt_consensus_columns(
        seq_lengths, numseq,
        np.ascontiguousarray(cand_ei, dtype=np.int64),
        np.ascontiguousarray(cand_ej, dtype=np.int64),
        np.ascontiguousarray(cand_sup, dtype=np.int32),
        len(cand_sup), colpos)

    rows = []
    for s in range(numseq):
        buf = np.full(n_cols, ord("-"), dtype=np.uint8)
        off = int(seq_offsets[s])
        cp = colpos[off:off + int(seq_lengths[s])]
        buf[cp] = np.frombuffer(ungapped_rows[s].encode("ascii"), dtype=np.uint8)
        rows.append(buf.tobytes().decode("ascii"))
    return rows


def build_consensus_py(table: PoarTable, ungapped_rows: List[str],
                       min_support: int) -> List[str]:
    """Pure-Python reference implementation (slow, used in tests)."""
    numseq = len(ungapped_rows)
    seq_lengths = [len(r) for r in ungapped_rows]
    seq_offsets = []
    total = 0
    for l in seq_lengths:
        seq_offsets.append(total)
        total += l
    elem_seq = [0] * total
    for s in range(numseq):
        for p in range(seq_lengths[s]):
            elem_seq[seq_offsets[s] + p] = s

    uf = _UnionFind(total, elem_seq, numseq)
    visited = [0] * total
    visit_counter = 0

    # candidates in pair order / key order, counting-sorted by support desc
    candidates = []  # (elem_i, elem_j, support)
    for i in range(numseq - 1):
        for j in range(i + 1, numseq):
            p = pair_index(i, j, numseq)
            sup = table._sup(p)
            for key, support in zip(table.keys[p].tolist(), sup.tolist()):
                if support >= min_support:
                    candidates.append((seq_offsets[i] + (key >> 20),
                                       seq_offsets[j] + (key & 0xFFFFF),
                                       support))
    # stable counting sort descending by support
    buckets = {}
    for c in candidates:
        buckets.setdefault(c[2], []).append(c)
    ordered = []
    for sup in range(32, 0, -1):
        ordered.extend(buckets.get(sup, []))

    for ei, ej, _ in ordered:
        visit_counter = _union_safe(uf, ei, ej, seq_offsets, seq_lengths,
                                    visited, visit_counter)

    # roots -> column ids in first-seen element order
    root_to_col = {}
    col_id = [0] * total
    n_cols = 0
    for i in range(total):
        root = uf.find(i)
        if root not in root_to_col:
            root_to_col[root] = n_cols
            n_cols += 1
        col_id[i] = root_to_col[root]

    order = _topo_sort(col_id, seq_offsets, seq_lengths, numseq, n_cols)
    col_order = [0] * n_cols
    for i, c in enumerate(order):
        col_order[c] = i

    rows = []
    for s in range(numseq):
        buf = ["-"] * n_cols
        off = seq_offsets[s]
        for pos in range(seq_lengths[s]):
            buf[col_order[col_id[off + pos]]] = ungapped_rows[s][pos]
        rows.append("".join(buf))
    return rows


def residue_confidence(table: PoarTable, rows: List[str]):
    """Per-residue and per-column confidence
    (compute_residue_confidence, consensus_msa.c:564-686)."""
    numseq = len(rows)
    alnlen = len(rows[0])
    pos = pos_matrix(rows)
    n_aln = table.n_alignments
    conf = np.zeros((numseq, alnlen), dtype=np.float64)
    sum_support = np.zeros((numseq, alnlen), dtype=np.float64)
    n_pairs = np.zeros((numseq, alnlen), dtype=np.int64)
    for i in range(numseq - 1):
        pi = pos[i]
        for j in range(i + 1, numseq):
            pj = pos[j]
            both = (pi >= 0) & (pj >= 0)
            keys = ((pi[both].astype(np.int64) << 20) |
                    pj[both].astype(np.int64))
            support = table.lookup_support(i, j, keys)
            sum_support[i, both] += support
            sum_support[j, both] += support
            n_pairs[i, both] += 1
            n_pairs[j, both] += 1
    ok = (n_pairs > 0) & (n_aln > 0)
    conf[ok] = sum_support[ok] / (n_pairs[ok] * float(n_aln))
    conf[pos < 0] = 0.0
    col_conf = np.zeros(alnlen, dtype=np.float64)
    isres = pos >= 0
    counts = isres.sum(axis=0)
    with np.errstate(invalid="ignore"):
        col_conf = np.where(counts > 0,
                            (conf * isres).sum(axis=0) / np.maximum(counts, 1),
                            0.0)
    return conf.astype(np.float32), col_conf.astype(np.float32)
