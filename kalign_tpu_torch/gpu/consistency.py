"""Anchor-consistency tables (default mode), host numpy.

Counterpart of kalign_tpu/tpu/consistency.py, the model of the reference's
lib/src/anchor_consistency.c: K diverse anchors picked farthest-first on
the per-sequence mean distances; a residue -> anchor position map per
(sequence, anchor) from pairwise alignments (N x K leaf DPs, run on the
card by GpuEngine.dp_leaf_batch); per-merge bonus inputs from
majority-vote column -> anchor maps.
"""

from dataclasses import dataclass
from typing import List

import numpy as np

from kalign_tpu_torch.core import params as P


def select_anchors(seq_dist: np.ndarray, K: int) -> List[int]:
    n = len(seq_dist)
    K = min(K, n)
    mean = float(np.mean(seq_dist))
    first = int(np.argmin(np.abs(seq_dist - mean)))
    anchors = [first]
    min_dist = np.abs(seq_dist - seq_dist[first])
    for _ in range(1, K):
        cand = min_dist.copy()
        cand[np.asarray(anchors)] = -1.0
        nxt = int(np.argmax(cand))
        anchors.append(nxt)
        min_dist = np.minimum(min_dist, np.abs(seq_dist - seq_dist[nxt]))
    return anchors


@dataclass
class ConsistencyTable:
    K: int
    weight: float
    anchor_ids: List[int]
    pos_maps: List[np.ndarray]  # [numseq * K], map[p] = anchor pos or -1
    numseq: int

    @classmethod
    def build(cls, engine, codes, ap: P.AlnParam, seq_dist: np.ndarray,
              K: int, weight: float) -> "ConsistencyTable":
        """None below 3 sequences; otherwise every sequence mapped onto
        every anchor, the shorter of the two on the DP's rows."""
        n = len(codes)
        if K <= 0 or n < 3 or seq_dist is None:
            return None
        K = min(K, n)
        anchors = select_anchors(seq_dist, K)
        maps: List[np.ndarray] = [None] * (n * K)
        base = P.AlnParam(**{**ap.__dict__})
        base.subm_offset = 0.0
        jobs = []      # (i, k, swapped)
        pairs = []     # (rows_seq_idx, cols_seq_idx)
        for i in range(n):
            li = len(codes[i])
            for k, ak in enumerate(anchors):
                if i == ak:
                    maps[i * K + k] = np.arange(li, dtype=np.int64)
                    continue
                if li <= len(codes[ak]):
                    pairs.append((i, ak))
                    jobs.append((i, k, False))
                else:
                    pairs.append((ak, i))
                    jobs.append((i, k, True))
        maps_spec = [(len(codes[i]), swapped) for i, _, swapped in jobs]
        all_maps = engine.dp_leaf_batch(codes, pairs, base, maps_spec)
        for (i, k, _), m in zip(jobs, all_maps):
            maps[i * K + k] = m
        return cls(K=K, weight=weight, anchor_ids=anchors, pos_maps=maps,
                   numseq=n)

    # ------------------------------------------------------------------
    def bonus_arrays(self, rows_node, len_r, cols_node, len_c,
                     sip, nsip, gaps, lens):
        """Compact bonus inputs: (apos_r, conf_r [K, len_r], apos_c,
        conf_c [K, len_c]).  The columns side keeps, per anchor position,
        only the LAST column that maps to it (the winner of the
        reference's inverse-map build, anchor_consistency.c:469-561), so
        that

          bonus[i, j] = sum_k per_w * conf_r[k,i] * conf_c[k,j]
                        * [apos_r[k,i] == apos_c[k,j] >= 0]

        is the reference's bonus matrix."""
        apos_r, conf_r = self._node_positions_all(rows_node, len_r, sip,
                                                  nsip, gaps, lens)
        apos_c, conf_c = self._node_positions_all(cols_node, len_c, sip,
                                                  nsip, gaps, lens)
        apos_c = apos_c.copy()
        conf_c = conf_c.copy()
        for k in range(self.K):
            pc = apos_c[k]
            sel = pc >= 0
            if sel.any():
                winner = np.full(int(pc.max()) + 1, -1, np.int64)
                winner[pc[sel]] = np.nonzero(sel)[0]
                keep = np.zeros(len_c, bool)
                keep[winner[winner >= 0]] = True
                apos_c[k] = np.where(keep, pc, -1)
                conf_c[k] = np.where(keep, conf_c[k], 0.0)
        return apos_r, conf_r, apos_c, conf_c

    def _node_positions_all(self, node, dp_len, sip, nsip, gaps, lens):
        """Every anchor's consensus position and confidence for each
        column of a node (anchor_consistency.c:352-467): a leaf reads its
        maps; a profile takes, per column, the first member's anchor
        position and the share of members that agree with it."""
        K = self.K
        if nsip[node] == 1:
            maps = self.pos_maps[node * K:(node + 1) * K]
            pos = np.full((K, dp_len), -1, dtype=np.int32)
            conf = np.zeros((K, dp_len), dtype=np.float32)
            upto = min(dp_len, len(maps[0]))
            for k in range(K):
                pos[k, :upto] = maps[k][:upto]
            conf[:, :upto] = (pos[:, :upto] >= 0)
            return pos, conf
        best = np.full((K, dp_len), -1, dtype=np.int64)
        agree = np.zeros((K, dp_len), dtype=np.int64)
        total = np.zeros((K, dp_len), dtype=np.int64)
        for si in sip[node]:
            if si >= self.numseq:
                continue
            g = np.asarray(gaps[si], dtype=np.int64)
            L = lens[si]
            # column -> ungapped residue index (or -1)
            col_res = np.full(int(g.sum()) + L, -1, dtype=np.int64)
            col_res[np.cumsum(g[:-1] + 1) - 1] = np.arange(L)
            col_res = col_res[:dp_len]
            idx = np.nonzero(col_res >= 0)[0]
            mstack = np.stack(
                [self.pos_maps[si * K + k] for k in range(K)])  # [K, L]
            apos = np.full((K, dp_len), -1, dtype=np.int64)
            apos[:, idx] = mstack[:, col_res[idx]]
            has = apos >= 0
            total += has
            fresh = (best < 0) & has
            best[fresh] = apos[fresh]
            agree += has & (apos == best)
        ok = (total > 0) & (agree > 0)
        pos = np.where(ok, best, -1).astype(np.int32)
        conf = np.zeros((K, dp_len), dtype=np.float32)
        conf[ok] = agree[ok] / total[ok]
        return pos, conf

    @property
    def per_weight(self) -> np.float32:
        return np.float32(self.weight / self.K)
