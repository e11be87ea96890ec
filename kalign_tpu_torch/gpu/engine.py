"""GPU engine: progressive MSA with the DP on the card.

Counterpart of kalign_tpu/tpu/engine.py::TpuEngine in its host-assembled,
single-device form (the ``KALIGN_TPU_NO_RESIDENT=1`` configuration):

  * anchor distances: the BPM kernel (gpu/distances.py);
  * guide tree: the native builder (native/);
  * progressive pass: level-synchronous — all merges of one guide-tree
    level are independent, so they are bucketed by padded shape and each
    bucket runs as one batch: an fp32 ``torch.bmm`` for the match scores,
    the row Gotoh kernel (or, for buckets padding to k * 1024 problems,
    the problem-per-lane kernel), and the traceback walk on the card;
    only step lists come back.  Profile merge and gap weave stay numpy
    (gpu/profile.py).

Every kernel wrapper runs its plain PyTorch version when the engine's
device is the CPU; the routing is the same on both devices.

Contract: the same pipeline semantics as the host engine; alignments are
score-optimal per merge and may differ from other engines on near-ties.
"""

from typing import List, Optional

import numpy as np
import torch

from kalign_tpu_torch import native
from kalign_tpu_torch.core import params as P
from kalign_tpu_torch.gpu import distances, gotoh_lanewise, gotoh_row
from kalign_tpu_torch.gpu import traceback as tb
from kalign_tpu_torch.gpu.profile import (Profile, leaf_profile,
                                          merge_profiles, weave_steps)


def _bucket(n: int, q: int = 128) -> int:
    return max(q, ((n + q - 1) // q) * q)


def _pow2_batch(B: int) -> int:
    """Launch batches are powers of two (min 8), as in the TPU engine, so
    the two engines bucket and route merges alike."""
    p = 8
    while p < B:
        p *= 2
    return p


def terminal_mask(steps: np.ndarray) -> np.ndarray:
    n = len(steps)
    term = np.zeros(n, dtype=bool)
    i = 0
    while i < n and steps[i] != 0:
        term[i] = True
        i += 1
    i = n - 1
    while i >= 0 and steps[i] != 0:
        term[i] = True
        i -= 1
    return term


class GpuEngine:
    # cap on the [B, L1p, L2p] match bytes of one launch; bigger buckets
    # split into chunked launches
    MAX_MATCH_BYTES = 1 << 30
    # centering-bias strength of --fast merges (tpu/engine.py:686)
    EPS = 1e-3

    def __init__(self, device):
        self.device = torch.device(device)
        # the match product is a full-fp32 bmm (the JAX engine leaves it
        # to XLA at f32): TF32 would round the scores to ~3 digits
        torch.backends.cuda.matmul.allow_tf32 = False
        # per-run routing counts: merges per kernel, bucket sizes per
        # level, and each launch batch's shape and lengths (la, lb)
        self.stats = {"row_merges": 0, "lanewise_merges": 0, "levels": [],
                      "batches": []}

    # ------------------------------------------------------------------
    def anchor_distances(self, codes, anchors):
        return distances.anchor_distances(codes, anchors, self.device)

    def build_tree(self, codes, dm, n_anchors):
        return native.build_tree(codes, dm, n_anchors)

    # ------------------------------------------------------------------
    @staticmethod
    def lanewise_ok(Bp: int) -> bool:
        return Bp % gotoh_lanewise.BT == 0 and Bp >= gotoh_lanewise.BT

    def max_launch(self, L1p: int, L2p: int) -> int:
        cap = max(8, self.MAX_MATCH_BYTES // (L1p * L2p * 4))
        p = 8
        while p * 2 <= cap:
            p *= 2
        return p

    def dispatch_bucket(self, lhs, rhs, pc, pr, la, lb, eps):
        """Queue match product + forward + walk for one bucket on the
        device (nothing is fetched).  The bucket arrives padded to a power
        of two (``align``), so every chunk is one too.  Returns a handle
        for collect_bucket."""
        B = lhs.shape[0]
        L1p, L2p = lhs.shape[1], rhs.shape[1]
        cap = self.max_launch(L1p, L2p)
        if B > cap:
            return ("multi", [
                self.dispatch_bucket(lhs[lo:lo + cap], rhs[lo:lo + cap],
                                     pc[lo:lo + cap], pr[lo:lo + cap],
                                     la[lo:lo + cap], lb[lo:lo + cap],
                                     eps[lo:lo + cap])
                for lo in range(0, B, cap)])
        dev = self.device

        def put(x):
            t = torch.from_numpy(np.ascontiguousarray(x))
            if dev.type != "cuda":
                return t
            # pinned and asynchronous: a pageable copy would wait for the
            # stream, and the level's buckets could not queue behind one
            # another
            return t.pin_memory().to(dev, non_blocking=True)

        lhs_d, rhs_d, pc_d, pr_d = put(lhs), put(rhs), put(pc), put(pr)
        la_d, lb_d, eps_d = put(la), put(lb), put(eps)
        match = torch.bmm(lhs_d, rhs_d.transpose(1, 2))       # fp32
        slope = lb_d.to(torch.float32) / torch.clamp(
            la_d.to(torch.float32), min=1.0)
        max_steps = L1p + L2p + 2
        self.stats["batches"].append(
            {"lanewise": self.lanewise_ok(B), "L1p": L1p, "L2p": L2p,
             "la": la.copy(), "lb": lb.copy()})
        if self.lanewise_ok(B):
            dec, score, st = gotoh_lanewise.forward(
                match, pc_d, pr_d, la_d, lb_d, slope, eps_d)
            steps, n = tb.walk_lanewise(dec, la_d, lb_d, st, max_steps)
            self.stats["lanewise_merges"] += B
        else:
            dec, score, st = gotoh_row.forward(
                match, pc_d, pr_d, la_d, lb_d, slope, eps_d)
            steps, n = tb.walk_rows(dec, la_d, lb_d, st, max_steps)
            self.stats["row_merges"] += B
        return ("walked", steps, n, score, B)

    def collect_bucket(self, handle):
        """Fetch one bucket's step lists: ([steps per merge], scores)."""
        if handle[0] == "multi":
            steps, scores = [], []
            for h in handle[1]:
                s, sc = self.collect_bucket(h)
                steps.extend(s)
                scores.append(sc)
            return steps, np.concatenate(scores)
        _, steps, n, score, B = handle
        steps = steps[:B].cpu().numpy()
        n = n[:B].cpu().numpy()
        score = score[:B].cpu().numpy()
        return ([steps[b, :n[b]] for b in range(B)],
                score.astype(np.float64))

    # ------------------------------------------------------------------
    def align(self, codes, tasks, ap: P.AlnParam, seq_distances):
        """One bottom-up --fast progressive pass (tpu/engine.py:731-901).
        Returns (gaps per sequence, per-merge scores indexed like the
        tasks sorted by parent id)."""
        sd = None if seq_distances is None else np.asarray(seq_distances)
        n = len(codes)
        nprof = 2 * n - 1
        lens = [len(c) for c in codes]
        gaps = [[0] * (l + 1) for l in lens]
        sip: List[Optional[List[int]]] = [[i] for i in range(n)] + \
            [None] * (n - 1)
        nsip = [1] * n + [0] * (n - 1)
        profiles: List[Optional[Profile]] = [None] * nprof
        conf = np.zeros(n - 1, dtype=np.float32)

        order = np.asarray(tasks)[np.argsort(np.asarray(tasks)[:, 2])]
        task_index = {int(c): t for t, (_, _, c) in enumerate(order)}

        level = {i: 0 for i in range(n)}
        levels: List[List[int]] = []
        for a, b, c in order:
            lv = 1 + max(level[int(a)], level[int(b)])
            level[int(c)] = lv
            while len(levels) < lv:
                levels.append([])
            levels[lv - 1].append(int(c))

        for lv_nodes in levels:
            batch = []
            for c in lv_nodes:
                t_idx = task_index[c]
                a, b = int(order[t_idx][0]), int(order[t_idx][1])
                eff = self.effective(ap, sd, sip, a, b, n)
                pa = self.node_profile(profiles, codes, a, nsip, eff)
                pb = self.node_profile(profiles, codes, b, nsip, eff)
                leaf_a = nsip[a] == 1
                leaf_b = nsip[b] == 1
                if leaf_a and not leaf_b:
                    rows_node = b
                elif leaf_b and not leaf_a:
                    rows_node = a
                elif pa.length <= pb.length:
                    rows_node = a
                else:
                    rows_node = b
                cols_node = b if rows_node == a else a
                prof_r = pa if rows_node == a else pb
                prof_c = pb if rows_node == a else pa
                cols_is_leaf = nsip[cols_node] == 1 and not (leaf_a and leaf_b)
                batch.append((c, a, b, rows_node, cols_node, prof_r, prof_c,
                              cols_is_leaf))

            buckets = {}
            for item in batch:
                key = (_bucket(item[5].length), _bucket(item[6].length))
                buckets.setdefault(key, []).append(item)
            self.stats["levels"].append(
                {f"{k[0]}x{k[1]}": len(v) for k, v in buckets.items()})

            # dispatch every bucket of the level, then collect
            dispatched = []
            for (L1p, L2p), items in buckets.items():
                B = len(items)
                Ba = _pow2_batch(B)
                pc = np.zeros((Ba, 3, L2p + 1), np.float32)
                pr = np.zeros((Ba, 3, L1p + 1), np.float32)
                la = np.full(Ba, 8, np.int32)
                lb = np.full(Ba, 8, np.int32)
                lhs = np.zeros((Ba, L1p, 23), np.float32)
                rhs = np.zeros((Ba, L2p, 23), np.float32)
                for k, (c, a, b, rn, cn, prof_r, prof_c, cif) in \
                        enumerate(items):
                    la[k] = prof_r.length
                    lb[k] = prof_c.length
                    if cif:
                        lhs[k, :la[k]] = prof_r.subrows
                        rhs[k, :lb[k]] = prof_c.counts
                    else:
                        lhs[k, :la[k]] = prof_r.counts
                        rhs[k, :lb[k]] = prof_c.subrows
                    pc[k, :, 1:lb[k] + 1] = (prof_c.pen[1:-1] *
                                             np.float32(nsip[rn])).T
                    pr[k, :, 1:la[k] + 1] = (prof_r.pen[1:-1] *
                                             np.float32(nsip[cn])).T
                # pad problems are 8 x 8 with copies of the last real
                # problem's penalties
                if Ba > B:
                    pc[B:] = pc[B - 1]
                    pr[B:] = pr[B - 1]
                eps = np.full(Ba, self.EPS, np.float32)
                dispatched.append((items, self.dispatch_bucket(
                    lhs, rhs, pc, pr, la, lb, eps)))

            for items, handle in dispatched:
                steps_list, scores = self.collect_bucket(handle)
                for k, (c, a, b, rn, cn, prof_r, prof_c, _) in \
                        enumerate(items):
                    steps_rc = np.asarray(steps_list[k], np.int8)
                    if rn == a:
                        steps = steps_rc
                    else:
                        steps = np.where(steps_rc == 1, 2,
                                         np.where(steps_rc == 2, 1,
                                                  0)).astype(np.int8)
                    conf[task_index[c]] = scores[k]
                    terminal = terminal_mask(steps)
                    prof_a = prof_r if rn == a else prof_c
                    prof_b = prof_c if rn == a else prof_r
                    profiles[c] = merge_profiles(prof_a, prof_b, steps,
                                                 terminal, nsip[a], nsip[b],
                                                 ap.gpo, ap.gpe, ap.tgpe)
                    profiles[a] = None
                    profiles[b] = None
                    weave_steps(steps, gaps, sip[a], sip[b])
                    nsip[c] = nsip[a] + nsip[b]
                    sip[c] = list(reversed(sip[a])) + list(reversed(sip[b]))
        return gaps, conf

    # ------------------------------------------------------------------
    @staticmethod
    def effective(ap: P.AlnParam, sd, sip, a, b, n):
        """Distance-scaled penalties and the VSM substitution offset of
        one merge (tpu/engine.py:962-978)."""
        gs, so = 1.0, 0.0
        if sd is not None:
            members = [s for s in sip[a] if s < n] + \
                [s for s in sip[b] if s < n]
            if members:
                avg = float(np.mean(sd[members], dtype=np.float64))
                if ap.dist_scale > 0.0:
                    gs = min(1.0, max(0.3, 1.0 - ap.dist_scale * avg))
                if ap.vsm_amax > 0.0:
                    so = max(0.0, ap.vsm_amax - avg)
        eff = P.AlnParam(**{**ap.__dict__})
        if gs < 1.0 or so > 0.0:
            eff.gpo = ap.gpo * gs
            eff.gpe = ap.gpe * gs
            eff.tgpe = ap.tgpe * gs
            eff.subm_offset = so
        return eff

    @staticmethod
    def node_profile(profiles, codes, node, nsip, eff: P.AlnParam):
        if profiles[node] is None:
            assert nsip[node] == 1
            profiles[node] = leaf_profile(codes[node], eff.subm, eff.gpo,
                                          eff.gpe, eff.tgpe, eff.subm_offset)
        return profiles[node]
