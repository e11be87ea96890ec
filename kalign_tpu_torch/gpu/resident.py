"""Device-resident progressive pass.

Counterpart of kalign_tpu/tpu/resident.py (``ResidentPass``, with the
refinement candidates of ``_bucket_step_refine``).  The host-assembled pass
(``GpuEngine(device, resident=False)``) assembles every bucket in numpy,
builds each merge's bonus arrays in a Python loop, fetches each bucket's
step lists and merges and weaves on the host.  This pass keeps the whole
progressive state on the engine's device between guide-tree levels:

  live store  counts [R, Lc, 23], subrows [R, Lc, 23], pen [R, Lc, 3]
              (f32): the profiles of the merged nodes not yet consumed,
              one row ("slot") each; leaves are built from the token table
  gaps_buf    [n, Lg] int32: every sequence's gap list (the weave state)
  posmap      [n, K, Lt] int64 (default mode): residue -> anchor position

Per level the host orients the merges and buckets them by padded shape
from the lengths it knows; each bucket's operands are gathered on the
device (``produce_operands``), its forward DP and walk go through
``GpuEngine.launch_bucket`` (the host pass's routing, match product and
kernels, in the host pass's batch shapes), and its merged profiles and
gap lists are built on the device (``merge_from_steps``,
``gap_profiles``, ``weave_apply``; ``node_positions`` votes default
mode's bonus arrays from the resident gap state).  The one transfer to
the host per level is the packed vector of new profile lengths, which
the next level's bucketing needs; the gap lists and the per-merge scores
come back in one transfer at the end.

Every operation here is plain PyTorch in the float order of the host
pass (gpu/profile.py, gpu/consistency.py), so on the CPU the two passes
give the same bytes.  The merges work in the DP's rows/columns space: a
profile merge adds the two sides' columns, and IEEE addition commutes, so
mirroring the path into the task's a/b order first (as the reference
does) would change no bit.
"""

from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from kalign_tpu_torch.gpu import traceback as tb
from kalign_tpu_torch.gpu.engine import _bucket, _pow2_batch, level_buckets

NALPHA = 23

# live-store shrink-compactions in this process (a test reads it)
_compactions = 0

# per-problem int32 fields of a bucket, one row each of one upload
FIELDS = ("rows_slot", "cols_slot", "rows_leaf", "cols_leaf", "rows_is_leaf",
          "cols_is_leaf", "cif", "real", "len_r", "len_c", "la", "lb",
          "nsip_r", "nsip_c")
_F = {k: i for i, k in enumerate(FIELDS)}
# per-problem float32 fields: the leaf build's VSM offset and penalties,
# and the merge's gap charges (terminal / interior, rows / columns side)
FFIELDS = ("soff", "pen_go", "pen_ge", "pen_tge", "gp_term_r", "gp_int_r",
           "gp_term_c", "gp_int_c")
_FF = {k: i for i, k in enumerate(FFIELDS)}


def _width(x, W: int):
    """x [R, L, ...] cut or zero-padded to W along dim 1."""
    if x.shape[1] >= W:
        return x[:, :W]
    pad = [0, 0] * (x.dim() - 2) + [0, W - x.shape[1]]
    return F.pad(x, pad)


def gather_side(live, tokens, subm, slot, leaf, is_leaf, length, soff,
                eff_pen, Lp: int):
    """One DP side of a batch: counts [B, Lp, 23], subrows [B, Lp, 23] and
    pen [B, Lp, 3], zero past each problem's length.  A leaf is built from
    its tokens as gpu/profile.py::leaf_profile builds it (one-hot counts,
    substitution rows minus the VSM offset, the merge's penalties); a
    merged node is read from its live slot."""
    dev = tokens.device
    B = slot.shape[0]
    valid = (torch.arange(Lp, device=dev)[None, :] < length[:, None])[..., None]
    toks = _width(tokens[:, :Lp][leaf.long()], Lp).long()
    alpha = torch.arange(NALPHA, device=dev)
    leaf_c = (toks[..., None] == alpha).to(torch.float32)
    leaf_s = subm[toks] - soff[:, None, None]
    leaf_p = eff_pen[:, None, :].expand(B, Lp, 3)
    sel = is_leaf.bool()[:, None, None]
    s = slot.long()
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    out = []
    for leaf_x, store in zip((leaf_c, leaf_s, leaf_p), live):
        x = torch.where(sel, leaf_x, _width(store[:, :Lp][s], Lp))
        out.append(torch.where(valid, x, zero))
    return out


def produce_operands(live, tokens, subm, fi, ff, L1p: int, L2p: int):
    """A chunk's DP operands (kalign_tpu/tpu/resident.py::_produce_operands
    :71, in the host pass's values: gpu/engine.py::GpuEngine.host_pass):
    lhs [B, L1p, 23], rhs [B, L2p, 23] (the columns side's counts and the
    rows side's substitution rows when the columns side is the leaf,
    zero for pad problems), pc [B, 3, L2p + 1], pr [B, 3, L1p + 1] (each
    side's penalties times the other side's member count, 1-based), and
    the two sides for the merge.  fi / ff: the chunk's FIELDS / FFIELDS
    rows on the device."""
    eff_pen = ff[[_FF["pen_go"], _FF["pen_ge"], _FF["pen_tge"]]].T
    soff = ff[_FF["soff"]]
    r = gather_side(live, tokens, subm, fi[_F["rows_slot"]],
                    fi[_F["rows_leaf"]], fi[_F["rows_is_leaf"]],
                    fi[_F["len_r"]], soff, eff_pen, L1p)
    c = gather_side(live, tokens, subm, fi[_F["cols_slot"]],
                    fi[_F["cols_leaf"]], fi[_F["cols_is_leaf"]],
                    fi[_F["len_c"]], soff, eff_pen, L2p)
    cif = fi[_F["cif"]].bool()[:, None, None]
    real = fi[_F["real"]].bool()[:, None, None]
    zero = torch.zeros((), dtype=torch.float32, device=tokens.device)
    lhs = torch.where(real, torch.where(cif, r[1], r[0]), zero)
    rhs = torch.where(real, torch.where(cif, c[0], c[1]), zero)

    def pens(p, nsip_other):
        body = p * nsip_other.to(torch.float32)[:, None, None]
        return F.pad(body, (0, 0, 1, 0)).transpose(1, 2).contiguous()
    pc = pens(c[2], fi[_F["nsip_r"]])
    pr = pens(r[2], fi[_F["nsip_c"]])
    return lhs, rhs, pc, pr, (r, c)


def merge_from_steps(steps, n, sides, ff, L1p: int, L2p: int):
    """The merged profiles of a chunk along its paths
    (kalign_tpu/tpu/resident.py::_merge_from_steps :222, with the float
    operations of gpu/profile.py::merge_profiles): steps [B, S] in the
    DP's rows/columns space (0 match, 1 gap in the rows, 2 gap in the
    columns, 3 past n).  A match column adds the two sides' columns, a
    gap column copies the one side's; the substitution rows are then
    charged the gap extension (terminal or interior, times the gapped
    side's member count).  Returns counts, subrows [B, S - 2, 23] and pen
    [B, S - 2, 3]."""
    (rc_, rs_, rp_), (cc_, cs_, cp_) = sides
    B, S = steps.shape
    dev = steps.device
    t = torch.arange(S, device=dev)[None, :]
    valid = t < n[:, None].long()
    is_m = (steps == 0) & valid
    gap_r = (steps == 1) & valid
    gap_c = (steps == 2) & valid
    ri = (torch.cumsum(steps != 1, dim=1) - 1).clamp(0, L1p - 1)
    ci = (torch.cumsum(steps != 2, dim=1) - 1).clamp(0, L2p - 1)
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    def merged(rx, cx):
        w = rx.shape[2]
        R = rx.gather(1, ri[..., None].expand(B, S, w))
        C = cx.gather(1, ci[..., None].expand(B, S, w))
        return torch.where(is_m[..., None], R + C,
                           torch.where(gap_r[..., None], C,
                                       torch.where(gap_c[..., None], R,
                                                   zero)))
    # terminal columns: the leading and trailing runs without a match
    big = torch.full((), S, device=dev)
    first = torch.where(is_m, t, big).min(dim=1, keepdim=True).values
    last = torch.where(is_m, t, -1).max(dim=1, keepdim=True).values
    term = valid & ((t < first) | (t > last))
    g = {k: ff[_FF[k]][:, None] for k in ("gp_term_r", "gp_int_r",
                                          "gp_term_c", "gp_int_c")}
    gp = torch.where(gap_r & term, g["gp_term_r"],
                     torch.where(gap_r, g["gp_int_r"],
                                 torch.where(gap_c & term, g["gp_term_c"],
                                             torch.where(gap_c, g["gp_int_c"],
                                                         zero))))
    counts = merged(rc_, cc_)
    subrows = merged(rs_, cs_) - gp[..., None]
    pen = merged(rp_, cp_)
    return counts[:, :S - 2], subrows[:, :S - 2], pen[:, :S - 2]


def gap_profiles(steps, n):
    """Gaps each merge inserts before every residue of its sides
    (kalign_tpu/tpu/resident.py::_bucket_gap_profiles :560): [2 * B, S + 2]
    int64, the rows side's B rows first.  A rows-side gap is a step 1, at
    the count of rows consumed so far; a columns-side gap a step 2."""
    B, S = steps.shape
    dev = steps.device
    valid = torch.arange(S, device=dev)[None, :] < n[:, None].long()
    out = torch.zeros((2, B, S + 2), dtype=torch.int64, device=dev)
    for side, gap in ((0, 1), (1, 2)):
        pos = torch.cumsum(steps != gap, dim=1).clamp(max=S + 1)
        out[side].scatter_add_(1, pos, ((steps == gap) & valid).long())
    return out.reshape(2 * B, S + 2)


def weave_apply(gaps_buf, gap_rows, mem_seq, mem_row, mem_len):
    """Compose a chunk's inserted gaps into its members' gap lists, in
    place (kalign_tpu/tpu/resident.py::_weave_apply :580, the integer
    arithmetic of gpu/profile.py::weave_steps).  gap_rows [2B, S + 2] from
    gap_profiles; mem_* [m]: sequence, row of gap_rows, length."""
    S2 = gap_rows.shape[1]
    newg = gap_rows[mem_row]
    scum = F.pad(torch.cumsum(newg, dim=1), (1, 0))
    g = gaps_buf[mem_seq].long()
    rel = F.pad(torch.cumsum(g + 1, dim=1)[:, :-1], (1, 0))
    hi = (rel + g + 1).clamp(0, S2)
    lo = rel.clamp(0, S2)
    add = scum.gather(1, hi) - scum.gather(1, lo)
    pos = torch.arange(g.shape[1], device=g.device)[None, :]
    g_new = torch.where(pos <= mem_len[:, None].long(), g + add, g)
    gaps_buf[mem_seq] = g_new.to(gaps_buf.dtype)


def node_positions(gaps_buf, posmap, seq_lens, mem_seq, mem_node, mem_ord,
                   n_nodes: int, Lp: int, dedup: bool):
    """Consensus anchor position and confidence of every column of a batch
    of nodes, from the resident gap state
    (kalign_tpu/tpu/resident.py::_node_positions_device :482; the host
    pass's gpu/consistency.py::ConsistencyTable.bonus_arrays).  A column's
    position per anchor is the first member's, in member order (mem_ord),
    that maps a residue there; its confidence the share of the members
    mapped there that agree, divided in float64 and rounded to float32 as
    the host divides.  dedup keeps, per anchor position, only the last
    column that maps to it (the columns side).  Keys are int64, so no
    size of input overflows them.  Returns pos [N, K, Lp] int32 (-1 for
    none) and conf [N, K, Lp] f32."""
    dev = gaps_buf.device
    n, K, Lt = posmap.shape
    M = mem_seq.shape[0]
    g = gaps_buf[mem_seq].long()
    Lg = g.shape[1]
    col = torch.cumsum(g + 1, dim=1) - 1          # column of each residue
    ridx = torch.arange(Lg, device=dev)[None, :]
    ok_res = (ridx < seq_lens[mem_seq][:, None]) & (col < Lp)
    col_res = torch.full((M, Lp + 1), -1, dtype=torch.int64, device=dev)
    col_res.scatter_(1, torch.where(ok_res, col, Lp),
                     torch.where(ok_res, ridx.expand(M, Lg), -1))
    col_res = col_res[:, :Lp]
    apos = posmap[mem_seq].gather(
        2, col_res.clamp(min=0)[:, None, :].expand(M, K, Lp))
    apos = torch.where((col_res >= 0)[:, None, :], apos, -1)
    has = apos >= 0

    P = Lt + 1
    sent = n * P                                   # above every real key
    key = torch.where(has, mem_ord.long()[:, None, None] * P + apos, sent)
    seg = mem_node.long()[:, None, None].expand(M, K, Lp)
    first = torch.full((n_nodes, K, Lp), sent, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, seg, key, reduce="amin")
    best = torch.where(first < sent, first % P, -1)
    total = torch.zeros((n_nodes, K, Lp), dtype=torch.int64, device=dev)
    total.index_add_(0, mem_node.long(), has.long())
    agree = torch.zeros_like(total)
    agree.index_add_(0, mem_node.long(),
                     (has & (apos == best[mem_node.long()])).long())
    ok = (total > 0) & (agree > 0) & (best >= 0)
    pos = torch.where(ok, best, -1)
    conf = torch.where(ok, agree.double() / total.clamp(min=1).double(),
                       torch.zeros((), dtype=torch.float64, device=dev))
    if dedup:
        okp = pos >= 0
        tgt = torch.where(okp, pos, Lt)
        cidx = torch.arange(Lp, device=dev).expand(n_nodes, K, Lp)
        winner = torch.full((n_nodes, K, Lt + 1), -1, dtype=torch.int64,
                            device=dev)
        winner.scatter_reduce_(2, tgt, torch.where(okp, cidx, -1),
                               reduce="amax")
        keep = okp & (winner.gather(2, tgt) == cidx)
        pos = torch.where(keep, pos, -1)
        conf = torch.where(keep, conf, 0.0)
    return pos.to(torch.int32), conf.to(torch.float32)


def node_gap_counts(gaps_buf, seq_lens, mem_seq, mem_node, n_nodes: int,
                    Lp: int):
    """Residues per column of a batch of nodes from the resident gap state
    (kalign_tpu/tpu/resident.py::_node_gap_counts_device :458; a node's
    gap counts are its member count minus these, as
    gpu/profile.py::column_gap_counts counts them).  mem_seq / mem_node
    [M] list every node's members.  Returns [n_nodes, Lp] int64."""
    g = gaps_buf[mem_seq].long()
    M, Lg = g.shape
    col = torch.cumsum(g + 1, dim=1) - 1          # column of each residue
    ridx = torch.arange(Lg, device=g.device)[None, :]
    valid = (ridx < seq_lens[mem_seq][:, None]) & (col < Lp)
    pres = torch.zeros((M, Lp + 1), dtype=torch.int64, device=g.device)
    pres.scatter_add_(1, torch.where(valid, col, Lp), valid.long())
    out = torch.zeros((n_nodes, Lp), dtype=torch.int64, device=g.device)
    return out.index_add_(0, mem_node.long(), pres[:, :Lp])


def sp_scores(steps, nsteps, r_counts, c_counts, gaps_rows, gaps_cols,
              nsip_r, nsip_c, subm, base_pen, L1p: int, L2p: int):
    """Expected cross-group sum-of-pairs of a batch of candidate paths
    (kalign_tpu/tpu/resident.py::_sp_scores :337, compute_sp_score
    lib/src/sp_score.c:75-201), float32 in the DP's rows/columns space
    as the reference computes it (the host pass scores in float64:
    gpu/profile.py::sp_score_from_profiles).  steps [B, S], nsteps [B];
    r_counts [B, L1p, 23], c_counts [B, L2p, 23]; gaps_rows [B, L1p],
    gaps_cols [B, L2p] per-column gap counts; nsip_r / nsip_c [B];
    base_pen [B, 3] (gpo, gpe, tgpe).  Returns [B] float32."""
    B, S = steps.shape
    dev = steps.device
    f32 = torch.float32
    zero = torch.zeros((), dtype=f32, device=dev)
    t = torch.arange(S, device=dev)[None, :]
    valid = t < nsteps[:, None].long()
    is_m = (steps == 0) & valid
    is_ga = (steps == 1) & valid          # gap in the rows: takes a column
    is_gb = (steps == 2) & valid          # gap in the columns: takes a row
    aic = (torch.cumsum(steps != 1, dim=1) - 1).clamp(0, L1p - 1)
    bic = (torch.cumsum(steps != 2, dim=1) - 1).clamp(0, L2p - 1)
    big = torch.full((), 1 << 30, device=dev)
    fz = torch.where(is_m, t, big).min(dim=1, keepdim=True).values
    lz = torch.where(is_m, t, -1).max(dim=1, keepdim=True).values
    term = valid & ((t < fz) | (t > lz))
    gpo = base_pen[:, 0:1]
    pen = torch.where(term, base_pen[:, 2:3], base_pen[:, 1:2])
    fa = r_counts.gather(1, aic[..., None].expand(B, S, r_counts.shape[2]))
    fb = c_counts.gather(1, bic[..., None].expand(B, S, c_counts.shape[2]))
    mterm = (torch.matmul(fa, subm) * fb).sum(dim=2)
    ga = gaps_rows.gather(1, aic).to(f32)
    gb = gaps_cols.gather(1, bic).to(f32)
    nra = nsip_r[:, None].to(f32) - ga
    nrb = nsip_c[:, None].to(f32) - gb
    cross = nra * gb + ga * nrb
    total = torch.where(is_m, mterm - cross * pen, zero).sum(dim=1)
    npairs_a = nsip_r[:, None].to(f32) * nrb
    npairs_b = nra * nsip_c[:, None].to(f32)
    total = total - (torch.where(is_ga, npairs_a * pen, zero)
                     + torch.where(is_gb, npairs_b * pen, zero)).sum(dim=1)
    first = torch.zeros_like(is_ga[:, :1])
    opens_a = is_ga & ~torch.cat([first, is_ga[:, :-1]], dim=1)
    opens_b = is_gb & ~torch.cat([first, is_gb[:, :-1]], dim=1)
    total = total - (torch.where(opens_a, npairs_a, zero)
                     + torch.where(opens_b, npairs_b, zero)).sum(dim=1) \
        * gpo[:, 0]
    return total


def select_paths(cands, sp_k):
    """The best candidate of each problem
    (kalign_tpu/tpu/resident.py::_bucket_step_refine :435-452): cands a
    list of K (steps [B, S], nsteps [B]), sp_k [K, B].  The first of
    equal SP wins.  Returns (steps, nsteps, SP, disagree [B] bool: any
    candidate's path differs from candidate 0's, best [B])."""
    steps_k = torch.stack([c[0] for c in cands])
    n_k = torch.stack([c[1] for c in cands])
    S = steps_k.shape[2]
    t = torch.arange(S, device=steps_k.device)[None, None, :]
    masked = torch.where(t < n_k[:, :, None].long(), steps_k,
                         torch.full((), tb.STEP_PAD, dtype=steps_k.dtype,
                                    device=steps_k.device))
    best = torch.argmax(sp_k, dim=0)
    sel = masked.gather(0, best[None, :, None].expand(1, *masked.shape[1:]))
    n_sel = n_k.gather(0, best[None])[0]
    sp = sp_k.gather(0, best[None])[0]
    multi = (masked != masked[0:1]).any(dim=2).any(dim=0)
    return sel[0], n_sel, sp, multi, best


class ResidentPass:
    """One bottom-up progressive pass with its state on the engine's
    device (kalign_tpu/tpu/resident.py::ResidentPass :620).
    cand_for(task index) gives a merge's centering-bias candidates
    (:629-641); a bucket of K > 1 candidates produces its operands once,
    runs the forward DP and walk once per candidate (through
    GpuEngine.launch_bucket, which computes the match product again for
    each), scores every path (sp_scores) and merges the best
    (select_paths).  ``run`` returns what GpuEngine.host_pass returns:
    the gap lists, the per-merge scores and the disagreement flags."""

    def __init__(self, engine, codes, ap, sd, ct=None, cand_for=None):
        self.eng = engine
        self.codes = codes
        self.ap = ap
        self.sd = sd
        self.ct = ct
        self.cand_for = cand_for or (lambda t: (engine.EPS,))
        self.n = len(codes)
        self.lens = [len(c) for c in codes]
        self.dev = engine.device
        # the live store: tensors, rows and width, node -> slot, free slots
        self.live = None
        self.live_rows = 8
        self.live_cap = 128
        self.slot_of = {}
        self.free: List[int] = []

    # ------------------------------------------------------------------
    def ensure_live(self, min_rows: int, min_cap: int) -> None:
        """Room for min_rows slots of min_cap columns
        (kalign_tpu/tpu/resident.py :687-733): the store grows by padding,
        or, when its width must grow while at most half its slots are
        needed, is compacted into a store of just the slots in use (a
        store as tall as the leaf levels and as wide as the root would
        not fit at scale)."""
        global _compactions
        rows = _pow2_batch(max(min_rows, self.live_rows))
        cap = _bucket(max(min_cap, self.live_cap))
        if self.live is None:
            self.live_rows, self.live_cap = rows, cap
            self.live = tuple(
                torch.zeros((rows, cap, w), dtype=torch.float32,
                            device=self.dev) for w in (NALPHA, NALPHA, 3))
            self.free = list(range(rows))
            return
        need = _pow2_batch(min_rows)
        if cap > self.live_cap and need <= self.live_rows // 2:
            _compactions += 1
            used = sorted(self.slot_of.items(), key=lambda kv: kv[1])
            src = torch.tensor([r for _, r in used], dtype=torch.int64,
                               device=self.dev)
            new = []
            for a in self.live:
                z = torch.zeros((need, cap, a.shape[2]), dtype=torch.float32,
                                device=self.dev)
                z[:len(used), :self.live_cap] = a[src]
                new.append(z)
            self.live = tuple(new)
            self.slot_of = {node: i for i, (node, _) in enumerate(used)}
            self.free = list(range(len(used), need))
            self.live_rows, self.live_cap = need, cap
            return
        if rows > self.live_rows or cap > self.live_cap:
            self.live = tuple(
                F.pad(a, (0, 0, 0, cap - self.live_cap, 0,
                          rows - self.live_rows)) for a in self.live)
            self.free.extend(range(self.live_rows, rows))
            self.live_rows, self.live_cap = rows, cap

    def scatter_live(self, slots, merged, B: int) -> None:
        """Store B merged profiles in the given slots
        (kalign_tpu/tpu/resident.py::_scatter_live :606)."""
        W = min(merged[0].shape[1], self.live_cap)
        idx = self.eng.put(np.asarray(slots, np.int64))
        for dst, src in zip(self.live, merged):
            dst[idx, :W] = src[:B, :W]

    # ------------------------------------------------------------------
    def bucket_fields(self, items, Ba: int):
        """The FIELDS / FFIELDS arrays of a bucket padded to Ba problems:
        a pad problem copies the last real one's fields, with real = 0
        and 8 x 8 DP lengths."""
        ap = self.ap
        B = len(items)
        fi = np.zeros((len(FIELDS), Ba), np.int32)
        ff = np.zeros((len(FFIELDS), Ba), np.float32)
        for k, (c, a, b, rn, cn, cif, eff) in enumerate(items):
            lr, lc = self.len_of[rn], self.len_of[cn]
            col = fi[:, k]
            col[_F["cif"]] = cif
            col[_F["real"]] = 1
            col[_F["len_r"]] = col[_F["la"]] = lr
            col[_F["len_c"]] = col[_F["lb"]] = lc
            col[_F["nsip_r"]] = self.nsip[rn]
            col[_F["nsip_c"]] = self.nsip[cn]
            for side, node in (("rows", rn), ("cols", cn)):
                if self.nsip[node] == 1:
                    col[_F[side + "_is_leaf"]] = 1
                    col[_F[side + "_leaf"]] = node
                else:
                    col[_F[side + "_slot"]] = self.slot_of[node]
            # the expressions of gpu/profile.py (leaf_profile,
            # merge_profiles), assigned into float32 as it assigns them
            fc = ff[:, k]
            fc[_FF["soff"]] = eff.subm_offset
            fc[_FF["pen_go"]] = -eff.gpo
            fc[_FF["pen_ge"]] = -eff.gpe
            fc[_FF["pen_tge"]] = -eff.tgpe
            sr, sc = self.nsip[rn], self.nsip[cn]
            fc[_FF["gp_term_r"]] = ap.tgpe * sr
            fc[_FF["gp_int_r"]] = ap.gpe * sr
            fc[_FF["gp_term_c"]] = ap.tgpe * sc
            fc[_FF["gp_int_c"]] = ap.gpe * sc
        fi[:, B:] = fi[:, B - 1:B]
        ff[:, B:] = ff[:, B - 1:B]
        fi[_F["real"], B:] = 0
        fi[_F["la"], B:] = 8
        fi[_F["lb"], B:] = 8
        return fi, ff

    def members(self, citems, which: int):
        """[3, m] int64 (sequence, node within the chunk, order within the
        node) of the rows (which = 3) or columns (4) nodes of a chunk."""
        out = [(si, k, o) for k, it in enumerate(citems)
               for o, si in enumerate(self.sip[it[which]])]
        return np.asarray(out or [(0, 0, 0)], np.int64).T

    # ------------------------------------------------------------------
    def run(self, order, task_index, levels):
        eng, ap, n, lens = self.eng, self.ap, self.n, self.lens
        split = eng.split
        self.sip = [[i] for i in range(n)] + [None] * (n - 1)
        self.nsip = [1] * n + [0] * (n - 1)
        self.len_of = {i: lens[i] for i in range(n)}

        with split("assembly"):
            Lt = _bucket(max(lens))
            tok = np.zeros((n, Lt), np.uint8)
            for i, c in enumerate(self.codes):
                tok[i, :len(c)] = c
            tokens = eng.put(tok)
            tok_lens = eng.put(np.asarray(lens, np.int64))
            subm = eng.put(np.asarray(ap.subm, np.float32))
            gaps_buf = torch.zeros((n, max(lens) + 1), dtype=torch.int32,
                                   device=self.dev)
            self.ensure_live(8, 128)
        ct, posmap = self.ct, None
        if ct is not None:
            with split("bonus"):
                pm = np.full((n, ct.K, Lt), -1, np.int64)
                for i in range(n):
                    for k in range(ct.K):
                        m = ct.pos_maps[i * ct.K + k]
                        pm[i, k, :len(m)] = m
                posmap = eng.put(pm)
                per_w = eng.put(np.asarray(ct.per_weight, np.float32))
        score_parts, score_tasks = [], []
        # per chunk of multi-candidate merges: (tasks, K, disagree, best,
        # SP [K, B])
        refine_parts = []

        for lv_nodes in levels:
            with split("assembly"):
                batch = []
                for c in lv_nodes:
                    a, b = (int(x) for x in order[task_index[c]][:2])
                    eff = eng.effective(ap, self.sd, self.sip, a, b, n)
                    leaf_a, leaf_b = self.nsip[a] == 1, self.nsip[b] == 1
                    if leaf_a and not leaf_b:
                        rn = b
                    elif leaf_b and not leaf_a:
                        rn = a
                    elif self.len_of[a] <= self.len_of[b]:
                        rn = a
                    else:
                        rn = b
                    cn = b if rn == a else a
                    cif = self.nsip[cn] == 1 and not (leaf_a and leaf_b)
                    batch.append((c, a, b, rn, cn, cif, eff))
                buckets = {}
                for item in batch:
                    key = (_bucket(self.len_of[item[3]]),
                           _bucket(self.len_of[item[4]]),
                           tuple(self.cand_for(task_index[item[0]])))
                    buckets.setdefault(key, []).append(item)
                eng.stats["levels"].append(level_buckets(buckets))

            # every bucket dispatched, in the host pass's chunks
            chunks = []
            for (L1p, L2p, cands), items in buckets.items():
                with split("assembly"):
                    # past the register row kernel's widths no pads: a
                    # wide launch holds only real problems (eng.pads)
                    Ba = _pow2_batch(len(items)) if eng.pads(L2p) else \
                        len(items)
                    fi_h, ff_h = self.bucket_fields(items, Ba)
                    fi, ff = eng.put(fi_h), eng.put(ff_h)
                    cap = eng.max_launch(L1p, L2p)
                for lo in range(0, Ba, cap):
                    sl = slice(lo, lo + cap)
                    Bc = min(cap, Ba - lo)
                    citems = items[sl]
                    bonus = None
                    if ct is not None:
                        with split("bonus"):
                            rows, cols = (node_positions(
                                gaps_buf, posmap, tok_lens,
                                *eng.put(self.members(citems, which)),
                                n_nodes=Bc, Lp=Lp, dedup=dedup)
                                for which, Lp, dedup in ((3, L1p, False),
                                                         (4, L2p, True)))
                            bonus = (per_w, *rows, *cols)
                    with split("assembly"):
                        lhs, rhs, pc, pr, sides = produce_operands(
                            self.live, tokens, subm, fi[:, sl], ff[:, sl],
                            L1p, L2p)
                    outs = []
                    for e in cands:
                        with split("dispatch"):
                            eps = torch.full((Bc,), e, dtype=torch.float32,
                                             device=self.dev)
                            outs.append(eng.launch_bucket(
                                lhs, rhs, pc, pr,
                                fi[_F["la"], sl].contiguous(),
                                fi[_F["lb"], sl].contiguous(), eps, bonus,
                                fi_h[_F["la"], sl], fi_h[_F["lb"], sl])[1:4])
                    steps, nst, score = outs[0]
                    if len(cands) > 1:
                        with split("refine"):
                            steps, nst, score, multi, best, sp_k = \
                                self.refine_chunk(citems, outs, sides,
                                                  fi[:, sl], gaps_buf,
                                                  tok_lens, subm, L1p, L2p)
                        if citems:
                            B = len(citems)
                            refine_parts.append((
                                [task_index[it[0]] for it in citems],
                                len(cands), multi[:B], best[:B],
                                sp_k[:, :B]))
                    if not citems:          # a chunk of pad problems
                        continue
                    with split("merge"):
                        merged = merge_from_steps(steps, nst, sides,
                                                  ff[:, sl], L1p, L2p)
                    chunks.append((citems, steps, nst, score, merged))

            # the level's gaps woven into gaps_buf, chunk by chunk (a
            # level's chunks share no sequence)
            for citems, steps, nst, _, _ in chunks:
                with split("weave"):
                    gp_rows = gap_profiles(steps, nst)
                    B = steps.shape[0]
                    mem = [(si, side * B + k, lens[si])
                           for k, it in enumerate(citems)
                           for side, node in ((0, it[3]), (1, it[4]))
                           for si in self.sip[node]]
                    mem = eng.put(np.asarray(mem, np.int64).T)
                    weave_apply(gaps_buf, gp_rows, *mem)

            # the level's one fetch: the new profile lengths
            with split("fetch"):
                new_len = eng.fetch(torch.cat(
                    [nst[:len(ci)] for ci, _, nst, _, _ in chunks]))
            with split("merge"):
                off = 0
                for citems, _, _, score, merged in chunks:
                    B = len(citems)
                    score_parts.append(score[:B])
                    score_tasks.extend(task_index[it[0]] for it in citems)
                    for k, (c, a, b, *_rest) in enumerate(citems):
                        self.len_of[c] = int(new_len[off + k])
                        self.nsip[c] = self.nsip[a] + self.nsip[b]
                        self.sip[c] = (list(reversed(self.sip[a]))
                                       + list(reversed(self.sip[b])))
                        for child in (a, b):
                            if child in self.slot_of:
                                self.free.append(self.slot_of.pop(child))
                    off += B
                new = [it[0] for ci, *_ in chunks for it in ci]
                self.ensure_live(len(self.slot_of) + len(new),
                                 max(self.len_of[c] for c in new))
                for citems, _, _, _, merged in chunks:
                    slots = [self.free.pop() for _ in citems]
                    for it, s in zip(citems, slots):
                        self.slot_of[it[0]] = s
                    self.scatter_live(slots, merged, len(citems))

        # the gap lists, the scores and the candidates' records in one
        # transfer (float bits ride as int32)
        with split("fetch"):
            flat = [gaps_buf.reshape(-1)]
            if score_parts:
                flat.append(torch.cat(score_parts).view(torch.int32))
            for _, _, multi, best, sp_k in refine_parts:
                flat += [multi.to(torch.int32), best.to(torch.int32),
                         sp_k.reshape(-1).contiguous().view(torch.int32)]
            host = eng.fetch(torch.cat(flat))
        ng = gaps_buf.numel()
        g = host[:ng].reshape(gaps_buf.shape)
        gaps = [g[i, :lens[i] + 1].tolist() for i in range(n)]
        conf = np.zeros(max(n - 1, 0), dtype=np.float32)
        off = ng + len(score_tasks)
        conf[np.asarray(score_tasks, np.int64)] = \
            host[ng:off].view(np.float32)
        disagree = np.zeros(max(n - 1, 0), dtype=bool)
        for tasks, K, *_ in refine_parts:
            B = len(tasks)
            multi, best = host[off:off + B], host[off + B:off + 2 * B]
            sp = host[off + 2 * B:off + (2 + K) * B].view(np.float32) \
                .reshape(K, B)
            off += (2 + K) * B
            for k, t in enumerate(tasks):
                disagree[t] = bool(multi[k])
                eng.stats["candidates"][t] = (int(best[k]),
                                              sp[:, k].tolist())
        return gaps, conf, disagree

    def refine_chunk(self, citems, outs, sides, fi, gaps_buf, tok_lens, subm,
                     L1p: int, L2p: int):
        """Trial selection of a chunk's candidates on the device
        (kalign_tpu/tpu/resident.py::_bucket_step_refine :400-455): each
        side's gap counts from the resident gap state, every candidate
        path's SP, the best path.  outs: K (steps, nsteps, score).
        Returns (steps, nsteps, SP, disagree, best, SP [K, B])."""
        eng = self.eng
        Bc = fi.shape[1]
        ap = self.ap
        gaps = []
        for which, Lp, ns in ((3, L1p, fi[_F["nsip_r"]]),
                              (4, L2p, fi[_F["nsip_c"]])):
            ms, mn, _ = eng.put(self.members(citems, which))
            res = node_gap_counts(gaps_buf, tok_lens, ms, mn, Bc, Lp)
            gaps.append(ns.long()[:, None] - res)
        base_pen = torch.tensor([ap.gpo, ap.gpe, ap.tgpe], dtype=torch.float32,
                                device=self.dev).expand(Bc, 3)
        (r_counts, _, _), (c_counts, _, _) = sides
        sp_k = torch.stack([sp_scores(st, n, r_counts, c_counts, gaps[0],
                                      gaps[1], fi[_F["nsip_r"]],
                                      fi[_F["nsip_c"]], subm, base_pen, L1p,
                                      L2p) for st, n, _ in outs])
        steps, nst, sp, multi, best = select_paths(
            [(st, n) for st, n, _ in outs], sp_k)
        return steps, nst, sp, multi, best, sp_k
