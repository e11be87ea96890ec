"""The port's device-resident progressive pass (gpu/resident.py) on the
CPU: against the port's host-assembled pass (byte-identical FASTA and
bitwise per-merge scores, one fetch per level plus one), against
kalign_tpu's ResidentPass (per-merge scores within rel 1e-5, the contract
of kalign_tpu/tpu/resident.py:25-32), and its device programs one by one
against the host pass's numpy (gpu/profile.py, gpu/consistency.py)."""

import copy
import os

import numpy as np
import pytest
import torch

from kalign_tpu import engine as JE
from kalign_tpu.core import io as jio
from kalign_tpu_torch import engine as TE
from kalign_tpu_torch.core import io as tio
from kalign_tpu_torch.core.msa import Msa
from kalign_tpu_torch.gpu import resident as R
from kalign_tpu_torch.gpu.consistency import ConsistencyTable
from kalign_tpu_torch.gpu.engine import GpuEngine, terminal_mask
from kalign_tpu_torch.gpu.profile import Profile, merge_profiles, weave_steps

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
FILES = ["BB11001.tfa", "BB12006.tfa", "BB30014.tfa", "small.fa"]
CASES = [(f, 0) for f in FILES] + [(f, 5) for f in FILES]
IDS = FILES + [f + "-default" for f in FILES]


def _port(path, consistency, resident):
    m = tio.read_alignment(path)
    m.quiet = True
    return TE.align_msa(m, consistency_anchors=consistency,
                        engine=GpuEngine("cpu", resident=resident),
                        autoroute=False)


@pytest.mark.parametrize("case,consistency", CASES, ids=IDS)
def test_resident_matches_host_pass(case, consistency):
    """Byte-identical FASTA and bitwise per-merge scores; the resident
    pass fetches once per level and once at the end."""
    path = os.path.join(DATA, case)
    host = _port(path, consistency, False)
    res = _port(path, consistency, True)
    assert tio.format_alignment(res, "fasta") == \
        tio.format_alignment(host, "fasta")
    assert np.array_equal(np.asarray(res.task_confidence).view(np.int32),
                          np.asarray(host.task_confidence).view(np.int32))
    st = res.engine_stats
    assert st["fetches"] == len(st["levels"]) + 1
    assert host.engine_stats["fetches"] > st["fetches"]
    assert set(st["progressive_split_s"]) >= {"assembly", "dispatch",
                                              "merge", "weave", "fetch"}


@pytest.mark.parametrize("case,consistency", CASES, ids=IDS)
def test_resident_scores_match_kalign_tpu_resident(case, consistency,
                                                   monkeypatch):
    """Per-merge scores within rel 1e-5 of kalign_tpu's ResidentPass
    (tpu-fast, resident, without the divergent-family autoroute)."""
    import kalign_tpu.tpu.resident as JR
    monkeypatch.delenv("KALIGN_TPU_NO_RESIDENT", raising=False)
    monkeypatch.setenv("KALIGN_TPU_NO_AUTOROUTE", "1")
    runs = []
    run = JR.ResidentPass.run

    def counted(self, *a, **k):
        runs.append(1)
        return run(self, *a, **k)
    monkeypatch.setattr(JR.ResidentPass, "run", counted)
    path = os.path.join(DATA, case)
    m = jio.read_alignment(path)
    m.quiet = True
    ref = JE.align_msa(m, consistency_anchors=consistency, engine="tpu-fast")
    assert runs == [1]
    out = _port(path, consistency, True)
    got = np.asarray(out.task_confidence, np.float64)
    want = np.asarray(ref.task_confidence, np.float64)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= 1e-5 * np.abs(want)), \
        np.abs(got - want).max()


def test_resident_preserves_residues():
    path = os.path.join(DATA, "BB12006.tfa")
    out = _port(path, 5, True)
    raw = {s.name: s.seq for s in tio.read_alignment(path).sequences}
    for s, row in zip(out.sequences, out.aligned_rows()):
        assert row.replace("-", "") == raw[s.name]


def test_live_store_compaction_parity():
    """The live store compacts when it must widen with most slots free
    (kalign_tpu/tests/test_resident.py:420-443): the counter rises and
    the alignment equals the host pass's."""
    import chip_smoke
    seqs = chip_smoke.family(96, seed=5, root_len=150, lo=20, hi=300,
                             letters=chip_smoke.DNA, subs=(0.1, 0.05),
                             max_indel=8)
    before = R._compactions
    outs = {}
    for resident in (True, False):
        m = Msa.from_sequences(seqs)
        m.quiet = True
        out = TE.align_msa(m, consistency_anchors=0,
                           engine=GpuEngine("cpu", resident=resident))
        outs[resident] = tio.format_alignment(out, "fasta")
    assert R._compactions > before
    assert outs[True] == outs[False]


# ---------------------------------------------------------------------------
def _random_path(rng, la, lb):
    steps, i, j = [], 0, 0
    while i < la or j < lb:
        c = rng.integers(0, 3)
        if c == 0 and i < la and j < lb:
            steps.append(0)
            i += 1
            j += 1
        elif c == 1 and j < lb:
            steps.append(1)
            j += 1
        elif i < la:
            steps.append(2)
            i += 1
    return np.asarray(steps, np.int8)


def _padded_steps(steps, S):
    out = np.full((1, S), 3, np.int8)
    out[0, :len(steps)] = steps
    return torch.from_numpy(out), torch.tensor([len(steps)], dtype=torch.int32)


def test_weave_apply_matches_weave_steps():
    """gap_profiles + weave_apply give weave_steps' gap lists exactly, on
    random paths and gap states (rows side: gaps at step 1, columns side:
    at step 2)."""
    rng = np.random.default_rng(7)

    def rand_gaps(prof_len):
        lm = int(rng.integers(1, prof_len + 1))
        g = np.zeros(lm + 1, np.int64)
        for _ in range(prof_len - lm):
            g[rng.integers(0, lm + 1)] += 1
        return lm, g.tolist()

    for _ in range(60):
        la = int(rng.integers(3, 15))
        lb = int(rng.integers(3, 15))
        steps = _random_path(rng, la, lb)
        lens, gaps = [], []
        for prof_len, count in ((la, 2), (lb, 1)):
            for _ in range(count):
                lm, g = rand_gaps(prof_len)
                lens.append(lm)
                gaps.append(g)
        want = copy.deepcopy(gaps)
        weave_steps(steps, want, [0, 1], [2])
        st, n = _padded_steps(steps, len(steps) + 3)
        gbuf = torch.zeros((3, max(lens) + 1), dtype=torch.int32)
        for s in range(3):
            gbuf[s, :len(gaps[s])] = torch.tensor(gaps[s])
        R.weave_apply(gbuf, R.gap_profiles(st, n), torch.tensor([0, 1, 2]),
                      torch.tensor([0, 0, 1]), torch.tensor(lens))
        for s in range(3):
            assert gbuf[s, :len(want[s])].tolist() == want[s]


def test_merge_from_steps_matches_merge_profiles():
    """merge_from_steps, in the DP's rows/columns space, gives
    merge_profiles' counts, subrows and pen bit for bit, whichever side is
    the task's operand a (merge_profiles then sees the mirrored path)."""
    rng = np.random.default_rng(13)
    gpe, tgpe = 1.25, 1.0
    L1p, L2p = 24, 32
    for trial in range(40):
        la = int(rng.integers(1, L1p + 1))
        lb = int(rng.integers(1, L2p + 1))
        nr, nc = (int(x) for x in rng.integers(1, 9, size=2))

        def prof(L):
            return Profile(
                counts=rng.random((L, 23), dtype=np.float32) * 3,
                subrows=rng.standard_normal((L, 23), dtype=np.float32) * 4,
                pen=-rng.random((L + 2, 3), dtype=np.float32) * 8)
        pr_, pc_ = prof(la), prof(lb)
        steps = _random_path(rng, la, lb)
        swapped = bool(trial % 2)
        if swapped:     # rows are operand b: the path mirrored into a/b
            ab = np.where(steps == 1, 2, np.where(steps == 2, 1, 0))
            want = merge_profiles(pc_, pr_, ab.astype(np.int8),
                                  terminal_mask(ab), nc, nr, 7.0, gpe, tgpe)
        else:
            want = merge_profiles(pr_, pc_, steps, terminal_mask(steps), nr,
                                  nc, 7.0, gpe, tgpe)

        def side(p, Lp):
            out = []
            for x in (p.counts, p.subrows, p.pen[1:-1]):
                z = np.zeros((1, Lp, x.shape[1]), np.float32)
                z[0, :len(x)] = x
                out.append(torch.from_numpy(z))
            return out
        ff = np.zeros((len(R.FFIELDS), 1), np.float32)
        for k, v in (("gp_term_r", tgpe * nr), ("gp_int_r", gpe * nr),
                     ("gp_term_c", tgpe * nc), ("gp_int_c", gpe * nc)):
            ff[R.FFIELDS.index(k), 0] = v
        st, n = _padded_steps(steps, L1p + L2p + 2)
        counts, subrows, pen = R.merge_from_steps(
            st, n, (side(pr_, L1p), side(pc_, L2p)), torch.from_numpy(ff),
            L1p, L2p)
        m = len(steps)
        for got, ref in ((counts, want.counts), (subrows, want.subrows),
                         (pen, want.pen[1:-1])):
            assert np.array_equal(got[0, :m].numpy().view(np.int32),
                                  ref.view(np.int32)), trial
            assert not got[0, m:].any()


def _consistency_case(rng, n, K, Lt, lens, members, Lpn):
    """A ConsistencyTable of random monotone position maps, and gap lists
    giving every member an aligned width of Lpn."""
    pos_maps = []
    for i in range(n):
        for _ in range(K):
            m = np.full(lens[i], -1, np.int64)
            p = 0
            for r in range(lens[i]):
                if rng.random() < 0.7 and p < Lt:
                    m[r] = p
                    p += int(rng.integers(1, 3))
            pos_maps.append(m)
    ct = ConsistencyTable(K=K, weight=2.0, anchor_ids=list(range(K)),
                          pos_maps=pos_maps, numseq=n)
    gaps = [[0] * (int(lens[i]) + 1) for i in range(n)]
    for m in members:
        g = np.zeros(lens[m] + 1, np.int64)
        for _ in range(Lpn - lens[m]):
            g[rng.integers(0, lens[m] + 1)] += 1
        gaps[m] = g.tolist()
    return ct, gaps


def _check_node_positions(rng, n, K, Lt, lens, members, Lpn):
    """Node n (the members, in that order) and leaf n - 1 (no member, so no
    gaps yet) as a batch of two nodes, on both sides, against
    bonus_arrays."""
    ct, gaps = _consistency_case(rng, n, K, Lt, lens, members, Lpn)
    leaf = n - 1
    sip = {n: list(members), leaf: [leaf]}
    nsip = {n: len(members), leaf: 1}
    Lp = Lpn + 5
    gbuf = torch.zeros((n, int(max(lens)) + 2), dtype=torch.int32)
    for i in range(n):
        gbuf[i, :len(gaps[i])] = torch.tensor(gaps[i])
    pmap = torch.full((n, K, Lt), -1, dtype=torch.int64)
    for i in range(n):
        for k in range(K):
            pmap[i, k, :lens[i]] = torch.from_numpy(ct.pos_maps[i * K + k])
    mem = [(s, 0, o) for o, s in enumerate(members)] + [(leaf, 1, 0)]
    mem = torch.tensor(mem).T
    got = {dedup: R.node_positions(gbuf, pmap, torch.from_numpy(lens), *mem,
                                   n_nodes=2, Lp=Lp, dedup=dedup)
           for dedup in (False, True)}
    lens_l = [int(x) for x in lens]
    for rn, cn, r_i, c_i in ((leaf, n, 1, 0), (n, leaf, 0, 1)):
        lr, lc = (Lpn if x == n else lens_l[leaf] for x in (rn, cn))
        apr, cfr, apc, cfc = ct.bonus_arrays(rn, lr, cn, lc, sip, nsip, gaps,
                                             lens_l)
        for (pos, conf), i, ap_, cf_, L in ((got[False], r_i, apr, cfr, lr),
                                            (got[True], c_i, apc, cfc, lc)):
            want_p = np.full((K, Lp), -1, np.int32)
            want_c = np.zeros((K, Lp), np.float32)
            want_p[:, :L] = ap_
            want_c[:, :L] = cf_
            assert np.array_equal(pos[i].numpy(), want_p)
            assert np.array_equal(conf[i].numpy().view(np.int32),
                                  want_c.view(np.int32))


def test_node_positions_matches_bonus_arrays():
    """Consensus positions and confidences from the resident gap state,
    both sides (the columns side's last-column dedup included), bitwise
    against ConsistencyTable.bonus_arrays on random gap states and maps."""
    rng = np.random.default_rng(11)
    for _ in range(25):
        n = int(rng.integers(3, 8))
        K = int(rng.integers(1, 4))
        Lt = int(rng.integers(6, 12))
        lens = rng.integers(3, Lt, n).astype(np.int64)
        members = rng.permutation(n - 1)[:rng.integers(2, n)]
        Lpn = int(max(lens[m] for m in members) + rng.integers(0, 4))
        _check_node_positions(rng, n, K, Lt, lens, members, Lpn)


def test_node_positions_long_sequences():
    """Sequences past 2,048 residues (kalign_tpu/tests/test_resident.py:215,
    where an int32 key once overflowed): the int64 keys need no guard."""
    rng = np.random.default_rng(7)
    n, K, Lt = 4, 2, 2176
    lens = np.full(n, Lt - 16, np.int64)
    _check_node_positions(rng, n, K, Lt, lens, np.arange(n - 1), Lt - 8)
