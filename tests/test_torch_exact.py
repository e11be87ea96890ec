"""The port's bit-exact engine on the CPU against kalign_tpu's: the plain
wavefront sweep (gpu/exact_sweep.py) against kalign_tpu/tpu/exact.py's
XLA sweep on random plans, bitwise; the host side (gpu/exact.py) against
the native single-merge oracle (paths and margin statistics equal, as
tests/test_exact_dp.py holds the reference); failing callbacks; packing;
the canary."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from kalign_tpu.tpu import exact as JX
from kalign_tpu_torch import engine as TE
from kalign_tpu_torch import native
from kalign_tpu_torch.core import io as tio
from kalign_tpu_torch.core import params as P
from kalign_tpu_torch.gpu import exact as X
from kalign_tpu_torch.gpu import exact_sweep as XS

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
NEG = np.float32(-3.4028234663852886e38)


def random_plan(rng, G, VR, C, use_chain):
    """G random grids: bands of windows (an init row and 0..5 rows each)
    with random column ranges, seeds (some -FLT_MAX), edge flags and
    addends; the column arrays reversed and padded as the host builds
    them."""
    f32 = np.float32
    p = {k: np.zeros((G, VR), bool) for k in XS.ROW_BOOL}
    p["startq"] = np.zeros((G, VR), np.int32)
    p["endq"] = np.full((G, VR), -1, np.int32)
    p["win_slot"] = np.full((G, VR), VR, np.int32)
    for k in XS.ROW_F32:
        p[k] = np.zeros((G, VR), f32)
    for g in range(G):
        vr, slot = 0, 0
        while True:
            R = int(rng.integers(0, 6))
            if vr + R + 1 > VR - int(rng.integers(0, 3)):
                break
            band = slice(vr, vr + R + 1)
            sq = int(rng.integers(0, C + 1))
            eq = int(rng.integers(sq, C + 1))
            p["active"][g, band] = True
            p["startq"][g, band] = sq
            p["endq"][g, band] = eq
            p["is_init"][g, vr] = True
            for k in ("init_tg", "start_tg", "end_tg"):
                p[k][g, band] = rng.random() < 0.5
            seeds = rng.standard_normal(3).astype(f32)
            seeds[rng.random(3) < 0.4] = NEG
            p["seedA"][g, vr], p["seedGA"][g, vr], p["seedGB"][g, vr] = seeds
            p["is_final"][g, vr + R] = True
            p["win_slot"][g, vr + R] = slot
            rows = slice(vr + 1, vr + R + 1)
            for k in ("gb_ext", "gb_open", "gb_tg", "dgb"):
                p[k][g, rows] = -rng.random(R).astype(f32) * 4
            vr += R + 1
            slot += 1
    for k in XS.COL_F32:
        full = -rng.random((G, C + 1)).astype(f32) * 4
        z = np.zeros((G, VR), f32)
        p[k] = np.concatenate([z, full[:, ::-1], z], axis=1)
    p["match"] = rng.standard_normal((G, VR, C + 1)).astype(f32)
    p["bonus"] = (rng.random((G, VR, C + 1)) * 0.5).astype(f32)
    p["p1cnt"] = rng.integers(0, 3, (G, VR, 23)).astype(f32)
    p2 = rng.standard_normal((G, C + 1, 23)).astype(f32)
    z = np.zeros((G, VR, 23), f32)
    p["p2sub_p"] = np.concatenate([z, p2[:, ::-1], z], axis=1)
    if use_chain:
        p["match"][:] = 0
    return p


def bits(x):
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


@pytest.mark.parametrize("use_chain", [False, True], ids=["match", "chain"])
def test_plain_sweep_matches_reference_sweep(use_chain):
    """plain on random plans: the reference's vmapped _sweep_one gives the
    same bits, -inf cells included; the wrapper's live slice and a
    narrower match/bonus (zeros past it) give the same bits too."""
    rng = np.random.default_rng(11 + use_chain)
    G, VR, C = 3, 32, 31
    p = random_plan(rng, G, VR, C, use_chain)
    ref = JX._sweep_batch((VR, C, VR, use_chain))(
        {k: jnp.asarray(v) for k, v in p.items()})
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got = XS.plain(tp, VR, C, VR, use_chain)
    assert got.shape == (G, VR, C + 1, 3)
    assert np.array_equal(bits(got), bits(ref))
    assert np.isneginf(got.numpy()).any() and np.isfinite(got.numpy()).any()
    # the live windows and columns, from a match / bonus cut at 20 columns
    width = 20
    cut = dict(tp, match=tp["match"][:, :, :width].contiguous(),
               bonus=tp["bonus"][:, :, :width].contiguous())
    tp["match"][:, :, width:] = 0
    tp["bonus"][:, :, width:] = 0
    launches = XS.launches
    live = XS.sweep(cut, VR, C, VR, use_chain, live=(5, 17))
    assert XS.launches == launches          # the CPU runs the plain version
    full = XS.plain(tp, VR, C, VR, use_chain)
    assert np.array_equal(bits(live), bits(full[:, :5, :17]))


def test_launch_plan_covers_every_grid_height():
    """Every power-of-two height has a block: one thread per row up to
    512 rows, then strips of 512 rows swept in turn (one row a thread
    measured fastest), with no top height (a window of la rows takes
    VR = pow2(la // 2 + 2)); with more rows a thread allowed (the
    settings script), a strip holds THREADS x ROWS rows."""
    for k in range(0, 18):
        VR = 1 << k
        lp = XS.launch_plan(VR)
        assert lp.threads * lp.rows * lp.strips == VR
        assert lp.threads <= XS.THREADS and lp.rows == XS.ROWS == 1
    assert XS.launch_plan(256) == (256, 1, 1)
    assert XS.launch_plan(4096) == (512, 1, 8)
    assert XS.launch_plan(16384) == (512, 1, 32)
    assert XS.launch_plan(64) == (64, 1, 1)
    rows, XS.ROWS = XS.ROWS, 4
    try:
        assert XS.launch_plan(512) == (512, 1, 1)
        assert XS.launch_plan(4096) == (512, 4, 2)
    finally:
        XS.ROWS = rows
    for bad in (0, 24, 3 * 4096):
        with pytest.raises(ValueError):
            XS.launch_plan(bad)
    assert XS.live_steps(64, 511, 300) == 364
    assert XS.live_steps(64, 127, 300) == 64 + 128


@pytest.fixture(scope="module")
def oracle():
    L = native.lib()
    ap = P.aln_param_init(P.BIOTYPE_PROTEIN, P.KALIGN_TYPE_PROTEIN,
                          -1.0, -1.0, -1.0, 1)
    subm = np.ascontiguousarray(ap.subm.astype(np.float32).reshape(-1))
    return L, subm, (np.float32(ap.gpo), np.float32(ap.gpe),
                     np.float32(ap.tgpe))


def _leaf(L, subm, g, seq):
    out = np.zeros((len(seq) + 2) * 64, np.float32)
    L.kt_leaf_profile(subm, g[0], g[1], g[2], seq, len(seq), out)
    return out


def _merged(L, subm, g, rng, n):
    a = rng.integers(0, 23, n).astype(np.uint8)
    b = rng.integers(0, 23, n).astype(np.uint8)
    steps = np.zeros(n + 2, np.int32)
    steps[0] = n
    steps[n + 1] = 3
    out = np.zeros((n + 2) * 64, np.float32)
    L.kt_merge_profiles(_leaf(L, subm, g, a), _leaf(L, subm, g, b),
                        subm, g[0], g[1], g[2], steps, 1, 1, 0.0, out)
    return out


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_exact_aligner_matches_native_oracle(oracle, mode):
    """ExactAligner.run against kt_run_align_single (the port's copy of
    the native runtime) in all three operand modes, with consistency
    bonuses, VSM offsets and flip perturbation: identical raw paths,
    margin sums and counts (tests/test_exact_dp.py:45 for the
    reference)."""
    L, subm, g = oracle
    gpo, gpe, tgpe = g
    rng = np.random.default_rng(42 + mode)
    for trial in range(12):
        la = int(rng.integers(1 if mode == 0 else 2, 50))
        lb = int(rng.integers(la, 70))
        s1 = s2 = p1 = p2 = None
        s1p = s2p = p1p = p2p = None
        sip = 0
        if mode == 0:
            s1 = rng.integers(0, 23, la).astype(np.uint8)
            s2 = rng.integers(0, 23, lb).astype(np.uint8)
            s1p, s2p = s1.ctypes.data, s2.ctypes.data
        else:
            p1 = _merged(L, subm, g, rng, la)
            L.kt_scale_gaps(p1, la, 2 if mode == 2 else 1)
            p1p = p1.ctypes.data
            if mode == 1:
                s2 = rng.integers(0, 23, lb).astype(np.uint8)
                s2p = s2.ctypes.data
                sip = 2
            else:
                p2 = _merged(L, subm, g, rng, lb)
                L.kt_scale_gaps(p2, lb, 2)
                p2p = p2.ctypes.data
        soff = np.float32(rng.choice([0.0, 0.9]))
        bonus = bptr = None
        if trial % 3 == 0:
            bonus = (rng.random(la * lb + 1) * 0.5).astype(np.float32)
            bptr = bonus.ctypes.data
        if trial % 4 == 3:
            fthr, ftr, fstr = np.float32(2.5), 1 + trial % 3, 4
        else:
            fthr, ftr, fstr = np.float32(0.0), 0, 1

        path_ref = np.full(max(la, lb) + 2, -1, np.int32)
        info_ref = np.zeros(3, np.float32)
        L.kt_run_align_single(mode, s1p, s2p, p1p, p2p, la, lb, sip,
                              subm, gpo, gpe, tgpe, soff, bptr, lb,
                              fthr, ftr, fstr, 0, path_ref, info_ref)
        aln = X.ExactAligner(mode, s1, s2, p1, p2, la, lb, sip,
                             subm.reshape(23, 23) if mode == 0 else None,
                             gpo, gpe, tgpe, soff, bonus, fthr, ftr, fstr)
        path = np.full(la + 2, -1, np.int32)
        msum, mcount, _ = aln.run(path)
        assert np.array_equal(path_ref[:la + 2], path), \
            f"path mismatch mode={mode} trial={trial}"
        assert np.float32(msum) == info_ref[0]
        assert mcount == int(info_ref[1])
        assert aln.sweeper.launches > 0


def _operands(oracle, rng, mode, n, bonus):
    """n random problems of one operand mode as (args of ExactAligner,
    in both packages' signature)."""
    L, subm, g = oracle
    out = []
    for k in range(n):
        la = int(rng.integers(2, 30))
        lb = int(rng.integers(1, 40))
        s1 = s2 = p1 = p2 = None
        sip = 0
        if mode == 0:
            s1 = rng.integers(0, 23, la).astype(np.uint8)
            s2 = rng.integers(0, 23, lb).astype(np.uint8)
        else:
            p1 = _merged(L, subm, g, rng, la)
            L.kt_scale_gaps(p1, la, 2 if mode == 2 else 1)
            if mode == 1:
                s2 = rng.integers(0, 23, lb).astype(np.uint8)
                sip = 2
            else:
                p2 = _merged(L, subm, g, rng, lb)
                L.kt_scale_gaps(p2, lb, 2)
        b = ((rng.random(la * lb + 1) * 0.5).astype(np.float32)
             if bonus and k % 2 == 0 else None)
        out.append((mode, s1, s2, p1, p2, la, lb, sip,
                    subm.reshape(23, 23) if mode == 0 else None, *g,
                    np.float32(rng.choice([0.0, 0.9])), b))
    return out


@pytest.mark.parametrize("mode,bonus", [(0, True), (1, True), (2, False),
                                        (0, False)])
def test_device_rows_are_the_reference_matrices(oracle, mode, bonus):
    """The match and bonus rows that Operands gathers for the sweep (on
    the plans' device; here the CPU) from per-row tables, column
    residues and the runtime's bonus array are kalign_tpu's dense
    matchF / matchB_r / bonusF / bonusB_r, value for value, zero past
    each problem's width and for profile x profile's match."""
    rng = np.random.default_rng(11 + mode)
    args = _operands(oracle, rng, mode, 5, bonus)
    ops = X.Operands.of_aligners([X.ExactAligner(*a) for a in args])
    refs = [JX.ExactAligner(*a) for a in args]
    R = ops.nrows
    for name in ("match", "bonus") if bonus else ("match",):
        store = ops.on(name, "cpu").numpy()
        assert store.shape == (2 * R + 1, ops.width)
        assert not store[2 * R].any()
        for p, ref in enumerate(refs):
            r0, la, lb = ops.rowoff[p], ref.la, ref.lb
            F = store[r0:r0 + la]
            B = store[R + r0:R + r0 + la]
            if name == "match":
                want_F = ref.matchF if mode != 2 else np.zeros((la, 1))
                want_B = ref.matchB_r if mode != 2 else np.zeros((la, 1))
            elif args[p][-1] is not None:
                want_F, want_B = ref.bonusF, ref.bonusB_r
            else:
                want_F = want_B = np.zeros((la, 1))
            for got, want in ((F, want_F), (B, want_B)):
                w = want.shape[1]
                assert np.array_equal(bits(got[:, :w]),
                                      bits(want.astype(np.float32)))
                assert not got[:, w:].any()


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_meets_match_the_reference_meetup(oracle, mode):
    """The meetup of many windows at once (exact._meets and _decode)
    against kalign_tpu's ExactAligner._meet_window, one window at a time,
    on random final rows with many ties and -FLT_MAX / -inf entries: the
    same winner (column, transition), the same runner-up (taken by a
    flip on every low margin), the same margins, bit for bit."""
    rng = np.random.default_rng(5 + mode)
    (a,) = _operands(oracle, rng, mode, 1, False)
    la, lb = a[5], a[6]
    ref = JX.ExactAligner(*a)
    flip = JX.ExactAligner(*a, flip_threshold=np.float32(1e30),
                           flip_trial=1, flip_stride=1)
    ops = X.Operands.of_aligners([X.ExactAligner(*a)])
    wins, rows_f, rows_b, want = [], [], [], []
    for _ in range(60):
        sa = int(rng.integers(0, la))
        ea = int(rng.integers(sa + 1, la + 1))
        sb = int(rng.integers(0, lb))
        eb = int(rng.integers(sb + 1, lb + 1))
        fst = rng.integers(-3, 3, (lb + 1, 3)).astype(np.float32) / 2
        bst = rng.integers(-3, 3, (lb + 1, 3)).astype(np.float32) / 2
        for st in (fst, bst):
            st[rng.random((lb + 1, 3)) < 0.2] = NEG
            st[rng.random((lb + 1, 3)) < 0.05] = -np.inf
        fs, bs = (0.0, NEG, NEG), (NEG, 0.0, NEG)
        w = JX._Win(sa, ea, sb, eb, fs, bs)
        c, tr = ref._meet_window(w, fst, bst)
        c2, tr2 = flip._meet_window(JX._Win(sa, ea, sb, eb, fs, bs), fst,
                                    bst)
        want.append((c, tr, c2 if w.has2 else -1, tr2 if w.has2 else -1,
                     w.has2, w.margin if w.has2 else np.float32(0.0)))
        wins.append((0, sa, ea, sb, eb, fs, bs))
        rows_f.append(fst)
        rows_b.append(bst[::-1])
    n = len(wins)
    out = torch.from_numpy(np.stack([np.stack(rows_f), np.stack(rows_b)]))
    w = X.Wins.of(wins)
    pos, margin = X._meets(ops, w, out, np.zeros(n, np.int64),
                           np.ones(n, np.int64), np.arange(n))
    got = X._decode(w, pos.numpy(), margin.numpy())
    for k in range(n):
        c, tr, c2, tr2, has2, m = (x[k] for x in got)
        assert (c, tr, bool(has2)) == want[k][:2] + (want[k][4],), k
        if has2:
            assert (c2, tr2) == want[k][2:4], k
            assert bits(np.float32(m)) == bits(want[k][5]), k


def test_upload_keeps_every_array():
    """exact.upload puts numpy arrays of every plan dtype (and tensors as
    they are) on the device in one copy, each unchanged."""
    rng = np.random.default_rng(2)
    arrays = {"b": rng.random((3, 5)) < 0.5,
              "i": rng.integers(-9, 9, (4, 7)).astype(np.int32),
              "f": rng.standard_normal((2, 3, 5)).astype(np.float32),
              "l": rng.integers(0, 1 << 40, 9),
              "t": torch.arange(6)}
    got = X.upload(arrays, "cpu")
    for k, v in arrays.items():
        want = v if torch.is_tensor(v) else torch.from_numpy(v)
        assert got[k].dtype == want.dtype and torch.equal(got[k], want)


@pytest.mark.parametrize("consistency", [5, 0], ids=["default", "fast"])
def test_failing_hook_raises_cleanly(consistency):
    """A DP backend failure must surface as a clean Python error, never
    as native memory corruption from the placeholder path, and must not
    poison later runs (tests/test_exact_dp.py:99,134 for the reference)."""
    calls = {"n": 0}

    def broken_hook(*args):
        calls["n"] += 1
        return 1
    cb = native.DP_HOOK_TYPE(broken_hook)
    native.set_dp_hook(cb)
    try:
        msa = tio.read_inputs([os.path.join(DATA, "small.fa")])
        msa.quiet = True
        with pytest.raises(RuntimeError):
            TE.align_msa(msa, consistency_anchors=consistency,
                         engine="host")
        assert calls["n"] >= 1
        native.set_dp_hook(None)
        msa2 = tio.read_inputs([os.path.join(DATA, "small.fa")])
        msa2.quiet = True
        out = TE.align_msa(msa2, consistency_anchors=consistency,
                           engine="host")
        assert out.alnlen > 0
    finally:
        native.set_dp_hook(None)


def test_failing_sweep_raises_with_its_traceback(monkeypatch):
    """A sweep that fails inside the gpu engine's callbacks stops the
    native runtime; the engine raises with the callback's traceback, and
    the native DP never runs in its place."""
    def broken(self, plans, key, live):
        raise RuntimeError("sweep refused")
    monkeypatch.setattr(X.Sweeper, "run", broken)
    with pytest.raises(RuntimeError, match="canary|sweep refused"):
        TE.GpuExactEngine("cpu")
    monkeypatch.undo()
    eng = TE.GpuExactEngine("cpu")
    monkeypatch.setattr(X.Sweeper, "run", broken)
    for consistency in (5, 0):
        msa = tio.read_inputs([os.path.join(DATA, "small.fa")])
        msa.quiet = True
        with pytest.raises(RuntimeError, match="device DP backend failed"
                           "(.|\n)*sweep refused"):
            TE.align_msa(msa, consistency_anchors=consistency, engine=eng)


def test_packing_budget_changes_no_bit(oracle, monkeypatch):
    """The consistency pre-pass's pairs through ExactPairBatch with no
    packing budget and with 128 virtual rows (several problems per grid,
    several chunks per launch), and BB12006 in default mode through the
    gpu engine at both budgets: identical paths and FASTA."""
    L, subm, g = oracle
    rng = np.random.default_rng(5)
    pairs = []
    for _ in range(12):
        la = int(rng.integers(1, 40))
        lb = int(rng.integers(la, 60))
        pairs.append((rng.integers(0, 23, la).astype(np.uint8),
                      rng.integers(0, 23, lb).astype(np.uint8)))
    out = {}
    for budget in (0, 128):
        monkeypatch.setitem(X.PACK_BUDGET, "cpu", budget)
        batch = X.ExactPairBatch(pairs, subm.reshape(23, 23), *g)
        paths = [np.full(len(a) + 2, -1, np.int32) for a, _ in pairs]
        batch.run(paths)
        out[budget] = (paths, batch.VR, batch.sweeper.grids)
        m = tio.read_alignment(os.path.join(DATA, "BB12006.tfa"))
        m.quiet = True
        res = TE.align_msa(m, consistency_anchors=5, engine="gpu",
                           device="cpu")
        out[budget] += (tio.format_alignment(res, "fasta"),)
    assert out[128][1] == 128 and out[0][1] < 128
    assert out[128][2] < out[0][2]
    for a, b in zip(out[0][0], out[128][0]):
        assert np.array_equal(a, b)
    assert out[0][3] == out[128][3]
    # and the pairs' paths are the native oracle's
    for (a, b), path in zip(pairs, out[0][0]):
        ref = np.full(len(b) + 2, -1, np.int32)
        info = np.zeros(3, np.float32)
        L.kt_run_align_single(0, a.ctypes.data, b.ctypes.data, None, None,
                              len(a), len(b), 0, subm, g[0], g[1], g[2],
                              np.float32(0.0), None, len(b), 0.0, 0, 1, 0,
                              ref, info)
        assert np.array_equal(ref[:len(a) + 2], path)


def test_canary_passes_on_the_cpu():
    rec = X.exactness_canary(X.Sweeper("cpu"))
    assert rec["path_equal"] and rec["margin_count"] > 0
    eng = TE.GpuExactEngine("cpu")
    assert eng.stats["canary"]["device"] == "cpu"
    assert eng.stats["engine"] == "gpu" and eng.stats["tree"] == "native"


# --------------------------------------------------------------------
# the kernel's band-local schedule (csrc/exact_sweep.cu), in PyTorch
# --------------------------------------------------------------------

def band_local_sweep(p, VR, C, Wmax, use_chain, ncols, strip):
    """The sweep as csrc/exact_sweep.cu schedules it: row vr computes
    column d - lag[vr] at step d, each strip of ``strip`` rows in turn
    over its own grid's steps (exact_sweep.schedule), a strip's first row
    reading the previous strip's last row by column.  Same formulas as
    exact_sweep.plain; out [G, Wmax, ncols, 3]."""
    lag, span = XS.schedule(p, ncols, strip)
    t = {k: torch.as_tensor(np.asarray(v)) for k, v in p.items()}
    G = t["seedA"].shape[0]
    lag, span = torch.from_numpy(lag).long(), torch.from_numpy(span).long()
    cols = {k: t[k][:, VR:VR + C + 1].flip(1) for k in XS.COL_F32}
    p2 = t["p2sub_p"][:, VR:VR + C + 1].flip(1)
    match, bonus = (XS._padded(t[k], C + 1) for k in ("match", "bonus"))
    out = torch.full((G, Wmax, C + 1, 3), float("-inf"))
    edge = torch.full((3, G, C + 1), float(NEG))
    gi = torch.arange(G)[:, None]
    for s in range(VR // strip):
        rows = torch.arange(s * strip, (s + 1) * strip)
        r = {k: t[k][:, rows] for k in XS.ROW_BOOL + XS.ROW_INT
             + XS.ROW_F32}
        L = lag[:, rows]
        neg = torch.full((G, strip), float(NEG))
        S1 = U = torch.full((3, G, strip), float(NEG))
        nxt = torch.full((3, G, C + 1), float(NEG))
        d0, d1 = span[:, s, 0], span[:, s, 1]
        for d in range(int(d0.min()), int(d1.max())):
            jv = d - L
            inwin = (r["active"] & (jv >= r["startq"]) & (jv <= r["endq"])
                     & ((d >= d0) & (d < d1))[:, None])
            jc = jv.clamp(0, C)
            if s == 0:
                up0 = torch.full((3, G, 1), float(NEG))
            else:
                up0 = torch.where(inwin[:, :1], edge[:, gi, jc[:, :1]],
                                  torch.tensor(float(NEG)))
            Up = torch.cat([up0, S1[:, :, :-1]], dim=2)
            A_l, GA_l = S1[0], S1[1]
            A_u, GA_u, GB_u = Up
            A_d, GA_d, GB_d = U
            ga_ext, ga_open, ga_tg, dga = (cols[k].gather(1, jc)
                                           for k in XS.COL_F32)
            at_start, at_end = jv == r["startq"], jv == r["endq"]
            ga_chain = torch.maximum(GA_l + ga_ext, A_l + ga_open)
            ga_chain_tg = torch.maximum(GA_l, A_l) + ga_tg
            iA = torch.where(at_start, r["seedA"], neg)
            iGA = torch.where(at_start, r["seedGA"],
                              torch.where(at_end, neg,
                                          torch.where(r["init_tg"],
                                                      ga_chain_tg, ga_chain)))
            iGB = torch.where(at_start, r["seedGB"], neg)
            a_int = torch.maximum(torch.maximum(A_d, GA_d + dga),
                                  GB_d + r["dgb"])
            if use_chain:
                prod = t["p1cnt"][:, rows] * p2[gi, jc]
                for c in range(XS.NSUB - 1, -1, -1):
                    a_int = a_int + prod[..., c]
            else:
                a_int = a_int + match[gi, rows[None], jc]
            a_int = a_int + bonus[gi, rows[None], jc]
            pA = torch.where(at_start, neg, a_int)
            pGA = torch.where(at_start | at_end, neg, ga_chain)
            gb_std = torch.maximum(GB_u + r["gb_ext"], A_u + r["gb_open"])
            gb_tgv = torch.maximum(GB_u, A_u) + r["gb_tg"]
            pGB = torch.where(at_start,
                              torch.where(r["start_tg"], gb_tgv, gb_std),
                              torch.where(at_end,
                                          torch.where(r["end_tg"], gb_tgv,
                                                      gb_std), gb_std))
            N = torch.where(inwin, torch.where(r["is_init"],
                                               torch.stack([iA, iGA, iGB]),
                                               torch.stack([pA, pGA, pGB])),
                            torch.tensor(float(NEG)))
            fin = r["is_final"] & inwin & (jv < ncols) & (r["win_slot"] < Wmax)
            g, k = torch.nonzero(fin, as_tuple=True)
            out[g, r["win_slot"][g, k].long(), jc[g, k]] = N[:, g, k].T
            g = torch.nonzero(inwin[:, -1], as_tuple=True)[0]
            nxt[:, g, jc[g, -1]] = N[:, g, -1]
            S1, U = N, Up
        edge = nxt
    return out[:, :, :ncols]


def assert_schedule_reaches_every_cell(p, ncols, strip):
    """schedule's lag and spans: every in-window cell below ncols of an
    active row runs inside its strip's span."""
    lag, span = XS.schedule(p, ncols, strip)
    startq, endq = np.asarray(p["startq"]), np.asarray(p["endq"])
    G, VR = startq.shape
    for g in range(G):
        for vr in np.flatnonzero(np.asarray(p["active"])[g]):
            d0, d1 = span[g, vr // strip]
            for j in range(startq[g, vr], min(endq[g, vr], ncols - 1) + 1):
                assert d0 <= lag[g, vr] + j < d1, (g, vr, j)


def hold_band_local(plans, key, live, strips=(None,)):
    """band_local_sweep against exact_sweep.plain on one plan: the live
    windows' outputs bit for bit, at each strip height."""
    VR, C, Wmax, chain = key
    W, ncols = live
    tp = {k: torch.as_tensor(np.asarray(v)) for k, v in plans.items()}
    ref = XS.plain(tp, VR, C, Wmax, chain, XS.live_steps(VR, C, ncols))
    for strip in strips:
        strip = VR if strip is None else min(strip, VR)
        assert_schedule_reaches_every_cell(plans, ncols, strip)
        got = band_local_sweep(plans, VR, C, Wmax, chain, ncols, strip)
        assert np.array_equal(bits(got[:, :W]), bits(ref[:, :W, :ncols])), \
            (key, live, strip)


@pytest.mark.parametrize("use_chain", [False, True], ids=["match", "chain"])
@pytest.mark.parametrize("ncols", [32, 17])
def test_band_local_schedule_matches_plain_on_random_plans(use_chain, ncols):
    """Random plans (ragged bands, windows with startq > 0, -FLT_MAX
    seeds), both operand forms: the kernel's band-local schedule gives
    plain's bits in one strip and in strips of 8 rows (bands crossing
    strips), at all columns and at a live width."""
    rng = np.random.default_rng(21 + use_chain)
    G, VR, C = 3, 32, 31
    p = random_plan(rng, G, VR, C, use_chain)
    assert (p["startq"][p["active"]] > 0).any()
    hold_band_local(p, (VR, C, VR, use_chain), (VR, ncols), (None, 8))


def test_schedule_of_the_reference_is_lag_vr():
    """exact_sweep.schedule with band_local=False is the reference's
    schedule, lag = vr, within its live steps; the band-local schedule's
    steps are never more and start every band at step 0."""
    rng = np.random.default_rng(4)
    G, VR, C = 2, 32, 31
    p = random_plan(rng, G, VR, C, False)
    lag, span = XS.schedule(p, C + 1, band_local=False)
    assert np.array_equal(lag, np.broadcast_to(np.arange(VR), (G, VR)))
    assert (span[:, 0, 1] <= XS.live_steps(VR, C, C + 1)).all()
    assert_schedule_reaches_every_cell(p, C + 1, VR)
    lag_b, span_b = XS.schedule(p, C + 1)
    assert (span_b[:, 0, 1] - span_b[:, 0, 0]
            <= span[:, 0, 1] - span[:, 0, 0]).all()
    init = p["is_init"] & p["active"]
    assert (lag_b[init] + p["startq"][init] == 0).all()
    assert XS.steps_run(span_b) == int((span_b[..., 1]
                                        - span_b[..., 0]).max())


def capture_launches(monkeypatch, keep):
    """Every sweep launch through exact.Sweeper.run passed to keep(plans,
    key, live, modes) first, modes the operand modes of its problems."""
    run, build = X.Sweeper.run, X._plans
    seen = {}

    def build_rec(ops, w, *args, **kw):
        seen["modes"] = ("pairs" if ops.kind == "pairs"
                         else tuple(sorted(set(ops.mode[w.p].tolist()))))
        return build(ops, w, *args, **kw)

    def run_rec(self, plans, key, live):
        keep(plans, key, live, seen.get("modes"))
        return run(self, plans, key, live)
    monkeypatch.setattr(X, "_plans", build_rec)
    monkeypatch.setattr(X.Sweeper, "run", run_rec)


@pytest.mark.parametrize("budget", [0, 128])
def test_band_local_schedule_matches_plain_on_packed_pairs(oracle,
                                                           monkeypatch,
                                                           budget):
    """The pre-pass's pairs as ExactPairBatch packs them (one pair a grid,
    and several pairs a grid at 128 virtual rows): every launch of the
    recursion, the band-local schedule = plain, in one strip and in
    strips of 16 rows."""
    L, subm, g = oracle
    rng = np.random.default_rng(9)
    pairs = [(rng.integers(0, 23, int(rng.integers(1, 40))).astype(np.uint8),
              rng.integers(0, 23, int(rng.integers(20, 60))).astype(np.uint8))
             for _ in range(10)]
    launches = []
    capture_launches(monkeypatch,
                     lambda *a: launches.append(a[:3]))
    monkeypatch.setitem(X.PACK_BUDGET, "cpu", budget)
    batch = X.ExactPairBatch(pairs, subm.reshape(23, 23), *g)
    batch.run([np.full(len(a) + 2, -1, np.int32) for a, _ in pairs])
    assert len(launches) > 3
    assert (batch.VR == 128) == (budget == 128)
    for plans, key, live in launches:
        hold_band_local(plans, key, live, (None, 16))


def test_band_local_schedule_matches_plain_on_bb12006_merges(oracle,
                                                             monkeypatch):
    """BB12006 through the gpu engine in default mode on the CPU: the
    first merge launch holding each of its operand modes (residues x
    residues, profile x profile; it has no profile x residues merge, so
    that one comes from a batch of three random such merges with
    bonuses), the band-local schedule = plain, in one strip and in strips
    of 64 rows."""
    first = {}

    def keep(plans, key, live, modes):
        for mode in (() if modes == "pairs" else modes):
            first.setdefault(mode, (plans, key, live))
    capture_launches(monkeypatch, keep)
    m = tio.read_alignment(os.path.join(DATA, "BB12006.tfa"))
    m.quiet = True
    TE.align_msa(m, consistency_anchors=5, engine="gpu", device="cpu")
    assert set(first) == {0, 2}
    rng = np.random.default_rng(13)
    alns = [X.ExactAligner(*a) for a in _operands(oracle, rng, 1, 3, True)]
    VR = max(a.VR for a in alns)
    C = max(a.Cpad for a in alns)
    for a in alns:
        a.VR, a.Cpad, a.Wmax = VR, C, VR
    X.run_merge_batch(alns, [np.full(a.la + 2, -1, np.int32) for a in alns])
    assert set(first) == {0, 1, 2}
    for plans, key, live in {id(v[0]): v for v in first.values()}.values():
        hold_band_local(plans, key, live, (None, 64))


def test_exact_split_covers_the_alignment(monkeypatch):
    """GpuExactEngine's exact_split_s on the CPU: the native runtime,
    plan building, enqueueing and fetching, none negative, enqueue and
    fetch seen, together no more than the alignment's wall; sweep_steps
    counts the reference schedule's live steps that the plain version
    ran."""
    import time
    eng = TE.GpuExactEngine("cpu")
    launches = []
    run = X.Sweeper.run

    def rec(self, plans, key, live):
        launches.append(XS.live_steps(key[0], key[1], live[1]))
        return run(self, plans, key, live)
    monkeypatch.setattr(X.Sweeper, "run", rec)
    msa = tio.read_inputs([os.path.join(DATA, "small.fa")])
    msa.quiet = True
    t0 = time.perf_counter()
    TE.align_msa(msa, consistency_anchors=5, engine=eng)
    wall = time.perf_counter() - t0
    sp = eng.stats["exact_split_s"]
    assert set(sp) == {"native", "plans", "enqueue", "fetch"}
    assert all(v >= 0 for v in sp.values())
    assert sp["enqueue"] > 0 and sp["fetch"] > 0 and sp["plans"] > 0
    assert sum(sp.values()) <= wall
    assert eng.stats["sweep_steps"] == sum(launches) > 0
