"""bonus_miss: of the cells of a merge's match that the anchor bonus is
due in, the share the program's match preparation got wrong (a cell
that is off where none is due counts too), in four rows of the first
problem of the last match block each alignment prepared (a merge of
its last level).  Judges the match
preparation (gpu/prepare.py::prepare_match, csrc/prepare_match.cu: the
centering bias and the consistency bonus added to a merge's match
before its DP) against the bonus worked out here from the block's
anchor positions and confidences and the traffic's consistency weight
over its anchors (Kalign's consistency_anchor_weight / K), a cell
counted off where it misses by more than four float32 steps of the
match (a merge's match scores run to 1e5 and more, so a bonus below a
step is no bonus to the DP and is not counted due):

  bonus[i, j] = w / K * sum_k conf_r[k, i] conf_c[k, j]
                [apos_r[k, i] == apos_c[k, j] >= 0]

and the bias |j - i lb / la| eps (kalign_tpu/tpu/engine.py:71-100).
The positions and confidences are the program's (its state at the
merge; the maps they come from are judged by map_miss).  An alignment
whose preparation was not seen reads 1; a traffic mix without
consistency reads 0."""

import torch

# the rows judged, as shares of the block's rows
ROWS = (0.1, 0.35, 0.6, 0.85)
KEEP_LAST = True


def _args(args, kwargs):
    names = ("match", "la", "lb", "bias_eps", "bonus", "col0", "row0")
    got = dict(zip(names, args))
    got.update(kwargs)
    got.setdefault("col0", 0)
    got.setdefault("row0", 0)
    return got


def record(call, args, kwargs):
    """The call, with the ROWS of its first problem copied before and
    after it (the preparation works in place, and the wave route reuses
    its block); its other arguments are kept as they are, one call an
    alignment (KEEP_LAST), so that a call costs two copies."""
    a = _args(args, kwargs)
    m = a["match"]
    R = m.shape[1]
    rows = sorted({min(R - 1, int(R * f)) for f in ROWS})

    def pick(t):
        return torch.stack([t[0, r] for r in rows])

    before = pick(m)
    out = call(*args, **kwargs)
    return out, dict(a, match=None, rows=rows, before=before,
                     after=pick(out))


AROUND = [("kalign_tpu_torch.gpu.engine:prepare_match", record),
          ("kalign_tpu_torch.gpu.prepare:prepare_match", record)]


def value(fam, rows, records, ctx):
    cons = ctx["traffic"].get("consistency")
    if not cons:
        return 0.0
    if not records:
        return 1.0
    rec = records[-1]
    f64 = torch.float64
    per_w = cons["weight"] / min(cons["anchors"], len(fam[0]))
    before = rec["before"].cpu().to(f64)
    after = rec["after"].cpu().to(f64)
    la, lb = float(rec["la"][0]), float(rec["lb"][0])
    eps = float(rec["bias_eps"][0])
    _, apr, cfr, apc, cfc = rec["bonus"]
    rr = torch.tensor(rec["rows"])
    W = before.shape[1]
    ii = torch.tensor([rec["row0"] + r + 1 for r in rec["rows"]],
                      dtype=f64)[:, None]
    jj = torch.arange(rec["col0"] + 1, rec["col0"] + W + 1,
                      dtype=f64)[None, :]
    bias = (jj - ii * (lb / max(la, 1.0))).abs() * eps
    apr = apr[0].cpu()[:, rr]
    cfr = cfr[0].cpu()[:, rr].to(f64)
    apc, cfc = apc[0].cpu(), cfc[0].cpu().to(f64)
    eq = (apr[:, :, None] == apc[:, None, :]) & (apr[:, :, None] >= 0)
    expect = (per_w * cfr[:, :, None] * cfc[:, None, :] * eq).sum(0)
    live = (ii <= la) & (jj <= lb)
    got = after - before + bias
    tol = 4 * ulp32(before.abs() + bias + expect) + 1e-6 * jj * abs(eps)
    off = ((got - expect).abs() > tol) & live
    due = int(((expect > tol) & live).sum())
    return int(off.sum()) / due if due else 1.0


def ulp32(x):
    """The spacing of float32 numbers at x (> 0)."""
    return torch.pow(2.0, torch.floor(torch.log2(x.clamp(min=1e-30))) - 23)
