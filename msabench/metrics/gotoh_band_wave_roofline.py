"""gotoh_band_wave_roofline (%, device trace): the band kernel's wave
route (csrc/gotoh_mesh.cu, gotoh_band_wave_kernel: a band of a
column-sharded DP that has its card to itself, or past 114,688 columns)
against its roofline.  Each launch (gpu/gotoh_mesh.py::launch) runs the
rows r0 + 1 .. r0 + nr of one band of the columns c0 + 1 .. c0 + Wd; it
needs the rows below la and the band's columns below lb, at the row
kernels' bytes and operations a cell (msabench/counts.py), and its
strips: the left band's read and its own written, STRIP floats a row and
one more (the first band writes only)."""

from msabench import counts, readers

KERNEL = "gotoh_band_wave_kernel"
STRIP = 5          # floats a strip row (gpu/gotoh_mesh.py STRIP)


def record(args, kwargs):
    band, _m, _strip_in, _strip_out, r0, nr, la, lb, first = args[:9]
    cfg = band.get("cfg")
    if getattr(cfg, "route", None) != "wave":
        return None
    return (int(r0), int(nr), int(la), int(lb), int(band["c0"]),
            int(band["dec"].shape[1]), bool(first))


PROBE = ("kalign_tpu_torch.gpu.gotoh_mesh:launch", record)


def least_s(rec) -> float:
    """The least seconds of one launch: its bytes or its operations."""
    r0, nr, la, lb, c0, Wd, first = rec
    rows = max(0, min(la, r0 + nr) - r0)
    cols = max(0, min(lb, c0 + Wd) - c0)
    if not rows or not cols:
        return 0.0
    bytes_, ops = counts.gotoh_launch([rows], [cols])
    bytes_ += (1 if first else 2) * (rows + 1) * STRIP * 4
    return counts.bound_s(bytes_, ops)[0]


def read(run):
    recs = [r for r in run.probes.get(readers.name_of(__file__)) or []
            if r is not None]
    if run.trace is None or not recs:
        return None
    least = sum(least_s(r) for r in recs)
    spent = run.trace.kernel_s(KERNEL)
    if spent <= 0 or least <= 0:
        return None
    return 100.0 * least / spent
