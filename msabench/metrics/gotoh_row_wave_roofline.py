"""gotoh_row_wave_roofline (%, device trace): the wave route's kernel
(csrc/gotoh_row_wave.cu, past 114,688 columns) against its roofline.
Each launch (gpu/gotoh_wave.py::launch_block) runs rows r0 .. r0 + nr
of problem b; the rows it needs are those below la[b], each lb[b]
columns (msabench/counts.py)."""

from msabench import readers

KERNEL = "gotoh_row_wave_kernel"


def record(args, kwargs):
    m, _prep, b, _buf, _dec, r0, _k, la, lb = args[:9]
    return (int(b), int(r0), int(m.shape[0]), la, lb)


PROBE = ("kalign_tpu_torch.gpu.gotoh_wave:launch_block", record)


def problems(rec, cache):
    b, r0, nr, la, lb = rec
    rows = max(0, min(readers.host(la, cache)[b], r0 + nr) - r0)
    return [(rows, readers.host(lb, cache)[b])]


def read(run):
    return readers.roofline(run, readers.name_of(__file__), KERNEL,
                            problems)
