"""gotoh_row_cluster_roofline (%, device trace): the row kernel's
cluster instantiation (csrc/gotoh_row.cu, 7,296 to 114,688 columns)
against its roofline.  Each launch of gpu/gotoh_row.py::launch on the
"cluster" route runs its batch's problems, each la x lb cells
(msabench/counts.py)."""

from msabench import readers

KERNEL = "gotoh_row_cluster_kernel"


def record(args, kwargs):
    from kalign_tpu_torch.gpu import gotoh_row
    match, _prep, la, lb = args[:4]
    cfg = kwargs.get("config") or (args[4] if len(args) > 4 else None) \
        or gotoh_row.launch_config(match.shape[0], match.shape[2])
    return (cfg.route, la, lb)


PROBE = ("kalign_tpu_torch.gpu.gotoh_row:launch", record)


def problems(rec, cache):
    route, la, lb = rec
    if route != "cluster":
        return []
    return list(zip(readers.host(la, cache), readers.host(lb, cache)))


def read(run):
    return readers.roofline(run, readers.name_of(__file__), KERNEL,
                            problems)
