"""Faults of the column-sharded route, planted underneath a run of the
four-card cell (test_msabench_khv.py), and its control: each is a
context manager that breaks what passes between a DP's bands, or rounds
its match, and puts it back on leaving.

* ``halo_reset``: every band's forward started as the first band's, from
  the DP's border instead of the strip of its left neighbour (a band
  state reset at each edge: the halo left out).
* ``handoff_zeroed``: the state the walk hands to the band on its left
  zeroed (the cell kept; 0 is the match state).
* ``match_bf16``: the control: each band's match, as its source makes it
  (the product, and on a merge the bias and the bonus added), rounded to
  bfloat16, the precision below the configuration's float32.
"""

from contextlib import contextmanager

import torch


@contextmanager
def _patched(owner, name, value):
    raw = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, raw)


@contextmanager
def halo_reset():
    from kalign_tpu_torch.gpu import gotoh_mesh
    launch, plain = gotoh_mesh.launch, gotoh_mesh.plain

    def first(run):
        def call(band, m, strip_in, strip_out, r0, nr, la, lb, is_first):
            return run(band, m, None, strip_out, r0, nr, la, lb, True)
        return call
    with _patched(gotoh_mesh, "launch", first(launch)), \
            _patched(gotoh_mesh, "plain", first(plain)):
        yield


def handoff_zeroed():
    from kalign_tpu_torch.gpu import traceback as tb
    walk_band = tb.walk_band

    def walk(dec, cell, col0, max_steps):
        steps, n, end = walk_band(dec, cell, col0, max_steps)
        end = end.clone()
        end[:, 2] = 0
        return steps, n, end
    return _patched(tb, "walk_band", walk)


def match_bf16():
    from kalign_tpu_torch.parallel import mesh
    band_source = mesh.band_source

    def source_of(*a, **k):
        src = band_source(*a, **k)

        def source(r0, r1, out=None):
            m = src(r0, r1, out)
            m.copy_(m.to(torch.bfloat16).to(torch.float32))
            return m
        return source
    return _patched(mesh, "band_source", source_of)


FAULTS = {"handoff_zeroed": handoff_zeroed, "match_bf16": match_bf16,
          "halo_reset": halo_reset}
