"""The row Gotoh kernels' count functions on known shapes."""

import pytest

from msabench import counts


def test_one_launch():
    b, ops = counts.gotoh_launch([10, 3], [20, 4])
    cells = 10 * 20 + 3 * 4
    assert ops == cells * counts.GOTOH_OPS_PER_CELL
    assert b == cells * 5 + (30 + 7) * 12 + 2 * 8


def test_the_least_time_is_bound_by_bytes_at_these_rates():
    # 5 bytes / 3.35e12 against 19 operations / 33.5e12 a cell
    rows, cols = [155943], [155950]
    b, ops = counts.gotoh_launch(rows, cols)
    t, by = counts.bound_s(b, ops)
    assert by == "bytes" and t == pytest.approx(b / 3.35e12)
    assert counts.least_seconds([[(155943, 155950)], [], [(10, 20)]]) == \
        pytest.approx(t + counts.bound_s(*counts.gotoh_launch([10], [20]))[0])


def test_a_wave_block_counts_its_rows_below_la():
    import torch
    from msabench import manifest
    from msabench.tests.conftest import ROOT
    wave = manifest.Manifest(ROOT).reader("gotoh_row_wave_roofline")
    la, lb = torch.tensor([5, 100], dtype=torch.int32), \
        torch.tensor([7, 200], dtype=torch.int32)
    cache = {}
    assert [wave.problems((1, r0, 64, la, lb), cache)
            for r0 in (0, 64, 128)] == [[(64, 200)], [(36, 200)], [(0, 200)]]


def test_a_row_launch_counts_its_route_only():
    import torch
    from msabench import manifest
    from msabench.tests.conftest import ROOT
    row = manifest.Manifest(ROOT).reader("gotoh_row_cluster_roofline")
    la, lb = torch.tensor([9000, 8000]), torch.tensor([9100, 7999])
    assert row.problems(("cluster", la, lb), {}) == [(9000, 9100),
                                                     (8000, 7999)]
    assert row.problems(("row", la, lb), {}) == []
