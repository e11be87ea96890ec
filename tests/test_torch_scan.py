"""The prefix sums of the scan transform (gpu/scan.py, csrc/scan.cu):
several row sets in one call, each summed left to right in float32
(np.cumsum's order, which kalign_tpu's oracles use), and the descriptors
one kernel launch takes them in."""

import numpy as np
import pytest
import torch

from kalign_tpu_torch.gpu import scan


def _sets(rng):
    """Strided views as the prepare functions pass them: non-dyadic values
    (sums that round), one column, more rows than a block's tile."""
    x = (rng.standard_normal((1000, 3, 131)) * 39.4).astype(np.float32)
    x[:, 1] /= np.float32(217.0)
    t = torch.from_numpy(x)
    return [t[:, 1, 1:], t[:33, 2, :1], t[:1, 0, :], t[:7, 2, 3:130]]


def test_several_sets_sum_left_to_right_in_float32():
    rng = np.random.default_rng(21)
    views = _sets(rng)
    outs = scan.prefix_sums_f32(*views)
    assert len(outs) == len(views)
    for got, v in zip(outs, views):
        ref = np.cumsum(v.numpy(), axis=1, dtype=np.float32)
        assert got.shape == v.shape and got.is_contiguous()
        assert np.array_equal(got.numpy().view(np.int32), ref.view(np.int32))
        assert torch.equal(scan.prefix_sum_f32(v), got)


def test_descriptors_carry_each_views_row_stride():
    rng = np.random.default_rng(22)
    views = _sets(rng)
    outs = [torch.empty(v.shape) for v in views]
    desc = scan.descriptors(list(zip(views, outs)))
    assert len(desc) == 5 * len(views)
    for k, (v, o) in enumerate(zip(views, outs)):
        assert desc[5 * k:5 * k + 5] == [v.data_ptr(), 3 * 131, v.shape[0],
                                         v.shape[1], o.data_ptr()]


def test_launch_refuses_what_the_kernel_does_not_take():
    x = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        scan.launch(x)
    with pytest.raises(ValueError, match="per launch"):
        scan.launch(*([x] * (scan.MAX_SETS + 1)))
    with pytest.raises(ValueError, match="float32"):
        scan.prefix_sums_f32(torch.zeros((4, 8), dtype=torch.float64))
