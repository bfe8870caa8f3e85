"""The identity the union kernels' selection rests on, on the CPU.

The union passes bisect their radius: from ``hi = r2`` (the k-th smallest
squared distance among the query's ±band sorted neighbours) six fp32
halvings ``mid = 0.5 * (lo + hi)`` keep ``hi = mid`` wherever
``count(d2 <= mid) >= k`` over the 3-tile window. That count test is
exactly ``d_(k) <= mid``, with d_(k) the window's k-th smallest squared
distance (invalid columns at +inf), for every mid: inf, ties and
invalid columns included. So the same halvings run against d_(k) alone
give the same radius bit for bit, which is what the CUDA kernels do with
one selection sweep instead of six counting sweeps.

Here ``window_union_a_plain``'s radius row, and ``window_union_b_plain``'s
``use_b`` row (pass B's radius below pass A's), are held bit-equal to a
radius computed that way in numpy, on small clouds with duplicate points,
invalid columns and a last tile whose window holds k - 1 valid points, at
three scales.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from threecrate_tpu_torch.kernels.knn import (  # noqa: E402
    window_union_a_plain, window_union_b_plain)
from threecrate_tpu_torch.ops import morton  # noqa: E402
from union_clouds import radius_from_kth, union_cloud, window_d2  # noqa: E402

BAND = 16


@pytest.mark.parametrize("scale", [1e-2, 1.0, 1e2, "lattice"])
@pytest.mark.parametrize("k", [1, 3, 10, 16, 17, 64])
@pytest.mark.parametrize("tile", [64, 256])
def test_union_radius_is_bisection_of_kth(tile, k, scale):
    n = 4096
    band = max(BAND, k)
    pts, valid = union_cloud(n, tile, k, 1.0 if scale == "lattice" else scale, tile + k,
                             lattice=scale == "lattice")
    out_a = window_union_a_plain(pts, valid[None], k, tile, band)
    hi_a = radius_from_kth(window_d2(pts.numpy(), valid.numpy(), tile), k, tile, band)
    np.testing.assert_array_equal(out_a[10].numpy(), hi_a)

    order = torch.sort(morton.morton_keys(pts.T, valid > 0.5, 1), stable=True).indices
    pts_b, valid_b = pts[:, order].contiguous(), valid[order]
    hia_b = out_a[10][order]
    out_b = window_union_b_plain(pts_b, valid_b[None], order.to(torch.int32)[None],
                                 hia_b[None], k, tile, band)
    hi_b = radius_from_kth(window_d2(pts_b.numpy(), valid_b.numpy(), tile), k, tile, band)
    np.testing.assert_array_equal(out_b[10].numpy(),
                                  (hi_b < hia_b.numpy()).astype(np.float32))
