"""Hand-written CUDA kernels for Hopper (sources in ``csrc/``), each with
its plain PyTorch version and a launch counter on its wrapper."""

from . import fpfh, icp, knn, knn_window, shot
from .fpfh import (fpfh_weight_a_tiles, fpfh_weight_b_tiles, spfh_a_tiles,
                   spfh_b_tiles, spfh_band_a_tiles, spfh_band_b_tiles)
from .icp import icp_match_tiles
from .knn import window_normals_tiles, window_union_a_tiles, window_union_b_tiles
from .knn_window import knn_window_tiles
from .shot import (shot_hist_a_tiles, shot_hist_b_tiles, shot_moments_a_tiles,
                   shot_moments_b_tiles)

# every kernel wrapper of the port, by kernel name
WRAPPERS = {
    "union_window_a": window_union_a_tiles,
    "union_window_b": window_union_b_tiles,
    "icp_match": icp_match_tiles,
    "spfh_a": spfh_a_tiles,
    "spfh_b": spfh_b_tiles,
    "fpfh_weight_a": fpfh_weight_a_tiles,
    "fpfh_weight_b": fpfh_weight_b_tiles,
    "spfh_band_a": spfh_band_a_tiles,
    "spfh_band_b": spfh_band_b_tiles,
    "knn_window": knn_window_tiles,
    "shot_moments_a": shot_moments_a_tiles,
    "shot_moments_b": shot_moments_b_tiles,
    "shot_hist_a": shot_hist_a_tiles,
    "shot_hist_b": shot_hist_b_tiles,
    "window_normals": window_normals_tiles,
}


def launch_counts():
    """{kernel name: launches since the last ``reset_launch_counts``}."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts():
    for fn in WRAPPERS.values():
        fn.launches = 0
    knn_window_tiles.shape_launches.clear()
