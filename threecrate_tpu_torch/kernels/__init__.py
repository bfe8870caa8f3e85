"""Hand-written CUDA kernels for Hopper (sources in ``csrc/``), each with
its plain PyTorch version and a launch counter on its wrapper."""

from . import icp, knn
from .icp import icp_match_tiles
from .knn import window_union_a_tiles, window_union_b_tiles

# every kernel wrapper of the port, by kernel name
WRAPPERS = {
    "union_window_a": window_union_a_tiles,
    "union_window_b": window_union_b_tiles,
    "icp_match": icp_match_tiles,
}


def launch_counts():
    """{kernel name: launches since the last ``reset_launch_counts``}."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts():
    for fn in WRAPPERS.values():
        fn.launches = 0
