"""State carried between the JAX package and the port, as numpy arrays.

``cloud_from_numpy`` and ``transform_from_numpy`` take a JAX
``PointCloud`` or ``Transform`` read as numpy arrays (padding and mask
included, so both packages see the same capacity) and build the port's
types; ``cloud_to_numpy`` and ``transform_to_numpy`` go back. The
system has no learned weights: besides the clouds, the state both
packages share is their configs, which ``fpfh_config_from``,
``shot_config_from``, ``global_registration_config_from``,
``multiscale_config_from``, ``gicp_config_from``, ``ndt_config_from``,
``patchwork_config_from`` and ``kiss_icp_config_from`` carry over field
by field.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .core.point_cloud import PointCloud
from .core.transform import Transform
from .ops.features import FpfhConfig, FpfhResult, ShotConfig, ShotResult
from .ops.gicp import GicpConfig
from .ops.global_registration import GlobalRegistrationConfig
from .ops.ground import PatchworkConfig
from .ops.kiss_icp import KissIcpConfig
from .ops.ndt import NdtConfig
from .ops.registration import MultiscaleConfig


def cloud_from_numpy(points, mask, attrs: Optional[Dict] = None,
                     device="cuda") -> PointCloud:
    """A port ``PointCloud`` with exactly these padded rows and mask, on
    the card unless ``device`` says otherwise."""
    def put(x, dtype):
        return torch.as_tensor(np.array(x), dtype=dtype, device=device)

    return PointCloud(put(points, torch.float32), put(mask, torch.bool),
                      {k: put(v, torch.float32) for k, v in (attrs or {}).items()})


def transform_from_numpy(m, device="cuda") -> Transform:
    return Transform(torch.as_tensor(np.array(m), dtype=torch.float32,
                                     device=device))


def cloud_to_numpy(cloud: PointCloud) -> Tuple[np.ndarray, np.ndarray,
                                               Dict[str, np.ndarray]]:
    """(points, mask, attrs) of a port cloud, padding included."""
    return (cloud.points.cpu().numpy(), cloud.mask.cpu().numpy(),
            {k: v.cpu().numpy() for k, v in cloud.attrs.items()})


def transform_to_numpy(t: Transform) -> np.ndarray:
    return t.matrix.cpu().numpy()


def _config_from(cls, config):
    return cls(**{f.name: getattr(config, f.name) for f in dataclasses.fields(cls)})


def fpfh_config_from(config) -> FpfhConfig:
    """The port's ``FpfhConfig`` with the fields of a JAX ``FpfhConfig``."""
    return _config_from(FpfhConfig, config)


def shot_config_from(config) -> ShotConfig:
    """The port's ``ShotConfig`` with the fields of a JAX ``ShotConfig``."""
    return _config_from(ShotConfig, config)


def global_registration_config_from(config) -> GlobalRegistrationConfig:
    """The port's ``GlobalRegistrationConfig`` with the fields of a JAX one."""
    return _config_from(GlobalRegistrationConfig, config)


def multiscale_config_from(config) -> MultiscaleConfig:
    """The port's ``MultiscaleConfig`` with the fields of a JAX one."""
    return _config_from(MultiscaleConfig, config)


def gicp_config_from(config) -> GicpConfig:
    """The port's ``GicpConfig`` with the fields of a JAX ``GicpConfig``."""
    return _config_from(GicpConfig, config)


def ndt_config_from(config) -> NdtConfig:
    """The port's ``NdtConfig`` with the fields of a JAX ``NdtConfig``."""
    return _config_from(NdtConfig, config)


def patchwork_config_from(config) -> PatchworkConfig:
    """The port's ``PatchworkConfig`` with the fields of a JAX one."""
    return _config_from(PatchworkConfig, config)


def kiss_icp_config_from(config) -> KissIcpConfig:
    """The port's ``KissIcpConfig`` with the fields of a JAX one."""
    return _config_from(KissIcpConfig, config)


def fpfh_result_to_numpy(res: FpfhResult) -> Tuple[np.ndarray, np.ndarray]:
    """(descriptors (N, 33), valid (N,)) of a port ``FpfhResult``."""
    return res.descriptors.cpu().numpy(), res.valid.cpu().numpy()


def shot_result_to_numpy(res: ShotResult) -> Tuple[np.ndarray, np.ndarray]:
    """(descriptors (N, dim), valid (N,)) of a port ``ShotResult``."""
    return res.descriptors.cpu().numpy(), res.valid.cpu().numpy()
