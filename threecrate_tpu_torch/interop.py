"""State carried between the JAX package and the port, as numpy arrays.

``cloud_from_numpy`` and ``transform_from_numpy`` take a JAX
``PointCloud`` or ``Transform`` read as numpy arrays (padding and mask
included, so both packages see the same capacity) and build the port's
types; ``cloud_to_numpy`` and ``transform_to_numpy`` go back. The
system has no learned weights: besides the clouds, the state both
packages share is their configs, which ``fpfh_config_from``,
``shot_config_from``, ``global_registration_config_from``,
``multiscale_config_from``, ``gicp_config_from``, ``ndt_config_from``,
``patchwork_config_from``, ``kiss_icp_config_from`` and
``frame_to_model_config_from`` carry over field by field. The depth
pipeline's state comes over as numpy arrays too: a fused dense or sparse
TSDF volume (``tsdf_volume_from_numpy``, ``sparse_tsdf_volume_from_numpy``)
and raycast model maps (``raycast_result_from_numpy``), so both packages
can be fed the same volume and maps. So do the surface slice's: a padded
``TriangleMesh`` (``mesh_from_numpy`` / ``mesh_to_numpy``, the same
capacities as JAX's), a ``VolumetricGrid`` (``grid_from_numpy``) and
``PoissonConfig`` (``poisson_config_from``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .core.mesh import TriangleMesh
from .core.point_cloud import PointCloud
from .core.transform import Transform
from .ops.features import FpfhConfig, FpfhResult, ShotConfig, ShotResult
from .ops.frame_to_model import FrameToModelConfig
from .ops.gicp import GicpConfig
from .ops.global_registration import GlobalRegistrationConfig
from .ops.ground import PatchworkConfig
from .ops.kiss_icp import KissIcpConfig
from .ops.ndt import NdtConfig
from .ops.registration import MultiscaleConfig
from .ops.tsdf import TsdfVolume
from .ops.tsdf_raycast import RaycastResult
from .ops.tsdf_sparse import SparseTsdfVolume
from .reconstruction.marching_cubes import VolumetricGrid
from .reconstruction.poisson import PoissonConfig


def _put(x, dtype, device):
    """A copy of ``x`` as a tensor on ``device`` (None stays None)."""
    return None if x is None else torch.as_tensor(np.array(x), dtype=dtype, device=device)


def cloud_from_numpy(points, mask, attrs: Optional[Dict] = None,
                     device="cuda") -> PointCloud:
    """A port ``PointCloud`` with exactly these padded rows and mask, on
    the card unless ``device`` says otherwise."""
    return PointCloud(_put(points, torch.float32, device), _put(mask, torch.bool, device),
                      {k: _put(v, torch.float32, device) for k, v in (attrs or {}).items()})


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


def frame_to_model_config_from(config) -> FrameToModelConfig:
    """The port's ``FrameToModelConfig`` with the fields of a JAX one."""
    return _config_from(FrameToModelConfig, config)


def poisson_config_from(config) -> PoissonConfig:
    """The port's ``PoissonConfig`` with the fields of a JAX one."""
    return _config_from(PoissonConfig, config)


def mesh_from_numpy(vertices, faces, vertex_mask, face_mask, attrs: Optional[Dict] = None,
                    device="cuda") -> TriangleMesh:
    """A port ``TriangleMesh`` with exactly these padded rows and masks
    (a JAX mesh read as numpy arrays), on ``device``."""
    return TriangleMesh(_put(vertices, torch.float32, device), _put(faces, torch.int32, device),
                        _put(vertex_mask, torch.bool, device), _put(face_mask, torch.bool, device),
                        {k: _put(v, torch.float32, device) for k, v in (attrs or {}).items()})


def mesh_to_numpy(mesh: TriangleMesh):
    """(vertices, faces, vertex_mask, face_mask, attrs) of a port mesh,
    padding included."""
    return (mesh.vertices.cpu().numpy(), mesh.faces.cpu().numpy(),
            mesh.vertex_mask.cpu().numpy(), mesh.face_mask.cpu().numpy(),
            {k: v.cpu().numpy() for k, v in mesh.attrs.items()})


def grid_from_numpy(values, origin, spacing, device="cuda") -> VolumetricGrid:
    """The port's ``VolumetricGrid`` with a JAX grid's fields, on ``device``."""
    return VolumetricGrid(*(_put(x, torch.float32, device) for x in (values, origin, spacing)))


def tsdf_volume_from_numpy(tsdf, weight, color, origin, voxel_size, truncation,
                           device="cuda") -> TsdfVolume:
    """The port's ``TsdfVolume`` with a JAX volume's fields (read as
    numpy arrays; ``color`` may be None), on ``device``."""
    f32 = torch.float32
    return TsdfVolume(*(_put(x, f32, device) for x in (tsdf, weight, color, origin,
                                                         voxel_size, truncation)))


def sparse_tsdf_volume_from_numpy(block_keys, n_blocks, tsdf, weight, origin, voxel_size,
                                  truncation, color=None, device="cuda") -> SparseTsdfVolume:
    """The port's ``SparseTsdfVolume`` with a JAX sparse volume's fields
    (read as numpy arrays, in the JAX field order), on ``device``."""
    f32 = torch.float32
    return SparseTsdfVolume(_put(block_keys, torch.int32, device),
                            _put(n_blocks, torch.int32, device),
                            *(_put(x, f32, device) for x in (tsdf, weight, origin, voxel_size,
                                                             truncation, color)))


def raycast_result_from_numpy(depth, vertices, normals, mask, confident=None, color=None,
                              device="cuda") -> RaycastResult:
    """The port's ``RaycastResult`` with a JAX result's maps (read as
    numpy arrays; ``confident`` and ``color`` may be None), on ``device``."""
    f32, b = torch.float32, torch.bool
    return RaycastResult(_put(depth, f32, device), _put(vertices, f32, device),
                         _put(normals, f32, device), _put(mask, b, device),
                         _put(confident, b, device), _put(color, f32, device))


def fpfh_result_to_numpy(res: FpfhResult) -> Tuple[np.ndarray, np.ndarray]:
    """(descriptors (N, 33), valid (N,)) of a port ``FpfhResult``."""
    return res.descriptors.cpu().numpy(), res.valid.cpu().numpy()


def shot_result_to_numpy(res: ShotResult) -> Tuple[np.ndarray, np.ndarray]:
    """(descriptors (N, dim), valid (N,)) of a port ``ShotResult``."""
    return res.descriptors.cpu().numpy(), res.valid.cpu().numpy()
