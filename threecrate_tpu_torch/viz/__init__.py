"""Visualization: device-side rendering + headless viewer
(threecrate-gpu renderers + threecrate-visualization equivalents).

Counterpart of ``threecrate_tpu.viz``; as there, the package root does
not import it: ``import threecrate_tpu_torch.viz``."""

from .camera import OrbitCamera
from .renderer import (
    MeshLightingParams,
    PbrMaterial,
    render_mesh,
    render_mesh_pbr,
    render_to_texture,
    render_point_cloud,
    save_image,
)
from .viewer import (
    ICPParams,
    InteractiveViewer,
    PipelineType,
    RANSACParams,
    ViewData,
    show_mesh,
    show_point_cloud,
)

__all__ = [
    "OrbitCamera", "render_mesh", "render_mesh_pbr", "render_to_texture",
    "PbrMaterial", "MeshLightingParams",
    "render_point_cloud", "save_image",
    "ICPParams", "InteractiveViewer", "PipelineType", "RANSACParams",
    "ViewData", "show_mesh", "show_point_cloud",
]
