from .projection import Camera, ProjectedSurfels, project_surfels
from .binning import BinnedScene, bin_surfels, num_tiles, TILE
from .render import render, rasterize_binned, bin_for_camera

__all__ = [
    "Camera", "ProjectedSurfels", "project_surfels", "BinnedScene",
    "bin_surfels", "num_tiles", "TILE", "render", "rasterize_binned",
    "bin_for_camera",
]
