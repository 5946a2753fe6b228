"""Tools of the port: depth-map dumps."""
from .colormap import depth_to_inferno, save_depth

__all__ = ["depth_to_inferno", "save_depth"]
