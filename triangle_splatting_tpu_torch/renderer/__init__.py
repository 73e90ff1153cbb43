"""Renderer facade of the port (object-style wrappers over ``ops.rasterize``;
port of ``triangle_splatting_tpu/renderer``): :class:`TriangleRenderer`,
:class:`GaussianRenderer` and :class:`MeshRenderer` (opaque renders of an
exported GLB)."""

from .triangle_renderer import TriangleRenderer  # noqa: F401
from .gaussian_renderer import GaussianRenderer  # noqa: F401
from .mesh_renderer import MeshRenderer  # noqa: F401
