"""Renderer facade of the port (object-style wrappers over ``ops.rasterize``;
port of ``triangle_splatting_tpu/renderer``): :class:`GaussianRenderer`."""

from .gaussian_renderer import GaussianRenderer  # noqa: F401
