"""triangle_splatting_tpu_torch — the PyTorch/CUDA port of triangle_splatting_tpu.

The JAX/Pallas package ``triangle_splatting_tpu`` is the reference; this
package reimplements it in PyTorch for NVIDIA Hopper (H100). Plain tensor
code is PyTorch and autograd; the Pallas TPU kernels become hand-written
CUDA kernels (``ops/cuda/csrc``), each with a plain PyTorch version beside
it that runs only for tensors on the CPU.

The module layout mirrors the reference (``ops/``, ``models/``,
``trainers/``, ``utils/``, ``datasets/``). Entry points take an explicit
``device`` that defaults to ``"cuda"`` and raise when no GPU is present;
only an explicit ``device="cpu"`` runs on the CPU.

This package never imports ``jax`` or ``triangle_splatting_tpu``.
"""

__version__ = "0.1.0"

from .utils.config import Config, loadConfig, saveConfig  # noqa: F401
from .utils.camera import Camera  # noqa: F401
from .ops.projection import RasterSettings  # noqa: F401

# The reference package surface, exported lazily (the JAX package's
# ``_LAZY``, name for name) so importing the package stays light until a
# symbol is used. Each name resolves to the port's counterpart.
_LAZY = {
    # model classes: the facade over the functional cores
    "VanillaTSModel": ("models.facade", "VanillaTSModel"),
    "VanillaGSModel": ("models.facade", "VanillaGSModel"),
    "ScaffoldGSModel": ("models.facade", "ScaffoldGSModel"),
    # trainers
    "VanillaTSTrainer": ("trainers.vanilla_ts", "VanillaTSTrainer"),
    "VanillaGSTrainer": ("trainers.vanilla_gs", "VanillaGSTrainer"),
    "ScaffoldGSTrainer": ("trainers.scaffold_gs", "ScaffoldGSTrainer"),
    "build_trainer": ("trainers", "build_trainer"),
    # datasets
    "BaseDatasetFactory": ("datasets.base", "BaseDatasetFactory"),
    "ColmapDatasetFactory": ("datasets.colmap", "ColmapDatasetFactory"),
    "NerfSyntheticDatasetFactory": ("datasets.nerf_synthetic", "NerfSyntheticDatasetFactory"),
    "MatrixCityDatasetFactory": ("datasets.matrix_city", "MatrixCityDatasetFactory"),
    "QijingDatasetFactory": ("datasets.qijing", "QijingDatasetFactory"),
    # serialization value types
    "RawTriangle": ("models.raw_triangle", "RawTriangle"),
    "RawGaussian": ("models.raw_gaussian", "RawGaussian"),
    "PointCloud": ("models.point_cloud", "PointCloud"),
    # renderer facade
    "TriangleRenderer": ("renderer.triangle_renderer", "TriangleRenderer"),
    "GaussianRenderer": ("renderer.gaussian_renderer", "GaussianRenderer"),
    "MeshRenderer": ("renderer.mesh_renderer", "MeshRenderer"),
    # utils
    "run_exp": ("utils.pipeline_utils", "run_exp"),
    "run_exp_with_args": ("utils.pipeline_utils", "run_exp_with_args"),
    "stdout_logger": ("utils.logger", "stdout_logger"),
    "OSSHandler": ("utils.file_handler", "OSSHandler"),
    # evaluation extras beyond the reference surface
    "mesh_geometry_scores": ("models.mesh_metrics", "mesh_geometry_scores"),
    "raytrace_soup": ("ops.raytrace", "raytrace_soup"),
}


def __getattr__(name):
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(f".{mod_name}", __name__), attr)


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
