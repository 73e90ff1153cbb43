"""Object-style model facade over the functional cores (port of
``triangle_splatting_tpu/models/facade.py``).

The reference exposes model classes at the package root
(``VanillaTSModel``, ``VanillaGSModel``, ``ScaffoldGSModel``) whose surface
is: construct from the ``model`` config section, ``create_from_pcd``,
``forward(camera, background)``, PLY / GLB IO. The compute cores are
functions over fixed-capacity params and state (models/triangle.py,
gaussian_model.py, scaffold.py); these thin classes hold them on an
explicit device (``"cuda"`` unless the caller asks for the CPU) so that
reference code keeps working (``model.loadPLY(...); model.forward(cam)``).

``forward`` renders as the JAX facade does: rich info on (the
``RasterSettings`` default) and the contribution statistics as each JAX
core defaults them (triangles and Gaussians with, Scaffold without), so it
returns the JAX facade's keys (and ``pairs_needed``). It runs under
``torch.no_grad()`` unless ``is_training``. Each facade bins its frames at
its own ``PairBudget``, sized from the pairs its frames needed and kept
when the facade loads another model, as the viewer's is; a frame that
overflows it is rendered again. The trainers do not use these wrappers.
"""

from __future__ import annotations

from dataclasses import replace
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops.projection import RasterSettings
from ..ops.rasterize import PairBudget
from ..utils import tracing
from ..utils.config import Config


def _mk_settings(camera, max_sh_degree, rasterizer_type="2D", back_culling=False):
    return RasterSettings(
        image_width=int(camera.image_width), image_height=int(camera.image_height),
        max_sh_degree=max_sh_degree, back_culling=back_culling,
        rasterizer_type=rasterizer_type)


def _pad_rows(x: np.ndarray, cap: int) -> np.ndarray:
    return np.concatenate([x, np.zeros((cap - x.shape[0],) + x.shape[1:], x.dtype)])


def _rows_on(x: np.ndarray, cap: int, device) -> torch.Tensor:
    """``x`` padded with zero rows to ``cap``, float32 on ``device``."""
    return torch.as_tensor(np.ascontiguousarray(_pad_rows(x, cap), np.float32)).to(device)


def _alive(n: int, cap: int, device) -> torch.Tensor:
    return torch.as_tensor(np.arange(cap) < n).to(device)


def triangles_from_raw(raw, max_sh_degree: int, device):
    """(params, state) of a ``RawTriangle`` on ``device``: its first
    (max_sh_degree + 1)^2 SH bands (missing ones zero), the capacity
    rounded up to 256, every read triangle alive, ``active_sh_degree`` 0."""
    from . import triangle as M
    n = len(raw)
    K = (max_sh_degree + 1) ** 2
    shs = raw.shs.reshape(n, -1, 3)
    feats = np.zeros((n, K, 3), np.float32)
    take = min(K, shs.shape[1])
    feats[:, :take] = shs[:, :take]
    cap = M._round_up(n, 256)
    params = M.TriangleParams(
        vertex=_rows_on(raw.vertex, cap, device), opacity=_rows_on(raw.opacity, cap, device),
        f_dc=_rows_on(feats[:, :1], cap, device), f_rest=_rows_on(feats[:, 1:], cap, device))
    state = replace(M.TriangleState.create(cap, device=device), alive=_alive(n, cap, device))
    return params, state


class _Facade:
    """Device, background and grad-mode handling shared by the facades."""

    def __init__(self, impl: str, device):
        self.impl = impl
        self.device = resolve_device(device)
        self.params = None
        self.state = None
        # frames rendered: the step id of a frame's spans
        self._frames = 0
        self._budget = PairBudget()

    def _background(self, background) -> torch.Tensor:
        if background is None:
            return torch.zeros(3, dtype=torch.float32, device=self.device)
        return torch.as_tensor(background, dtype=torch.float32).to(self.device)

    def _render(self, core_forward, camera, background, is_training, settings, **kw) -> dict:
        self._frames += 1
        tracing.set_step(self._frames)
        background = self._background(background)

        def draw(max_pairs):
            return core_forward(self.params, self.state, camera, background, self.cfg,
                                settings, is_training=bool(is_training), impl=self.impl,
                                max_pairs=max_pairs, **kw)
        with tracing.span("render"), \
                torch.set_grad_enabled(bool(is_training) and torch.is_grad_enabled()):
            return self._budget.render(draw)


class VanillaTSModel(_Facade):
    """Triangle model facade (reference models/VanillaTS_model.py:21-917).

    ``config.max_sh_degree`` defaults to 0 like the reference; pass the
    checkpoint's trained degree when loading a PLY / GLB or higher SH bands
    are dropped. A loaded model starts at ``active_sh_degree`` 0, as the
    JAX facade's does, so it renders its DC band until the state is set.
    """

    def __init__(self, config: Optional[Config] = None, impl: str = "cuda", device="cuda"):
        from . import triangle as M
        super().__init__(impl, device)
        self._M = M
        mc = config or Config()
        self.cfg = M.ModelConfig(
            max_sh_degree=mc.max_sh_degree if mc.max_sh_degree is not None else 0,
            use_color_affine=bool(mc.use_color_affine),
            back_culling=bool(mc.back_culling),
            ste_threshold=mc.ste_threshold,
            gamma_rescale=bool(mc.gamma_rescale),
            render_up_scale=mc.render_up_scale,
            rasterizer_type=mc.rasterizer_type or "2D")

    def create_from_pcd(self, pcd, init_opacity: float = 0.1, seed: int = 0):
        self.params, self.state = self._M.create_from_points(
            pcd.points, pcd.colors, getattr(pcd, "normals", None), self.cfg,
            init_opacity=init_opacity, seed=seed, device=self.device)
        return self

    @property
    def point_count(self) -> int:
        return 0 if self.state is None else int(self.state.alive.sum())

    def forward(self, camera, background=None, is_training: bool = False) -> dict:
        """Render through one camera; returns the reference render_pkg dict
        (render / depth / normal / radii / contrib_* ...)."""
        settings = _mk_settings(camera, self.cfg.max_sh_degree, self.cfg.rasterizer_type,
                                self.cfg.back_culling)
        return self._render(self._M.forward, camera, background, is_training, settings,
                            apply_color_affine=False, need_stats=True)

    @torch.no_grad()
    def toRaw(self):
        from .raw_triangle import RawTriangle
        alive = self.state.alive
        vertex = self.params.vertex[alive].cpu().numpy()
        opacity = self.params.opacity[alive].cpu().numpy()
        shs = self._M.get_features(self.params)[alive].cpu().numpy()
        return RawTriangle(vertex, opacity, shs.reshape(len(vertex), -1))

    def savePLY(self, path):
        self.toRaw().savePLY(path, save_extra=True)

    def saveGLB(self, path):
        self.toRaw().saveGLB(path, save_back=not self.cfg.back_culling)

    def _from_raw(self, raw):
        self.params, self.state = triangles_from_raw(raw, self.cfg.max_sh_degree, self.device)
        return self

    def loadPLY(self, path):
        from .raw_triangle import RawTriangle
        return self._from_raw(RawTriangle(ply_path=str(path)))

    def loadGLB(self, path):
        from .raw_triangle import RawTriangle
        return self._from_raw(RawTriangle(glb_path=str(path)))

    def set_gamma(self, gamma: float):
        self.state = replace(self.state, gamma=torch.tensor(
            float(gamma), dtype=torch.float32, device=self.device))
        return self


class VanillaGSModel(_Facade):
    """Gaussian model facade (reference models/VanillaGS_model.py:19-718)."""

    def __init__(self, config: Optional[Config] = None, impl: str = "cuda", device="cuda"):
        from . import gaussian_model as G
        super().__init__(impl, device)
        self._G = G
        mc = config or Config()
        self.cfg = G.GSModelConfig(
            max_sh_degree=mc.max_sh_degree if mc.max_sh_degree is not None else 3)

    def create_from_pcd(self, pcd, init_opacity: float = 0.1):
        self.params, self.state = self._G.create_from_points(
            pcd.points, pcd.colors, self.cfg, init_opacity=init_opacity, device=self.device)
        return self

    @property
    def point_count(self) -> int:
        return 0 if self.state is None else int(self.state.alive.sum())

    def forward(self, camera, background=None, is_training: bool = False) -> dict:
        settings = _mk_settings(camera, self.cfg.max_sh_degree)
        return self._render(self._G.forward, camera, background, is_training, settings,
                            need_stats=True)

    @torch.no_grad()
    def savePLY(self, path):
        """The alive Gaussians in the 3DGS PLY schema (``f_rest``
        channel-major)."""
        from .raw_gaussian import RawGaussian, pack_sh_features
        alive = self.state.alive

        def host(x):
            return x[alive].cpu().numpy()
        g = RawGaussian(xyz=host(self.params.xyz), opacity=host(self.params.opacity),
                        shs=pack_sh_features(host(self._G.get_features(self.params))),
                        scale=host(self.params.scaling), rotation=host(self.params.rotation))
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        g.savePLY(path)

    def loadPLY(self, path):
        """Read a 3DGS PLY. The dead capacity slots get identity rotations
        (the JAX facade leaves them zero; they are masked out either way)."""
        from .raw_gaussian import RawGaussian, unpack_sh_features
        G = self._G
        g = RawGaussian(ply_path=str(path))
        n = len(g)
        K = (self.cfg.max_sh_degree + 1) ** 2
        feats = unpack_sh_features(g.shs, K)
        cap = (n + 255) // 256 * 256
        dev = self.device
        rot = _rows_on(g.rotation, cap, dev)
        rot[n:, 0] = 1.0
        self.params = G.GaussianParams(
            xyz=_rows_on(g.xyz, cap, dev), scaling=_rows_on(g.scale, cap, dev), rotation=rot,
            opacity=_rows_on(g.opacity, cap, dev), f_dc=_rows_on(feats[:, :1], cap, dev),
            f_rest=_rows_on(feats[:, 1:], cap, dev))
        self.state = replace(G.GaussianState.create(cap, device=dev), alive=_alive(n, cap, dev))
        return self


class ScaffoldGSModel(_Facade):
    """Scaffold-GS facade (reference models/ScaffoldGS_model.py:21-633):
    anchors + MLP heads decode neural Gaussians per view."""

    def __init__(self, config: Optional[Config] = None, impl: str = "cuda", device="cuda"):
        from . import scaffold as S
        super().__init__(impl, device)
        self._S = S
        mc = config or Config()
        self.cfg = S.ScaffoldConfig(feat_dim=mc.feat_dim or 32,
                                    hidden_dim=mc.hidden_dim or 32,
                                    n_offsets=mc.n_offsets or 10)

    def create_from_pcd(self, pcd, voxel_size: float = 0.001, seed: int = 0):
        self.params, self.state = self._S.create_from_points(
            pcd.points, self.cfg, voxel_size=voxel_size, seed=seed, device=self.device)
        return self

    @property
    def anchor_count(self) -> int:
        return 0 if self.state is None else int(self.state.alive.sum())

    def forward(self, camera, background=None, is_training: bool = False) -> dict:
        return self._render(self._S.forward, camera, background, is_training,
                            _mk_settings(camera, 0), need_stats=False)
