"""Numpy value type for 3DGS-compatible Gaussian sets and their PLY IO
(the port's own copy of ``triangle_splatting_tpu/models/raw_gaussian.py``,
host numpy, byte-identical files).

Schema of the INRIA 3DGS PLY layout: x,y,z, nx,ny,nz, f_dc_0..2, f_rest_*,
opacity, scale_0..2, rot_0..3, so the files interoperate with the wider
Gaussian-splatting ecosystem.
"""

from __future__ import annotations

import numpy as np

from ..utils.ply import read_ply, write_ply


def morton_order(xyz: np.ndarray, bits: int = 21) -> np.ndarray:
    """Morton (Z-curve) ordering of points: improves the locality of PLY
    storage for streaming viewers."""
    mn, mx = xyz.min(0), xyz.max(0)
    q = ((xyz - mn) / np.maximum(mx - mn, 1e-12) * ((1 << bits) - 1)).astype(np.uint64)
    code = np.zeros(len(xyz), np.uint64)
    for b in range(bits):
        for d in range(3):
            code |= ((q[:, d] >> np.uint64(b)) & np.uint64(1)) << np.uint64(3 * b + d)
    return np.argsort(code)


def pack_sh_features(features: np.ndarray) -> np.ndarray:
    """(n, K, 3) coefficient-major SH features -> the flat 3DGS PLY layout:
    f_dc RGB followed by f_rest CHANNEL-major (all R coeffs, all G, all B).
    The ONE place that encodes the layout; ``unpack_sh_features`` inverts."""
    features = np.asarray(features, np.float32)
    n = features.shape[0]
    return np.concatenate(
        [features[:, 0, :],
         features[:, 1:, :].transpose(0, 2, 1).reshape(n, -1)], axis=1)


def unpack_sh_features(shs: np.ndarray, K: int) -> np.ndarray:
    """Inverse of ``pack_sh_features``: flat PLY layout -> (n, K, 3); bands
    the file lacks are zero, extra bands are dropped."""
    shs = np.asarray(shs, np.float32)
    n = shs.shape[0]
    out = np.zeros((n, K, 3), np.float32)
    out[:, 0, :] = shs[:, :3]
    rest = shs[:, 3:]
    n_coef = min(rest.shape[1] // 3, K - 1)
    if n_coef > 0:
        file_coef = rest.shape[1] // 3
        out[:, 1:1 + n_coef, :] = rest[:, :file_coef * 3].reshape(
            n, 3, file_coef).transpose(0, 2, 1)[:, :n_coef]
    return out


class RawGaussian:
    def __init__(self, xyz=None, opacity=None, shs=None, scale=None,
                 rotation=None, normals=None, ply_path=None):
        self.xyz = np.zeros((0, 3), np.float32) if xyz is None else np.asarray(xyz, np.float32)
        n = self.xyz.shape[0]
        self.opacity = (np.zeros((n, 1), np.float32) if opacity is None
                        else np.asarray(opacity, np.float32).reshape(n, -1))
        self.shs = (np.zeros((n, 3), np.float32) if shs is None
                    else np.asarray(shs, np.float32).reshape(n, -1))
        self.scale = (np.zeros((n, 3), np.float32) if scale is None
                      else np.asarray(scale, np.float32).reshape(n, -1))
        self.rotation = (np.tile(np.array([[1, 0, 0, 0]], np.float32), (n, 1))
                         if rotation is None else np.asarray(rotation, np.float32).reshape(n, -1))
        self.normals = (np.zeros((n, 3), np.float32) if normals is None
                        else np.asarray(normals, np.float32))
        if ply_path is not None:
            self.loadPLY(ply_path)

    def __len__(self):
        return self.xyz.shape[0]

    def sort_morton(self):
        order = morton_order(self.xyz)
        for attr in ("xyz", "opacity", "shs", "scale", "rotation", "normals"):
            setattr(self, attr, getattr(self, attr)[order])
        return self

    def savePLY(self, path):
        n = len(self)
        n_rest = self.shs.shape[1] - 3
        names = (["x", "y", "z", "nx", "ny", "nz"]
                 + [f"f_dc_{i}" for i in range(3)]
                 + [f"f_rest_{i}" for i in range(n_rest)]
                 + ["opacity"]
                 + [f"scale_{i}" for i in range(self.scale.shape[1])]
                 + [f"rot_{i}" for i in range(self.rotation.shape[1])])
        attrs = np.concatenate([
            self.xyz, self.normals, self.shs[:, :3], self.shs[:, 3:],
            self.opacity, self.scale, self.rotation], axis=1)
        rec = np.zeros(n, dtype=[(nm, "f4") for nm in names])
        for i, nm in enumerate(names):
            rec[nm] = attrs[:, i]
        write_ply(path, {"vertex": rec})

    def loadPLY(self, path):
        data = read_ply(path)["vertex"]
        names = data.dtype.names
        self.xyz = np.stack([data["x"], data["y"], data["z"]], 1).astype(np.float32)
        if "nx" in names:
            self.normals = np.stack([data["nx"], data["ny"], data["nz"]], 1).astype(np.float32)
        f_dc = np.stack([data[f"f_dc_{i}"] for i in range(3)], 1)
        # 3DGS stores f_rest channel-major: (3, K-1) flattened; keep raw order.
        rest_names = sorted((nm for nm in names if nm.startswith("f_rest_")),
                            key=lambda x: int(x.split("_")[-1]))
        rest = (np.stack([data[nm] for nm in rest_names], 1)
                if rest_names else np.zeros((len(self.xyz), 0), np.float32))
        self.shs = np.concatenate([f_dc, rest], 1).astype(np.float32)
        self.opacity = np.asarray(data["opacity"], np.float32)[:, None] \
            if "opacity" in names else np.zeros((len(self.xyz), 1), np.float32)
        scale_names = sorted((nm for nm in names if nm.startswith("scale_")),
                             key=lambda x: int(x.split("_")[-1]))
        self.scale = (np.stack([data[nm] for nm in scale_names], 1).astype(np.float32)
                      if scale_names else np.zeros((len(self.xyz), 3), np.float32))
        rot_names = sorted((nm for nm in names if nm.startswith("rot_")),
                           key=lambda x: int(x.split("_")[-1]))
        self.rotation = (np.stack([data[nm] for nm in rot_names], 1).astype(np.float32)
                         if rot_names else np.tile(np.array([[1, 0, 0, 0]], np.float32),
                                                   (len(self.xyz), 1)))
        return self
