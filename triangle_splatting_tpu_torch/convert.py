"""Carry model weights between the JAX package and the port.

The JAX package keeps ``TriangleParams`` / ``TriangleState`` / ``AdamState``,
``GaussianParams`` / ``GaussianState`` / ``GSAdamState`` and
``ScaffoldParams`` / ``ScaffoldState`` / ``ScaffoldAdamState`` as pytrees of
arrays; the port keeps dataclasses of tensors with the same field names and
layouts. These functions move them as numpy arrays keyed by field name, so
neither package imports the other.
"""

from __future__ import annotations

from dataclasses import fields

import numpy as np
import torch

from .device import resolve_device
from .models.gaussian_model import GaussianParams, GaussianState, GSAdamState
from .models.scaffold import ScaffoldAdamState, ScaffoldParams, ScaffoldState
from .models.triangle import AdamState, TriangleParams, TriangleState


def _params(leaves: dict, dev, cls=TriangleParams):
    kw = {}
    for f in fields(cls):
        v = leaves.get(f.name)
        kw[f.name] = None if v is None else torch.as_tensor(
            np.array(v, dtype=np.float32)).to(dev)
    return cls(**kw)


def _state(leaves: dict, dev, cls):
    kw = {}
    for f in fields(cls):
        v = np.asarray(leaves[f.name])
        dtype = {"alive": bool, "active_sh_degree": np.int32}.get(f.name, np.float32)
        kw[f.name] = torch.as_tensor(np.array(v, dtype=dtype)).to(dev)
    return cls(**kw)


def triangle_from_numpy(params: dict, state: dict, opt: dict | None = None,
                        device="cuda"):
    """Port containers from numpy leaves keyed by the JAX field names.

    ``params``: vertex, opacity, f_dc, f_rest (affine_* optional);
    ``state``: alive, gradient_accum, ..., gamma, active_sh_degree;
    ``opt``: {"m": params-like, "v": params-like, "step": int} or None.
    Returns (params, state, opt) with opt None when not given.
    """
    dev = resolve_device(device)
    o = None
    if opt is not None:
        o = AdamState(m=_params(opt["m"], dev), v=_params(opt["v"], dev),
                      step=int(np.asarray(opt["step"])))
    return _params(params, dev), _state(state, dev, TriangleState), o


def gaussian_from_numpy(params: dict, state: dict, opt: dict | None = None,
                        device="cuda"):
    """Port Gaussian containers from numpy leaves keyed by the JAX field
    names (``params``: xyz, scaling, rotation, opacity, f_dc, f_rest;
    ``state``: alive, ..., gamma, active_sh_degree; ``opt``: {"m", "v",
    "step"} or None). Returns (params, state, opt)."""
    dev = resolve_device(device)
    o = None
    if opt is not None:
        o = GSAdamState(m=_params(opt["m"], dev, GaussianParams),
                        v=_params(opt["v"], dev, GaussianParams),
                        step=int(np.asarray(opt["step"])))
    return _params(params, dev, GaussianParams), _state(state, dev, GaussianState), o


def _to_np(x):
    return None if x is None else x.detach().cpu().numpy()


def triangle_to_numpy(params: TriangleParams, state: TriangleState,
                      opt: AdamState | None = None):
    """Inverse of :func:`triangle_from_numpy`: dicts of numpy leaves."""
    p = {f.name: _to_np(getattr(params, f.name)) for f in fields(TriangleParams)}
    s = {f.name: _to_np(getattr(state, f.name)) for f in fields(TriangleState)}
    o = None
    if opt is not None:
        o = dict(m={f.name: _to_np(getattr(opt.m, f.name)) for f in fields(TriangleParams)},
                 v={f.name: _to_np(getattr(opt.v, f.name)) for f in fields(TriangleParams)},
                 step=np.int32(opt.step))
    return p, s, o


def gaussian_to_numpy(params: GaussianParams, state: GaussianState,
                      opt: GSAdamState | None = None):
    """Inverse of :func:`gaussian_from_numpy`: dicts of numpy leaves."""
    p = {f.name: _to_np(getattr(params, f.name)) for f in fields(GaussianParams)}
    s = {f.name: _to_np(getattr(state, f.name)) for f in fields(GaussianState)}
    o = None
    if opt is not None:
        o = dict(m={f.name: _to_np(getattr(opt.m, f.name)) for f in fields(GaussianParams)},
                 v={f.name: _to_np(getattr(opt.v, f.name)) for f in fields(GaussianParams)},
                 step=np.int32(opt.step))
    return p, s, o


def _tensor_tree(x, dev):
    if isinstance(x, dict):
        return {k: _tensor_tree(v, dev) for k, v in x.items()}
    return torch.as_tensor(np.array(x, dtype=np.float32)).to(dev)


def _scaffold_params(leaves: dict, dev) -> ScaffoldParams:
    return ScaffoldParams(anchor=_tensor_tree(leaves["anchor"], dev),
                          anchor_feat=_tensor_tree(leaves["anchor_feat"], dev),
                          mlps=_tensor_tree(leaves["mlps"], dev))


def scaffold_from_numpy(params: dict, state: dict, opt: dict | None = None, device="cuda"):
    """Port Scaffold containers from numpy leaves keyed by the JAX field
    names: ``params`` anchor, anchor_feat and mlps (head -> {w1, b1, w2,
    b2}); ``state`` alive, anchor_scaling, ..., voxel_size,
    opacity_threshold; ``opt`` {"m": params-like, "v": params-like,
    "step"} or None. Returns (params, state, opt)."""
    dev = resolve_device(device)
    o = None
    if opt is not None:
        o = ScaffoldAdamState(m=_scaffold_params(opt["m"], dev), v=_scaffold_params(opt["v"], dev),
                              step=int(np.asarray(opt["step"])))
    kw = {f.name: torch.as_tensor(np.array(state[f.name],
                                           dtype=bool if f.name == "alive" else np.float32)).to(dev)
          for f in fields(ScaffoldState)}
    return _scaffold_params(params, dev), ScaffoldState(**kw), o


def _scaffold_np(p: ScaffoldParams) -> dict:
    return {"anchor": _to_np(p.anchor), "anchor_feat": _to_np(p.anchor_feat),
            "mlps": {h: {leaf: _to_np(t) for leaf, t in d.items()} for h, d in p.mlps.items()}}


def scaffold_to_numpy(params: ScaffoldParams, state: ScaffoldState,
                      opt: ScaffoldAdamState | None = None):
    """Inverse of :func:`scaffold_from_numpy`: nested dicts of numpy leaves
    (the JAX checkpoint blob's layout once its dataclasses are dicts)."""
    s = {f.name: _to_np(getattr(state, f.name)) for f in fields(ScaffoldState)}
    o = None
    if opt is not None:
        o = dict(m=_scaffold_np(opt.m), v=_scaffold_np(opt.v), step=np.int32(opt.step))
    return _scaffold_np(params), s, o
