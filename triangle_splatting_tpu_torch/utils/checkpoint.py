"""Checkpoint IO (port of ``triangle_splatting_tpu/utils/checkpoint.py``,
its pickle format).

A checkpoint is one pickled dict of host numpy arrays: ``params``, ``opt``
and ``state``, each field name -> array (``None`` for an absent leaf;
``opt`` holds ``m`` and ``v`` as such dicts and ``step`` as a 0-d int32),
and ``scene_bbox``. The JAX package's ``orbax`` format needs JAX and is
refused by name.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np
import torch


def _refuse_orbax() -> None:
    raise NotImplementedError(
        "trainer.ckpt_format 'orbax' is not ported to triangle_splatting_tpu_torch "
        "(it needs JAX); use 'pickle'")


def _host(x):
    """Tensors anywhere in nested dicts / lists / tuples -> numpy arrays."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_host(v) for v in x)
    return x


def save_ckpt(path, blob: dict, fmt: str = "pickle") -> None:
    if fmt == "orbax":
        _refuse_orbax()
    if fmt != "pickle":
        raise ValueError(f"unknown checkpoint format {fmt!r}")
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_host(blob), f)


def load_ckpt(path) -> dict:
    with open(Path(path), "rb") as f:
        blob = pickle.load(f)
    if isinstance(blob, dict) and blob.get("__orbax__"):
        _refuse_orbax()
    return blob


def model_blob(params: dict, state: dict, opt: dict, scene_bbox=None) -> dict:
    """The checkpoint dict of numpy leaves (``convert.*_to_numpy``'s
    output), the Adam step as a 0-d int32 array as the JAX trainers store
    it."""
    opt = dict(opt, step=np.asarray(opt["step"], np.int32))
    return dict(params=params, opt=opt, state=state, scene_bbox=scene_bbox)
