"""Config system: YAML -> attribute namespace with ``None`` for missing keys.

Host-only copy of ``triangle_splatting_tpu/utils/config.py`` (the port
imports nothing of the JAX package).

Feature parity with the reference's ``utils/config.py:6-74``: every optional
feature in the framework is switched on by the *presence* of its config block,
so ``Config.__getattr__`` returns ``None`` for any missing attribute instead of
raising. Nested dicts become nested ``Config`` objects; lists of dicts become
lists of ``Config``.
"""

from __future__ import annotations

import json
from argparse import Namespace
from pathlib import Path
from typing import Any

import yaml


class Config(Namespace):
    """Namespace whose missing attributes read as ``None``."""

    def __getattr__(self, name: str) -> Any:
        # Only called when normal lookup fails.
        if name.startswith("__"):
            raise AttributeError(name)
        return None

    def __contains__(self, name: str) -> bool:
        return name in self.__dict__

    def get(self, name: str, default: Any = None) -> Any:
        value = self.__dict__.get(name, None)
        return default if value is None else value

    def to_dict(self) -> dict:
        return config_to_dict(self)

    def __deepcopy__(self, memo):
        return dict_to_config(json.loads(json.dumps(config_to_dict(self))))


def dict_to_config(d: Any) -> Any:
    """Recursively convert dicts (and lists of dicts) into Config objects."""
    if isinstance(d, dict):
        cfg = Config()
        for k, v in d.items():
            setattr(cfg, k, dict_to_config(v))
        return cfg
    if isinstance(d, (list, tuple)):
        return type(d)(dict_to_config(v) for v in d)
    return d


def config_to_dict(cfg: Any) -> Any:
    if isinstance(cfg, (Config, Namespace)):
        return {k: config_to_dict(v) for k, v in vars(cfg).items()}
    if isinstance(cfg, (list, tuple)):
        return [config_to_dict(v) for v in cfg]
    return cfg


def loadConfig(path: str | Path) -> Config:
    """Load a YAML or JSON config file into a Config tree."""
    path = Path(path)
    with open(path) as f:
        if path.suffix in (".yaml", ".yml"):
            data = yaml.safe_load(f)
        elif path.suffix == ".json":
            data = json.load(f)
        else:
            raise ValueError(f"Unsupported config format: {path.suffix}")
    return dict_to_config(data)



def saveConfig(cfg: Config, path: str | Path) -> None:
    """Write a Config tree as YAML or JSON (by the file's suffix)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    data = config_to_dict(cfg)
    with open(path, "w") as f:
        if path.suffix in (".yaml", ".yml"):
            yaml.safe_dump(data, f, sort_keys=False)
        elif path.suffix == ".json":
            json.dump(data, f, indent=2)
        else:
            raise ValueError(f"Unsupported config format: {path.suffix}")
