"""Trainers of the port (VanillaTS: the photo and mesh recipes)."""

TRAINER_TYPES = ("VanillaTS",)


def build_trainer(config, **kwargs):
    """Dispatch on ``config.trainer.type`` (default VanillaTS); keyword
    arguments (``device``, ``impl``, ...) go to the trainer."""
    from ..utils.config import loadConfig
    if isinstance(config, str):
        config = loadConfig(config)
    ttype = (config.trainer.type if config.trainer is not None else None) \
        or "VanillaTS"
    if ttype == "VanillaTS":
        from .vanilla_ts import VanillaTSTrainer
        return VanillaTSTrainer(config, **kwargs)
    if ttype in ("VanillaGS", "ScaffoldGS"):
        raise NotImplementedError(f"trainer type {ttype} is not ported yet")
    raise ValueError(f"Unknown trainer type: {ttype}")
