"""Trainers of the port (VanillaTS: the photo and mesh recipes; VanillaGS:
the Gaussian baseline; ScaffoldGS: anchors decoded by MLP heads)."""

TRAINER_TYPES = ("VanillaTS", "VanillaGS", "ScaffoldGS")


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
    if ttype == "VanillaGS":
        from .vanilla_gs import VanillaGSTrainer
        return VanillaGSTrainer(config, **kwargs)
    if ttype == "ScaffoldGS":
        from .scaffold_gs import ScaffoldGSTrainer
        return ScaffoldGSTrainer(config, **kwargs)
    raise ValueError(f"Unknown trainer type: {ttype}")
