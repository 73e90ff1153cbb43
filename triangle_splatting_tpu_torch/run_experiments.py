"""Experiment launcher of the port (the root ``run_experiments.py``'s twin,
with the same presets, aliases and arguments).

Usage, from a directory holding ``config/<type>.yaml``:
    python -m triangle_splatting_tpu_torch.run_experiments --type NerfSynthetic_VanillaTS \
        --dataset_path /data/nerf_synthetic [--scenes lego ship] [--num_workers 1]

Each scene trains through the port's ``build_trainer`` on ``device``
(``"cuda"``: it raises without a GPU).

Per-dataset presets (scene lists, per-scene resolution divisors, per-scene
target triangle counts for mesh runs) mirror run_experiments.py:19-86.
"""

import argparse
from copy import deepcopy


def exp(config_path: str, dataset_path: str, scene: str, exp_name: str,
        target_res=None, target_point_num=None, device="cuda"):
    from triangle_splatting_tpu_torch.device import resolve_device
    from triangle_splatting_tpu_torch.trainers import build_trainer
    from triangle_splatting_tpu_torch.utils.config import loadConfig
    device = resolve_device(device)

    config = loadConfig(config_path)
    config.dataset.local_dir = dataset_path
    config.dataset.scene_id = scene
    if target_res is not None:
        config.dataset.train_target_res = target_res
        config.dataset.test_target_res = target_res
    if target_point_num is not None and config.model.model_update is not None \
            and config.model.model_update.contribution_pruning is not None:
        config.model.model_update.contribution_pruning.target_point_num = target_point_num

    trainer = build_trainer(config, exp_name=exp_name, device=device)
    trainer.train()


# Scene presets (reference run_experiments.py:19-86)
NERF_SYNTHETIC_SCENES = ["chair", "drums", "ficus", "hotdog", "lego",
                         "materials", "mic", "ship"]
NERF_SYNTHETIC_MESH_POINTS = {"chair": 89_000, "drums": 82_000, "ficus": 41_000,
                              "hotdog": 58_000, "lego": 112_000,
                              "materials": 78_000, "mic": 83_000, "ship": 93_000}
MIPNERF360_SCENES = {"bicycle": 4, "bonsai": 2, "counter": 2, "garden": 4,
                     "kitchen": 2, "room": 2, "stump": 4, "flowers": 4,
                     "treehill": 4}
TANKS_SCENES = {"truck": 1, "train": 1, "drjohnson": 1, "playroom": 1}


def build_jobs(args):
    """(config_path, dataset_path, scene, exp_name, target_res,
    target_point_num) tuples for the requested experiment type."""
    config_path = f"config/{args.type}.yaml"
    jobs = []
    if args.type.startswith("NerfSynthetic"):
        scenes = args.scenes or NERF_SYNTHETIC_SCENES
        for scene in scenes:
            tp = (NERF_SYNTHETIC_MESH_POINTS.get(scene)
                  if args.type.endswith("_mesh") else None)
            jobs.append((config_path, args.dataset_path, scene, scene, None, tp))
    elif args.type == "MipNerf360_VanillaTS":
        scenes = args.scenes or list(MIPNERF360_SCENES)
        for scene in scenes:
            jobs.append((config_path, args.dataset_path, scene, scene,
                         MIPNERF360_SCENES.get(scene, 1), None))
    elif args.type == "TanksAndBlending_VanillaTS":
        scenes = args.scenes or list(TANKS_SCENES)
        for scene in scenes:
            jobs.append((config_path, args.dataset_path, scene, scene, 1, None))
    elif args.type == "MatrixCity_VanillaTS_mesh":
        jobs.append((config_path, args.dataset_path, None, "matrix_city", None, None))
    return jobs


# Reference CLI spelling (run_experiments.py:99-110) -> config name
TYPE_ALIASES = {
    "NerfSynthetic": "NerfSynthetic_VanillaTS",
    "NerfSynthetic_mesh": "NerfSynthetic_VanillaTS_mesh",
    "MipNerf360": "MipNerf360_VanillaTS",
    "TanksAndBlending": "TanksAndBlending_VanillaTS",
    "MatrixCity_mesh": "MatrixCity_VanillaTS_mesh",
}


def parse_args(argv=None):
    """CLI parsing incl. short --type alias resolution (the reference's
    spellings, run_experiments.py:99-110)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--type", required=True, choices=[
        "NerfSynthetic_VanillaTS", "NerfSynthetic_VanillaTS_mesh",
        "MipNerf360_VanillaTS", "TanksAndBlending_VanillaTS",
        "MatrixCity_VanillaTS_mesh", *TYPE_ALIASES],
        help="experiment preset; the reference's short spellings "
             "(NerfSynthetic, NerfSynthetic_mesh, MipNerf360, "
             "TanksAndBlending, MatrixCity_mesh) are accepted as aliases")
    parser.add_argument("--dataset_path", required=True)
    parser.add_argument("--scenes", nargs="*", default=None)
    parser.add_argument("--num_workers", type=int, default=1)
    args = parser.parse_args(argv)
    args.type = TYPE_ALIASES.get(args.type, args.type)
    return args


def main():
    args = parse_args()
    jobs = build_jobs(args)
    from triangle_splatting_tpu_torch.utils.pipeline_utils import run_exp_with_args
    run_exp_with_args(exp, jobs, num_workers=args.num_workers)


if __name__ == "__main__":
    main()
