"""MatrixCity dataset factory (port of
``triangle_splatting_tpu/datasets/matrix_city.py``): the train and test
splits are separate COLMAP text models under ``train/block_all`` and
``test/block_all_test``."""

from __future__ import annotations

from .colmap import ColmapDatasetFactory
from .colmap_loader import readColmapCameras


class MatrixCityDatasetFactory(ColmapDatasetFactory):
    def _getCameraInfos(self):
        root = self.root
        train = readColmapCameras(
            root / "train/block_all/sparse/images.txt",
            root / "train/block_all/sparse/cameras.txt",
            "train/block_all/input")
        test = readColmapCameras(
            root / "test/block_all_test/sparse/images.txt",
            root / "test/block_all_test/sparse/cameras.txt",
            "test/block_all_test/input")
        train = sorted(train, key=lambda x: x.image_name)
        test = sorted(test, key=lambda x: x.image_name)
        return train, test
