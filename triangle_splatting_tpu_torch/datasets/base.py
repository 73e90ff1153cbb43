"""Dataset factory base + host-side prefetching loader (port of
``triangle_splatting_tpu/datasets/base.py``).

Items are port ``Camera``s whose ground-truth image already lies on the
dataset's device. Image decode runs on a thread pool (PIL releases the
GIL), and with ``cache_gb`` > 0 every view is kept after its first load,
so later epochs do no host work and no host-to-device copy.
"""

from __future__ import annotations

import queue
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np

from ..utils import tracing
from ..utils.camera import Camera
from ..utils.config import Config
from ..utils.logger import Logger


class PrefetchLoader:
    """Iterates a map-style dataset in shuffled epochs with lookahead."""

    def __init__(self, dataset, num_workers: int = 8, prefetch: int = 16,
                 shuffle: bool = True, seed: int = 0, cache_gb: float = 4.0):
        self.dataset = dataset
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.prefetch = max(2, prefetch)
        self.pool = ThreadPoolExecutor(max_workers=max(1, num_workers))
        self._futures: "queue.Queue" = queue.Queue()
        self._order: list[int] = []
        self._pos = 0
        self._cache_budget = int(cache_gb * (1 << 30))
        self._cache: Optional[dict] = {} if self._cache_budget > 0 else None

    @staticmethod
    def _item_bytes(item) -> int:
        total = 0
        for leaf in (item.gt_image, item.alpha_mask):
            if leaf is not None:
                total += leaf.numel() * leaf.element_size()
        return total

    def _maybe_cache(self, i: int, item) -> None:
        if self._cache is None:
            return
        if max(self._item_bytes(item), 1) * len(self.dataset) > self._cache_budget:
            self._cache = None        # whole set won't fit: stream instead
            return
        self._cache.setdefault(i, item)

    def _refill(self):
        while self._futures.qsize() < self.prefetch:
            if self._pos >= len(self._order):
                idx = np.arange(len(self.dataset))
                if self.shuffle:
                    self.rng.shuffle(idx)
                self._order = idx.tolist()
                self._pos = 0
            i = self._order[self._pos]
            self._pos += 1
            if self._cache is not None and i in self._cache:
                self._futures.put((i, None))
            else:
                self._futures.put((i, self.pool.submit(self.dataset.__getitem__, i)))

    def next(self) -> Camera:
        self._refill()
        i, fut = self._futures.get()
        if fut is None and self._cache is not None and i in self._cache:
            item = self._cache[i]
            tracing.count("data.cache_hit", 1)
        else:
            with tracing.span("data.wait"):
                item = fut.result() if fut is not None else self.dataset[i]
            tracing.count("data.loaded", 1)
            self._maybe_cache(i, item)
        self._refill()
        return item

    def close(self):
        self.pool.shutdown(wait=True, cancel_futures=True)


class BaseDatasetFactory:
    """Factory surface shared by the dataset types."""

    def __init__(self, config: Config = None, logger: Logger = None,
                 device="cuda"):
        self._config = config or Config()
        self._logger = logger or Logger("dataset", output_dir=None)
        self.device = device
        self._train_dataset = None
        self._test_dataset = None
        self._train_loader: Optional[PrefetchLoader] = None
        self._test_cache: Optional[dict] = None

    def nextTrainData(self) -> Camera:
        if self._train_loader is None:
            cache_gb = self._config.image_cache_gb
            self._train_loader = PrefetchLoader(
                self._train_dataset, num_workers=self._config.num_workers or 8,
                cache_gb=4.0 if cache_gb is None else float(cache_gb))
        return self._train_loader.next()

    def getTrainDataset(self):
        return self._train_dataset

    def getTestDataset(self) -> Iterator[Camera]:
        if self._test_cache is None:
            self._test_cache = {}
        budget = self._config.image_cache_gb
        budget = int((4.0 if budget is None else float(budget)) * (1 << 30))
        for i in range(len(self._test_dataset)):
            item = self._test_cache.get(i)
            if item is None:
                item = self._test_dataset[i]
                per_view = max(PrefetchLoader._item_bytes(item), 1)
                if per_view * len(self._test_dataset) <= budget:
                    self._test_cache[i] = item
            yield item

    def getTrainDatasetSize(self) -> int:
        return len(self._train_dataset)

    def getTestDatasetSize(self) -> int:
        return len(self._test_dataset)

    def getPointCloud(self):
        raise NotImplementedError

    def getSceneInfo(self) -> dict | None:
        """Scene metadata (``bbox_xyz`` for scenes with a bounding box);
        None: no box, every point counts as inside."""
        return None

    def getGTGaussian(self):
        """The ground-truth Gaussian set of the Scaffold MLP distillation: the
        3DGS PLY at the config's ``gt_gaussian_path`` (read once)."""
        if getattr(self, "_gt_gaussian", None) is None:
            path = self._config.gt_gaussian_path
            if path is None:
                raise FileNotFoundError("dataset config has no gt_gaussian_path")
            from ..models.raw_gaussian import RawGaussian
            self._gt_gaussian = RawGaussian(ply_path=str(path))
        return self._gt_gaussian

    def close(self) -> None:
        """Stop the prefetch threads."""
        if self._train_loader is not None:
            self._train_loader.close()
            self._train_loader = None
