"""ml_ready npy dataset, the loading half the serving path needs.

Per slice ``{id}_ct.npy`` [4, 3, H, W] float in [0, 1] and
``{id}_bbox.npy`` [n, 5] = (x1, y1, x2, y2, cls) in pixels. Images load
as [4, H, W, 3] scaled to 0..255.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np


class LesionDataset:
    def __init__(
        self,
        data_path: str,
        ids: Sequence[str],
        load_to_ram: bool = False,
    ):
        self.data_path = data_path
        self.ids = list(ids)
        self._cache: Optional[List] = None
        if load_to_ram:
            self._cache = [self._load(i) for i in range(len(self.ids))]

    def __len__(self) -> int:
        return len(self.ids)

    def _load(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        base = os.path.join(self.data_path, self.ids[index])
        ct = np.load(base + "_ct.npy")  # [4, 3, H, W] in [0, 1]
        img = np.transpose(ct, (0, 2, 3, 1))  # [4, H, W, 3]
        img = (img * 255.0).astype(np.float32)
        bbox = np.load(base + "_bbox.npy").astype(np.float32)  # [n, 5]
        return img, bbox

    def raw_item(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        if self._cache is not None:
            img, bbox = self._cache[index]
            return img.copy(), bbox.copy()
        return self._load(index)

    def pull_image(self, index: int) -> np.ndarray:
        """Original-resolution image [4, H, W, 3] float 0..255."""
        return self.raw_item(index)[0]
