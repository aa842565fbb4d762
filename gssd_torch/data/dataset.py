"""ml_ready npy dataset and static-shape batching.

Per slice ``{id}_ct.npy`` [4, 3, H, W] float in [0, 1] and
``{id}_bbox.npy`` [n, 5] = (x1, y1, x2, y2, cls) in pixels. Images load
as [4, H, W, 3] scaled to 0..255, boxes normalised to [0, 1]. Batches
are static-shape: images stacked [B, H, W, 12] (phase-major channels)
and the variable-length targets padded to ``max_gt`` with a validity
mask.
"""

from __future__ import annotations

import os
import queue as queue_mod
import threading
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


class LesionDataset:
    def __init__(
        self,
        data_path: str,
        ids: Sequence[str],
        transform: Optional[Callable] = None,
        load_to_ram: bool = False,
    ):
        self.data_path = data_path
        self.ids = list(ids)
        self.transform = transform
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

    def pull_anno(self, index: int) -> np.ndarray:
        """[n, 5] boxes in original pixels plus the class."""
        return self.raw_item(index)[1]

    def __getitem__(self, index: int):
        """(image, boxes [n, 4] in [0, 1], labels [n]) after the transform."""
        img, target = self.raw_item(index)
        h, w = img.shape[1], img.shape[2]
        boxes = target[:, :4].copy()
        boxes[:, 0::2] /= w
        boxes[:, 1::2] /= h
        labels = target[:, 4].copy()
        if self.transform is not None:
            img, boxes, labels = self.transform(img, boxes, labels)
        return img, boxes, labels


def pad_targets(
    boxes: np.ndarray, labels: np.ndarray, max_gt: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad a [n, 4] / [n] target pair to static [max_gt] with validity."""
    n = min(len(boxes), max_gt)
    out_b = np.zeros((max_gt, 4), np.float32)
    out_l = np.zeros((max_gt,), np.int32)
    out_v = np.zeros((max_gt,), bool)
    out_b[:n] = boxes[:n]
    out_l[:n] = labels[:n]
    out_v[:n] = True
    return out_b, out_l, out_v


def collate(items: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
            max_gt: int = 16) -> Dict[str, np.ndarray]:
    """Stack ([4, H, W, 3] image, [n, 4] boxes, [n] labels) items into a
    static-shape NHWC batch with 12 phase-major channels."""
    imgs, bs, ls, vs = [], [], [], []
    for img, boxes, labels in items:
        p, h, w, c = img.shape
        imgs.append(np.transpose(img, (1, 2, 0, 3)).reshape(h, w, p * c))
        b, lab, v = pad_targets(boxes, labels, max_gt)
        bs.append(b)
        ls.append(lab)
        vs.append(v)
    return {
        "image": np.stack(imgs).astype(np.float32),
        "boxes": np.stack(bs),
        "labels": np.stack(ls),
        "valid": np.stack(vs),
    }


def collate_pixellink(items: Sequence[Tuple[np.ndarray, np.ndarray, dict]],
                      max_gt: int = 16) -> Dict[str, np.ndarray]:
    """``collate`` for PixelLink items, whose third element is the target
    dict of ``make_pixel_link_targets`` plus "labels": adds the stacked
    maps pixel_mask int32, neg_pixel_mask uint8, pixel_pos_weight f32 and
    link_mask int32 to the batch."""
    maps = ("pixel_mask", "neg_pixel_mask", "pixel_pos_weight", "link_mask")
    batch = collate([(img, boxes, np.asarray(t["labels"])) for img, boxes, t in items], max_gt)
    for key, dt in zip(maps, (np.int32, np.uint8, np.float32, np.int32)):
        batch[key] = np.stack([t[key] for _, _, t in items]).astype(dt)
    return batch


class BatchLoader:
    """Shuffling, endlessly repeating batch iterator with one background
    prefetch thread. The order is a seeded ``default_rng`` permutation
    per epoch; ``collate_fn`` stacks the items. ``close`` stops the
    thread."""

    def __init__(self, dataset: LesionDataset, batch_size: int, max_gt: int = 16,
                 seed: int = 1111, shuffle: bool = True, prefetch: int = 2,
                 collate_fn: Callable = collate):
        if len(dataset) == 0:
            raise ValueError("BatchLoader over an empty dataset")
        self.dataset = dataset
        self.batch_size = batch_size
        self.max_gt = max_gt
        self.shuffle = shuffle
        self.collate_fn = collate_fn
        self.rng = np.random.default_rng(seed)
        self._queue: queue_mod.Queue = queue_mod.Queue(maxsize=prefetch)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._started = False
        self._stop = threading.Event()

    def _index_stream(self) -> Iterator[int]:
        n = len(self.dataset)
        while True:
            order = self.rng.permutation(n) if self.shuffle else np.arange(n)
            yield from order

    def _worker(self):
        stream = self._index_stream()
        while not self._stop.is_set():
            items = [self.dataset[next(stream)] for _ in range(self.batch_size)]
            batch = self.collate_fn(items, self.max_gt)
            while not self._stop.is_set():
                try:
                    self._queue.put(batch, timeout=0.1)
                    break
                except queue_mod.Full:
                    pass

    def close(self):
        """Stop the prefetch thread and wait for it (at most one batch)."""
        self._stop.set()
        if self._started:
            self._thread.join()

    def __iter__(self):
        if not self._started:
            self._thread.start()
            self._started = True
        while True:
            yield self._queue.get()
