"""Device-resident training data with augmentation on the card.

The whole training split goes to the device once, as a uint8 stack of
phase-collapsed NHWC slices (~3.1 MB a 512x512 slice). Per batch only
the sample indices and each item's affine and photometric scalars cross
to the card; the gather, the hat matrices, the warp and the normalise
run there (``data/augment_device.py``), so the batch is assembled in
device memory. The geometry is the host sampler's, shared with
``DeviceAugmentation``.

The stream is a function of (seed, batch index): the permutation of
``_EpochPermuter`` and a per-batch reseed, the contract of
``MPBatchLoader``, so ``start_batch`` resumes it exactly.

A data-parallel rank passes its ``rows``: it draws the whole batch's
indices and geometry, as every rank does, and gathers and warps only
its rows.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from gssd_torch.data.augment_device import DeviceAugmentation, hat_matrices, warp
from gssd_torch.data.dataset import LesionDataset, _EpochPermuter

# refuse to cache more than this on the device unless GSSD_DEVICE_CACHE_GB
# says otherwise; full clinical sets take --aug_method host or device
DEFAULT_CACHE_GB = 4.0


class DeviceCacheLoader:
    """Endless batch iterator over a dataset held on ``device``. Yields
    the step's batch dict, every leaf a tensor on ``device``: ``image``
    [B, size, size, 12] f32 (augmented), ``boxes``, ``labels``, ``valid``
    padded to ``max_gt``; with ``rows``, only those rows of each batch."""

    def __init__(self, dataset: LesionDataset, batch_size: int, size: int = 300,
                 max_gt: int = 16, seed: int = 1111, pixeljitter: float = 0.01,
                 ratio: float = 1.5, mean: float = 0.0, use_normalize: bool = True,
                 shuffle: bool = True, start_batch: int = 0, device="cuda",
                 rows: Optional[slice] = None):
        if len(dataset) == 0:
            raise ValueError("DeviceCacheLoader over an empty dataset")
        self.batch_size = batch_size
        self.rows = rows
        self.seed = seed
        self.start_batch = start_batch
        self.device = torch.device(device)
        self._perm = _EpochPermuter(seed, len(dataset), shuffle)

        imgs, self._boxes, self._labels = [], [], []
        for i in range(len(dataset)):
            img, bbox = dataset.raw_item(i)  # [4, H, W, 3] f32 0..255
            p, h, w, c = img.shape
            imgs.append(np.clip(np.transpose(img, (1, 2, 0, 3)).reshape(h, w, p * c),
                                0, 255).astype(np.uint8))
            b = bbox[:, :4].copy()
            b[:, 0::2] /= w
            b[:, 1::2] /= h
            self._boxes.append(b.astype(np.float32))
            self._labels.append(bbox[:, 4].astype(np.int32))
        stack = np.stack(imgs)
        cap = float(os.environ.get("GSSD_DEVICE_CACHE_GB", DEFAULT_CACHE_GB))
        if stack.nbytes > cap * 2**30:
            raise ValueError(
                f"device cache would be {stack.nbytes / 2**30:.1f} GiB (cap {cap}); use "
                "--aug_method host/device for datasets this large or raise "
                "GSSD_DEVICE_CACHE_GB")
        self.cache = torch.from_numpy(stack).to(self.device)
        self.src_size = stack.shape[1]
        self._geom = DeviceAugmentation(
            size=size, src_size=self.src_size, pixeljitter=pixeljitter, ratio=ratio,
            mean=mean, use_normalize=use_normalize, seed=seed, max_gt=max_gt,
            device=self.device)

    def _gather_warp(self, idx: torch.Tensor, scale, offset, flip, bright, contr
                     ) -> torch.Tensor:
        """Items ``idx`` of the cache warped by their scalars (all on the
        device) -> [B, size, size, 12] f32."""
        g = self._geom
        mat_y, mat_x = hat_matrices(scale, offset, flip, g.size, self.src_size)
        return warp(self.cache.index_select(0, idx), mat_y, mat_x, bright, contr, g.mean,
                    g.use_normalize)

    def _batch(self, j: int) -> Dict[str, torch.Tensor]:
        idx = np.asarray(self._perm.indices_for_batch(j, self.batch_size), np.int64)
        # per-batch reseed: the stream is a function of (seed, j)
        self._geom.rng = np.random.default_rng((self.seed << 20) ^ j)
        geom, targets = self._geom.sample_batch([self._boxes[i] for i in idx],
                                                [self._labels[i] for i in idx])
        if self.rows is not None:
            idx, geom = idx[self.rows], geom.take(self.rows)
            targets = {k: v[self.rows] for k, v in targets.items()}
        image = self._gather_warp(torch.from_numpy(idx).to(self.device, non_blocking=True),
                                  *geom.to(self.device))
        return {"image": image, **{k: torch.from_numpy(v).to(self.device, non_blocking=True)
                                   for k, v in targets.items()}}

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        j = self.start_batch
        while True:
            yield self._batch(j)
            j += 1
