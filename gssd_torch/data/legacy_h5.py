"""Legacy v1 h5 dataset (reference data/data_custom.py FISHdetection): the
port of ``gssd_tpu/data/legacy_h5.py``.

The v1 pipeline (DEPRECATED trainers, test_ap.py, 3Dircadb extraction)
stores whole-subject arrays in h5: group 'ct' holds [n, 4, 3, H, W]
volumes and 'label'/'coordinate' holds per-sample boxes. This reader
exposes them with the item protocol of the port's LesionDataset
(``pull_image``, ``pull_anno``, ``__getitem__``), so that
``gssd_torch.eval.ap_iobb.run_detection_eval`` takes it unchanged and
the modern harness can evaluate legacy-format data (e.g. the 3Dircadb h5
dumps of preprocessing/ircadb.py extract_to_h5).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np


class H5LesionDataset:
    def __init__(self, h5_path: str, transform: Optional[Callable] = None):
        import h5py

        self.transform = transform
        self._images: List[np.ndarray] = []
        self._targets: List[np.ndarray] = []
        with h5py.File(h5_path, "r") as f:
            ct_group = f["ct"]
            label_group = f["label"] if "label" in f else f["coordinate"]
            for key in sorted(ct_group.keys()):
                cts = np.asarray(ct_group[key])  # [n, 4, 3, H, W]
                idx = key.split("_")[-1]
                lbl_key = [k for k in label_group.keys()
                           if k.endswith("_" + idx)]
                labels = np.asarray(label_group[lbl_key[0]]) if lbl_key \
                    else None
                for i in range(cts.shape[0]):
                    self._images.append(cts[i].astype(np.float32))
                    if labels is None or labels.ndim < 2:
                        t = np.zeros((0, 5), np.float32)
                    elif labels[i].ndim == 3 and labels[i].shape[-1] == 5:
                        # v1 ROI-era coordinate tensor [phase, channel, 5]
                        # (preprocessing/legacy_v1.py): boxes come from
                        # the middle slice of one phase (the DEPRECATED
                        # trainer's convention, :128-132)
                        mid = labels[i].shape[1] // 2
                        t = np.asarray(labels[i][0, mid], np.float32
                                       ).reshape(-1, 5)
                    elif labels[i].size % 5 == 0:
                        t = np.asarray(labels[i], np.float32).reshape(-1, 5)
                    else:
                        t = np.zeros((0, 5), np.float32)
                    self._targets.append(t)

    def __len__(self) -> int:
        return len(self._images)

    def pull_image(self, index: int) -> np.ndarray:
        """[4, H, W, 3] float 0..255 (matching LesionDataset)."""
        img = np.transpose(self._images[index], (0, 2, 3, 1))
        return img * 255.0

    def pull_anno(self, index: int) -> np.ndarray:
        return self._targets[index]

    def __getitem__(self, index: int):
        img = self.pull_image(index)
        target = self._targets[index]
        h, w = img.shape[1], img.shape[2]
        boxes = target[:, :4].copy()
        if len(boxes):
            boxes[:, 0::2] /= w
            boxes[:, 1::2] /= h
        labels = target[:, 4].copy() if len(target) else np.zeros((0,))
        if self.transform is not None:
            img, boxes, labels = self.transform(img, boxes, labels)
        return img, boxes, labels
