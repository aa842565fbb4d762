"""Training logs: tab-separated text files plus TensorBoard scalars.

The port of ``gssd_tpu/utils/logging.py``. ``MetricsLogger`` writes
``<log_dir>/<name>_log.txt`` files (``args``, ``train``, ``valid``,
``test``), one line per call: ``<step>\\t<group>\\tkey=value...``. Where
``torch.utils.tensorboard`` imports, the same scalars (and score
histograms) also go to ``<log_dir>/tb``; where it does not, that sink
is left out, and so are the images (``log_image``: the input grid with
its boxes, every 100 iterations), which go only there.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional

import numpy as np


class MetricsLogger:
    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._files: Dict[str, object] = {}
        self.tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return
        self.tb = SummaryWriter(os.path.join(log_dir, "tb"))

    def _file(self, name: str):
        if name not in self._files:
            self._files[name] = open(os.path.join(self.log_dir, f"{name}_log.txt"), "a",
                                     buffering=1)
        return self._files[name]

    def log_args(self, args: Mapping):
        f = self._file("args")
        for k, v in sorted(dict(args).items()):
            f.write(f"{k}\t{v}\n")
        f.write("\n")

    def log_scalars(self, group: str, step: int, scalars: Mapping[str, float],
                    file: Optional[str] = None):
        if self.tb is not None:
            for k, v in scalars.items():
                self.tb.add_scalar(f"{group}/{k}", float(v), step)
        cols = "\t".join(f"{k}={float(v):.6g}" for k, v in scalars.items())
        self._file(file or "train").write(f"{step}\t{group}\t{cols}\n")

    def log_histogram(self, tag: str, step: int, values):
        """Detection-score histograms (before and after the confidence
        filter), TensorBoard only."""
        if self.tb is not None:
            values = np.asarray(values, np.float32).ravel()
            if values.size:
                self.tb.add_histogram(tag, values, step)

    def log_image(self, tag: str, step: int, image):
        """image: [H, W, C] float array in [0, 1], TensorBoard only."""
        if self.tb is not None:
            self.tb.add_image(tag, np.transpose(image, (2, 0, 1)), step)

    def close(self):
        for f in self._files.values():
            f.close()
        self._files.clear()
        if self.tb is not None:
            self.tb.close()


class NullLogger:
    """``MetricsLogger``'s interface, writing nothing: the logger of a
    data-parallel rank that neither prints the run nor evaluates a fold."""

    tb = None

    def log_args(self, args):
        pass

    def log_scalars(self, group, step, scalars, file=None):
        pass

    def log_histogram(self, tag, step, values):
        pass

    def log_image(self, tag, step, image):
        pass

    def close(self):
        pass
