"""gssd_torch — GSSD / GSSD++ liver-lesion detection in PyTorch with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The port of ``gssd_tpu`` (JAX on a TPU), which stays the reference this
package is tested against. It imports neither JAX nor ``gssd_tpu``.
Serving path: ``python -m gssd_torch.infer``; training:
``python -m gssd_torch.train`` (the SSD family: SSD, GSSD, GSSD++ and
the FSSD family), ``python -m gssd_torch.train_pixellink`` (PixelLink++),
``python -m gssd_torch.train_unet`` (UNet liver segmentation) and
``python -m gssd_torch.train_voc`` (the VOC SSD300 baseline).
"""

import torch


def resolve_device(name) -> torch.device:
    """The device an entry point runs on. A CUDA device is required
    unless the caller asks for the CPU by name: without a card this
    raises rather than carrying on on the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but CUDA is not available; "
            "pass device='cpu' (--device cpu) to run on the CPU")
    return dev
