"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version. ``KERNELS`` lists every kernel the serving path launches."""

from gssd_torch.ops.kernels import deform_hat, flash_attn
from gssd_torch.ops.kernels.build import CudaKernel, build

KERNELS = {
    "flash_attn_fwd": flash_attn.KERNEL,
    "deform_conv_fwd": deform_hat.KERNEL,
}

__all__ = ["CudaKernel", "KERNELS", "build", "deform_hat", "flash_attn"]
