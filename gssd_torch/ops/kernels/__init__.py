"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version. ``KERNELS`` lists every kernel the serving and training paths
launch, on every DCN route and with the wide-conv switch on."""

from gssd_torch.ops.kernels import deform_hat, deform_sample, flash_attn, stem_conv
from gssd_torch.ops.kernels.build import CudaKernel, build

KERNELS = {
    "flash_attn_fwd": flash_attn.KERNEL,
    "flash_attn_bwd": flash_attn.BWD_KERNEL,
    "deform_conv_fwd": deform_hat.KERNEL,
    "deform_conv_bwd": deform_hat.BWD_KERNEL,
    "deform_sample_fwd": deform_sample.FWD_KERNEL,
    "deform_sample_dx": deform_sample.DX_KERNEL,
    "deform_sample_dab": deform_sample.DAB_KERNEL,
    "stem_conv_fwd": stem_conv.FWD_KERNEL,
    "stem_conv_bwd": stem_conv.BWD_KERNEL,
}

__all__ = ["CudaKernel", "KERNELS", "build", "deform_hat", "deform_sample", "flash_attn",
           "stem_conv"]
