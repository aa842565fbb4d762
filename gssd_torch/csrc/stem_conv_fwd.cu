// Stem conv forward for Hopper (sm_90a): a grouped 3x3, stride 1, zero
// "same" padding conv over NCHW, the port of
// gssd_tpu/ops/pallas/stem_conv.py _fwd_kernel (conv3x3_wide's forward,
// behind USE_PALLAS_WIDE_CONV). Its arithmetic: the input patches rounded
// to bf16, the weights in the compute dtype (bf16, or f32 in an f32
// model), f32 accumulation, the f32 bias added to the f32 sum and one
// rounding to x's dtype. The kernel itself is in stem_conv.cuh.
//
// What bounds it here: at the PixelLink++ stem (batch 16, 300 x 300)
// conv1_2 (64 -> 64, 4 groups) moves 368 MB (0.11 ms at 3.35 TB/s) and
// does 26.5 GFLOP of grouped products; conv1_1 (12 -> 64) moves 219 MB.
// The CUDA cores' f32 FMA rate puts conv1_2 at ~0.4 ms even at their
// peak; the tensor cores (mma.sync or wgmma on bf16) are the next step,
// kept for a later change because f32 weights have to go through the
// same kernel.

#include "stem_conv.cuh"

// x [B, Cin, H, W], w [Cout, Cin / G, 3, 3] of one dtype (dtype 0: bf16,
// 1: f32), bias [Cout] f32, out [B, Cout, H, W] in x's dtype; all
// contiguous. Returns the CUDA error code of the launch (0 on success).
extern "C" int stem_conv_fwd(const void* x, const void* w, const void* bias, void* out, int B,
                             int Cin, int Cout, int G, int H, int W, int dtype, void* stream) {
    if (!stem::conv_shape_ok(B, Cin, Cout, G, H, W) || (dtype != 0 && dtype != 1))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* b = static_cast<const float*>(bias);
    if (dtype == 0)
        return (int)stem::launch_conv3x3<stem::bf16, stem::bf16>(x, w, b, out, B, Cin, Cout, G,
                                                                 H, W, s);
    return (int)stem::launch_conv3x3<float, float>(x, w, b, out, B, Cin, Cout, G, H, W, s);
}

extern "C" const char* stem_conv_fwd_error(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
