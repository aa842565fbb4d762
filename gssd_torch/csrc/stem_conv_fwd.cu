// Stem conv forward for Hopper (sm_90a): a grouped 3x3, stride 1, zero
// "same" padding conv over NCHW, the port of
// gssd_tpu/ops/pallas/stem_conv.py _fwd_kernel (conv3x3_wide's forward,
// behind USE_PALLAS_WIDE_CONV). Its arithmetic: the input patches rounded
// to bf16, the weights in the compute dtype, f32 accumulation, the f32
// bias added to the f32 sum and one rounding to x's dtype.
//
// The kernel is stem_conv.cuh's implicit-GEMM conv on the tensor cores
// (mma.sync, bf16 operands), which the backward's dx runs too. bf16 weights
// go through as one part; f32 weights (an f32 model) as three bf16 parts,
// hi = bf16(w), mid = bf16(w - hi), lo = bf16(w - hi - mid), whose sum is w
// exactly: every product bf16(x) * part is exact in f32, so the result
// differs from an f32 conv of bf16(x) with w only in the order of its f32
// sums (the wrapper's split_bf16 makes the parts).
//
// What bounds it: at the PixelLink++ stem (batch 16, 300 x 300) conv1_2
// (64 -> 64, 4 groups) moves 368 MB (0.110 ms at 3.35 TB/s) for 26.5 GFLOP
// of grouped products (0.027 ms on the tensor cores); conv1_1 (12 -> 64)
// moves 219 MB, most of it the output. The design streams whole rows
// (stem_conv.cuh).

#include "stem_conv.cuh"

// x [B, Cin, H, W] (dtype 0: bf16, 1: f32); w [parts, Cout, Cin / G, 3, 3]
// bf16 (1 part for bf16 x, 3 for f32 x); bias [Cout] f32; wpack scratch of
// stem_conv_fwd_wpack_elems bf16; out [B, Cout, H, W] in x's dtype. Cin /
// G and Cout / G at most 64. All contiguous. Returns the CUDA error code of
// the first launch that failed (0 on success).
extern "C" int stem_conv_fwd(const void* x, const void* w, const void* bias, void* wpack,
                             void* out, int B, int Cin, int Cout, int G, int H, int W, int dtype,
                             int parts, void* stream) {
    if (!stem::conv_shape_ok(B, Cin, Cout, G, H, W) || !stem::conv_ok(Cin / G, Cout / G) ||
        (dtype != 0 && dtype != 1) || parts != (dtype == 0 ? 1 : 3))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const stem::bf16* wb = static_cast<const stem::bf16*>(w);
    const float* b = static_cast<const float*>(bias);
    stem::bf16* wp = static_cast<stem::bf16*>(wpack);
    if (dtype == 0)
        return (int)stem::launch_conv<stem::bf16, 1>(x, wb, b, wp, out, B, G, Cin / G, Cout / G,
                                                     H, W, s);
    return (int)stem::launch_conv<float, 3>(x, wb, b, wp, out, B, G, Cin / G, Cout / G, H, W, s);
}

// bf16 elements of the wpack scratch a launch at these sizes takes
extern "C" long stem_conv_fwd_wpack_elems(int Cin, int Cout, int G, int parts) {
    return stem::conv_wpack_elems(Cin / G, Cout / G, G, parts);
}

extern "C" const char* stem_conv_fwd_error(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
