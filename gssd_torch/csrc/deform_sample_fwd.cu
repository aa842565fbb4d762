// Separable deformable sampling, forward, for Hopper (sm_90a):
//
//   out[n, p, c] = sum_qx B[n, p, qx] * ( sum_qy A[n, p, qy] * x[n, qy, qx, c] )
//
// n runs over (image, deformable group); A [n, P, H], B [n, P, W], x [n,
// H, W, Cg] are bf16, out [n, P, Cg] is f32. Replaces
// gssd_tpu/ops/pallas/deform_sample.py _fwd_kernel (the Pallas TPU kernel
// behind abx_sample, dcn_impl='pallas'), with its roundings: bf16 inputs,
// the inner product over qy accumulated in f32, multiplied by the bf16 B
// value in f32 and summed over qx in f32 (separate multiply and add, as
// the TPU kernel's t * b then sum).
//
// The TPU kernel contracts the dense hat rows on the MXU: 2 * H * W * Cg
// operations a pixel, of which 4 * Cg are non-zero, since a hat row A[p,
// :] (times the mask) or B[p, :] has at most two non-zeros. Here a first
// kernel (hat_ranges, csrc/hat_ranges.cuh) stores each row's first and
// last non-zero index; the second gives a thread 8 channels of one (n,
// p) and walks only the cells inside both ranges: for qx in B's range,
// ascending, T = sum over qy in A's range, ascending, of a * x (each a
// product of two bf16 values, exact in f32, added with __fadd_rn), then
// acc = __fadd_rn(acc, __fmul_rn(b, T)); no fmaf, as the plain version
// multiplies and adds separately. x arrives as 16-byte loads of 8 bf16
// channels (Cg / 8 neighbouring threads read one corner's Cg channels)
// and out leaves as two 16-byte stores a thread.
//
// Rounding: at hat rows T has at most two non-zero exact terms and acc at
// most two non-zero terms b * T, and a sum of at most two non-zero terms
// rounds once whatever the order; the terms outside the ranges are exact
// zeros, whose sum into an f32 value leaves it unchanged. So at hat rows
// (including empty rows and integer positions) the output is the dense
// order's (abx_fwd_plain's) bit for bit. Rows with more non-zeros are
// walked over their whole range and summed in this order, within f32
// rounding of any other. The one difference: the dense order multiplies
// a NaN or Inf of x by the zeros of A and B outside the ranges, which
// spreads NaN over the row; here a non-finite value of x reaches out only
// where its cell lies inside both ranges of a p.
//
// What bounds it: the bytes, x read once (94.6 MB at batch 32, 38x38, Cg
// 256), A and B (28 MB) and the f32 out written (189 MB), ~0.093 ms at
// 3.35 TB/s; the corners come from L2 (each x row is read by the ~4 p
// that sample around it). Takes any H and W and Cg a multiple of 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hat_ranges.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;

// t += a * x for the 8 channels of x (8 bf16 in v), each product exact
__device__ __forceinline__ void add_row(float (&t)[8], float a, uint4 v) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        t[2 * j] = __fadd_rn(t[2 * j], __fmul_rn(a, __uint_as_float(w[j] << 16)));
        t[2 * j + 1] =
            __fadd_rn(t[2 * j + 1], __fmul_rn(a, __uint_as_float(w[j] & 0xffff0000u)));
    }
}

// one column qx of a hat row: T = 0 + a0 x0 (+ a1 x1 where the A row has
// two cells), then acc += b T
__device__ __forceinline__ void column(float (&acc)[8], float a0, float a1, float b, uint4 v0,
                                       uint4 v1, bool two) {
    float t[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) t[j] = 0.0f;
    add_row(t, a0, v0);
    if (two) add_row(t, a1, v1);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(b, t[j]));
}

__global__ void __launch_bounds__(THREADS)
abx_fwd_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
               const bf16* __restrict__ x, const int4* __restrict__ ranges,
               float* __restrict__ out, int P, int H, int W, int Cg) {
    const int cpr = Cg / 8;  // threads per pixel
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= P * cpr) return;
    const int n = blockIdx.y;
    const int p = i / cpr;
    const int c = (i - p * cpr) * 8;
    const size_t row = (size_t)n * P + p;
    const int4 r = ranges[row];
    const bf16* arow = A + row * H;
    const bf16* brow = B + row * W;
    const bf16* xn = x + (size_t)n * H * W * Cg + c;

    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.0f;
    if (r.x <= r.y && r.y - r.x <= 1 && r.z <= r.w && r.w - r.z <= 1) {
        // a hat row's 1 or 2 cells each way: every load issued first, then
        // the same operations in the same order as the loop below
        const bool y2 = r.y > r.x, x2 = r.w > r.z;
        const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
        const bf16* c00 = xn + ((size_t)r.x * W + r.z) * Cg;
        const uint4 v00 = *reinterpret_cast<const uint4*>(c00);
        const uint4 v10 = y2 ? *reinterpret_cast<const uint4*>(c00 + (size_t)W * Cg) : zero;
        const uint4 v01 = x2 ? *reinterpret_cast<const uint4*>(c00 + Cg) : zero;
        const uint4 v11 =
            y2 && x2 ? *reinterpret_cast<const uint4*>(c00 + (size_t)(W + 1) * Cg) : zero;
        const float a0 = __bfloat162float(arow[r.x]);
        const float a1 = y2 ? __bfloat162float(arow[r.y]) : 0.0f;
        const float b0 = __bfloat162float(brow[r.z]);
        const float b1 = x2 ? __bfloat162float(brow[r.w]) : 0.0f;
        column(acc, a0, a1, b0, v00, v10, y2);
        if (x2) column(acc, a0, a1, b1, v01, v11, y2);
    } else {
        for (int qx = r.z; qx <= r.w; ++qx) {
            float t[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) t[j] = 0.0f;
            for (int qy = r.x; qy <= r.y; ++qy)
                add_row(t, __bfloat162float(arow[qy]),
                        *reinterpret_cast<const uint4*>(xn + ((size_t)qy * W + qx) * Cg));
            const float b = __bfloat162float(brow[qx]);
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(b, t[j]));
        }
    }
    float4* o = reinterpret_cast<float4*>(out + row * Cg + c);
    o[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    o[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
}

}  // namespace

// A [NG,P,H], B [NG,P,W], x [NG,H,W,Cg] bf16; out [NG,P,Cg] f32; ranges
// [NG,P] int4 scratch. All contiguous and 16-byte aligned; Cg a multiple
// of 8. Launches the range pass and the sample kernel on `stream`;
// returns the CUDA error code (0 on success).
extern "C" int deform_sample_fwd(const void* A, const void* B, const void* x, void* out,
                                 void* ranges, int NG, int P, int H, int W, int Cg,
                                 void* stream) {
    if (NG < 1 || NG > 65535 || P < 1 || H < 1 || W < 1 || Cg < 8 || Cg % 8 ||
        (long)P * (Cg / 8) > 0x7fffffffL - THREADS)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bf16* a = static_cast<const bf16*>(A);
    const bf16* b = static_cast<const bf16*>(B);
    cudaError_t err =
        hat_ranges_pass::launch(a, b, static_cast<int4*>(ranges), (long)NG * P, H, W, s);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)(((long)P * (Cg / 8) + THREADS - 1) / THREADS), NG);
    abx_fwd_kernel<<<grid, THREADS, 0, s>>>(a, b, static_cast<const bf16*>(x),
                                            static_cast<const int4*>(ranges),
                                            static_cast<float*>(out), P, H, W, Cg);
    return (int)cudaGetLastError();
}

extern "C" const char* deform_sample_fwd_error(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
