// Shared part of the stem conv kernels (stem_conv_fwd.cu, stem_conv_bwd.cu):
// a grouped 3x3, stride 1, zero "same" padding conv over NCHW tensors,
//
//   out[b, co, y, x] = T( bias[co] + sum_{ci in co's group, ky, kx}
//                         bf16(in[b, ci, y + ky - 1, x + kx - 1]) * w[co, ci, ky, kx] )
//
// with the input rounded to bf16 as it enters shared memory, the weights
// in their own type (bf16 or f32), an f32 accumulator, the f32 bias added
// to it (when there is one) and one rounding to T at the end: the
// forward of stem_conv_fwd.cu. (The backward's dx has its own
// tensor-core kernel in stem_conv_bwd.cu.)
//
// The TPU kernel (gssd_tpu/ops/pallas/stem_conv.py) densifies the groups
// into a block-diagonal [9 Cin, Cout] weight and multiplies im2col patches
// on the MXU; the extra terms are exact zeros. Here each block computes
// the grouped conv directly (4x fewer MACs at 4 groups) on the CUDA cores:
// it owns 32 x 32 output pixels of one image and 16 output channels of
// one group, stages 8 input channels at a time with a one-pixel halo in
// shared memory (f32) with their 16 x 9 weights, and each thread keeps
// 4 rows x 16 channels of one column in registers. Per input channel and
// kernel column a thread reads 6 inputs and 3 x 16 weights (broadcast,
// float4) for 192 FMAs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace stem {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_bf16(float v) {
    return __bfloat162float(__float2bfloat16(v));
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16(v); }

constexpr int TX = 32;                     // output columns per block (one warp)
constexpr int TY = 32;                     // output rows per block
constexpr int RPT = 4;                     // rows per thread
constexpr int CO_T = 16;                   // output channels per block
constexpr int CI_T = 8;                    // input channels per shared-memory chunk
constexpr int THREADS = TX * (TY / RPT);   // 256

// in [B, Cin, H, W] T; w [Cout, Cin / G, 3, 3] WT; bias [Cout] f32 or null;
// out [B, Cout, H, W] T. Grid (ceil(W / TX), ceil(H / TY), B * G * n_co)
// with n_co = ceil(Cout / G / CO_T).
template <typename T, typename WT>
__global__ void __launch_bounds__(THREADS, 2)
conv3x3_kernel(const T* __restrict__ in, const WT* __restrict__ w,
               const float* __restrict__ bias, T* __restrict__ out,
               int Cin, int Cout, int G, int H, int W) {
    __shared__ float xs[CI_T][TY + 2][TX + 2];
    __shared__ __align__(16) float ws[CI_T][9][CO_T];

    const int cgi = Cin / G, cgo = Cout / G;
    const int n_co = (cgo + CO_T - 1) / CO_T;
    int z = blockIdx.z;
    const int cc = z % n_co;
    z /= n_co;
    const int grp = z % G;
    const int b = z / G;
    const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
    const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
    const int co_l0 = cc * CO_T;  // first output channel of the block, within the group
    const int nco = min(CO_T, cgo - co_l0);
    const size_t plane = (size_t)H * W;
    const T* inb = in + ((size_t)b * Cin + (size_t)grp * cgi) * plane;

    float acc[RPT][CO_T];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int j = 0; j < CO_T; ++j) acc[r][j] = 0.f;

    for (int c0 = 0; c0 < cgi; c0 += CI_T) {
        const int nci = min(CI_T, cgi - c0);
        __syncthreads();  // the previous chunk is consumed
        for (int i = threadIdx.x; i < nci * (TY + 2) * (TX + 2); i += THREADS) {
            const int ci = i / ((TY + 2) * (TX + 2));
            const int rem = i - ci * (TY + 2) * (TX + 2);
            const int yy = rem / (TX + 2), xx = rem - yy * (TX + 2);
            const int gy = y0 + yy - 1, gx = x0 + xx - 1;
            float v = 0.f;
            if (gy >= 0 && gy < H && gx >= 0 && gx < W)
                v = round_bf16(to_f32(inb[(size_t)(c0 + ci) * plane + (size_t)gy * W + gx]));
            xs[ci][yy][xx] = v;
        }
        for (int i = threadIdx.x; i < CI_T * 9 * CO_T; i += THREADS) {
            const int j = i % CO_T, t = (i / CO_T) % 9, ci = i / (9 * CO_T);
            float v = 0.f;
            if (ci < nci && j < nco)
                v = to_f32(w[((size_t)(grp * cgo + co_l0 + j) * cgi + c0 + ci) * 9 + t]);
            ws[ci][t][j] = v;
        }
        __syncthreads();
        for (int ci = 0; ci < nci; ++ci) {
#pragma unroll
            for (int kx = 0; kx < 3; ++kx) {
                float v[RPT + 2];
#pragma unroll
                for (int r = 0; r < RPT + 2; ++r) v[r] = xs[ci][ty * RPT + r][tx + kx];
#pragma unroll
                for (int ky = 0; ky < 3; ++ky) {
                    float wv[CO_T];
                    const float4* wp = reinterpret_cast<const float4*>(&ws[ci][ky * 3 + kx][0]);
#pragma unroll
                    for (int q = 0; q < CO_T / 4; ++q) {
                        const float4 t4 = wp[q];
                        wv[4 * q] = t4.x;
                        wv[4 * q + 1] = t4.y;
                        wv[4 * q + 2] = t4.z;
                        wv[4 * q + 3] = t4.w;
                    }
#pragma unroll
                    for (int r = 0; r < RPT; ++r)
#pragma unroll
                        for (int j = 0; j < CO_T; ++j) acc[r][j] = fmaf(v[r + ky], wv[j], acc[r][j]);
                }
            }
        }
    }

    const int x = x0 + tx;
    if (x >= W) return;
#pragma unroll
    for (int j = 0; j < CO_T; ++j) {
        if (j < nco) {
            const int co = grp * cgo + co_l0 + j;
            T* outc = out + ((size_t)b * Cout + co) * plane + x;
            const float bv = bias != nullptr ? bias[co] : 0.f;
#pragma unroll
            for (int r = 0; r < RPT; ++r) {
                const int y = y0 + ty * RPT + r;
                if (y < H) outc[(size_t)y * W] = from_f32<T>(bias != nullptr ? acc[r][j] + bv : acc[r][j]);
            }
        }
    }
}

inline bool conv_shape_ok(int B, int Cin, int Cout, int G, int H, int W) {
    return B >= 1 && G >= 1 && Cin >= G && Cout >= G && Cin % G == 0 && Cout % G == 0 &&
           H >= 1 && W >= 1 && (long long)B * G * ((Cout / G + CO_T - 1) / CO_T) <= 65535;
}

template <typename T, typename WT>
cudaError_t launch_conv3x3(const void* in, const void* w, const float* bias, void* out, int B,
                           int Cin, int Cout, int G, int H, int W, cudaStream_t stream) {
    const int n_co = (Cout / G + CO_T - 1) / CO_T;
    const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, B * G * n_co);
    conv3x3_kernel<T, WT><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(in), static_cast<const WT*>(w), bias, static_cast<T*>(out), Cin,
        Cout, G, H, W);
    return cudaGetLastError();
}

}  // namespace stem
