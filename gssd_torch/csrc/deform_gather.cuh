// The bilinear corner terms of the hat DCN, shared by csrc/deform_conv_fwd.cu
// and csrc/deform_conv_bwd.cu, so that the forward's samples and the
// backward's are formed by the same code, with the plain versions'
// roundings and order (gssd_torch/ops/kernels/deform_hat.py):
//   corner q = (dy, dx) = (q >> 1, q & 1) of (floor(py), floor(px)),
//   ay = max(0, 1 - |py - qy|), bx = max(0, 1 - |px - qx|) in f32,
//   w_q = bf16((ay * bx) * m), 0 for a corner outside the map,
//   sample = bf16((((0 + w_0 x_0) + w_1 x_1) + w_2 x_2) + w_3 x_3),
// every product and sum rounded on its own (__fmul_rn, __fadd_rn: no
// fused multiply-add), so that a sample is the plain version's bit for
// bit. Channels travel as bf16 pairs in 32-bit words, the first channel
// in the low half.

#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace dcn {

struct Corners {
    int pix[4];   // qy * W + qx of each corner, 0 outside the map
    float w[4];   // bf16(ay * bx * m), 0 outside the map
    float ay[4], bx[4];
    bool in[4];
};

__device__ __forceinline__ Corners corners_of(float fy, float fx, float m, int H, int W) {
    Corners c;
    const float y0 = floorf(fy), x0 = floorf(fx);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const float qy = y0 + (float)(q >> 1);
        const float qx = x0 + (float)(q & 1);
        c.in[q] = qy >= 0.0f && qy < (float)H && qx >= 0.0f && qx < (float)W;
        c.ay[q] = fmaxf(0.0f, 1.0f - fabsf(fy - qy));
        c.bx[q] = fmaxf(0.0f, 1.0f - fabsf(fx - qx));
        c.w[q] = c.in[q] ? __bfloat162float(__float2bfloat16(__fmul_rn(__fmul_rn(c.ay[q], c.bx[q]), m)))
                         : 0.0f;
        c.pix[q] = c.in[q] ? (int)qy * W + (int)qx : 0;
    }
    return c;
}

__device__ __forceinline__ float lo_f(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_f(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// NW words (2 NW bf16 channels) from src, of which `left` channels are
// valid (left <= 0: none). VEC: src is aligned to 4 NW bytes and left is
// >= 2 NW or <= 0, so one vector load; otherwise word by word (left is
// even: C/G is).
template <int NW, bool VEC>
__device__ __forceinline__ void load_words(uint32_t (&v)[NW], const __nv_bfloat16* src, int left) {
    if constexpr (VEC) {
        if (left <= 0) {
#pragma unroll
            for (int i = 0; i < NW; ++i) v[i] = 0u;
        } else if constexpr (NW == 4) {
            const uint4 u = __ldg(reinterpret_cast<const uint4*>(src));
            v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
        } else if constexpr (NW == 2) {
            const uint2 u = __ldg(reinterpret_cast<const uint2*>(src));
            v[0] = u.x, v[1] = u.y;
        } else {
            v[0] = __ldg(reinterpret_cast<const uint32_t*>(src));
        }
    } else {
#pragma unroll
        for (int i = 0; i < NW; ++i)
            v[i] = 2 * i < left ? __ldg(reinterpret_cast<const uint32_t*>(src) + i) : 0u;
    }
}

template <int NW, bool VEC>
__device__ __forceinline__ void store_words(__nv_bfloat16* dst, const uint32_t (&v)[NW], int left) {
    if constexpr (VEC) {
        if (left <= 0) return;
        if constexpr (NW == 4)
            *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
        else if constexpr (NW == 2)
            *reinterpret_cast<uint2*>(dst) = make_uint2(v[0], v[1]);
        else
            *reinterpret_cast<uint32_t*>(dst) = v[0];
    } else {
#pragma unroll
        for (int i = 0; i < NW; ++i)
            if (2 * i < left) reinterpret_cast<uint32_t*>(dst)[i] = v[i];
    }
}

// the bf16 samples of 2 NW channels from the words of the four corners
template <int NW>
__device__ __forceinline__ void blend(uint32_t (&out)[NW], const uint32_t (&v)[4][NW],
                                      const float (&w)[4]) {
#pragma unroll
    for (int i = 0; i < NW; ++i) {
        float a = 0.0f, b = 0.0f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            a = __fadd_rn(a, __fmul_rn(w[q], lo_f(v[q][i])));
            b = __fadd_rn(b, __fmul_rn(w[q], hi_f(v[q][i])));
        }
        out[i] = pack2(a, b);
    }
}

}  // namespace dcn
