// Warp-level tensor-core helpers of the stem conv kernels
// (csrc/stem_conv.cuh, csrc/stem_conv_bwd.cu): the bf16 mma.sync.m16n8k16
// with f32 sums, the ldmatrix loads of its fragments from shared memory
// and stmatrix, which stores such fragments back.
//
// Fragments (g = lane / 4, t = lane % 4): A (16 x 16, row-major) a0 =
// (row g, k 2t..2t+1), a1 = (row g + 8, same k), a2 = (row g, k 2t + 8..),
// a3 = (row g + 8, k 2t + 8..); B (16 x 8, stored n-major) b0 = (k 2t..,
// col g), b1 = (k 2t + 8.., col g); D (16 x 8) d0, d1 = (row g, cols 2t,
// 2t + 1), d2, d3 = (row g + 8, the same cols). ldmatrix_x4 gives A when
// lane l points at row l % 16, columns (l / 16) * 8 .. + 8.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma16816 {

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    // not volatile: a pure function of its registers, free to be scheduled
    asm(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
    const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
    const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a));
}

// the inverse of ldmatrix_x4: lane l points at row l % 8 of matrix l / 8
__device__ __forceinline__ void stmatrix_x4(__nv_bfloat16* p, const uint32_t (&r)[4]) {
    const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
    asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1,%2,%3,%4};\n"
                 :
                 : "r"(a), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
                 : "memory");
}

// stmatrix_x4 storing each 8 x 8 matrix transposed: lane l points at
// row l % 8 of matrix l / 8, which receives column l % 8 of the fragment
__device__ __forceinline__ void stmatrix_x4_trans(__nv_bfloat16* p, const uint32_t (&r)[4]) {
    const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
    asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1,%2,%3,%4};\n"
                 :
                 : "r"(a), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
                 : "memory");
}

}  // namespace mma16816
