// The separable sampler's range pass, shared by csrc/deform_sample_fwd.cu,
// deform_sample_dx.cu and deform_sample_dab.cu: for each row of the hat
// matrices A [rows, H] and B [rows, W] (bf16), the first and last index
// of a non-zero entry. A hat row max(0, 1 - |pos - q|) (times the mask,
// for A) has at most two non-zeros, so the kernels that read these
// ranges add only the terms inside them; the terms outside are products
// with exact zeros. The pass works from the rows as given, so any A and
// B give the right answer, not only hat weights.
//
// A block takes ROWS consecutive rows: it copies their A, then their B
// values (contiguous, 16-byte aligned) into shared memory with 16-byte
// loads, and each thread scans one row there. Rows longer than MAX_STAGED
// are scanned in device memory, a thread per row.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hat_ranges_pass {

constexpr int ROWS = 128;          // rows (and threads) per block
constexpr int MAX_STAGED = 384;    // longest row staged in shared memory (96 KB)

// first and last index i < len with row[i] != 0 (NaN counts as non-zero,
// -0 as zero); (1, 0) for an all-zero row
__device__ __forceinline__ int2 nonzero_range(const uint16_t* row, int len) {
    int lo = 1, hi = 0;
    for (int i = 0; i < len; ++i) {
        if (row[i] & 0x7fff) {
            if (lo > hi) lo = i;
            hi = i;
        }
    }
    return make_int2(lo, hi);
}

// the ranges of this block's rows of one matrix [rows, len]; the calling
// thread's row from shared memory (STAGED) or device memory
template <bool STAGED>
__device__ __forceinline__ int2 block_rows(const uint16_t* __restrict__ m, uint16_t* buf,
                                           long row0, int nrows, int len) {
    const int tid = threadIdx.x;
    if (!STAGED)
        return tid < nrows ? nonzero_range(m + (row0 + tid) * len, len) : make_int2(1, 0);
    const uint16_t* src = m + row0 * len;  // 16-byte aligned: row0 is a multiple of ROWS
    const int n = nrows * len;
    __syncthreads();  // the previous matrix's rows are scanned
    for (int i = tid; i < n / 8; i += ROWS)
        reinterpret_cast<uint4*>(buf)[i] = reinterpret_cast<const uint4*>(src)[i];
    for (int i = n / 8 * 8 + tid; i < n; i += ROWS) buf[i] = src[i];
    __syncthreads();
    return tid < nrows ? nonzero_range(buf + tid * len, len) : make_int2(1, 0);
}

// ranges[i] = (A lo, A hi, B lo, B hi) of row i < rows
template <bool STAGED>
__global__ void __launch_bounds__(ROWS)
hat_ranges(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ B,
           int4* __restrict__ ranges, long rows, int H, int W) {
    extern __shared__ __align__(16) uint16_t buf[];
    const long row0 = (long)blockIdx.x * ROWS;
    const int nrows = rows - row0 < ROWS ? (int)(rows - row0) : ROWS;
    const int2 a = block_rows<STAGED>(reinterpret_cast<const uint16_t*>(A), buf, row0, nrows, H);
    const int2 b = block_rows<STAGED>(reinterpret_cast<const uint16_t*>(B), buf, row0, nrows, W);
    if (threadIdx.x < nrows) ranges[row0 + threadIdx.x] = make_int4(a.x, a.y, b.x, b.y);
}

// launches hat_ranges over `rows` rows on `stream`; A and B 16-byte
// aligned
inline cudaError_t launch(const __nv_bfloat16* A, const __nv_bfloat16* B, int4* ranges, long rows,
                          int H, int W, cudaStream_t stream) {
    const unsigned blocks = (unsigned)((rows + ROWS - 1) / ROWS);
    const int len = H > W ? H : W;
    if (len > MAX_STAGED) {
        hat_ranges<false><<<blocks, ROWS, 0, stream>>>(A, B, ranges, rows, H, W);
        return cudaGetLastError();
    }
    const size_t smem = (size_t)ROWS * len * sizeof(uint16_t);
    cudaError_t err = cudaFuncSetAttribute(hat_ranges<true>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    hat_ranges<true><<<blocks, ROWS, smem, stream>>>(A, B, ranges, rows, H, W);
    return cudaGetLastError();
}

}  // namespace hat_ranges_pass
