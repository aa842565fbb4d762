// Fused SAGAN attention backward for Hopper (sm_90a):
//   given q, k, v (bf16), lse (f32), dO (bf16) and D = rowsum(dO * O) (f32),
//   P  = exp(q k^T - lse)             (recomputed, f32)
//   dV = bf16(P)^T dO                 (bf16 products, f32 sums)
//   dP = dO V^T                       (bf16 products, f32 sums)
//   dS = P * (dP - D)                 (f32)
//   dQ = dS K,  dK = dS^T Q           (f32 products, f32 sums)
// dK and dV are written in bf16 by the kernels; dQ is summed in f32 and
// rounded to bf16 by the caller.
//
// Replaces gssd_tpu/ops/pallas/flash_attn.py _bwd_kernel (the Pallas TPU
// kernel) with the same arithmetic. dS stays f32 as there (its comment
// measured ~1.6% gradient error with a bf16 dS); the two dk-deep
// products that consume it run as f32 FMA on the CUDA cores (no TF32).
// Only the two dv-deep bf16 products (dV and dP) and the bf16 logits
// use the tensor cores (mma.sync m16n8k16).
//
// What bounds it here: 2*N*M*(3*dk + 2*dv) operations against a few MB
// of q/k/v/dO, so the ideal kernel is bound by operations; the f32 FMA
// share (2*N*M*2*dk) runs at the CUDA-core rate, not the tensor cores'.
//
// The TPU kernel owns a query tile and revisits the dK/dV output block
// over the sequential grid. Blocks here run in parallel, so every block
// owns a 64-key tile and walks all query tiles: dK and dV are summed in
// the block, with no atomics. Two kernels:
//   flash_bwd_dv:   one block per (key tile, 128-column slice of dv); it
//                   recomputes P^T (dk-deep, cheap) and accumulates
//                   bf16(P)^T dO in registers (64 f32 a thread even at
//                   dv = 512, which a single 64 x 512 f32 tile would not
//                   allow);
//   flash_bwd_dkdq: one block per key tile; it recomputes P^T and dP^T =
//                   V dO^T over the full dv (V and the dO tile in shared
//                   memory, ~200 KB at dk = 128, dv = 512), forms dS^T in
//                   f32 in shared memory, adds dS^T Q into its dK
//                   registers and dS K into dQ with f32 atomicAdd (dQ is
//                   summed over key tiles, so its order of summation is
//                   not deterministic).
// Ragged tiles: key rows past M and query rows past N are zero-filled
// and their P is forced to 0, so they add nothing (M = 1, 9, 25 work).

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TK = 64;    // keys per block
constexpr int TQ = 64;    // queries per step
constexpr int PAD = 8;    // bf16 padding per smem row: conflict-free ldmatrix
constexpr int SPAD = 4;   // f32 padding per dS row
constexpr int MAX_DK = 128;
constexpr int MAX_DV = 512;

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
    const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
    const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
    return *reinterpret_cast<uint32_t*>(&v);
}

// rows [row0, row0 + rows) x cols [col0, col0 + width) of a row-major
// [nvalid, ld] bf16 matrix into smem [rows][width + PAD] with cp.async;
// rows past nvalid are zero. width and col0 are multiples of 8.
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src, int row0, int rows,
                                                int nvalid, int ld, int col0, int width,
                                                int nthreads) {
    const int vpr = width / 8;
    const int lds = width + PAD;
    for (int i = threadIdx.x; i < rows * vpr; i += nthreads) {
        const int r = i / vpr;
        const int c = (i - r * vpr) * 8;
        bf16* d = dst + r * lds + c;
        if (row0 + r < nvalid)
            __pipeline_memcpy_async(d, src + (size_t)(row0 + r) * ld + col0 + c, 16);
        else
            *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
}

// c[j] (NT n-tiles of 8 columns) = A[16 rows, kdim] . B[NT*8 rows, kdim]^T,
// both row-major bf16 in smem (lda, ldb in elements). Accumulator layout:
// c[j][0..1] row g, columns j*8 + 2*tig + {0,1}; c[j][2..3] row g + 8.
template <int NT>
__device__ __forceinline__ void mma_nt(float (&c)[NT][4], const bf16* a, int lda, const bf16* b,
                                       int ldb, int kdim, int lane) {
#pragma unroll
    for (int j = 0; j < NT; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.0f;
    const int mi = lane >> 3, r = lane & 7;
    for (int kk = 0; kk < kdim; kk += 16) {
        uint32_t af[4];
        ldmatrix_x4(af, a + ((mi & 1) * 8 + r) * lda + kk + (mi >> 1) * 8);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
            uint32_t bb[4];
            ldmatrix_x4(bb, b + ((j + (mi >> 1)) * 8 + r) * ldb + kk + (mi & 1) * 8);
            mma_bf16(c[j], af, bb[0], bb[1]);
            mma_bf16(c[j + 1], af, bb[2], bb[3]);
        }
    }
}

// ---------------------------------------------------------------------------
// dV: block (key tile, dv slice of DVT columns, image), 4 warps x 16 keys
// ---------------------------------------------------------------------------

constexpr int DV_THREADS = 128;

template <int DVT>
__global__ void __launch_bounds__(DV_THREADS)
flash_bwd_dv(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ dO, const float* __restrict__ lse,
             bf16* __restrict__ dv_out, int N, int M, int dk, int dv) {
    constexpr int LDO = DVT + PAD;
    extern __shared__ __align__(128) unsigned char smem[];
    const int ldk = dk + PAD;
    bf16* ks = reinterpret_cast<bf16*>(smem);  // [TK][ldk]
    bf16* qs = ks + TK * ldk;                  // [2][TQ][ldk]
    bf16* os = qs + 2 * TQ * ldk;              // [2][TQ][LDO]
    float* ls = reinterpret_cast<float*>(os + 2 * TQ * LDO);  // [2][TQ]

    const int b = blockIdx.z;
    const int m0 = blockIdx.x * TK;
    const int c0 = blockIdx.y * DVT;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2, tig = lane & 3;
    const bf16* qb = q + (size_t)b * N * dk;
    const bf16* kb = k + (size_t)b * M * dk;
    const bf16* ob = dO + (size_t)b * N * dv;
    const float* lb = lse + (size_t)b * N;
    const int ntiles = (N + TQ - 1) / TQ;

    auto load_q = [&](int t, int buf) {
        load_tile_async(qs + buf * TQ * ldk, qb, t * TQ, TQ, N, dk, 0, dk, DV_THREADS);
        load_tile_async(os + buf * TQ * LDO, ob, t * TQ, TQ, N, dv, c0, DVT, DV_THREADS);
        for (int i = threadIdx.x; i < TQ; i += DV_THREADS) {
            const int n = t * TQ + i;
            ls[buf * TQ + i] = n < N ? lb[n] : 0.0f;
        }
    };

    load_tile_async(ks, kb, m0, TK, M, dk, 0, dk, DV_THREADS);
    load_q(0, 0);
    __pipeline_commit();

    float acc[DVT / 8][4];
#pragma unroll
    for (int f = 0; f < DVT / 8; ++f) acc[f][0] = acc[f][1] = acc[f][2] = acc[f][3] = 0.0f;
    const bool key_ok[2] = {m0 + warp * 16 + g < M, m0 + warp * 16 + g + 8 < M};

    for (int t = 0; t < ntiles; ++t) {
        const int buf = t & 1;
        if (t + 1 < ntiles) load_q(t + 1, buf ^ 1);
        __pipeline_commit();
        __pipeline_wait_prior(1);
        __syncthreads();
        // S^T [16 keys x 64 queries] of this warp
        float s[TQ / 8][4];
        mma_nt<TQ / 8>(s, ks + warp * 16 * ldk, ldk, qs + buf * TQ * ldk, ldk, dk, lane);
        const bf16* ot = os + buf * TQ * LDO;
        const float* lt = ls + buf * TQ;
        const int n0 = t * TQ;
        const int mi = lane >> 3, r = lane & 7;
#pragma unroll
        for (int kk = 0; kk < TQ / 16; ++kk) {
            // A operand: bf16(P^T) of queries kk*16 .. +15 = tiles 2kk, 2kk+1
            uint32_t pa[4];
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int j = 2 * kk + half;
                float p[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int col = j * 8 + 2 * tig + (e & 1);
                    p[e] = (n0 + col < N && key_ok[e >> 1]) ? expf(s[j][e] - lt[col]) : 0.0f;
                }
                pa[2 * half] = pack_bf16(p[0], p[1]);      // key row g
                pa[2 * half + 1] = pack_bf16(p[2], p[3]);  // key row g + 8
            }
#pragma unroll
            for (int f = 0; f < DVT / 8; f += 2) {
                uint32_t bo[4];
                ldmatrix_x4_trans(bo, ot + (kk * 16 + (mi & 1) * 8 + r) * LDO + (f + (mi >> 1)) * 8);
                mma_bf16(acc[f], pa, bo[0], bo[1]);
                mma_bf16(acc[f + 1], pa, bo[2], bo[3]);
            }
        }
        __syncthreads();  // this buffer is refilled two tiles on
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int m = m0 + warp * 16 + g + 8 * h;
        if (m < M) {
            bf16* row = dv_out + ((size_t)b * M + m) * dv + c0 + 2 * tig;
#pragma unroll
            for (int f = 0; f < DVT / 8; ++f)
                *reinterpret_cast<__nv_bfloat162*>(row + f * 8) =
                    __floats2bfloat162_rn(acc[f][2 * h], acc[f][2 * h + 1]);
        }
    }
}

// ---------------------------------------------------------------------------
// dK and dQ: block (key tile, image), 8 warps: warp w computes keys
// (w % 4) * 16 .. +16 x queries (w / 4) * 32 .. +32 of S^T and dP^T. The
// f32 products then run with thread t owning 4 rows x DR = dk / 16
// columns: keys (t / 16) * 4 .. +4 of dK, queries (t / 16) * 4 .. +4 of
// the tile's dQ, columns (t % 16) * DR .. +DR.
// ---------------------------------------------------------------------------

constexpr int DKQ_THREADS = 256;
constexpr int LDS = TQ + SPAD;  // f32 row stride of the dS tiles

template <int DR>
__global__ void __launch_bounds__(DKQ_THREADS)
flash_bwd_dkdq(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dO,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dq_acc, bf16* __restrict__ dk_out, int N, int M, int dv) {
    constexpr int dk = DR * 16;
    constexpr int ldk = dk + PAD;
    extern __shared__ __align__(128) unsigned char smem[];
    const int ldv = dv + PAD;
    bf16* ks = reinterpret_cast<bf16*>(smem);  // [TK][ldk]
    bf16* qs = ks + TK * ldk;                  // [TQ][ldk]
    bf16* vs = qs + TQ * ldk;                  // [TK][ldv]
    bf16* os = vs + TK * ldv;                  // [TQ][ldv]
    float* dst_kq = reinterpret_cast<float*>(os + TQ * ldv);  // dS^T [TK][LDS]
    float* dst_qk = dst_kq + TK * LDS;                        // dS   [TQ][LDS]
    float* ls = dst_qk + TQ * LDS;                            // [TQ]
    float* ds_ = ls + TQ;                                     // [TQ] (D)

    const int b = blockIdx.z;
    const int m0 = blockIdx.x * TK;
    const int tid = threadIdx.x;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2, tig = lane & 3;
    const int wk = (warp & 3) * 16;  // warp's key rows
    const int wq = (warp >> 2) * 32; // warp's query columns
    const int rg = tid / 16;         // row group of the f32 products (4 rows)
    const int cg = (tid % 16) * DR;  // first column of the f32 products
    const bf16* qb = q + (size_t)b * N * dk;
    const bf16* kb = k + (size_t)b * M * dk;
    const bf16* vb = v + (size_t)b * M * dv;
    const bf16* ob = dO + (size_t)b * N * dv;
    const int ntiles = (N + TQ - 1) / TQ;

    load_tile_async(ks, kb, m0, TK, M, dk, 0, dk, DKQ_THREADS);
    load_tile_async(vs, vb, m0, TK, M, dv, 0, dv, DKQ_THREADS);
    __pipeline_commit();

    float dk_acc[4][DR];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DR; ++j) dk_acc[i][j] = 0.0f;
    const bool key_ok[2] = {m0 + wk + g < M, m0 + wk + g + 8 < M};

    for (int t = 0; t < ntiles; ++t) {
        const int n0 = t * TQ;
        load_tile_async(qs, qb, n0, TQ, N, dk, 0, dk, DKQ_THREADS);
        load_tile_async(os, ob, n0, TQ, N, dv, 0, dv, DKQ_THREADS);
        for (int i = tid; i < TQ; i += DKQ_THREADS) {
            const int n = n0 + i;
            ls[i] = n < N ? lse[(size_t)b * N + n] : 0.0f;
            ds_[i] = n < N ? delta[(size_t)b * N + n] : 0.0f;
        }
        __pipeline_commit();
        __pipeline_wait_prior(0);
        __syncthreads();

        // P^T and dP^T [16 keys x 32 queries] of this warp on the tensor cores
        float s[4][4], dp[4][4];
        mma_nt<4>(s, ks + wk * ldk, ldk, qs + wq * ldk, ldk, dk, lane);
        mma_nt<4>(dp, vs + wk * ldv, ldv, os + wq * ldv, ldv, dv, lane);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int col = wq + j * 8 + 2 * tig + (e & 1);
                const int row = wk + g + 8 * (e >> 1);
                const float p = (n0 + col < N && key_ok[e >> 1]) ? expf(s[j][e] - ls[col]) : 0.0f;
                const float dsv = p * (dp[j][e] - ds_[col]);
                dst_kq[row * LDS + col] = dsv;
                dst_qk[col * LDS + row] = dsv;
            }
        }
        __syncthreads();

        // dK[keys rg*4 .. +4][cg .. +DR] += dS^T Q   (f32)
#pragma unroll 4
        for (int n = 0; n < TQ; ++n) {
            const float4 d4 = *reinterpret_cast<const float4*>(dst_qk + n * LDS + rg * 4);
            const float dsr[4] = {d4.x, d4.y, d4.z, d4.w};
            float qv[DR];
#pragma unroll
            for (int j = 0; j < DR; ++j) qv[j] = __bfloat162float(qs[n * ldk + cg + j]);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < DR; ++j) dk_acc[i][j] = fmaf(dsr[i], qv[j], dk_acc[i][j]);
        }
        // dQ[queries rg*4 .. +4][cg .. +DR] += dS K   (f32, atomics over key tiles)
        {
            float dq_part[4][DR];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < DR; ++j) dq_part[i][j] = 0.0f;
#pragma unroll 4
            for (int m = 0; m < TK; ++m) {
                const float4 d4 = *reinterpret_cast<const float4*>(dst_kq + m * LDS + rg * 4);
                const float dsr[4] = {d4.x, d4.y, d4.z, d4.w};
                float kv[DR];
#pragma unroll
                for (int j = 0; j < DR; ++j) kv[j] = __bfloat162float(ks[m * ldk + cg + j]);
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < DR; ++j) dq_part[i][j] = fmaf(dsr[i], kv[j], dq_part[i][j]);
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int n = n0 + rg * 4 + i;
                if (n < N) {
                    float* row = dq_acc + ((size_t)b * N + n) * dk + cg;
#pragma unroll
                    for (int j = 0; j < DR; ++j) atomicAdd(row + j, dq_part[i][j]);
                }
            }
        }
        __syncthreads();  // Q, dO and dS tiles are refilled next step
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int m = m0 + rg * 4 + i;
        if (m < M) {
            bf16* row = dk_out + ((size_t)b * M + m) * dk + cg;
#pragma unroll
            for (int j = 0; j < DR; ++j) row[j] = __float2bfloat16(dk_acc[i][j]);
        }
    }
}

template <int DVT>
cudaError_t launch_dv(const bf16* q, const bf16* k, const bf16* dO, const float* lse, bf16* dv_out,
                      int B, int N, int M, int dk, int dv, cudaStream_t stream) {
    const size_t smem = ((size_t)(TK + 2 * TQ) * (dk + PAD) + (size_t)2 * TQ * (DVT + PAD)) *
                            sizeof(bf16) +
                        2 * TQ * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dv<DVT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((M + TK - 1) / TK, dv / DVT, B);
    flash_bwd_dv<DVT><<<grid, DV_THREADS, smem, stream>>>(q, k, dO, lse, dv_out, N, M, dk, dv);
    return cudaGetLastError();
}

template <int DR>
cudaError_t launch_dkdq(const bf16* q, const bf16* k, const bf16* v, const bf16* dO,
                        const float* lse, const float* delta, float* dq_acc, bf16* dk_out, int B,
                        int N, int M, int dv, cudaStream_t stream) {
    constexpr int dk = DR * 16;
    const size_t smem = ((size_t)(TK + TQ) * (dk + PAD) + (size_t)(TK + TQ) * (dv + PAD)) *
                            sizeof(bf16) +
                        ((size_t)(TK + TQ) * LDS + 2 * TQ) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdq<DR>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((M + TK - 1) / TK, 1, B);
    flash_bwd_dkdq<DR><<<grid, DKQ_THREADS, smem, stream>>>(q, k, v, dO, lse, delta, dq_acc,
                                                             dk_out, N, M, dv);
    return cudaGetLastError();
}

}  // namespace

// q [B,N,dk], k [B,M,dk], v [B,M,dv], dO [B,N,dv] bf16; lse, delta [B,N]
// f32 (delta = rowsum(f32(dO) * O)); dq_acc [B,N,dk] f32, ZEROED by the
// caller (atomic sums); dk_out [B,M,dk], dv_out [B,M,dv] bf16. All
// contiguous and 16-byte aligned; dk in 16..128 and dv in 16..512,
// multiples of 16. Launches the two kernels on `stream` and returns the
// CUDA error code (0 on success).
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v, const void* dO,
                              const void* lse, const void* delta, void* dq_acc, void* dk_out,
                              void* dv_out, int B, int N, int M, int dk, int dv, void* stream) {
    if (B < 1 || N < 1 || M < 1 || dk % 16 || dk < 16 || dk > MAX_DK || dv % 16 || dv < 16 ||
        dv > MAX_DV)
        return (int)cudaErrorInvalidValue;
    const bf16* qq = static_cast<const bf16*>(q);
    const bf16* kk = static_cast<const bf16*>(k);
    const bf16* vv = static_cast<const bf16*>(v);
    const bf16* oo = static_cast<const bf16*>(dO);
    const float* ll = static_cast<const float*>(lse);
    const float* dd = static_cast<const float*>(delta);
    float* dq = static_cast<float*>(dq_acc);
    bf16* dkk = static_cast<bf16*>(dk_out);
    bf16* dvv = static_cast<bf16*>(dv_out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (dv % 128 == 0) err = launch_dv<128>(qq, kk, oo, ll, dvv, B, N, M, dk, dv, s);
    else if (dv % 64 == 0) err = launch_dv<64>(qq, kk, oo, ll, dvv, B, N, M, dk, dv, s);
    else if (dv % 32 == 0) err = launch_dv<32>(qq, kk, oo, ll, dvv, B, N, M, dk, dv, s);
    else err = launch_dv<16>(qq, kk, oo, ll, dvv, B, N, M, dk, dv, s);
    if (err != cudaSuccess) return (int)err;
    switch (dk / 16) {
        case 1: err = launch_dkdq<1>(qq, kk, vv, oo, ll, dd, dq, dkk, B, N, M, dv, s); break;
        case 2: err = launch_dkdq<2>(qq, kk, vv, oo, ll, dd, dq, dkk, B, N, M, dv, s); break;
        case 3: err = launch_dkdq<3>(qq, kk, vv, oo, ll, dd, dq, dkk, B, N, M, dv, s); break;
        case 4: err = launch_dkdq<4>(qq, kk, vv, oo, ll, dd, dq, dkk, B, N, M, dv, s); break;
        case 5: err = launch_dkdq<5>(qq, kk, vv, oo, ll, dd, dq, dkk, B, N, M, dv, s); break;
        case 6: err = launch_dkdq<6>(qq, kk, vv, oo, ll, dd, dq, dkk, B, N, M, dv, s); break;
        case 7: err = launch_dkdq<7>(qq, kk, vv, oo, ll, dd, dq, dkk, B, N, M, dv, s); break;
        default: err = launch_dkdq<8>(qq, kk, vv, oo, ll, dd, dq, dkk, B, N, M, dv, s); break;
    }
    return (int)err;
}

extern "C" const char* flash_attn_bwd_error(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
