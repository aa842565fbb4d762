// Fused SAGAN attention forward for Hopper (sm_90a):
//   o = softmax(q k^T) v,   lse = logsumexp(q k^T)   per image.
//
// Replaces gssd_tpu/ops/pallas/flash_attn.py _fwd_kernel (the Pallas TPU
// kernel). Same arithmetic: f32 logits with no 1/sqrt(dk) scale, f32
// row max and sum, P = exp(s - lse) normalised in f32 and THEN rounded
// to bf16, P.V with f32 accumulation, f32 output plus the row lse.
//
// What bounds it here: at the serving sites the product work
// 2*N*M*(dk+dv) is about 300-500 operations per byte of q/k/v/o, so the
// ideal kernel is tensor-core bound. The TPU kernel keeps a whole
// [TN, M] f32 logits block in VMEM; at M = 1444 that is 370 KB for 64
// rows, more than the 227 KB of shared memory a block may use. This
// kernel instead takes two passes over the keys in 64-key tiles:
//   pass 1 computes each row's max and sum of exp (online, per thread
//          over its own columns, combined across the 4 threads that
//          share a row at the end),
//   pass 2 recomputes the logits, forms normalised bf16 P and
//          accumulates P.V.
// The second QK^T costs dk/(dk+dv) = 20% extra work at dk = dv/4 and
// keeps "normalise, then round" exact, which an online softmax would not.
//
// A block owns 64 query rows (16 per warp) and up to 128 value columns,
// so the f32 accumulator stays at 64 registers a thread even at dv = 512
// (fc7 sites): wider dv is split over blockIdx.y. Products are
// mma.sync m16n8k16 bf16 with ldmatrix operands; the logits never leave
// registers, because the accumulator layout of Q.K^T is the operand
// layout P needs for P.V. K and V tiles are double-buffered with
// cp.async, so the next tile loads while this one is multiplied.
// wgmma/TMA are left for a later change. Ragged key tiles mask their
// columns to -inf (P = 0), ragged query tiles are zero-filled and never
// stored, so M = 1, 9, 25 work.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TN = 64;       // query rows per block
constexpr int TM = 64;       // keys per tile
constexpr int WARPS = 4;     // 16 query rows per warp
constexpr int THREADS = WARPS * 32;
constexpr int MAX_DK = 128;
constexpr int PAD = 8;       // bf16 padding per smem row: conflict-free ldmatrix

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
                                                int nvalid, int ld, int col0, int width) {
    const int vpr = width / 8;
    const int lds = width + PAD;
    for (int i = threadIdx.x; i < rows * vpr; i += THREADS) {
        const int r = i / vpr;
        const int c = (i - r * vpr) * 8;
        bf16* d = dst + r * lds + c;
        if (row0 + r < nvalid)
            __pipeline_memcpy_async(d, src + (size_t)(row0 + r) * ld + col0 + c, 16);
        else
            *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
}

// s[j] (8 n-tiles of 8 keys) = the warp's 16 query rows . k_tile^T.
// Accumulator layout: s[j][0..1] row g, keys j*8 + 2*tig + {0,1};
// s[j][2..3] the same keys of row g + 8 (g = lane / 4, tig = lane % 4).
__device__ __forceinline__ void tile_logits(float (&s)[TM / 8][4],
                                            const uint32_t (&qf)[MAX_DK / 16][4],
                                            const bf16* kt, int dk, int lane) {
    const int ldk = dk + PAD;
#pragma unroll
    for (int j = 0; j < TM / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
    // ldmatrix x4 over keys (j .. j+1 tiles) x dims (kk*16 + {0, 8})
    const int mi = lane >> 3, r = lane & 7;
#pragma unroll
    for (int kk = 0; kk < MAX_DK / 16; ++kk) {
        if (kk * 16 < dk) {
#pragma unroll
            for (int j = 0; j < TM / 8; j += 2) {
                uint32_t b[4];
                ldmatrix_x4(b, kt + ((j + (mi >> 1)) * 8 + r) * ldk + kk * 16 + (mi & 1) * 8);
                mma_bf16(s[j], qf[kk], b[0], b[1]);
                mma_bf16(s[j + 1], qf[kk], b[2], b[3]);
            }
        }
    }
}

template <int DVT>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int N, int M, int dk, int dv) {
    constexpr int LDV = DVT + PAD;
    extern __shared__ __align__(128) unsigned char smem[];
    const int ldk = dk + PAD;
    bf16* qs = reinterpret_cast<bf16*>(smem);  // [TN][ldk]
    bf16* ks = qs + TN * ldk;                  // [2][TM][ldk]
    bf16* vs = ks + 2 * TM * ldk;              // [2][TM][LDV]

    const int b = blockIdx.z;
    const int n0 = blockIdx.x * TN;
    const int c0 = blockIdx.y * DVT;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2, tig = lane & 3;
    const bf16* qb = q + (size_t)b * N * dk;
    const bf16* kb = k + (size_t)b * M * dk;
    const bf16* vb = v + (size_t)b * M * dv;
    const int ntiles = (M + TM - 1) / TM;

    // Q (A operand) fragments of the warp's 16 rows, kept in registers
    load_tile_async(qs, qb, n0, TN, N, dk, 0, dk);
    load_tile_async(ks, kb, 0, TM, M, dk, 0, dk);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    uint32_t qf[MAX_DK / 16][4];
    {
        const int mi = lane >> 3, r = lane & 7;
#pragma unroll
        for (int kk = 0; kk < MAX_DK / 16; ++kk)
            if (kk * 16 < dk)
                ldmatrix_x4(qf[kk], qs + (warp * 16 + (mi & 1) * 8 + r) * ldk + kk * 16 +
                                        (mi >> 1) * 8);
    }

    // pass 1: per-thread max / sum of exp over its own columns of rows
    // g (h = 0) and g + 8 (h = 1)
    float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.0f, 0.0f};
    for (int t = 0; t < ntiles; ++t) {
        if (t + 1 < ntiles) load_tile_async(ks + ((t + 1) & 1) * TM * ldk, kb, (t + 1) * TM, TM, M, dk, 0, dk);
        __pipeline_commit();
        __pipeline_wait_prior(1);
        __syncthreads();
        float s[TM / 8][4];
        tile_logits(s, qf, ks + (t & 1) * TM * ldk, dk, lane);
        const int m0 = t * TM;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            float mx = -INFINITY;
#pragma unroll
            for (int j = 0; j < TM / 8; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e)
                    if (m0 + j * 8 + 2 * tig + e < M) mx = fmaxf(mx, s[j][2 * h + e]);
            const float m_new = fmaxf(m_r[h], mx);
            if (m_new == -INFINITY) continue;  // no valid column of this row yet
            float sum = 0.0f;
#pragma unroll
            for (int j = 0; j < TM / 8; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e)
                    if (m0 + j * 8 + 2 * tig + e < M) sum += expf(s[j][2 * h + e] - m_new);
            l_r[h] = l_r[h] * expf(m_r[h] - m_new) + sum;
            m_r[h] = m_new;
        }
        __syncthreads();  // this K buffer is refilled two tiles on
    }
    float row_lse[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        float m = m_r[h];
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        float l = l_r[h] * expf(m_r[h] - m);  // 0 for a thread with no valid column
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        row_lse[h] = m + logf(l);
    }
    if (blockIdx.y == 0 && tig == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int n = n0 + warp * 16 + g + 8 * h;
            if (n < N) lse[(size_t)b * N + n] = row_lse[h];
        }
    }

    // pass 2: normalised bf16 P straight from the logit registers, P.V
    float acc[DVT / 8][4];
#pragma unroll
    for (int f = 0; f < DVT / 8; ++f) acc[f][0] = acc[f][1] = acc[f][2] = acc[f][3] = 0.0f;
    load_tile_async(ks, kb, 0, TM, M, dk, 0, dk);
    load_tile_async(vs, vb, 0, TM, M, dv, c0, DVT);
    __pipeline_commit();
    for (int t = 0; t < ntiles; ++t) {
        if (t + 1 < ntiles) {
            const int nb = (t + 1) & 1;
            load_tile_async(ks + nb * TM * ldk, kb, (t + 1) * TM, TM, M, dk, 0, dk);
            load_tile_async(vs + nb * TM * LDV, vb, (t + 1) * TM, TM, M, dv, c0, DVT);
        }
        __pipeline_commit();
        __pipeline_wait_prior(1);
        __syncthreads();
        float s[TM / 8][4];
        tile_logits(s, qf, ks + (t & 1) * TM * ldk, dk, lane);
        const bf16* vt = vs + (t & 1) * TM * LDV;
        const int m0 = t * TM;
        const int mi = lane >> 3, r = lane & 7;
#pragma unroll
        for (int kk = 0; kk < TM / 16; ++kk) {
            // A operand of keys kk*16 .. +15 = logit tiles 2kk and 2kk+1
            uint32_t pa[4];
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int j = 2 * kk + half;
                const int col = m0 + j * 8 + 2 * tig;
                float p[4];
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    p[e] = (col + (e & 1) < M) ? expf(s[j][e] - row_lse[e >> 1]) : 0.0f;
                pa[2 * half] = pack_bf16(p[0], p[1]);      // row g
                pa[2 * half + 1] = pack_bf16(p[2], p[3]);  // row g + 8
            }
#pragma unroll
            for (int f = 0; f < DVT / 8; f += 2) {
                // B operands of value-column tiles f, f+1 from row-major V
                uint32_t bv[4];
                ldmatrix_x4_trans(bv, vt + (kk * 16 + (mi & 1) * 8 + r) * LDV + (f + (mi >> 1)) * 8);
                mma_bf16(acc[f], pa, bv[0], bv[1]);
                mma_bf16(acc[f + 1], pa, bv[2], bv[3]);
            }
        }
        __syncthreads();  // this K/V buffer is refilled two tiles on
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int n = n0 + warp * 16 + g + 8 * h;
        if (n < N) {
            float* orow = o + ((size_t)b * N + n) * dv + c0 + 2 * tig;
#pragma unroll
            for (int f = 0; f < DVT / 8; ++f)
                *reinterpret_cast<float2*>(orow + f * 8) = make_float2(acc[f][2 * h], acc[f][2 * h + 1]);
        }
    }
}

template <int DVT>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, float* o, float* lse,
                   int B, int N, int M, int dk, int dv, cudaStream_t stream) {
    const size_t smem = ((size_t)(TN + 2 * TM) * (dk + PAD) + (size_t)2 * TM * (DVT + PAD)) *
                        sizeof(bf16);
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<DVT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((N + TN - 1) / TN, dv / DVT, B);
    flash_fwd_kernel<DVT><<<grid, THREADS, smem, stream>>>(q, k, v, o, lse, N, M, dk, dv);
    return cudaGetLastError();
}

}  // namespace

// q [B,N,dk], k [B,M,dk], v [B,M,dv] bf16; o [B,N,dv] f32; lse [B,N] f32.
// All contiguous and 16-byte aligned; dk, dv multiples of 16, dk <= 128.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                              int B, int N, int M, int dk, int dv, void* stream) {
    if (B < 1 || N < 1 || M < 1 || dk % 16 || dk > MAX_DK || dk < 16 || dv % 16 || dv < 16)
        return (int)cudaErrorInvalidValue;
    const bf16* qq = static_cast<const bf16*>(q);
    const bf16* kk = static_cast<const bf16*>(k);
    const bf16* vv = static_cast<const bf16*>(v);
    float* oo = static_cast<float*>(o);
    float* ll = static_cast<float*>(lse);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (dv % 128 == 0) err = launch<128>(qq, kk, vv, oo, ll, B, N, M, dk, dv, s);
    else if (dv % 64 == 0) err = launch<64>(qq, kk, vv, oo, ll, B, N, M, dk, dv, s);
    else if (dv % 32 == 0) err = launch<32>(qq, kk, vv, oo, ll, B, N, M, dk, dv, s);
    else err = launch<16>(qq, kk, vv, oo, ll, B, N, M, dk, dv, s);
    return (int)err;
}

extern "C" const char* flash_attn_fwd_error(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
