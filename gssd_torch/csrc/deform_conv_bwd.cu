// Modulated deformable convolution (DCNv2) backward for Hopper (sm_90a).
//
// Replaces gssd_tpu/ops/pallas/deform_hat.py _bwd_kernel /
// _bwd_kernel_allwin / _bwd_kernel_stacked (the Pallas TPU kernels of
// hat_bwd; their window tiers are TPU scheduling and compute the same
// function). Same arithmetic as hat_bwd, per pixel p, group g, tap k:
//   gb     = bf16(g)                                          [P, Cout]
//   dU_k   = bf16( gb . W_k^T )            (f32 sums)         [P, Cg]
//   for each of the 4 corners q of (py, px) inside the map, with f32
//   hats ay = max(0, 1 - |py - qy|), bx = max(0, 1 - |px - qx|):
//     dS_q = <dU_k[p], x[q]>                                   (f32)
//     dm  += dS_q * ay * bx
//     dpy += m * dS_q * day * bx,  dpx += m * dS_q * ay * dbx
//            (day, dbx = +1 at floor + 1, -1 at floor, also at integer
//             coordinates: the 4-corner subgradient)
//     w_q  = bf16(ay * bx * m)
//     dx[q] += w_q * dU_k[p]                                   (f32)
//   samp   = bf16( sum_q w_q * x[q] )
//   dW_k  += samp^T . gb                   (f32 sums over B*P)
// dx and dW are rounded to bf16 at the end. The corner weights w_q are
// rounded to bf16 here because the JAX backward rounds them; the port's
// forward kernel keeps them in f32 (ROADMAP Queue C), so this backward
// follows the JAX backward, not the port's own forward.
//
// What bounds it here: dU and dW are each 2*B*P*K*C*Cout operations
// (4.4e11 at batch 32, 38x38, C 1024, Cout 512), the corner terms ~3e9:
// the ideal kernel is tensor-core bound. The TPU kernel avoids gathers
// with a dense hat matrix over the map; a GPU gathers well. One call
// runs these kernels on one stream:
//   1. gemm_bf16 (dU): per group, [B*P x Cout] . [Cout x K*Cg] on the
//      tensor cores (mma.sync, 128 x 128 tiles, cp.async double
//      buffer), written as bf16 to a scratch [B*P, G, K, Cg];
//   2. deform_bwd_corners: one warp per (b, p, g, k) gathers its 4
//      corners of x, forms dS, dm, dpy, dpx and the bf16 sample (to a
//      second scratch [B*P, G, K, Cg]);
//   3. dx as a gather, so that each dx element is one thread's f32 sum
//      in one fixed order, the same on every run (a scatter with atomics
//      would add in the order the blocks happen to run):
//      a. bucket_count: every sample (b, p, g, k) with a corner inside
//         the map is counted (integer atomics) in the bucket of its
//         top-left corner cell (floor(py), floor(px)) in [-1, H-1] x
//         [-1, W-1] of its (b, g); bucket_scan turns the counts into
//         offsets (a block per (b, g)); bucket_fill writes each sample's
//         flat index into its bucket; bucket_sort sorts each bucket by
//         flat index, so that the order no longer depends on which
//         thread placed which entry (insertion sort: ~K entries a bucket;
//         a bucket holding n samples costs n^2 / 2 steps of its thread);
//      b. dx_gather: one warp per (b, qy, qx, g), lanes over channel
//         pairs, visits the cells whose samples can have q as a corner in
//         the order (qy, qx), (qy, qx - 1), (qy - 1, qx), (qy - 1, qx - 1)
//         and each cell's samples by flat index, and adds w_q * dU with
//         the same bf16 w_q = bf16(ay * bx * m) as the corner terms, then
//         rounds the f32 sum once to bf16. Every term w_q * dU is exact
//         in f32 (two bf16 factors).
//   4. gemm_bf16 (dW): per group, [K*Cg x B*P] . [B*P x Cout]: each block
//      owns a 128 x 128 tile of dW and walks all pixels, so dW needs no
//      atomics.
// The scratch buffers cost 2 * B*P*G*K*Cg bf16 (1.7 GB at the training
// site) and one extra write and read of each; the buckets 4 bytes a
// sample and 8 a cell.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace {

using namespace mma16816;
typedef __nv_bfloat16 bf16;

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int PAD = 8;
constexpr int GEMM_THREADS = 256;  // 8 warps: 2 (m) x 4 (n), 64 x 32 each

// rows [r0, r0 + rows) x cols [c0, c0 + cols) of a row-major matrix with
// nr valid rows, nc valid columns and leading dimension ld into smem
// [rows][lds]; out-of-range elements are zero. 16-byte cp.async where
// `vec` (ld and the base are multiples of 8 elements) and the 8-element
// chunk is whole, element loads otherwise.
__device__ __forceinline__ void load_block(bf16* dst, int lds, const bf16* src, long ld, int r0,
                                           int rows, int nr, int c0, int cols, int nc, bool vec) {
    const int vpr = cols / 8;
    for (int i = threadIdx.x; i < rows * vpr; i += GEMM_THREADS) {
        const int r = i / vpr;
        const int c = (i - r * vpr) * 8;
        bf16* d = dst + r * lds + c;
        const int gr = r0 + r, gc = c0 + c;
        if (gr < nr && vec && gc + 8 <= nc) {
            __pipeline_memcpy_async(d, src + (size_t)gr * ld + gc, 16);
        } else {
#pragma unroll
            for (int e = 0; e < 8; ++e)
                d[e] = (gr < nr && gc + e < nc) ? src[(size_t)gr * ld + gc + e]
                                                : __float2bfloat16(0.0f);
        }
    }
}

// C[m, n] = sum_k A(m, k) B(k, n), bf16 in, f32 sums, bf16 out; batched
// over blockIdx.z with element offsets a_z, b_z, c_z. A(m, k) is
// A[k * lda + m] when A_KM, else A[m * lda + k]; B(k, n) is B[k * ldb + n]
// when B_KN, else B[n * ldb + k]; C is row-major with ldc.
template <bool A_KM, bool B_KN>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_bf16(const bf16* __restrict__ A, const bf16* __restrict__ B, bf16* __restrict__ C, int M,
          int N, int Kd, long lda, long ldb, long ldc, long a_z, long b_z, long c_z, int vec_a,
          int vec_b) {
    constexpr int LDA_S = A_KM ? BM + PAD : BK + PAD;
    constexpr int LDB_S = B_KN ? BN + PAD : BK + PAD;
    constexpr int A_TILE = A_KM ? BK * LDA_S : BM * LDA_S;
    constexpr int B_TILE = B_KN ? BK * LDB_S : BN * LDB_S;
    __shared__ __align__(128) bf16 As[2][A_TILE];
    __shared__ __align__(128) bf16 Bs[2][B_TILE];

    A += blockIdx.z * a_z;
    B += blockIdx.z * b_z;
    C += blockIdx.z * c_z;
    const int m0 = blockIdx.y * BM;
    const int n0 = blockIdx.x * BN;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2, tig = lane & 3;
    const int mi = lane >> 3, r = lane & 7;
    const int wm = (warp / 4) * 64;
    const int wn = (warp % 4) * 32;

    auto load = [&](int k0, int buf) {
        if (A_KM) load_block(As[buf], LDA_S, A, lda, k0, BK, Kd, m0, BM, M, vec_a);
        else load_block(As[buf], LDA_S, A, lda, m0, BM, M, k0, BK, Kd, vec_a);
        if (B_KN) load_block(Bs[buf], LDB_S, B, ldb, k0, BK, Kd, n0, BN, N, vec_b);
        else load_block(Bs[buf], LDB_S, B, ldb, n0, BN, N, k0, BK, Kd, vec_b);
    };

    float acc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;

    const int nk = (Kd + BK - 1) / BK;
    load(0, 0);
    __pipeline_commit();
    for (int t = 0; t < nk; ++t) {
        const int buf = t & 1;
        if (t + 1 < nk) load((t + 1) * BK, buf ^ 1);
        __pipeline_commit();
        __pipeline_wait_prior(1);
        __syncthreads();
        const bf16* as = As[buf];
        const bf16* bs = Bs[buf];
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
            uint32_t af[4][4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                if (A_KM)
                    ldmatrix_x4_trans(af[i], as + (kk + (mi >> 1) * 8 + r) * LDA_S + wm + i * 16 +
                                                 (mi & 1) * 8);
                else
                    ldmatrix_x4(af[i], as + (wm + i * 16 + (mi & 1) * 8 + r) * LDA_S + kk +
                                           (mi >> 1) * 8);
            }
#pragma unroll
            for (int j = 0; j < 4; j += 2) {
                uint32_t bb[4];
                if (B_KN)
                    ldmatrix_x4_trans(bb, bs + (kk + (mi & 1) * 8 + r) * LDB_S + wn +
                                              (j + (mi >> 1)) * 8);
                else
                    ldmatrix_x4(bb, bs + (wn + (j + (mi >> 1)) * 8 + r) * LDB_S + kk +
                                        (mi & 1) * 8);
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    mma_bf16(acc[i][j], af[i], bb[0], bb[1]);
                    mma_bf16(acc[i][j + 1], af[i], bb[2], bb[3]);
                }
            }
        }
        __syncthreads();  // this buffer is refilled two steps on
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int m = m0 + wm + i * 16 + g + 8 * h;
            if (m >= M) continue;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int n = n0 + wn + j * 8 + 2 * tig + e;
                    if (n < N) C[(size_t)m * ldc + n] = __float2bfloat16(acc[i][j][2 * h + e]);
                }
            }
        }
    }
}

constexpr int CORNER_THREADS = 256;

// one warp per (b, p, g, k) = flat index wi of py/px/m [B, P, G, K];
// lanes own channel pairs c = 2 * lane + 64 * i of the group
__global__ void __launch_bounds__(CORNER_THREADS)
deform_bwd_corners(const bf16* __restrict__ x,      // [B, H, W, C]
                   const float* __restrict__ py,    // [B, P, G, K]
                   const float* __restrict__ px,
                   const float* __restrict__ mk,
                   const bf16* __restrict__ dU,     // [B, P, G, K, Cg]
                   float* __restrict__ dpy,         // [B, P, G, K]
                   float* __restrict__ dpx,
                   float* __restrict__ dm,
                   bf16* __restrict__ samp,         // [B, P, G, K, Cg]
                   long total, int H, int W, int C, int G, int K, int P) {
    const long wi = (long)blockIdx.x * (CORNER_THREADS / 32) + threadIdx.x / 32;
    if (wi >= total) return;
    const int lane = threadIdx.x % 32;
    const int Cg = C / G;
    const int g = (int)((wi / K) % G);
    const long bp = wi / ((long)G * K);
    const int b = (int)(bp / P);
    const float fy = py[wi], fx = px[wi], m = mk[wi];
    const float y0 = floorf(fy), x0 = floorf(fx);

    float s0[4], sw[4], ay[4], bx[4];
    long base[4];  // element offset of the corner's group channels in x
    bool in[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const float qy = y0 + (float)(q >> 1);
        const float qx = x0 + (float)(q & 1);
        ay[q] = fmaxf(0.0f, 1.0f - fabsf(fy - qy));
        bx[q] = fmaxf(0.0f, 1.0f - fabsf(fx - qx));
        in[q] = qy >= 0.0f && qy < (float)H && qx >= 0.0f && qx < (float)W;
        s0[q] = ay[q] * bx[q];
        sw[q] = in[q] ? __bfloat162float(__float2bfloat16(s0[q] * m)) : 0.0f;
        base[q] = in[q] ? (((long)b * H + (long)qy) * W + (long)qx) * C + (long)g * Cg : 0;
    }

    float dS[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const bf16* du = dU + wi * Cg;
    bf16* so = samp + wi * Cg;
    for (int c = 2 * lane; c < Cg; c += 64) {
        const __nv_bfloat162 u2 = *reinterpret_cast<const __nv_bfloat162*>(du + c);
        const float u0 = __low2float(u2), u1 = __high2float(u2);
        float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            if (!in[q]) continue;
            const __nv_bfloat162 x2 = *reinterpret_cast<const __nv_bfloat162*>(x + base[q] + c);
            const float v0 = __low2float(x2), v1 = __high2float(x2);
            dS[q] = fmaf(u0, v0, fmaf(u1, v1, dS[q]));
            a0 = fmaf(sw[q], v0, a0);
            a1 = fmaf(sw[q], v1, a1);
        }
        *reinterpret_cast<__nv_bfloat162*>(so + c) = __floats2bfloat162_rn(a0, a1);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) dS[q] += __shfl_xor_sync(0xffffffffu, dS[q], o);
    if (lane == 0) {
        float sm = 0.0f, sy = 0.0f, sx = 0.0f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            if (!in[q]) continue;
            const float mdS = dS[q] * m;
            const float day = (q >> 1) ? 1.0f : -1.0f;
            const float dbx = (q & 1) ? 1.0f : -1.0f;
            sm += dS[q] * s0[q];
            sy += mdS * day * bx[q];
            sx += mdS * ay[q] * dbx;
        }
        dm[wi] = sm;
        dpy[wi] = sy;
        dpx[wi] = sx;
    }
}

// The bucket of sample wi (flat index of py/px/m [B, P, G, K]): its
// top-left corner cell (floor(py), floor(px)) in [-1, H-1] x [-1, W-1]
// of its (b, g), or -1 where no corner lies inside the map (NaN too).
__device__ __forceinline__ int bucket_of(const float* __restrict__ py,
                                         const float* __restrict__ px, long wi, int H, int W,
                                         int G, int K, int P) {
    const float y0 = floorf(py[wi]), x0 = floorf(px[wi]);
    if (!(y0 >= -1.0f && y0 <= (float)(H - 1) && x0 >= -1.0f && x0 <= (float)(W - 1)))
        return -1;
    const int g = (int)((wi / K) % G);
    const int b = (int)(wi / ((long)G * K * P));
    return (((b * G + g) * (H + 1)) + (int)y0 + 1) * (W + 1) + (int)x0 + 1;
}

// counts per cell, and per (b, g) the samples with a cell in seg_total
__global__ void bucket_count(const float* __restrict__ py, const float* __restrict__ px,
                             int* __restrict__ count, int* __restrict__ seg_total, long total,
                             int H, int W, int G, int K, int P) {
    const long wi = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (wi >= total) return;
    const int c = bucket_of(py, px, wi, H, W, G, K, P);
    if (c >= 0) atomicAdd(count + c, 1);
    // one add per (b, g) a warp: neighbouring samples share their (b, g)
    const int seg = c >= 0 ? c / ((H + 1) * (W + 1)) : -1;
    const unsigned peers = __match_any_sync(__activemask(), seg);
    if (seg >= 0 && __ffs(peers) - 1 == (int)(threadIdx.x % 32))
        atomicAdd(seg_total + seg, __popc(peers));
}

constexpr int SCAN_THREADS = 512;

// One block per (b, g): offset[i] = sum of count[j < i] over the cells of
// that (b, g) and all before it (the earlier ones through seg_total);
// offset[nb] = the sum of all. count is left zeroed, as bucket_fill's
// cursors.
__global__ void __launch_bounds__(SCAN_THREADS)
bucket_scan(int* __restrict__ count, const int* __restrict__ seg_total, int* __restrict__ offset,
            int cells) {
    __shared__ int sums[SCAN_THREADS];
    const int t = threadIdx.x, seg = blockIdx.x;
    int base = 0;
    for (int s = t; s < seg; s += SCAN_THREADS) base += seg_total[s];
    sums[t] = base;
    __syncthreads();
    for (int d = SCAN_THREADS / 2; d > 0; d >>= 1) {  // the block's sum of base
        if (t < d) sums[t] += sums[t + d];
        __syncthreads();
    }
    base = sums[0];
    __syncthreads();
    int* cnt = count + (long)seg * cells;
    int* off = offset + (long)seg * cells;
    const int chunk = (cells + SCAN_THREADS - 1) / SCAN_THREADS;
    const int lo = min(cells, t * chunk), hi = min(cells, lo + chunk);
    int s = 0;
    for (int i = lo; i < hi; ++i) s += cnt[i];
    sums[t] = s;
    __syncthreads();
    for (int d = 1; d < SCAN_THREADS; d <<= 1) {  // inclusive scan of the chunk sums
        const int v = t >= d ? sums[t - d] : 0;
        __syncthreads();
        sums[t] += v;
        __syncthreads();
    }
    int run = base + sums[t] - s;
    for (int i = lo; i < hi; ++i) {
        off[i] = run;
        run += cnt[i];
        cnt[i] = 0;
    }
    if (seg == gridDim.x - 1 && t == SCAN_THREADS - 1) off[cells] = base + sums[t];
}

__global__ void bucket_fill(const float* __restrict__ py, const float* __restrict__ px,
                            const int* __restrict__ offset, int* __restrict__ cursor,
                            int* __restrict__ entries, long total, int H, int W, int G, int K,
                            int P) {
    const long wi = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (wi >= total) return;
    const int c = bucket_of(py, px, wi, H, W, G, K, P);
    if (c >= 0) entries[offset[c] + atomicAdd(cursor + c, 1)] = (int)wi;
}

__global__ void bucket_sort(const int* __restrict__ offset, int* __restrict__ entries, int nb) {
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= nb) return;
    int* e = entries + offset[c];
    const int n = offset[c + 1] - offset[c];
    for (int i = 1; i < n; ++i) {
        const int v = e[i];
        int j = i - 1;
        while (j >= 0 && e[j] > v) {
            e[j + 1] = e[j];
            --j;
        }
        e[j + 1] = v;
    }
}

constexpr int GATHER_THREADS = 256;
constexpr int MAX_PAIR_STEPS = 8;  // C/G <= 64 * MAX_PAIR_STEPS

// one warp per (b, qy, qx, g); lane pairs c = 2 * lane + 64 * i
__global__ void __launch_bounds__(GATHER_THREADS)
dx_gather(const float* __restrict__ py, const float* __restrict__ px,
          const float* __restrict__ mk, const bf16* __restrict__ dU,  // [B, P, G, K, Cg]
          const int* __restrict__ offset, const int* __restrict__ entries,
          bf16* __restrict__ dx,  // [B, H, W, C]
          int B, int H, int W, int C, int G) {
    const long wid = (long)blockIdx.x * (GATHER_THREADS / 32) + threadIdx.x / 32;
    if (wid >= (long)B * H * W * G) return;
    const int lane = threadIdx.x % 32;
    const int Cg = C / G;
    const int g = (int)(wid % G);
    const long pix = wid / G;  // (b * H + qy) * W + qx
    const int qx = (int)(pix % W);
    const int qy = (int)((pix / W) % H);
    const int b = (int)(pix / ((long)H * W));
    const int steps = (Cg + 63) / 64;

    float acc[MAX_PAIR_STEPS][2];
#pragma unroll
    for (int i = 0; i < MAX_PAIR_STEPS; ++i) acc[i][0] = acc[i][1] = 0.0f;

#pragma unroll 1
    for (int q = 0; q < 4; ++q) {
        const int dy = q >> 1, dxx = q & 1;  // q is corner (dy, dxx) of the cell's samples
        const int cell = ((b * G + g) * (H + 1) + qy - dy + 1) * (W + 1) + qx - dxx + 1;
        const int e0 = offset[cell], n = offset[cell + 1] - e0;
        for (int j0 = 0; j0 < n; j0 += 32) {
            // each lane fetches one entry and its corner weight
            int wi_l = 0;
            float sw_l = 0.0f;
            if (j0 + lane < n) {
                wi_l = entries[e0 + j0 + lane];
                const float fy = py[wi_l], fx = px[wi_l], m = mk[wi_l];
                const float cy = floorf(fy) + (float)dy;
                const float cx = floorf(fx) + (float)dxx;
                const float ay = fmaxf(0.0f, 1.0f - fabsf(fy - cy));
                const float bx = fmaxf(0.0f, 1.0f - fabsf(fx - cx));
                sw_l = __bfloat162float(__float2bfloat16(ay * bx * m));
            }
            const int cnt = min(32, n - j0);
#pragma unroll 4
            for (int j = 0; j < cnt; ++j) {
                const int wi = __shfl_sync(0xffffffffu, wi_l, j);
                const float sw = __shfl_sync(0xffffffffu, sw_l, j);
                const bf16* du = dU + (long)wi * Cg;
#pragma unroll
                for (int i = 0; i < MAX_PAIR_STEPS; ++i) {
                    const int c = 2 * lane + 64 * i;
                    if (i < steps && c < Cg) {
                        const __nv_bfloat162 u2 = *reinterpret_cast<const __nv_bfloat162*>(du + c);
                        acc[i][0] = __fadd_rn(acc[i][0], __fmul_rn(sw, __low2float(u2)));
                        acc[i][1] = __fadd_rn(acc[i][1], __fmul_rn(sw, __high2float(u2)));
                    }
                }
            }
        }
    }
    bf16* out = dx + pix * C + (long)g * Cg;
#pragma unroll
    for (int i = 0; i < MAX_PAIR_STEPS; ++i) {
        const int c = 2 * lane + 64 * i;
        if (i < steps && c < Cg)
            *reinterpret_cast<__nv_bfloat162*>(out + c) = __floats2bfloat162_rn(acc[i][0], acc[i][1]);
    }
}

template <bool A_KM, bool B_KN>
cudaError_t gemm(const bf16* A, const bf16* B, bf16* C, int M, int N, int Kd, long lda, long ldb,
                 long ldc, long a_z, long b_z, long c_z, int batch, cudaStream_t stream) {
    auto aligned = [](const void* p, long ld, long z) {
        return (reinterpret_cast<uintptr_t>(p) % 16 == 0) && ld % 8 == 0 && z % 8 == 0;
    };
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
    gemm_bf16<A_KM, B_KN><<<grid, GEMM_THREADS, 0, stream>>>(
        A, B, C, M, N, Kd, lda, ldb, ldc, a_z, b_z, c_z, aligned(A, lda, a_z), aligned(B, ldb, b_z));
    return cudaGetLastError();
}

}  // namespace

// x [B,H,W,C] bf16; py, px, m [B,P,G,K] f32; wg [G,K,C/G,Cout] bf16; gb
// [B,P,Cout] bf16 (the output gradient rounded to bf16). Outputs: dpy,
// dpx, dm [B,P,G,K] f32; dx [B,H,W,C] bf16; dwg [G,K,C/G,Cout] bf16.
// Scratch: du, samp [B,P,G,K,C/G] bf16; buckets int32 of
// 2 * B*G*(H+1)*(W+1) + 1 + B*G + B*P*G*K elements. All contiguous; C/G even
// and <= 512; x, dx 4-byte aligned. Returns the CUDA error code of the
// launches (0 on success).
extern "C" int deform_conv_bwd(const void* x, const void* py, const void* px, const void* m,
                               const void* wg, const void* gb, void* dpy, void* dpx, void* dm,
                               void* dx, void* dwg, void* du, void* samp, void* buckets, int B,
                               int H, int W, int C, int G, int K, int P, int Cout, void* stream) {
    if (B < 1 || H < 1 || W < 1 || G < 1 || C % G || (C / G) % 2 || C / G > 64 * MAX_PAIR_STEPS ||
        K < 1 || P < 1 || Cout < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int Cg = C / G;
    const long KC = (long)K * Cg;
    const long BP = (long)B * P;
    const long total = BP * G * K;
    const long nb = (long)B * G * (H + 1) * (W + 1);
    if (BP > 65535L * BM || total > 0x7fffffffL || nb + 1 > 0x7fffffffL)
        return (int)cudaErrorInvalidValue;
    const bf16* wgp = static_cast<const bf16*>(wg);
    const bf16* gbp = static_cast<const bf16*>(gb);
    const float* pyp = static_cast<const float*>(py);
    const float* pxp = static_cast<const float*>(px);
    const float* mp = static_cast<const float*>(m);
    bf16* dup = static_cast<bf16*>(du);
    bf16* sp = static_cast<bf16*>(samp);
    int* count = static_cast<int*>(buckets);
    int* seg_total = count + nb;
    int* offset = seg_total + (long)B * G;
    int* entries = offset + nb + 1;
    // 1. dU[bp, g, kc] = sum_n gb[bp, n] wg[g, kc, n]
    cudaError_t err = gemm<false, false>(gbp, wgp, dup, (int)BP, (int)KC, Cout, Cout, Cout, G * KC,
                                         0, KC * Cout, KC, G, s);
    if (err != cudaSuccess) return (int)err;
    // 2. the corner terms and the bf16 samples
    const long blocks = (total + CORNER_THREADS / 32 - 1) / (CORNER_THREADS / 32);
    deform_bwd_corners<<<(unsigned)blocks, CORNER_THREADS, 0, s>>>(
        static_cast<const bf16*>(x), pyp, pxp, mp, dup, static_cast<float*>(dpy),
        static_cast<float*>(dpx), static_cast<float*>(dm), sp, total, H, W, C, G, K, P);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    // 3. dx: the samples bucketed by corner cell, then gathered per element
    err = cudaMemsetAsync(count, 0, (nb + (long)B * G) * sizeof(int), s);
    if (err != cudaSuccess) return (int)err;
    const unsigned sample_blocks = (unsigned)((total + 255) / 256);
    bucket_count<<<sample_blocks, 256, 0, s>>>(pyp, pxp, count, seg_total, total, H, W, G, K, P);
    bucket_scan<<<B * G, SCAN_THREADS, 0, s>>>(count, seg_total, offset, (H + 1) * (W + 1));
    bucket_fill<<<sample_blocks, 256, 0, s>>>(pyp, pxp, offset, count, entries, total, H, W, G,
                                              K, P);
    bucket_sort<<<(unsigned)((nb + 255) / 256), 256, 0, s>>>(offset, entries, (int)nb);
    const long warps = (long)B * H * W * G;
    dx_gather<<<(unsigned)((warps + GATHER_THREADS / 32 - 1) / (GATHER_THREADS / 32)),
                GATHER_THREADS, 0, s>>>(pyp, pxp, mp, dup, offset, entries,
                                        static_cast<bf16*>(dx), B, H, W, C, G);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    // 4. dW[g, kc, n] = sum_bp samp[bp, g, kc] gb[bp, n]
    err = gemm<true, true>(sp, gbp, static_cast<bf16*>(dwg), (int)KC, Cout, (int)BP, G * KC, Cout,
                           Cout, KC, 0, KC * Cout, G, s);
    return (int)err;
}

extern "C" const char* deform_conv_bwd_error(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
