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
// runs three kernels on one stream:
//   1. gemm_bf16 (dU): per group, [B*P x Cout] . [Cout x K*Cg] on the
//      tensor cores (mma.sync, 128 x 128 tiles, cp.async double
//      buffer), written as bf16 to a scratch [B*P, G, K, Cg];
//   2. deform_bwd_corners: one warp per (b, p, g, k) gathers its 4
//      corners of x, forms dS, dm, dpy, dpx and the bf16 sample (to a
//      second scratch [B*P, G, K, Cg]) and adds its dx terms with f32
//      atomicAdd into an f32 [B, H, W, C] buffer: the order of those
//      sums is not deterministic;
//   3. gemm_bf16 (dW): per group, [K*Cg x B*P] . [B*P x Cout]: each block
//      owns a 128 x 128 tile of dW and walks all pixels, so dW needs no
//      atomics.
// The scratch buffers cost 2 * B*P*G*K*Cg bf16 (1.7 GB at the training
// site) and one extra write and read of each.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int PAD = 8;
constexpr int GEMM_THREADS = 256;  // 8 warps: 2 (m) x 4 (n), 64 x 32 each

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

__device__ __forceinline__ void atomic_add2(float* p, float a, float b) {
#if (__CUDACC_VER_MAJOR__ > 12 || (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 4))
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(a, b));  // sm_90 vector atomic
#else
    atomicAdd(p, a);
    atomicAdd(p + 1, b);
#endif
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
                   float* __restrict__ dx,          // [B, H, W, C] f32, zeroed
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
    long base[4];  // element offset of the corner's group channels in x / dx
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
            atomic_add2(dx + base[q] + c, sw[q] * u0, sw[q] * u1);
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
// dpx, dm [B,P,G,K] f32; dx_acc [B,H,W,C] f32, ZEROED by the caller;
// dwg [G,K,C/G,Cout] bf16. Scratch: du, samp [B,P,G,K,C/G] bf16. All
// contiguous; C/G even; x, dx_acc 8-byte aligned. Returns the CUDA error
// code of the three launches (0 on success).
extern "C" int deform_conv_bwd(const void* x, const void* py, const void* px, const void* m,
                               const void* wg, const void* gb, void* dpy, void* dpx, void* dm,
                               void* dx_acc, void* dwg, void* du, void* samp, int B, int H, int W,
                               int C, int G, int K, int P, int Cout, void* stream) {
    if (B < 1 || H < 1 || W < 1 || G < 1 || C % G || (C / G) % 2 || K < 1 || P < 1 || Cout < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int Cg = C / G;
    const long KC = (long)K * Cg;
    const long BP = (long)B * P;
    if (BP > 65535L * BM) return (int)cudaErrorInvalidValue;
    const bf16* wgp = static_cast<const bf16*>(wg);
    const bf16* gbp = static_cast<const bf16*>(gb);
    bf16* dup = static_cast<bf16*>(du);
    bf16* sp = static_cast<bf16*>(samp);
    // 1. dU[bp, g, kc] = sum_n gb[bp, n] wg[g, kc, n]
    cudaError_t err = gemm<false, false>(gbp, wgp, dup, (int)BP, (int)KC, Cout, Cout, Cout, G * KC,
                                         0, KC * Cout, KC, G, s);
    if (err != cudaSuccess) return (int)err;
    // 2. the corner terms, dx and the bf16 samples
    const long total = BP * G * K;
    const long blocks = (total + CORNER_THREADS / 32 - 1) / (CORNER_THREADS / 32);
    deform_bwd_corners<<<(unsigned)blocks, CORNER_THREADS, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const float*>(py), static_cast<const float*>(px),
        static_cast<const float*>(m), dup, static_cast<float*>(dpy), static_cast<float*>(dpx),
        static_cast<float*>(dm), static_cast<float*>(dx_acc), sp, total, H, W, C, G, K, P);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    // 3. dW[g, kc, n] = sum_bp samp[bp, g, kc] gb[bp, n]
    err = gemm<true, true>(sp, gbp, static_cast<bf16*>(dwg), (int)KC, Cout, (int)BP, G * KC, Cout,
                           Cout, KC, 0, KC * Cout, G, s);
    return (int)err;
}

extern "C" const char* deform_conv_bwd_error(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
