// Separable deformable sampling, gradients of the hat matrices, for
// Hopper (sm_90a):
//
//   dA[n, p, qy] = sum_{qx, c} bf16(B[n, p, qx] * g[n, p, c]) * x[n, qy, qx, c]
//   dB[n, p, qx] = sum_{qy, c} bf16(A[n, p, qy] * g[n, p, c]) * x[n, qy, qx, c]
//
// n runs over (image, deformable group); x [n, H, W, Cg], g [n, P, Cg], A
// [n, P, H], B [n, P, W] are bf16, dA and dB f32. Replaces
// gssd_tpu/ops/pallas/deform_sample.py _dab_kernel (the backward of
// abx_sample for dcn_impl='pallas') with its roundings: E = B * g and F =
// A * g formed in f32 from the bf16 inputs and rounded to bf16, products
// with bf16 x accumulated in f32.
//
// What bounds it here: two products of 2 * n * P * H * W * Cg operations
// each (0.27 TFLOP at batch 32, 38x38, Cg 256) with bf16 operands, so the
// ideal kernel is tensor-core bound (~0.28 ms on an H100). The TPU kernel
// forms E and F as whole [TP, W * Cg] and [TP, H * Cg] blocks in VMEM.
// Here neither is ever stored: each is one GEMM, [P x (r, c)] . [(r, c) x
// q], whose A operand is built in registers. For dA, r = qx and q = qy;
// for dB, r = qy and q = qx (one kernel, two launches). A block owns 128
// pixels of one n and all of q (<= 64: 8 n-tiles of 8); it walks channel
// chunks of 64 and, within each, r four at a time. Per (r, 16 channels)
// a thread multiplies its 8 g values (kept in registers for the chunk)
// by S[p, r] and packs them into the mma A fragment; x tiles [q][c] come
// by cp.async, double-buffered, and feed mma.sync bf16 through ldmatrix.
// Every pixel tile re-reads x from L2 (12 times at 38x38 per pass).
// Takes H, W <= 64 and Cg a multiple of 8; edges are masked.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TP = 128;       // pixels per block, 16 per warp
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int CC = 64;        // channels per chunk: 4 k-steps of 16
constexpr int RC = 4;         // r per pipeline stage
constexpr int MAXHW = 64;     // q <= 64: 8 n-tiles
constexpr int PAD = 8;
constexpr int LDC = CC + PAD;  // smem row of a [q][c] or [p][c] tile

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

// bf16(s * lo) in the low half, bf16(s * hi) in the high half, where the
// word holds two bf16 values (lo in the low half)
__device__ __forceinline__ uint32_t scaled_pair(float s, uint32_t word) {
    const float lo = __uint_as_float(word << 16);
    const float hi = __uint_as_float(word & 0xffff0000u);
    __nv_bfloat162 v = __floats2bfloat162_rn(s * lo, s * hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

__host__ __device__ __forceinline__ int padded(int Q) { return (Q + 15) / 16 * 16; }

__host__ __device__ __forceinline__ size_t smem_bytes(int Q, int R) {
    return (size_t)TP * R * sizeof(float)                       // Ss [TP][R]
           + (size_t)TP * LDC * sizeof(bf16)                    // Gs [TP][LDC]
           + (size_t)2 * RC * padded(Q) * LDC * sizeof(bf16);   // Xs [2][RC][QP][LDC]
}

// SIDE 0: out = dA (S = B, R = W, Q = H); SIDE 1: out = dB (S = A, R = H, Q = W)
template <int SIDE>
__global__ void __launch_bounds__(THREADS)
abx_dab_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
               const bf16* __restrict__ S, float* __restrict__ out, int P, int H, int W,
               int Cg) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int R = SIDE == 0 ? W : H;
    const int Q = SIDE == 0 ? H : W;
    const int QP = padded(Q);
    float* Ss = reinterpret_cast<float*>(smem);
    bf16* Gs = reinterpret_cast<bf16*>(Ss + TP * R);
    bf16* Xs = Gs + TP * LDC;

    const int n = blockIdx.z;
    const int p0 = blockIdx.x * TP;
    const int tid = threadIdx.x;
    const int warp = tid / 32, lane = tid % 32;
    const int gr = lane >> 2, tig = lane & 3;
    const int mi = lane >> 3, r8 = lane & 7;
    const bf16* xn = x + (size_t)n * H * W * Cg;
    const bf16* gn = g + (size_t)n * P * Cg;
    const bf16* Sn = S + (size_t)n * P * R;
    const int nt = QP / 8;  // n-tiles of q, even

    for (int i = tid; i < TP * R; i += THREADS) {
        const int row = i / R, r = i - row * R;
        const int p = p0 + row;
        Ss[i] = p < P ? __bfloat162float(Sn[(size_t)p * R + r]) : 0.0f;
    }

    // x[q, r, c0 .. c0 + CC) (dA) or x[r, q, ...] (dB) for r in stage s
    // into Xs half `buf`, zero outside the map and past Cg
    auto stage = [&](int c0, int s, int buf) {
        for (int i = tid; i < RC * QP * (CC / 8); i += THREADS) {
            const int j = i / (QP * (CC / 8));
            const int rem = i - j * QP * (CC / 8);
            const int q = rem / (CC / 8);
            const int c = (rem - q * (CC / 8)) * 8;
            const int r = s * RC + j;
            bf16* d = Xs + ((buf * RC + j) * QP + q) * LDC + c;
            if (r < R && q < Q && c0 + c < Cg) {
                const size_t pix = SIDE == 0 ? (size_t)q * W + r : (size_t)r * W + q;
                __pipeline_memcpy_async(d, xn + pix * Cg + c0 + c, 16);
            } else {
                *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
            }
        }
    };

    float acc[MAXHW / 8][4];
#pragma unroll
    for (int f = 0; f < MAXHW / 8; ++f) acc[f][0] = acc[f][1] = acc[f][2] = acc[f][3] = 0.0f;
    const int nst = (R + RC - 1) / RC;
    const float* s_lo = Ss + (warp * 16 + gr) * R;      // row gr
    const float* s_hi = Ss + (warp * 16 + gr + 8) * R;  // row gr + 8

    for (int c0 = 0; c0 < Cg; c0 += CC) {
        __syncthreads();  // Gs and both Xs halves are free
        for (int i = tid; i < TP * (CC / 8); i += THREADS) {
            const int row = i / (CC / 8), c = (i % (CC / 8)) * 8;
            const int p = p0 + row;
            bf16* d = Gs + row * LDC + c;
            if (p < P && c0 + c < Cg)
                __pipeline_memcpy_async(d, gn + (size_t)p * Cg + c0 + c, 16);
            else
                *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
        }
        stage(c0, 0, 0);
        __pipeline_commit();
        for (int s = 0; s < nst; ++s) {
            if (s + 1 < nst) stage(c0, s + 1, (s + 1) & 1);
            __pipeline_commit();
            __pipeline_wait_prior(1);
            __syncthreads();
            // the thread's g values of this chunk: rows gr, gr + 8; per
            // k-step the channel pairs 2 tig and 2 tig + 8
            uint32_t gw[CC / 16][4];
#pragma unroll
            for (int kk = 0; kk < CC / 16; ++kk) {
                const bf16* lo = Gs + (warp * 16 + gr) * LDC + kk * 16 + 2 * tig;
                const bf16* hi = lo + 8 * LDC;
                gw[kk][0] = *reinterpret_cast<const uint32_t*>(lo);
                gw[kk][1] = *reinterpret_cast<const uint32_t*>(hi);
                gw[kk][2] = *reinterpret_cast<const uint32_t*>(lo + 8);
                gw[kk][3] = *reinterpret_cast<const uint32_t*>(hi + 8);
            }
            const bf16* xs = Xs + (s & 1) * RC * QP * LDC;
            for (int j = 0; j < RC && s * RC + j < R; ++j) {
                const float slo = s_lo[s * RC + j], shi = s_hi[s * RC + j];
#pragma unroll
                for (int kk = 0; kk < CC / 16; ++kk) {
                    const uint32_t a[4] = {scaled_pair(slo, gw[kk][0]), scaled_pair(shi, gw[kk][1]),
                                           scaled_pair(slo, gw[kk][2]), scaled_pair(shi, gw[kk][3])};
#pragma unroll
                    for (int f = 0; f < MAXHW / 8; f += 2) {
                        if (f < nt) {
                            uint32_t b[4];
                            ldmatrix_x4(b, xs + ((j * QP) + (f + (mi >> 1)) * 8 + r8) * LDC +
                                               kk * 16 + (mi & 1) * 8);
                            mma_bf16(acc[f], a, b[0], b[1]);
                            mma_bf16(acc[f + 1], a, b[2], b[3]);
                        }
                    }
                }
            }
            __syncthreads();  // this Xs half is refilled two stages on
        }
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int p = p0 + warp * 16 + gr + 8 * h;
        if (p >= P) continue;
        float* orow = out + ((size_t)n * P + p) * Q;
#pragma unroll
        for (int f = 0; f < MAXHW / 8; ++f) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int q = f * 8 + 2 * tig + e;
                if (q < Q) orow[q] = acc[f][2 * h + e];
            }
        }
    }
}

template <int SIDE>
cudaError_t launch(const bf16* x, const bf16* g, const bf16* S, float* out, int NG, int P, int H,
                   int W, int Cg, cudaStream_t stream) {
    const size_t smem = SIDE == 0 ? smem_bytes(H, W) : smem_bytes(W, H);
    cudaError_t err = cudaFuncSetAttribute(abx_dab_kernel<SIDE>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((P + TP - 1) / TP, 1, NG);
    abx_dab_kernel<SIDE><<<grid, THREADS, smem, stream>>>(x, g, S, out, P, H, W, Cg);
    return cudaGetLastError();
}

}  // namespace

// x [NG,H,W,Cg], g [NG,P,Cg], A [NG,P,H], B [NG,P,W] bf16; dA [NG,P,H], dB
// [NG,P,W] f32. All contiguous and 16-byte aligned; H, W <= 64; Cg a
// multiple of 8. Launches the dA pass, then the dB pass. Returns the CUDA
// error code of the launches (0 on success).
extern "C" int deform_sample_dab(const void* x, const void* g, const void* A, const void* B,
                                 void* dA, void* dB, int NG, int P, int H, int W, int Cg,
                                 void* stream) {
    if (NG < 1 || P < 1 || H < 1 || W < 1 || H > MAXHW || W > MAXHW || Cg < 8 || Cg % 8)
        return (int)cudaErrorInvalidValue;
    const bf16* xx = static_cast<const bf16*>(x);
    const bf16* gg = static_cast<const bf16*>(g);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = launch<0>(xx, gg, static_cast<const bf16*>(B), static_cast<float*>(dA), NG,
                                P, H, W, Cg, s);
    if (err != cudaSuccess) return (int)err;
    return (int)launch<1>(xx, gg, static_cast<const bf16*>(A), static_cast<float*>(dB), NG, P, H,
                          W, Cg, s);
}

extern "C" const char* deform_sample_dab_error(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
