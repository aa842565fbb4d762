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
// What bounds it here: 2 * n * P * H * W * Cg operations against reading
// A, B, x once and writing out (~0.2 GB at batch 32, 38x38, Cg 256 for
// 0.14 TFLOP), so the ideal kernel is tensor-core bound. The TPU kernel
// forms the whole [TP, W * Cg] f32 product A . x in VMEM (TP * 9728 f32 at
// 38x38, Cg 256), far more than a block's shared memory. Here a block
// owns 128 pixels x 64 channels of one n and walks qx: for each column
// one [128 x H] x [H x 64] product on the tensor cores (mma.sync bf16,
// f32 accumulators in registers, H padded to a multiple of 16 with
// zeros), then out += B[p, qx] * T in registers. A's fragments stay in
// registers for the whole block; x columns arrive by cp.async, four
// columns per stage, double-buffered. The block re-reads its n's x once
// per 128-pixel tile (12 times at 38x38) from L2. Takes H, W <= 64 and
// Cg a multiple of 8; pixel and channel edges are masked.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TP = 128;       // pixels per block, 16 per warp
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int TC = 64;        // channels per block: 8 n-tiles of 8
constexpr int RC = 4;         // qx columns per pipeline stage
constexpr int MAXHW = 64;     // H (4 k-steps of 16) and W
constexpr int PAD = 8;        // bf16 padding per smem row: conflict-free ldmatrix
constexpr int LDX = TC + PAD;

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

// padded qy extent (multiple of 16) and the smem layout
__host__ __device__ __forceinline__ int padded(int H) { return (H + 15) / 16 * 16; }

__host__ __device__ __forceinline__ size_t smem_bytes(int H, int W) {
    const int KP = padded(H);
    return (size_t)TP * (KP + PAD) * sizeof(bf16)      // As [TP][KP + PAD]
           + (size_t)TP * W * sizeof(float)            // Bs [TP][W]
           + (size_t)2 * RC * KP * LDX * sizeof(bf16);  // Xs [2][RC][KP][LDX]
}

__global__ void __launch_bounds__(THREADS)
abx_fwd_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
               const bf16* __restrict__ x, float* __restrict__ out, int P, int H, int W,
               int Cg) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int KP = padded(H);
    const int lda = KP + PAD;
    bf16* As = reinterpret_cast<bf16*>(smem);
    float* Bs = reinterpret_cast<float*>(As + TP * lda);
    bf16* Xs = reinterpret_cast<bf16*>(Bs + TP * W);

    const int n = blockIdx.z;
    const int p0 = blockIdx.x * TP;
    const int c0 = blockIdx.y * TC;
    const int tid = threadIdx.x;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, tig = lane & 3;
    const int mi = lane >> 3, r8 = lane & 7;
    const bf16* An = A + (size_t)n * P * H;
    const bf16* Bn = B + (size_t)n * P * W;
    const bf16* xn = x + (size_t)n * H * W * Cg;

    // x columns r0 .. r0 + RC - 1, rows qy < KP, channels c0 .. c0 + TC - 1
    // into Xs half `buf`; zero outside the map and past Cg
    auto stage = [&](int s, int buf) {
        const int r0 = s * RC;
        for (int i = tid; i < RC * KP * (TC / 8); i += THREADS) {
            const int j = i / (KP * (TC / 8));
            const int rem = i - j * KP * (TC / 8);
            const int q = rem / (TC / 8);
            const int c = (rem - q * (TC / 8)) * 8;
            bf16* d = Xs + ((buf * RC + j) * KP + q) * LDX + c;
            if (r0 + j < W && q < H && c0 + c < Cg)
                __pipeline_memcpy_async(d, xn + ((size_t)q * W + r0 + j) * Cg + c0 + c, 16);
            else
                *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
        }
    };

    stage(0, 0);
    __pipeline_commit();
    for (int i = tid; i < TP * KP; i += THREADS) {
        const int row = i / KP, q = i - row * KP;
        const int p = p0 + row;
        As[row * lda + q] = (p < P && q < H) ? An[(size_t)p * H + q] : __float2bfloat16(0.0f);
    }
    for (int i = tid; i < TP * W; i += THREADS) {
        const int row = i / W, q = i - row * W;
        const int p = p0 + row;
        Bs[i] = p < P ? __bfloat162float(Bn[(size_t)p * W + q]) : 0.0f;
    }
    __syncthreads();

    // the warp's 16 rows of A as mma A fragments, kept for the whole block
    uint32_t af[MAXHW / 16][4];
#pragma unroll
    for (int kk = 0; kk < MAXHW / 16; ++kk)
        if (kk * 16 < KP)
            ldmatrix_x4(af[kk], As + (warp * 16 + (mi & 1) * 8 + r8) * lda + kk * 16 + (mi >> 1) * 8);

    float acc[TC / 8][4];
#pragma unroll
    for (int f = 0; f < TC / 8; ++f) acc[f][0] = acc[f][1] = acc[f][2] = acc[f][3] = 0.0f;
    const float* b_lo = Bs + (warp * 16 + g) * W;      // row g
    const float* b_hi = Bs + (warp * 16 + g + 8) * W;  // row g + 8

    const int nst = (W + RC - 1) / RC;
    for (int s = 0; s < nst; ++s) {
        if (s + 1 < nst) stage(s + 1, (s + 1) & 1);
        __pipeline_commit();
        __pipeline_wait_prior(1);
        __syncthreads();
        const bf16* xs = Xs + (s & 1) * RC * KP * LDX;
        for (int j = 0; j < RC && s * RC + j < W; ++j) {
            float t[TC / 8][4];
#pragma unroll
            for (int f = 0; f < TC / 8; ++f) t[f][0] = t[f][1] = t[f][2] = t[f][3] = 0.0f;
#pragma unroll
            for (int kk = 0; kk < MAXHW / 16; ++kk) {
                if (kk * 16 < KP) {
#pragma unroll
                    for (int f = 0; f < TC / 8; f += 2) {
                        uint32_t bv[4];
                        ldmatrix_x4_trans(bv, xs + (j * KP + kk * 16 + (mi & 1) * 8 + r8) * LDX +
                                                  (f + (mi >> 1)) * 8);
                        mma_bf16(t[f], af[kk], bv[0], bv[1]);
                        mma_bf16(t[f + 1], af[kk], bv[2], bv[3]);
                    }
                }
            }
            const float blo = b_lo[s * RC + j], bhi = b_hi[s * RC + j];
#pragma unroll
            for (int f = 0; f < TC / 8; ++f) {
                acc[f][0] = __fadd_rn(acc[f][0], __fmul_rn(blo, t[f][0]));
                acc[f][1] = __fadd_rn(acc[f][1], __fmul_rn(blo, t[f][1]));
                acc[f][2] = __fadd_rn(acc[f][2], __fmul_rn(bhi, t[f][2]));
                acc[f][3] = __fadd_rn(acc[f][3], __fmul_rn(bhi, t[f][3]));
            }
        }
        __syncthreads();  // this Xs half is refilled two stages on
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int p = p0 + warp * 16 + g + 8 * h;
        if (p < P) {
            float* orow = out + ((size_t)n * P + p) * Cg;
#pragma unroll
            for (int f = 0; f < TC / 8; ++f) {
                const int c = c0 + f * 8 + 2 * tig;
                if (c < Cg)
                    *reinterpret_cast<float2*>(orow + c) = make_float2(acc[f][2 * h], acc[f][2 * h + 1]);
            }
        }
    }
}

}  // namespace

// A [NG,P,H], B [NG,P,W], x [NG,H,W,Cg] bf16; out [NG,P,Cg] f32. All
// contiguous and 16-byte aligned; H, W <= 64; Cg a multiple of 8. Returns
// the CUDA error code of the launch (0 on success).
extern "C" int deform_sample_fwd(const void* A, const void* B, const void* x, void* out, int NG,
                                 int P, int H, int W, int Cg, void* stream) {
    if (NG < 1 || P < 1 || H < 1 || W < 1 || H > MAXHW || W > MAXHW || Cg < 8 || Cg % 8)
        return (int)cudaErrorInvalidValue;
    const size_t smem = smem_bytes(H, W);
    cudaError_t err = cudaFuncSetAttribute(abx_fwd_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((P + TP - 1) / TP, (Cg + TC - 1) / TC, NG);
    abx_fwd_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(A), static_cast<const bf16*>(B), static_cast<const bf16*>(x),
        static_cast<float*>(out), P, H, W, Cg);
    return (int)cudaGetLastError();
}

extern "C" const char* deform_sample_fwd_error(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
