// Separable deformable sampling, input gradient, for Hopper (sm_90a):
//
//   dx[n, qy, qx, c] = sum_p A[n, p, qy] * ( B[n, p, qx] * g[n, p, c] )
//
// n runs over (image, deformable group); A [n, P, H], B [n, P, W], g [n,
// P, Cg] are bf16, dx [n, H, W, Cg] is f32. Replaces
// gssd_tpu/ops/pallas/deform_sample.py _dx_kernel (the backward of
// abx_sample for dcn_impl='pallas', and the dx of dcn_impl='fused'), with
// its arithmetic: E = B * g and A * E in f32. A product of two bf16
// values is exact in f32 and so is its product with a third (8 + 8 + 8
// significant bits), so every term is exact and only the order of the f32
// sum over p can differ from the TPU's. No TF32, no bf16 E.
//
// What bounds it here: 2 * n * P * H * W * Cg f32 operations (0.14 TFLOP
// at batch 32, 38x38, Cg 256), which the tensor cores cannot take
// without rounding E, so the bound is the CUDA cores' f32 rate: ~2 ms a
// call on an H100. The TPU kernel revisits its whole [H, W, Cg] output
// block across p-tiles of a sequential grid. Blocks here run in parallel,
// so a block owns an output tile of 16 qy x 8 qx x 64 channels and walks
// every p itself: no atomics, and the sum over p runs in one fixed order.
// p arrives 32 at a time into shared memory as f32 (A, B, g slices);
// each thread holds 8 qy x 4 channels of one qx in registers and per p
// forms its 4 E values and 32 FMAs. The dense hat rows are mostly zero;
// the kernel does not skip them, as the TPU kernel does not.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TY = 16;        // qy per block: 2 groups of 8
constexpr int TX = 8;         // qx per block
constexpr int TCH = 64;       // channels per block: 16 groups of 4
constexpr int PC = 32;        // p per shared-memory chunk
constexpr int THREADS = 256;  // (qy group, qx, channel group) = 2 x 8 x 16

__global__ void __launch_bounds__(THREADS)
abx_dx_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
              const bf16* __restrict__ g, float* __restrict__ dx, int P, int H, int W, int Cg) {
    __shared__ __align__(16) float As[PC][TY];
    __shared__ __align__(16) float Bs[PC][TX];
    __shared__ __align__(16) float Gs[PC][TCH];

    const int n = blockIdx.z;
    const int tiles_x = (W + TX - 1) / TX;
    const int qy0 = (blockIdx.x / tiles_x) * TY;
    const int qx0 = (blockIdx.x % tiles_x) * TX;
    const int c0 = blockIdx.y * TCH;
    const int tid = threadIdx.x;
    const int tc = tid & 15;         // channels c0 + 4 tc .. + 3
    const int tx = (tid >> 4) & 7;   // qx0 + tx
    const int tyg = tid >> 7;        // qy0 + 8 tyg .. + 7
    const bf16* An = A + (size_t)n * P * H;
    const bf16* Bn = B + (size_t)n * P * W;
    const bf16* gn = g + (size_t)n * P * Cg;

    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;

    for (int pc = 0; pc < P; pc += PC) {
        __syncthreads();  // the previous chunk is consumed
        for (int i = tid; i < PC * TY; i += THREADS) {
            const int pp = i / TY, q = i % TY;
            const int p = pc + pp, qy = qy0 + q;
            As[pp][q] = (p < P && qy < H) ? __bfloat162float(An[(size_t)p * H + qy]) : 0.0f;
        }
        for (int i = tid; i < PC * TX; i += THREADS) {
            const int pp = i / TX, q = i % TX;
            const int p = pc + pp, qx = qx0 + q;
            Bs[pp][q] = (p < P && qx < W) ? __bfloat162float(Bn[(size_t)p * W + qx]) : 0.0f;
        }
        for (int i = tid; i < PC * TCH / 2; i += THREADS) {
            const int pp = i / (TCH / 2), c = 2 * (i % (TCH / 2));
            const int p = pc + pp;
            float2 v = make_float2(0.0f, 0.0f);
            if (p < P && c0 + c < Cg)
                v = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(gn + (size_t)p * Cg + c0 + c));
            Gs[pp][c] = v.x;
            Gs[pp][c + 1] = v.y;
        }
        __syncthreads();
#pragma unroll 4
        for (int pp = 0; pp < PC; ++pp) {
            const float4 a0 = *reinterpret_cast<const float4*>(&As[pp][8 * tyg]);
            const float4 a1 = *reinterpret_cast<const float4*>(&As[pp][8 * tyg + 4]);
            const float b = Bs[pp][tx];
            const float4 gv = *reinterpret_cast<const float4*>(&Gs[pp][4 * tc]);
            const float e[4] = {b * gv.x, b * gv.y, b * gv.z, b * gv.w};
            const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], e[j], acc[i][j]);
        }
    }

    const int qx = qx0 + tx;
    const int c = c0 + 4 * tc;
    if (qx >= W || c >= Cg) return;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int qy = qy0 + 8 * tyg + i;
        if (qy < H)
            *reinterpret_cast<float4*>(dx + (((size_t)n * H + qy) * W + qx) * Cg + c) =
                make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
}

}  // namespace

// A [NG,P,H], B [NG,P,W], g [NG,P,Cg] bf16; dx [NG,H,W,Cg] f32. All
// contiguous and 16-byte aligned; Cg a multiple of 8. Returns the CUDA
// error code of the launch (0 on success).
extern "C" int deform_sample_dx(const void* A, const void* B, const void* g, void* dx, int NG,
                                int P, int H, int W, int Cg, void* stream) {
    if (NG < 1 || P < 1 || H < 1 || W < 1 || Cg < 8 || Cg % 8) return (int)cudaErrorInvalidValue;
    const dim3 grid(((H + TY - 1) / TY) * ((W + TX - 1) / TX), (Cg + TCH - 1) / TCH, NG);
    abx_dx_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(A), static_cast<const bf16*>(B), static_cast<const bf16*>(g),
        static_cast<float*>(dx), P, H, W, Cg);
    return (int)cudaGetLastError();
}

extern "C" const char* deform_sample_dx_error(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
