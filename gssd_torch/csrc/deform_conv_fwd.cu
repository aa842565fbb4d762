// Modulated deformable convolution (DCNv2) forward for Hopper (sm_90a).
//
//   out[b, p, n] = bias[n] + sum_{g, k, c} samp[b, p, g, k, c] * wg[g, k, c, n]
//   samp         = bf16( sum_{4 corners} bf16(ay * bx * m[b, p, g, k]) * x[b, corner, g*Cg + c] )
//
// Replaces gssd_tpu/ops/pallas/deform_hat.py _fwd_kernel /
// _fwd_kernel_allwin (the Pallas TPU kernels behind deform_conv2d_hat).
// The TPU kernel writes bilinear sampling as a dense "hat" matrix
// product over the whole flattened map, because a TPU gathers badly. A
// GPU gathers well, so this kernel samples the four corners directly:
// one block owns a [64 pixels x 256 output channels] tile of one image
// and walks the steps (group g, tap k, 32-channel chunk). For each step
//   1. the 4 corner indices and weights (times the mask) of its 64
//      pixels, once per (g, k); a corner outside the map gets weight 0
//      (its index is clamped to a valid pixel, so the load stays legal),
//   2. the corners of bf16 x, blended in f32 and rounded to bf16 into
//      shared memory (as the TPU kernel's samp.astype(bf16) does),
//   3. the [64 x 32] sample tile times the [32 x 256] bf16 weight slice
//      on the tensor cores (wmma, f32 accumulation).
// Groups and taps sum in the same f32 accumulator, then the bias is
// added. Each corner weight ay*bx*m is rounded to bf16 before the blend,
// as the hat kernel rounds it (deform_hat.py:343), and the sample once
// more after it.
//
// What bounds it here: the GEMM is 2*P*K*C*Cout = 13.6 GFLOP per image
// at the 38x38, C = 1024, Cout = 512 serving site against ~7 MB of
// traffic, so the ideal kernel is tensor-core bound. The steps are
// software-pipelined so that loads do not wait in line: the next
// step's weight slice goes by cp.async into the other half of a double
// buffer, and its 16 corner loads per thread are issued before this
// step's products and blended after them. Still left for a later
// change: wgmma/TMA, and each sample is gathered once per 256-channel
// output tile (twice at Cout = 512). Coordinates py/px arrive
// precomputed (base + tap + offset, f32), so one kernel serves every
// map size, stride and dilation.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TP = 64;    // output pixels per block
constexpr int TC = 256;   // output channels per block
constexpr int KC = 32;    // input channels per step
constexpr int WARPS = 8;  // 2 (pixel) x 4 (channel) warps, 32 x 64 each
constexpr int THREADS = WARPS * 32;
constexpr int PPT = TP / (THREADS / (KC / 2));  // pixels per thread in the gather: 4

constexpr size_t SMEM_BYTES = 2 * TP * KC * sizeof(bf16)      // As, double-buffered
                              + 2 * KC * TC * sizeof(bf16)    // Bs, double-buffered
                              + 2 * TP * 4 * sizeof(int)      // corner index tables
                              + 2 * TP * 4 * sizeof(float)    // corner weight tables
                              + WARPS * 256 * sizeof(float);  // epilogue scratch

__global__ void __launch_bounds__(THREADS, 2)
deform_fwd_kernel(const bf16* __restrict__ x,      // [B, H, W, C]
                  const float* __restrict__ py,    // [B, P, G, K]
                  const float* __restrict__ px,    // [B, P, G, K]
                  const float* __restrict__ mk,    // [B, P, G, K]
                  const bf16* __restrict__ wg,     // [G, K, Cg, Cout]
                  const float* __restrict__ bias,  // [Cout]
                  float* __restrict__ out,         // [B, P, Cout]
                  int H, int W, int C, int G, int K, int P, int Cout) {
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* As = reinterpret_cast<bf16*>(smem);        // [2][TP][KC]
    bf16* Bs = As + 2 * TP * KC;                     // [2][KC][TC]
    int* cidx = reinterpret_cast<int*>(Bs + 2 * KC * TC);  // [2][TP][4]
    float* cw = reinterpret_cast<float*>(cidx + 2 * TP * 4);  // [2][TP][4]
    float* scratch = cw + 2 * TP * 4;                // [WARPS][256]

    const int b = blockIdx.z;
    const int p0 = blockIdx.x * TP;
    const int n0 = blockIdx.y * TC;
    const int Cg = C / G;
    const int tid = threadIdx.x;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int wr = warp / 4;  // rows wr*32 .. +32
    const int wc = warp % 4;  // cols wc*64 .. +64
    const bf16* xb = x + (size_t)b * H * W * C;
    const bool vec_w = (Cout % 8) == 0;
    const int nc = (Cg + KC - 1) / KC;  // steps per (g, k)
    const int total = G * K * nc;
    // gather map: channel pair cp (16 pairs = KC channels) x pixel row
    const int cp = tid % (KC / 2);
    const int prow = tid / (KC / 2);  // pixels prow + 16 * i

    // corner table of (g, k) = gk into table half `tb`
    auto corners = [&](int gk, int tb) {
        if (tid < TP) {
            const int g = gk / K, k = gk % K;
            const int p = p0 + tid;
            float fy = 0.0f, fx = 0.0f, m = 0.0f;
            if (p < P) {
                const size_t o = (((size_t)b * P + p) * G + g) * K + k;
                fy = py[o];
                fx = px[o];
                m = mk[o];
            }
            // clamping keeps the int conversion defined; a floor below
            // -1 or above H-1 leaves both corners of that axis outside
            const float y0f = fminf(fmaxf(floorf(fy), -2.0f), (float)H);
            const float x0f = fminf(fmaxf(floorf(fx), -2.0f), (float)W);
            const int y0 = (int)y0f;
            const int x0 = (int)x0f;
#pragma unroll
            for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
                for (int dx = 0; dx < 2; ++dx) {
                    const int yy = y0 + dy;
                    const int xx = x0 + dx;
                    const bool in = p < P && yy >= 0 && yy < H && xx >= 0 && xx < W;
                    // the hat weights max(0, 1 - |p - q|) in f32, and their
                    // product with the mask rounded to bf16, as the TPU
                    // kernel forms them
                    const float ay = fmaxf(0.0f, 1.0f - fabsf(fy - (float)yy));
                    const float bx = fmaxf(0.0f, 1.0f - fabsf(fx - (float)xx));
                    const float w = __bfloat162float(__float2bfloat16(ay * bx * m));
                    cidx[(tb * TP + tid) * 4 + dy * 2 + dx] = in ? yy * W + xx : 0;
                    cw[(tb * TP + tid) * 4 + dy * 2 + dx] = in ? w : 0.0f;
                }
            }
        }
    };

    // weight slice [KC x TC] of step s into Bs half `buf`, zero past Cg / Cout
    auto load_w = [&](int s, int buf) {
        const int gk = s / nc, c0 = (s % nc) * KC;
        const bf16* wk = wg + (size_t)gk * Cg * Cout;
        bf16* dst = Bs + buf * KC * TC;
        if (vec_w) {
            for (int e = tid; e < KC * TC / 8; e += THREADS) {
                const int r = e / (TC / 8);
                const int n = (e % (TC / 8)) * 8;
                if (c0 + r < Cg && n0 + n < Cout)
                    __pipeline_memcpy_async(dst + r * TC + n, wk + (size_t)(c0 + r) * Cout + n0 + n, 16);
                else
                    *reinterpret_cast<uint4*>(dst + r * TC + n) = make_uint4(0u, 0u, 0u, 0u);
            }
        } else {
            for (int e = tid; e < KC * TC; e += THREADS) {
                const int r = e / TC;
                const int n = e % TC;
                dst[e] = (c0 + r < Cg && n0 + n < Cout) ? wk[(size_t)(c0 + r) * Cout + n0 + n]
                                                        : __float2bfloat16(0.0f);
            }
        }
    };

    // corner loads of step s (issued early, consumed by blend)
    uint32_t raw[PPT][4];
    auto gather_issue = [&](int s, int tb) {
        const int g = (s / nc) / K;
        const int c = (s % nc) * KC + 2 * cp;
#pragma unroll
        for (int i = 0; i < PPT; ++i) {
            const int t = prow + 16 * i;
#pragma unroll
            for (int j = 0; j < 4; ++j)
                raw[i][j] = c < Cg ? *reinterpret_cast<const uint32_t*>(
                                         xb + (size_t)cidx[(tb * TP + t) * 4 + j] * C + g * Cg + c)
                                   : 0u;
        }
    };

    auto blend = [&](int tb, int buf) {
        bf16* dst = As + buf * TP * KC;
#pragma unroll
        for (int i = 0; i < PPT; ++i) {
            const int t = prow + 16 * i;
            float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                // bf16 -> f32 is the bit pattern shifted up 16 places;
                // channel c sits in the low half
                const float w = cw[(tb * TP + t) * 4 + j];
                a0 = fmaf(w, __uint_as_float(raw[i][j] << 16), a0);
                a1 = fmaf(w, __uint_as_float(raw[i][j] & 0xffff0000u), a1);
            }
            *reinterpret_cast<__nv_bfloat162*>(dst + t * KC + 2 * cp) = __floats2bfloat162_rn(a0, a1);
        }
    };

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

    // prologue: step 0 into buffer 0
    corners(0, 0);
    __syncthreads();
    load_w(0, 0);
    __pipeline_commit();
    gather_issue(0, 0);
    blend(0, 0);

    for (int s = 0; s < total; ++s) {
        const int n = s + 1;
        const int buf = s & 1;
        const int ntb = (n / nc) & 1;
        if (n < total && n % nc == 0) {  // step n starts a new (g, k)
            corners(n / nc, ntb);
            __syncthreads();
        }
        if (n < total) {
            load_w(n, buf ^ 1);
            gather_issue(n, ntb);
        }
        __pipeline_commit();
        __pipeline_wait_prior(1);
        __syncthreads();  // As/Bs half `buf` complete
        const bf16* a = As + buf * TP * KC;
        const bf16* w = Bs + buf * KC * TC;
#pragma unroll
        for (int kk = 0; kk < KC / 16; ++kk) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
                wmma::load_matrix_sync(af[i], a + (wr * 32 + i * 16) * KC + kk * 16, KC);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bf;
                wmma::load_matrix_sync(bf, w + kk * 16 * TC + wc * 64 + j * 16, TC);
#pragma unroll
                for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], af[i], bf, acc[i][j]);
            }
        }
        if (n < total) blend(ntb, buf ^ 1);
        __syncthreads();  // half `buf` free for step s + 2
    }

    // epilogue: + bias, guarded store
    float* sc = scratch + warp * 256;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            __syncwarp();
            wmma::store_matrix_sync(sc, acc[i][j], 16, wmma::mem_row_major);
            __syncwarp();
            for (int e = lane; e < 256; e += 32) {
                const int p = p0 + wr * 32 + i * 16 + e / 16;
                const int nn = n0 + wc * 64 + j * 16 + e % 16;
                if (p < P && nn < Cout) out[((size_t)b * P + p) * Cout + nn] = sc[e] + bias[nn];
            }
        }
    }
}

}  // namespace

// x [B,H,W,C] bf16; py, px, m [B,P,G,K] f32 (absolute sample coordinates
// and modulation); wg [G,K,C/G,Cout] bf16; bias [Cout] f32; out [B,P,Cout]
// f32. All contiguous and 16-byte aligned; C/G even. Returns the CUDA
// error code of the launch (0 on success).
extern "C" int deform_conv_fwd(const void* x, const void* py, const void* px, const void* m,
                               const void* wg, const void* bias, void* out, int B, int H, int W,
                               int C, int G, int K, int P, int Cout, void* stream) {
    if (B < 1 || H < 1 || W < 1 || G < 1 || C % G || (C / G) % 2 || K < 1 || P < 1 || Cout < 1)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(deform_fwd_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((P + TP - 1) / TP, (Cout + TC - 1) / TC, B);
    deform_fwd_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(x), static_cast<const float*>(py), static_cast<const float*>(px),
        static_cast<const float*>(m), static_cast<const bf16*>(wg), static_cast<const float*>(bias),
        static_cast<float*>(out), H, W, C, G, K, P, Cout);
    return (int)cudaGetLastError();
}

extern "C" const char* deform_conv_fwd_error(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
