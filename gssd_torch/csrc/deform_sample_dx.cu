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
// The TPU kernel contracts the dense hat rows, whose 2 * n * P * H * W *
// Cg operations (0.14 TFLOP a call at batch 32, 38x38, Cg 256) are almost
// all products with zeros: a hat row A[p, :] or B[p, :] has at most two
// non-zeros, so at most 4 of the H * W cells of a p get a non-zero term.
// Here a first kernel (hat_ranges, csrc/hat_ranges.cuh) reads A and B
// once and stores, for each (n, p), the first and last non-zero index of
// each row (an empty row as lo > hi); it works from the rows as given,
// so any A and B give the right answer, not only hat weights. The second kernel gives a block
// an 8 x 8 tile of (qy, qx) and 128 channels of one n; a thread owns one
// row of the tile and one channel pair, its 8 x 2 sums in registers. The
// block walks p in ascending order, 512 at a time: the p whose two
// ranges both meet the tile are compacted into a list in shared memory,
// in order; their g and hat values are staged in shared memory, 32 p at a
// time, and each thread adds A * (B * g) to its cells inside the p's
// ranges.
// Each dx element belongs to one thread, which adds its terms in
// ascending p, as the dense order does; the terms skipped are exactly
// +-0 (a zero of A or B times a finite product), and adding +-0 to an
// f32 sum that starts at +0 leaves it unchanged, so the result is the
// dense order's bit for bit. The one difference: the dense order
// multiplies a NaN or Inf of g, A or B by the zeros of the other rows,
// which spreads NaN over the row or the map; here a non-finite value
// reaches dx only where both rows of its p are inside their ranges.
//
// What bounds it now: the bytes, A and B read once (28 MB at batch 32),
// g (94.6 MB) and the f32 dx written (189 MB), ~0.093 ms at 3.35 TB/s;
// the terms left are ~4 * n * P * Cg FMAs. Each block also scans the
// ranges of its n (16 bytes a p, from L2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hat_ranges.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TY = 8;         // qy per block
constexpr int TX = 8;         // qx per block
constexpr int NPAIR = 64;     // channel pairs per block (128 channels)
constexpr int THREADS = TY * NPAIR;  // one (row, channel pair) each
constexpr int SUB = 32;       // listed p staged at a time

__global__ void __launch_bounds__(THREADS)
abx_dx_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
              const bf16* __restrict__ g, const int4* __restrict__ ranges,
              float* __restrict__ dx, int P, int H, int W, int Cg) {
    __shared__ int plist[THREADS];
    __shared__ int4 rlist[THREADS];               // the listed p's ranges clipped to the tile
    __shared__ __nv_bfloat162 gsh[SUB][NPAIR];    // g of SUB listed p, this block's channels
    __shared__ float hsh[SUB][TY + TX];           // A[p, qy0 ..], B[p, qx0 ..]
    __shared__ int wsum[THREADS / 32];

    const int n = blockIdx.z;
    const int tiles_x = (W + TX - 1) / TX;
    const int qy0 = (blockIdx.x / tiles_x) * TY;
    const int qx0 = (blockIdx.x % tiles_x) * TX;
    const int tid = threadIdx.x;
    const int lane = tid % 32, warp = tid / 32;
    const int row = tid / NPAIR, pair = tid % NPAIR;  // this thread's cells: (qy0 + row, qx0 ..)
    const int qy = qy0 + row;
    const int c = blockIdx.y * 2 * NPAIR + 2 * pair;
    const bool has_c = c < Cg;
    const bf16* An = A + (size_t)n * P * H;
    const bf16* Bn = B + (size_t)n * P * W;
    const bf16* gn = g + (size_t)n * P * Cg;
    const int4* rn = ranges + (size_t)n * P;

    float acc[TX][2];
#pragma unroll
    for (int i = 0; i < TX; ++i) acc[i][0] = acc[i][1] = 0.0f;

    for (int p0 = 0; p0 < P; p0 += THREADS) {
        // list the p of this step whose two ranges meet the tile, ascending
        const int p = p0 + tid;
        int4 r = p < P ? rn[p] : make_int4(1, 0, 1, 0);
        r = make_int4(max(r.x, qy0), min(r.y, qy0 + TY - 1), max(r.z, qx0), min(r.w, qx0 + TX - 1));
        const bool sel = r.x <= r.y && r.z <= r.w;
        const unsigned mask = __ballot_sync(0xffffffffu, sel);
        if (lane == 0) wsum[warp] = __popc(mask);
        __syncthreads();  // also: the previous step's list is consumed
        int pos = __popc(mask & ((1u << lane) - 1)), total = 0;
        for (int w = 0; w < THREADS / 32; ++w) {
            const int v = wsum[w];
            pos += w < warp ? v : 0;
            total += v;
        }
        if (sel) {
            plist[pos] = p;
            rlist[pos] = r;
        }
        __syncthreads();

        for (int j0 = 0; j0 < total; j0 += SUB) {
            const int m = min(SUB, total - j0);
            // stage g and the hat values of the listed p, one load a thread
            for (int i = tid; i < m * NPAIR; i += THREADS) {
                const int j = i / NPAIR, cp = blockIdx.y * 2 * NPAIR + 2 * (i % NPAIR);
                if (cp < Cg)
                    gsh[j][i % NPAIR] = *reinterpret_cast<const __nv_bfloat162*>(
                        gn + (size_t)plist[j0 + j] * Cg + cp);
            }
            if (tid < m * (TY + TX)) {
                const int j = tid / (TY + TX), e = tid % (TY + TX);
                const int pj = plist[j0 + j];
                float v = 0.0f;
                if (e < TY) {
                    if (qy0 + e < H) v = __bfloat162float(An[(size_t)pj * H + qy0 + e]);
                } else if (qx0 + e - TY < W) {
                    v = __bfloat162float(Bn[(size_t)pj * W + qx0 + e - TY]);
                }
                hsh[j][e] = v;
            }
            __syncthreads();
            if (has_c) {
                for (int j = 0; j < m; ++j) {
                    const int4 rr = rlist[j0 + j];
                    if (qy < rr.x || qy > rr.y) continue;
                    const float a = hsh[j][row];
                    const float2 gv = __bfloat1622float2(gsh[j][pair]);
#pragma unroll
                    for (int i = 0; i < TX; ++i) {
                        if (qx0 + i < rr.z || qx0 + i > rr.w) continue;
                        const float b = hsh[j][TY + i];
                        const float e0 = b * gv.x, e1 = b * gv.y;
                        acc[i][0] = fmaf(a, e0, acc[i][0]);
                        acc[i][1] = fmaf(a, e1, acc[i][1]);
                    }
                }
            }
            __syncthreads();  // gsh and hsh are refilled
        }
    }

    if (!has_c || qy >= H) return;
#pragma unroll
    for (int i = 0; i < TX; ++i)
        if (qx0 + i < W)
            *reinterpret_cast<float2*>(dx + (((size_t)n * H + qy) * W + qx0 + i) * Cg + c) =
                make_float2(acc[i][0], acc[i][1]);
}

}  // namespace

// A [NG,P,H], B [NG,P,W], g [NG,P,Cg] bf16; dx [NG,H,W,Cg] f32; ranges
// [NG,P] int4 scratch. All contiguous and 16-byte aligned; Cg a multiple
// of 8. Launches the range pass and the dx kernel on `stream`; returns
// the CUDA error code (0 on success).
extern "C" int deform_sample_dx(const void* A, const void* B, const void* g, void* dx,
                                void* ranges, int NG, int P, int H, int W, int Cg, void* stream) {
    if (NG < 1 || P < 1 || H < 1 || W < 1 || Cg < 8 || Cg % 8 || NG > 65535)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = hat_ranges_pass::launch(static_cast<const bf16*>(A),
                                              static_cast<const bf16*>(B),
                                              static_cast<int4*>(ranges), (long)NG * P, H, W, s);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(((H + TY - 1) / TY) * ((W + TX - 1) / TX), (Cg + 2 * NPAIR - 1) / (2 * NPAIR),
                    NG);
    abx_dx_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const bf16*>(A), static_cast<const bf16*>(B), static_cast<const bf16*>(g),
        static_cast<const int4*>(ranges), static_cast<float*>(dx), P, H, W, Cg);
    return (int)cudaGetLastError();
}

extern "C" const char* deform_sample_dx_error(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
