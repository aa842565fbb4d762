// Stem conv backward for Hopper (sm_90a), the port of
// gssd_tpu/ops/pallas/stem_conv.py _bwd_kernel (conv3x3_wide's VJP). One
// launch runs up to three kernels:
//
// 1. dx (when asked for): the conv of g with the spatially flipped,
//    transposed weights, both rounded to bf16, f32 accumulation, rounded
//    to x's dtype: stem_conv.cuh's conv3x3_kernel on (g, wt, no bias).
// 2. dW partial sums: dW[co, ci, ky, kx] = sum_{b, y, x} bf16(g[b, co, y,
//    x]) * bf16(x[b, ci, y + ky - 1, x + kx - 1]) in f32, the grouped
//    weight gradient (the TPU's dense block-diagonal dW holds it on its
//    diagonal blocks and zeros elsewhere).
// 3. The sum of those partials, in one fixed order: dW stays f32 and is
//    never rounded, as in JAX, where only pack_weights' slice lies between
//    the kernel's f32 dW and the f32 parameter.
//
// The TPU kernel carries dW in a revisited output block across its
// sequential (batch, row tile) grid. Blocks here run in parallel, so a
// block owns one image, one band of rows and a tile of up to 16 x 16
// (co, ci) pairs of one group, walks its band in 8 x 64 pixel tiles staged
// in shared memory as bf16 (x with a one-pixel halo, g without), and
// writes its 9 partial sums per pair; a second kernel adds the bands and
// images in order. No atomics: the result does not depend on scheduling.
// Each thread owns one pair (or, with fewer pairs than threads, one pair
// and one slice of the rows) and slides a 3 x 3 window of x along a row:
// 3 new x values and one g value for 9 FMAs.
//
// What bounds it: at conv1_2 (batch 16, 300 x 300, 64 -> 64, 4 groups)
// x, g and dx move 552 MB (0.17 ms at 3.35 TB/s); dx and dW do 53 GFLOP
// of grouped products on the CUDA cores.

#include "stem_conv.cuh"

namespace {

using stem::bf16;

constexpr int SX = 64;          // pixel tile: columns
constexpr int SY = 8;           // pixel tile: rows
constexpr int DCO = 16;         // output channels per block
constexpr int DCI = 16;         // input channels per block
constexpr int DTHREADS = DCO * DCI;

// x [B, Cin, H, W], g [B, Cout, H, W] of type T; part [n_bands * B, Cout,
// Cin / G, 9] f32. Grid (n_bands, B, G * n_co * n_ci).
template <typename T>
__global__ void __launch_bounds__(DTHREADS)
dw_partial_kernel(const T* __restrict__ x, const T* __restrict__ g, float* __restrict__ part,
                  int B, int Cin, int Cout, int G, int H, int W, int band_rows) {
    __shared__ bf16 xs[DCI][SY + 2][SX + 2];
    __shared__ bf16 gs[DCO][SY][SX];
    __shared__ float red[DTHREADS][9];

    const int cgi = Cin / G, cgo = Cout / G;
    const int n_ci = (cgi + DCI - 1) / DCI, n_co = (cgo + DCO - 1) / DCO;
    int z = blockIdx.z;
    const int cci = z % n_ci;
    z /= n_ci;
    const int cco = z % n_co;
    const int grp = z / n_co;
    const int b = blockIdx.y, band = blockIdx.x;
    const int ci0 = cci * DCI, co0 = cco * DCO;  // within the group
    const int nci = min(DCI, cgi - ci0), nco = min(DCO, cgo - co0);
    const int npair = nci * nco;
    const int slices = DTHREADS / npair;
    const int tid = threadIdx.x;
    const int pair = tid % npair, slice = tid / npair;
    const bool active = slice < slices;
    const int co_l = pair / nci, ci_l = pair % nci;
    const size_t plane = (size_t)H * W;
    const T* xb = x + ((size_t)b * Cin + (size_t)grp * cgi + ci0) * plane;
    const T* gb = g + ((size_t)b * Cout + (size_t)grp * cgo + co0) * plane;
    const int ys = band * band_rows, ye = min(H, ys + band_rows);

    float acc[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) acc[k] = 0.f;

    for (int ty0 = ys; ty0 < ye; ty0 += SY) {
        for (int tx0 = 0; tx0 < W; tx0 += SX) {
            __syncthreads();  // the previous tile is consumed
            for (int i = tid; i < nci * (SY + 2) * (SX + 2); i += DTHREADS) {
                const int ci = i / ((SY + 2) * (SX + 2));
                const int rem = i - ci * (SY + 2) * (SX + 2);
                const int yy = rem / (SX + 2), xx = rem - yy * (SX + 2);
                const int gy = ty0 + yy - 1, gx = tx0 + xx - 1;
                float v = 0.f;
                if (gy >= 0 && gy < H && gx >= 0 && gx < W)
                    v = stem::to_f32(xb[(size_t)ci * plane + (size_t)gy * W + gx]);
                xs[ci][yy][xx] = __float2bfloat16(v);
            }
            for (int i = tid; i < nco * SY * SX; i += DTHREADS) {
                const int co = i / (SY * SX);
                const int rem = i - co * SY * SX;
                const int yy = rem / SX, xx = rem - yy * SX;
                const int gy = ty0 + yy, gx = tx0 + xx;
                float v = 0.f;
                // rows past the band belong to the next block's sum
                if (gy < ye && gx < W) v = stem::to_f32(gb[(size_t)co * plane + (size_t)gy * W + gx]);
                gs[co][yy][xx] = __float2bfloat16(v);
            }
            __syncthreads();
            if (!active) continue;
            for (int r = slice; r < SY; r += slices) {
                float win[3][3];
#pragma unroll
                for (int ky = 0; ky < 3; ++ky) {
                    win[ky][0] = __bfloat162float(xs[ci_l][r + ky][0]);
                    win[ky][1] = __bfloat162float(xs[ci_l][r + ky][1]);
                }
                for (int xx = 0; xx < SX; ++xx) {
#pragma unroll
                    for (int ky = 0; ky < 3; ++ky) win[ky][2] = __bfloat162float(xs[ci_l][r + ky][xx + 2]);
                    const float gv = __bfloat162float(gs[co_l][r][xx]);
#pragma unroll
                    for (int ky = 0; ky < 3; ++ky)
#pragma unroll
                        for (int kx = 0; kx < 3; ++kx) acc[ky * 3 + kx] = fmaf(gv, win[ky][kx], acc[ky * 3 + kx]);
#pragma unroll
                    for (int ky = 0; ky < 3; ++ky) {
                        win[ky][0] = win[ky][1];
                        win[ky][1] = win[ky][2];
                    }
                }
            }
        }
    }

    // the slices of one pair, added in slice order
#pragma unroll
    for (int k = 0; k < 9; ++k) red[tid][k] = active ? acc[k] : 0.f;
    __syncthreads();
    if (tid < npair) {
        float s[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) s[k] = red[tid][k];
        for (int sl = 1; sl < slices; ++sl)
#pragma unroll
            for (int k = 0; k < 9; ++k) s[k] += red[sl * npair + tid][k];
        const int co = grp * cgo + co0 + co_l;
        float* dst = part + (((size_t)(band * B + b) * Cout + co) * cgi + ci0 + ci_l) * 9;
#pragma unroll
        for (int k = 0; k < 9; ++k) dst[k] = s[k];
    }
}

// dw[i] = sum_{p < np} part[p * n + i], p ascending.
__global__ void dw_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw, int np,
                                 int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float s = 0.f;
    for (int p = 0; p < np; ++p) s += part[(size_t)p * n + i];
    dw[i] = s;
}

template <typename T>
cudaError_t launch_dw(const void* x, const void* g, float* part, float* dw, int B, int Cin,
                      int Cout, int G, int H, int W, int band_rows, int n_bands,
                      cudaStream_t stream) {
    const int n_ci = (Cin / G + DCI - 1) / DCI, n_co = (Cout / G + DCO - 1) / DCO;
    const dim3 grid(n_bands, B, G * n_co * n_ci);
    dw_partial_kernel<T><<<grid, DTHREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), part, B, Cin, Cout, G, H, W,
        band_rows);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int n = Cout * (Cin / G) * 9;
    dw_reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(part, dw, n_bands * B, n);
    return cudaGetLastError();
}

}  // namespace

// x [B, Cin, H, W] and g [B, Cout, H, W] of one dtype (dtype 0: bf16, 1:
// f32); wt [Cin, Cout / G, 3, 3] bf16, the flipped transposed weights;
// dx [B, Cin, H, W] in x's dtype, or null to skip it; part [n_bands * B,
// Cout, Cin / G, 9] f32 scratch; dw [Cout, Cin / G, 3, 3] f32. band_rows *
// n_bands covers H. All contiguous. Returns the CUDA error code of the
// first launch that failed (0 on success).
extern "C" int stem_conv_bwd(const void* x, const void* g, const void* wt, void* dx, void* part,
                             void* dw, int B, int Cin, int Cout, int G, int H, int W,
                             int band_rows, int n_bands, int dtype, void* stream) {
    if (!stem::conv_shape_ok(B, Cout, Cin, G, H, W) || (dtype != 0 && dtype != 1) ||
        band_rows < 1 || n_bands < 1 || (long long)band_rows * n_bands < H ||
        (long long)band_rows * (n_bands - 1) >= H || B > 65535)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaSuccess;
    if (dx != nullptr) {
        err = dtype == 0
                  ? stem::launch_conv3x3<bf16, bf16>(g, wt, nullptr, dx, B, Cout, Cin, G, H, W, s)
                  : stem::launch_conv3x3<float, bf16>(g, wt, nullptr, dx, B, Cout, Cin, G, H, W, s);
        if (err != cudaSuccess) return (int)err;
    }
    float* p = static_cast<float*>(part);
    float* d = static_cast<float*>(dw);
    err = dtype == 0 ? launch_dw<bf16>(x, g, p, d, B, Cin, Cout, G, H, W, band_rows, n_bands, s)
                     : launch_dw<float>(x, g, p, d, B, Cin, Cout, G, H, W, band_rows, n_bands, s);
    return (int)err;
}

extern "C" const char* stem_conv_bwd_error(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
