// Stem conv backward for Hopper (sm_90a), the port of
// gssd_tpu/ops/pallas/stem_conv.py _bwd_kernel (conv3x3_wide's VJP), with
// its arithmetic: g, x and the flipped weights rounded to bf16, products
// on the tensor cores with f32 sums, dx rounded once to x's dtype, dW
// kept f32. One launch runs up to three kernels:
//
// 1. dx (when asked for): dx[b, ci, y, x] = sum_{j, ky, kx} bf16(g[b, j,
//    y + ky - 1, x + kx - 1]) * wt[ci, j, ky, kx], wt the flipped,
//    transposed weights: the forward's conv of g (stem_conv.cuh, one bf16
//    part, no bias), its weights packed first in the same launch.
// 2. dW partial sums, per group [9 cgi x pixels] . [pixels x cgo]:
//    dW[co, ci, ky, kx] = sum_{b, y, x} bf16(x[b, ci, y + ky - 1, x + kx -
//    1]) * bf16(g[b, co, y, x]) (the TPU's dense block-diagonal dW holds
//    it on its diagonal blocks and zeros elsewhere). A block owns one
//    image, one band of rows and 16 x 16 (co, ci) of one group, and walks
//    its band in 8 x 64 pixel tiles staged in shared memory: x in three
//    copies shifted by kx (so that every ldmatrix row is 16-byte aligned)
//    and g planar. Each thread loads the next tile's share of x and g into
//    registers (8- or 16-byte loads where W is a multiple of 4) while the
//    current tile is computed, and stores it after. Rows of A are the
//    (ci, tap) pairs, 144 at 16 channels (27, padded to 32, at conv1_1);
//    B is g. Two warps own each pixel row
//    of the tile (the first 5 and the last 4 m-tiles): the 4 k-steps of
//    the row go into a fresh accumulator, added to the warp's sum in f32
//    (a long mma chain drifts in its own accumulation: PERF.md §6); the
//    8 rows' sums are added in row order at the end of the band, and the
//    block writes its partial.
// 3. The sum of those partials over bands and images, in one fixed
//    order: dW stays f32 and is never rounded, as in JAX, where only
//    pack_weights' slice lies between the kernel's f32 dW and the f32
//    parameter.
// The TPU kernel carries dW in a revisited output block across its
// sequential (batch, row tile) grid. Blocks here run in parallel; the
// partials and their ordered sum keep the result independent of the
// schedule. No atomics.
//
// What bounds it: at conv1_2 (batch 16, 300 x 300, 64 -> 64, 4 groups)
// x, g and dx move 552 MB (0.17 ms at 3.35 TB/s); dx and dW do 53 GFLOP
// of grouped products, 0.05 ms on the tensor cores.

#include "mma_sync.cuh"
#include "stem_conv.cuh"

namespace {

using namespace mma16816;
using stem::bf16;
using stem::Quad;

// ---- dW -------------------------------------------------------------------

constexpr int SX = 64;          // pixel tile: columns
constexpr int SY = 8;           // pixel tile: rows (two warps each)
constexpr int DCO = 16;         // output channels per block
constexpr int DCI = 16;         // input channels per block
constexpr int DW_THREADS = 2 * 32 * SY;
constexpr int NCOL = DCI * 9;   // (ci, tap) rows of A a block: 144, 9 m-tiles
constexpr int MH = (NCOL / 16 + 1) / 2;  // m-tiles a warp: the first 5 or the last 4
// x copies: rows of XROW bf16 (176 bytes, 48 mod 128), planes of XPL (1808
// bytes, 16 mod 128), copies of XCOPY (16 mod 128): the address of row
// n = ci * 9 + ky * 3 + kx of A, mod 128 bytes, is 16 (n + 3 r) + const (r
// the pixel row),
// so the 8 rows of an ldmatrix hit 8 bank groups
constexpr int XROW = 88;
constexpr int XPL = 904;
constexpr int XCOPY = DCI * XPL + 8;
constexpr int GPL = SY * SX + 8;  // g planes: 1040 bytes, 16 mod 128
constexpr int DW_SMEM = 2 * (3 * XCOPY + DCO * GPL);

// staging work a thread does per tile: x's 4-wide groups of the 64
// interior columns (16 channels x 10 rows), x's two halo columns, g's
// groups (16 channels x 8 rows)
constexpr int XQ = (DCI * (SY + 2) * (SX / 4) + DW_THREADS - 1) / DW_THREADS;
constexpr int XH = (DCI * (SY + 2) * 2 + DW_THREADS - 1) / DW_THREADS;
constexpr int GQ = (DCO * SY * (SX / 4) + DW_THREADS - 1) / DW_THREADS;

// one tile's x and g in registers, loaded for the next tile while the
// current one is computed
template <typename T>
struct TileRegs {
    Quad<T> xq[XQ], gq[GQ];
    float xh[XH];

    __device__ void load(const T* xb, const T* gb, size_t plane, int H, int W, int ye, int ty0,
                         int tx0, int nci, int nco, bool vec) {
        const int tid = threadIdx.x;
#pragma unroll
        for (int k = 0; k < XQ; ++k) {
            const int i = tid + k * DW_THREADS;
            const int ci = i / ((SY + 2) * (SX / 4)), rem = i % ((SY + 2) * (SX / 4));
            const int gy = ty0 + rem / (SX / 4) - 1;
            if (ci < nci && gy >= 0 && gy < H)
                xq[k].load(xb + (size_t)ci * plane + (size_t)gy * W, tx0 + 4 * (rem % (SX / 4)), W,
                           vec);
            else
                xq[k].load(xb, W, W, true);  // zeros
        }
#pragma unroll
        for (int k = 0; k < XH; ++k) {
            const int i = tid + k * DW_THREADS;
            const int ci = i / ((SY + 2) * 2), rem = i % ((SY + 2) * 2);
            const int gy = ty0 + rem / 2 - 1, gx = rem % 2 ? tx0 + SX : tx0 - 1;
            xh[k] = ci < nci && gy >= 0 && gy < H && gx >= 0 && gx < W
                        ? stem::to_f32(xb[(size_t)ci * plane + (size_t)gy * W + gx])
                        : 0.f;
        }
#pragma unroll
        for (int k = 0; k < GQ; ++k) {
            const int i = tid + k * DW_THREADS;
            const int co = i / (SY * (SX / 4)), rem = i % (SY * (SX / 4));
            const int gy = ty0 + rem / (SX / 4);
            // rows past the band belong to the next block's sum
            if (co < nco && gy < ye)
                gq[k].load(gb + (size_t)co * plane + (size_t)gy * W, tx0 + 4 * (rem % (SX / 4)), W,
                           vec);
            else
                gq[k].load(gb, W, W, true);  // zeros
        }
    }

    // x into its three shifted copies (copy kx holds halo column xx at xx
    // - kx, columns 0..63), g planar; bf16
    __device__ void store(bf16* xs, bf16* gsm, int nci, int nco) const {
        const int tid = threadIdx.x;
#pragma unroll
        for (int k = 0; k < XQ; ++k) {
            const int i = tid + k * DW_THREADS;
            const int ci = i / ((SY + 2) * (SX / 4)), rem = i % ((SY + 2) * (SX / 4));
            if (ci >= nci) continue;
            bf16* row = xs + ci * XPL + (rem / (SX / 4)) * XROW;
            const int xx0 = 1 + 4 * (rem % (SX / 4));
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const bf16 v = xq[k].get(e);
#pragma unroll
                for (int kx = 0; kx < 3; ++kx) {
                    const int idx = xx0 + e - kx;
                    if (idx >= 0 && idx < SX) row[kx * XCOPY + idx] = v;
                }
            }
        }
#pragma unroll
        for (int k = 0; k < XH; ++k) {
            const int i = tid + k * DW_THREADS;
            const int ci = i / ((SY + 2) * 2), rem = i % ((SY + 2) * 2);
            if (ci >= nci) continue;
            bf16* row = xs + ci * XPL + (rem / 2) * XROW;
            const bf16 v = __float2bfloat16(xh[k]);
            if (rem % 2) row[2 * XCOPY + SX - 1] = v;  // column 65: copy 2 only
            else row[0] = v;                             // column 0: copy 0 only
        }
#pragma unroll
        for (int k = 0; k < GQ; ++k) {
            const int i = tid + k * DW_THREADS;
            const int co = i / (SY * (SX / 4)), rem = i % (SY * (SX / 4));
            if (co >= nco) continue;
            bf16* dst = gsm + co * GPL + (rem / (SX / 4)) * SX + 4 * (rem % (SX / 4));
            __nv_bfloat162 lo, hi;
            lo.x = gq[k].get(0);
            lo.y = gq[k].get(1);
            hi.x = gq[k].get(2);
            hi.y = gq[k].get(3);
            reinterpret_cast<__nv_bfloat162*>(dst)[0] = lo;
            reinterpret_cast<__nv_bfloat162*>(dst)[1] = hi;
        }
    }
};

// x [B, Cin, H, W], g [B, Cout, H, W] of type T; part [n_bands * B, Cout,
// Cin / G, 9] f32. Grid (n_bands, B, G * n_co * n_ci). `vec`: W is a
// multiple of 4 and x, g are 16-byte aligned.
template <typename T>
__global__ void __launch_bounds__(DW_THREADS, 1)
dw_mma_kernel(const T* __restrict__ x, const T* __restrict__ g, float* __restrict__ part, int B,
              int Cin, int Cout, int G, int H, int W, int band_rows, int vec) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // 3 x [DCI][10][XROW] (+ pad)
    bf16* gsm = xs + 3 * XCOPY;                     // [DCO][GPL]
    float* red = reinterpret_cast<float*>(smem_raw);  // [DCO][NCOL], after the last tile

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
    const int ncols = nci * 9;
    const int mtiles = (ncols + 15) / 16;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int row = warp % SY, m0 = warp / SY * MH;  // the warp's pixel row and m-tiles
    const size_t plane = (size_t)H * W;
    const T* xb = x + ((size_t)b * Cin + (size_t)grp * cgi + ci0) * plane;
    const T* gb = g + ((size_t)b * Cout + (size_t)grp * cgo + co0) * plane;
    const int ys = band * band_rows, ye = min(H, ys + band_rows);
    const int ntx = (W + SX - 1) / SX;
    const int ntiles = (ye - ys + SY - 1) / SY * ntx;

    // rows of g past nco stay zero
    for (int i = tid; i < DCO * GPL; i += DW_THREADS) gsm[i] = __float2bfloat16(0.0f);
    // this lane's A row (n = 16 m + lane % 16) in each of the warp's
    // m-tiles m0 + mm, as an offset into xs at pixel (row, column 0)
    int arow[MH];
#pragma unroll
    for (int mm = 0; mm < MH; ++mm) {
        const int n = 16 * (m0 + mm) + lane % 16;
        const int ci = n / 9, ky = (n % 9) / 3, kx = n % 3;
        arow[mm] = n < ncols ? kx * XCOPY + ci * XPL + (row + ky) * XROW : 0;
    }

    float acc[MH][2][4];
#pragma unroll
    for (int mm = 0; mm < MH; ++mm)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) acc[mm][nt][0] = acc[mm][nt][1] = acc[mm][nt][2] = acc[mm][nt][3] = 0.0f;

    TileRegs<T> regs;
    regs.load(xb, gb, plane, H, W, ye, ys, 0, nci, nco, vec != 0);
    for (int t = 0; t < ntiles; ++t) {
        __syncthreads();  // the previous tile is consumed
        regs.store(xs, gsm, nci, nco);
        __syncthreads();
        if (t + 1 < ntiles)
            regs.load(xb, gb, plane, H, W, ye, ys + (t + 1) / ntx * SY, (t + 1) % ntx * SX, nci,
                      nco, vec != 0);

        // B = g of the warp's row: k-step s, co tiles 0 and 1
        uint32_t bg[4][4];
#pragma unroll
        for (int s = 0; s < 4; ++s)
            ldmatrix_x4(bg[s], gsm + (lane % 8 + 8 * (lane / 16)) * GPL + row * SX + 16 * s +
                                   8 * ((lane / 8) % 2));
#pragma unroll
        for (int mm = 0; mm < MH; ++mm) {
            if (m0 + mm >= mtiles) break;
            float fresh[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
            for (int s = 0; s < 4; ++s) {
                uint32_t a[4];
                ldmatrix_x4(a, xs + arow[mm] + 16 * s + 8 * (lane / 16));
                mma_bf16(fresh[0], a, bg[s][0], bg[s][1]);
                mma_bf16(fresh[1], a, bg[s][2], bg[s][3]);
            }
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[mm][nt][e] += fresh[nt][e];
        }
    }

    // the rows' sums in row order (the two warps of a row own different
    // m-tiles), then the block's partial
    const int lg = lane / 4, lt = lane % 4;
    for (int r = 0; r < SY; ++r) {
        __syncthreads();
        if (row == r) {
#pragma unroll
            for (int mm = 0; mm < MH; ++mm) {
                if (m0 + mm >= NCOL / 16) break;
#pragma unroll
                for (int nt = 0; nt < 2; ++nt)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        // D row n = 16 m + lg + 8 (e / 2), column co = 8 nt + 2 lt + e % 2
                        float& v = red[(8 * nt + 2 * lt + e % 2) * NCOL + 16 * (m0 + mm) + lg +
                                       8 * (e / 2)];
                        v = (r == 0 ? 0.0f : v) + acc[mm][nt][e];
                    }
            }
        }
    }
    __syncthreads();
    for (int i = tid; i < nco * ncols; i += DW_THREADS) {
        const int co = i / ncols, n = i % ncols;
        part[((size_t)(band * B + b) * Cout + grp * cgo + co0 + co) * cgi * 9 + ci0 * 9 + n] =
            red[co * NCOL + n];
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
    cudaError_t err = cudaFuncSetAttribute(dw_mma_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, DW_SMEM);
    if (err != cudaSuccess) return err;
    const dim3 grid(n_bands, B, G * n_co * n_ci);
    const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(g) % 16 == 0;
    dw_mma_kernel<T><<<grid, DW_THREADS, DW_SMEM, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), part, B, Cin, Cout, G, H, W,
        band_rows, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int n = Cout * (Cin / G) * 9;
    dw_reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(part, dw, n_bands * B, n);
    return cudaGetLastError();
}

}  // namespace

// x [B, Cin, H, W] and g [B, Cout, H, W] of one dtype (dtype 0: bf16, 1:
// f32); wt [Cin, Cout / G, 3, 3] bf16, the flipped transposed weights;
// dx [B, Cin, H, W] in x's dtype, or null to skip it; wpack scratch of
// stem_conv_bwd_wpack_elems bf16 (the packed dx weights); part [n_bands *
// B, Cout, Cin / G, 9] f32 scratch; dw [Cout, Cin / G, 3, 3] f32.
// band_rows * n_bands covers H; Cin / G and Cout / G <= 64 where dx is
// asked for. All contiguous, 16-byte aligned. Returns the CUDA error code
// of the first launch that failed (0 on success).
extern "C" int stem_conv_bwd(const void* x, const void* g, const void* wt, void* dx, void* wpack,
                             void* part, void* dw, int B, int Cin, int Cout, int G, int H, int W,
                             int band_rows, int n_bands, int dtype, void* stream) {
    if (!stem::conv_shape_ok(B, Cout, Cin, G, H, W) || (dtype != 0 && dtype != 1) ||
        band_rows < 1 || n_bands < 1 || (long long)band_rows * n_bands < H ||
        (long long)band_rows * (n_bands - 1) >= H || B > 65535 ||
        (long long)G * ((Cin / G + DCI - 1) / DCI) * ((Cout / G + DCO - 1) / DCO) > 65535 ||
        (dx != nullptr && !stem::conv_ok(Cout / G, Cin / G)))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaSuccess;
    if (dx != nullptr) {
        // dx is the forward's conv of g with the flipped, transposed weights
        const bf16* w = static_cast<const bf16*>(wt);
        bf16* wp = static_cast<bf16*>(wpack);
        const int CI = Cout / G, CO = Cin / G;
        err = dtype == 0 ? stem::launch_conv<bf16, 1>(g, w, nullptr, wp, dx, B, G, CI, CO, H, W, s)
                         : stem::launch_conv<float, 1>(g, w, nullptr, wp, dx, B, G, CI, CO, H, W, s);
        if (err != cudaSuccess) return (int)err;
    }
    float* p = static_cast<float*>(part);
    float* d = static_cast<float*>(dw);
    err = dtype == 0 ? launch_dw<bf16>(x, g, p, d, B, Cin, Cout, G, H, W, band_rows, n_bands, s)
                     : launch_dw<float>(x, g, p, d, B, Cin, Cout, G, H, W, band_rows, n_bands, s);
    return (int)err;
}

// bf16 elements of the wpack scratch the dx of a launch at these sizes takes
extern "C" long stem_conv_bwd_wpack_elems(int Cin, int Cout, int G) {
    return stem::conv_wpack_elems(Cout / G, Cin / G, G, 1);
}

extern "C" const char* stem_conv_bwd_error(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
