// Stem conv backward for Hopper (sm_90a), the port of
// gssd_tpu/ops/pallas/stem_conv.py _bwd_kernel (conv3x3_wide's VJP), with
// its arithmetic: g, x and the flipped weights rounded to bf16, products
// on the tensor cores with f32 sums, dx rounded once to x's dtype, dW
// kept f32. One launch runs up to three kernels:
//
// 1. dx (when asked for), per group an implicit GEMM [pixels x 9 cgo] .
//    [9 cgo x cgi]: dx[b, ci, y, x] = sum_{j, ky, kx} bf16(g[b, j, y + ky
//    - 1, x + kx - 1]) * wt[ci, j, ky, kx], wt the flipped, transposed
//    weights. A block owns 8 x 64 pixels of one image and one group; it
//    stages g with its one-pixel halo once (8- or 16-byte loads where W is
//    a multiple of 4), channels innermost ([pixel][j], bf16), and the
//    weights as [tap][j chunk][ci][16 j] (packed once a launch by
//    pack_dx_weights, copied with 16-byte loads); each warp owns
//    one row (four 16-pixel fragments) and runs, per tap and 16-channel
//    chunk of j, mma.sync.m16n8k16 with A loaded by ldmatrix from the
//    halo tile shifted by the tap (each lane points at its own pixel row).
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

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

// Four consecutive elements of a row of g or x, raw: one 8-byte (bf16) or
// 16-byte (f32) load where `vec` (W a multiple of 4, 16-byte aligned
// tensors), else four element loads; zeros past the row's end
template <typename T> struct Quad;
template <> struct Quad<bf16> {
    uint2 v;
    __device__ void load(const bf16* row, int gx0, int W, bool vec) {
        if (vec) {
            v = gx0 < W ? __ldg(reinterpret_cast<const uint2*>(row + gx0)) : make_uint2(0, 0);
            return;
        }
        uint16_t e[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
            e[i] = gx0 + i < W ? __ldg(reinterpret_cast<const unsigned short*>(row + gx0 + i)) : 0;
        v = make_uint2(e[0] | (uint32_t)e[1] << 16, e[2] | (uint32_t)e[3] << 16);
    }
    __device__ bf16 get(int i) const {
        const uint32_t w = i < 2 ? v.x : v.y;
        return __ushort_as_bfloat16((unsigned short)(i % 2 ? w >> 16 : w & 0xffff));
    }
};
template <> struct Quad<float> {
    float4 v;
    __device__ void load(const float* row, int gx0, int W, bool vec) {
        if (vec) {
            v = gx0 < W ? __ldg(reinterpret_cast<const float4*>(row + gx0))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
            return;
        }
        float e[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) e[i] = gx0 + i < W ? __ldg(row + gx0 + i) : 0.f;
        v = make_float4(e[0], e[1], e[2], e[3]);
    }
    __device__ bf16 get(int i) const {
        return __float2bfloat16(i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w);
    }
};

// ---- dx -------------------------------------------------------------------

constexpr int DX_TH = 8;               // pixel rows a block
constexpr int DX_TW = 64;              // pixel columns a block
constexpr int DX_THREADS = 32 * DX_TH; // a warp a row
constexpr int HALO = (DX_TH + 2) * (DX_TW + 2);
constexpr int WROW = 24;               // a weight row: 16 j + 8 pad (48 bytes)

// bf16 elements a halo pixel takes: 16 j a chunk + 8 pad (a stride of
// 16 mod 128 bytes, so the 8 rows of an ldmatrix hit 8 bank groups)
__host__ __device__ constexpr int dx_pixel_stride(int nch) { return 16 * nch + 8; }

// bf16 elements of one group's packed dx weights [9][nch][NT * 8][WROW]
__host__ __device__ constexpr int dx_weight_elems(int nch, int nt) { return 9 * nch * nt * 8 * WROW; }

template <int NT>
__host__ __device__ constexpr int dx_smem_bytes(int nch) {
    return 2 * (HALO * dx_pixel_stride(nch) + dx_weight_elems(nch, NT));
}

// wpack[grp][tap][jc][ci][jj] = wt[grp * cgi + ci, 16 jc + jj, tap], zero
// past cgi, cgo and in the 8 pad elements of a row: each block of the dx
// kernel copies its group's slice with 16-byte loads
__global__ void pack_dx_weights(const bf16* __restrict__ wt, bf16* __restrict__ wpack, int G,
                                int cgi, int cgo, int nch, int nt) {
    const int per = dx_weight_elems(nch, nt);
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= G * per) return;
    const int grp = i / per, r = i % per;
    const int jj = r % WROW, ci = (r / WROW) % (nt * 8), jc = (r / (WROW * nt * 8)) % nch;
    const int tap = r / (WROW * nt * 8 * nch);
    const int j = 16 * jc + jj;
    wpack[i] = ci < cgi && jj < 16 && j < cgo ? wt[((size_t)(grp * cgi + ci) * cgo + j) * 9 + tap]
                                              : __float2bfloat16(0.0f);
}

// g [B, Cout, H, W] of type T; wpack the packed weights; dx [B, Cin, H,
// W] of type T. NT: 8-wide tiles of ci (cgi <= 8 NT); Cout / G <= 64.
// Grid (ceil(W / DX_TW), ceil(H / DX_TH), B * G). `vec`: W is a multiple
// of 4 and g and dx are 16-byte aligned.
// loads a thread makes per 16 channels of the halo tile: quads, halo values
constexpr int DQ = 16 * (DX_TH + 2) * (DX_TW / 4) / DX_THREADS;
constexpr int DH = (16 * (DX_TH + 2) * 2 + DX_THREADS - 1) / DX_THREADS;

template <typename T, int NT>
__global__ void __launch_bounds__(DX_THREADS)
dx_mma_kernel(const T* __restrict__ g, const bf16* __restrict__ wpack, T* __restrict__ dx,
              int Cin, int Cout, int G, int H, int W, int vec) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int cgi = Cin / G, cgo = Cout / G;
    const int nch = (cgo + 15) / 16;
    const int ps = dx_pixel_stride(nch);
    bf16* gs = reinterpret_cast<bf16*>(smem_raw);  // [HALO][ps]
    bf16* ws = gs + HALO * ps;                      // [9][nch][NT * 8][WROW]

    const int grp = blockIdx.z % G, b = blockIdx.z / G;
    const int x0 = blockIdx.x * DX_TW, y0 = blockIdx.y * DX_TH;
    const int tid = threadIdx.x;
    const size_t plane = (size_t)H * W;
    const T* gb = g + ((size_t)b * Cout + (size_t)grp * cgo) * plane;

    const int wn = dx_weight_elems(nch, NT) / 8;  // 16-byte chunks
    const uint4* wsrc = reinterpret_cast<const uint4*>(wpack) + (size_t)grp * wn;
    for (int i = tid; i < wn; i += DX_THREADS) reinterpret_cast<uint4*>(ws)[i] = __ldg(wsrc + i);
    // g with its halo, 16 channels at a time: every load of a thread in
    // flight before its stores (quads of the 32 interior columns, then the
    // two halo columns)
    for (int jc = 0; jc < nch; ++jc) {
        Quad<T> q[DQ];
        float h[DH];
#pragma unroll
        for (int k = 0; k < DQ; ++k) {
            const int i = tid + k * DX_THREADS;
            const int j = 16 * jc + i / ((DX_TH + 2) * (DX_TW / 4));
            const int rem = i % ((DX_TH + 2) * (DX_TW / 4));
            const int gy = y0 + rem / (DX_TW / 4) - 1;
            if (j < cgo && gy >= 0 && gy < H)
                q[k].load(gb + (size_t)j * plane + (size_t)gy * W, x0 + 4 * (rem % (DX_TW / 4)), W,
                          vec);
            else
                q[k].load(gb, W, W, true);  // zeros
        }
#pragma unroll
        for (int k = 0; k < DH; ++k) {
            const int i = tid + k * DX_THREADS;
            const int j = 16 * jc + i / ((DX_TH + 2) * 2), rem = i % ((DX_TH + 2) * 2);
            const int gy = y0 + rem / 2 - 1, gx = rem % 2 ? x0 + DX_TW : x0 - 1;
            h[k] = i < 16 * (DX_TH + 2) * 2 && j < cgo && gy >= 0 && gy < H && gx >= 0 && gx < W
                       ? stem::to_f32(gb[(size_t)j * plane + (size_t)gy * W + gx])
                       : 0.f;
        }
#pragma unroll
        for (int k = 0; k < DQ; ++k) {
            const int i = tid + k * DX_THREADS;
            const int jl = i / ((DX_TH + 2) * (DX_TW / 4)), rem = i % ((DX_TH + 2) * (DX_TW / 4));
            const int p0 = rem / (DX_TW / 4) * (DX_TW + 2) + 1 + 4 * (rem % (DX_TW / 4));
#pragma unroll
            for (int e = 0; e < 4; ++e) gs[(p0 + e) * ps + 16 * jc + jl] = q[k].get(e);
        }
#pragma unroll
        for (int k = 0; k < DH; ++k) {
            const int i = tid + k * DX_THREADS;
            if (i >= 16 * (DX_TH + 2) * 2) continue;
            const int jl = i / ((DX_TH + 2) * 2), rem = i % ((DX_TH + 2) * 2);
            const int p = rem / 2 * (DX_TW + 2) + (rem % 2 ? DX_TW + 1 : 0);
            gs[p * ps + 16 * jc + jl] = __float2bfloat16(h[k]);
        }
    }
    __syncthreads();

    const int warp = tid / 32, lane = tid % 32;
    const int lg = lane / 4, lt = lane % 4;
    float acc[4][NT][4];
#pragma unroll
    for (int f = 0; f < 4; ++f)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) acc[f][nt][0] = acc[f][nt][1] = acc[f][nt][2] = acc[f][nt][3] = 0.0f;

    for (int tap = 0; tap < 9; ++tap) {
        const int ky = tap / 3, kx = tap % 3;
        for (int jc = 0; jc < nch; ++jc) {
            uint32_t bw[NT][2];
            const bf16* wrow = ws + (tap * nch + jc) * NT * 8 * WROW;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
                bw[nt][0] = lds32(wrow + (nt * 8 + lg) * WROW + 2 * lt);
                bw[nt][1] = lds32(wrow + (nt * 8 + lg) * WROW + 2 * lt + 8);
            }
#pragma unroll
            for (int f = 0; f < 4; ++f) {
                // fragment f: pixel row `warp`, columns 16 f ..
                const int hp = (warp + ky) * (DX_TW + 2) + 16 * f + lane % 16 + kx;
                uint32_t a[4];
                ldmatrix_x4(a, gs + hp * ps + 16 * jc + 8 * (lane / 16));
#pragma unroll
                for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[f][nt], a, bw[nt][0], bw[nt][1]);
            }
        }
    }

    // the output, 8 channels at a time, through shared memory (the halo
    // tile is consumed) into whole 4-pixel stores
    T* dxb = dx + ((size_t)b * Cin + (size_t)grp * cgi) * plane;
    T* os = reinterpret_cast<T*>(smem_raw);  // [8 ci][DX_TH][DX_TW]
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
        __syncthreads();
#pragma unroll
        for (int f = 0; f < 4; ++f)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int e = 0; e < 2; ++e)
                    os[((2 * lt + e) * DX_TH + warp) * DX_TW + 16 * f + lg + 8 * h] =
                        stem::from_f32<T>(acc[f][nt][2 * h + e]);
        __syncthreads();
#pragma unroll
        for (int k = 0; k < 8 * DX_TH * DX_TW / 4 / DX_THREADS; ++k) {
            const int i = tid + k * DX_THREADS;
            const int cl = i / (DX_TH * DX_TW / 4), r = i / (DX_TW / 4) % DX_TH, q = i % (DX_TW / 4);
            const int ci = 8 * nt + cl, y = y0 + r, xq = x0 + 4 * q;
            if (ci >= cgi || y >= H || xq >= W) continue;
            const T* src = os + (cl * DX_TH + r) * DX_TW + 4 * q;
            T* dst = dxb + (size_t)ci * plane + (size_t)y * W + xq;
            if (vec) {
                if constexpr (sizeof(T) == 2)
                    *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
                else
                    *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
            } else {
                for (int e = 0; e < 4 && xq + e < W; ++e) dst[e] = src[e];
            }
        }
    }
}

template <typename T, int NT>
cudaError_t launch_dx_nt(const void* g, const void* wt, bf16* wpack, void* dx, int B, int Cin,
                         int Cout, int G, int H, int W, cudaStream_t stream) {
    const int nch = (Cout / G + 15) / 16;
    const int n = G * dx_weight_elems(nch, NT);
    pack_dx_weights<<<(n + 255) / 256, 256, 0, stream>>>(static_cast<const bf16*>(wt), wpack, G,
                                                         Cin / G, Cout / G, nch, NT);
    const int smem = dx_smem_bytes<NT>(nch);
    cudaError_t err = cudaFuncSetAttribute(dx_mma_kernel<T, NT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((W + DX_TW - 1) / DX_TW, (H + DX_TH - 1) / DX_TH, B * G);
    const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(dx) % 16 == 0;
    dx_mma_kernel<T, NT><<<grid, DX_THREADS, smem, stream>>>(
        static_cast<const T*>(g), wpack, static_cast<T*>(dx), Cin, Cout, G, H, W, vec);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dx(const void* g, const void* wt, bf16* wpack, void* dx, int B, int Cin,
                      int Cout, int G, int H, int W, cudaStream_t stream) {
    const int cgi = Cin / G;
    if (cgi <= 16) return launch_dx_nt<T, 2>(g, wt, wpack, dx, B, Cin, Cout, G, H, W, stream);
    if (cgi <= 32) return launch_dx_nt<T, 4>(g, wt, wpack, dx, B, Cin, Cout, G, H, W, stream);
    return launch_dx_nt<T, 8>(g, wt, wpack, dx, B, Cin, Cout, G, H, W, stream);
}

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
// G * 9 * 4 * 64 * 24 bf16 (the packed dx weights); part [n_bands * B,
// Cout, Cin / G, 9] f32 scratch; dw [Cout, Cin / G, 3, 3] f32. band_rows
// * n_bands covers H; Cin / G and Cout / G <= 64 where dx is asked for.
// All contiguous, 16-byte aligned. Returns the CUDA error code of the
// first launch that failed (0 on success).
extern "C" int stem_conv_bwd(const void* x, const void* g, const void* wt, void* dx, void* wpack,
                             void* part, void* dw, int B, int Cin, int Cout, int G, int H, int W,
                             int band_rows, int n_bands, int dtype, void* stream) {
    if (!stem::conv_shape_ok(B, Cout, Cin, G, H, W) || (dtype != 0 && dtype != 1) ||
        band_rows < 1 || n_bands < 1 || (long long)band_rows * n_bands < H ||
        (long long)band_rows * (n_bands - 1) >= H || B > 65535 ||
        (dx != nullptr && (Cin / G > 64 || Cout / G > 64)))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaSuccess;
    if (dx != nullptr) {
        bf16* wp = static_cast<bf16*>(wpack);
        err = dtype == 0 ? launch_dx<bf16>(g, wt, wp, dx, B, Cin, Cout, G, H, W, s)
                         : launch_dx<float>(g, wt, wp, dx, B, Cin, Cout, G, H, W, s);
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
