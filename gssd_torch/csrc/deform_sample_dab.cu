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
// Each pass is a GEMM, [P x (r, c)] . [(r, c) x q], whose A operand
// bf16(S[p, r] * g[p, c]) is built in registers: for dA, S = B, r = qx and
// q = qy; for dB, S = A, r = qy and q = qx. The TPU kernel contracts all
// R columns r of every p, but S[p, :] is a hat row with at most two
// non-zeros, so almost every product is with an exact zero. Here:
//
// 1. hat_ranges (csrc/hat_ranges.cuh) stores the first and last non-zero
//    index of each A and B row;
// 2. dab_buckets, one block per (n, pass), sorts the p of its n by the
//    first non-zero index (lo) of their S row (stable: ascending p within
//    a bucket; all-zero rows in a bucket of their own) and cuts each
//    bucket into tiles of up to 64 p: each warp counts the keys of one
//    segment of p (lanes with one key found by __match_any_sync), the
//    counts are scanned, each warp places its segment in p order, and
//    each tile gets the largest last non-zero index among its p;
// 3. the product kernel (one launch per pass) gives a block one tile and
//    up to 64 q (four warps of 16 p); it walks r from the bucket's lo to
//    the tile's largest last non-zero index (two values of r at hat rows,
//    where the dense contraction walks all R), in the loop nest of the
//    dense kernel: channel chunks of 64, then r ascending, then the k16
//    steps, on mma.sync bf16 with f32 accumulators. Per (r, 16 channels)
//    a thread multiplies its 8 g values by S[p, r] and packs them into
//    the A fragment; x tiles [q][c] and the g rows of a chunk come by
//    cp.async, double-buffered, and x feeds the tensor cores through
//    ldmatrix. A tile of all-zero rows writes zero rows. Each p's row is
//    written by one block, so there are no partial sums.
//
// Rounding: the terms dropped are products with exact zeros (S[p, r] = 0
// gives bf16(0 * g) = 0), and every output element's (chunk, r, k-step)
// order is the dense kernel's with those steps left out, so at finite
// inputs the result is the dense tensor-core order's.
//
// What bounds it: the bytes, x and g read once (94.6 MB each at batch 32,
// 38x38, Cg 256), A and B (28 MB) and dA, dB written (56 MB), ~0.082 ms
// at 3.35 TB/s; the products left, 2 * (2 H + 2 W) * Cg MACs a pixel at
// hat rows, take ~0.015 ms on the tensor cores. Takes any H and W and Cg
// a multiple of 8; edges are masked.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hat_ranges.cuh"
#include "mma_sync.cuh"

namespace {

typedef __nv_bfloat16 bf16;
using mma16816::ldmatrix_x4;
using mma16816::mma_bf16;

constexpr int TPB = 64;       // pixels per tile: 4 warps x 16 rows
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int CC = 64;        // channels per chunk: 4 k-steps of 16
constexpr int QT = 64;        // q per block: 8 n-tiles of 8
constexpr int PAD = 8;
constexpr int LDC = CC + PAD;  // smem row of a [q][c] or [p][c] tile
constexpr int BUCKET_WARPS = 16;
constexpr int BUCKET_THREADS = BUCKET_WARPS * 32;
constexpr unsigned FULL = 0xffffffffu;

// scratch, per pass (0: dA, 1: dB) and n: plist [round4(P)] ints, the p
// in bucket order, then tiles [T] int4 (first index into plist, count <=
// TPB, the bucket's lo, the largest last non-zero index among its p),
// count 0 past the last tile
__host__ __device__ __forceinline__ int round4(int P) { return (P + 3) / 4 * 4; }
__host__ __device__ __forceinline__ int max_tiles(int P, int H, int W) {
    return (P + TPB - 1) / TPB + (H > W ? H : W) + 1;
}
__host__ __device__ __forceinline__ long slot_ints(int P, int H, int W) {
    return round4(P) + 4L * max_tiles(P, H, W);
}
// the bucket kernel's counts, per (pass, n), in scratch after the slots
__host__ __device__ __forceinline__ long work_ints(int H, int W) {
    return (BUCKET_WARPS + 3L) * ((H > W ? H : W) + 1) + 1;
}
// all of the scratch: both passes' slots and counts for every n
__host__ __device__ __forceinline__ long scratch_ints(int NG, int P, int H, int W) {
    return 2L * NG * (slot_ints(P, H, W) + work_ints(H, W));
}

// bf16(s * lo) in the low half, bf16(s * hi) in the high half, where the
// word holds two bf16 values (lo in the low half)
__device__ __forceinline__ uint32_t scaled_pair(float s, uint32_t word) {
    const float lo = __uint_as_float(word << 16);
    const float hi = __uint_as_float(word & 0xffff0000u);
    __nv_bfloat162 v = __floats2bfloat162_rn(s * lo, s * hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// the bucket of a pixel in pass SIDE: its S row's lo, or R for an
// all-zero row
__device__ __forceinline__ int bucket_key(int4 r, int side, int H, int W) {
    return side == 0 ? (r.z <= r.w ? r.z : W) : (r.x <= r.y ? r.x : H);
}

// each warp of the bucket kernel walks one contiguous segment of p, 32 at
// a time; the lanes with the same key share one leader, which adds their
// count (pass 1) or places them after its warp's earlier ones (pass 2)
__device__ __forceinline__ void segment_pass(const int4* __restrict__ rn, int* own, int* plist,
                                             int p0, int p1, int side, int H, int W,
                                             bool place) {
    const int lane = threadIdx.x % 32;
    for (int i0 = p0; i0 < p1; i0 += 32) {
        const int p = i0 + lane;
        const bool live = p < p1;
        const int k = live ? bucket_key(rn[p], side, H, W) : -1 - lane;  // dead: no peers
        const unsigned peers = __match_any_sync(FULL, k);
        const int leader = __ffs(peers) - 1;
        const int start = __shfl_sync(FULL, live && lane == leader ? own[k] : 0, leader);
        if (place && live) plist[start + __popc(peers & ((1u << lane) - 1))] = p;
        __syncwarp();
        if (live && lane == leader) own[k] = start + __popc(peers);
        __syncwarp();
    }
}

// one block per (n, pass): the pixels of n in bucket order, stable (p
// ascending within a bucket), and the tiles. Warp w owns the p of segment
// w and row w of `seen`: its count of each bucket (pass 1), then, after
// the scans, the next free index of each bucket for its segment (pass 2).
// Each count has one writer at a time.
__global__ void __launch_bounds__(BUCKET_THREADS)
dab_buckets(const int4* __restrict__ ranges, int* __restrict__ scratch, int P, int H, int W) {
    const int n = blockIdx.x, side = blockIdx.y, NG = gridDim.x;
    const int NB = (side == 0 ? W : H) + 1;
    int* work = scratch + 2L * NG * slot_ints(P, H, W) + ((size_t)side * NG + n) * work_ints(H, W);
    int* seen = work;                        // [BUCKET_WARPS][NB]
    int* count = seen + BUCKET_WARPS * NB;   // [NB]
    int* pstart = count + NB;                // [NB]: first index of each bucket
    int* tstart = pstart + NB;               // [NB + 1]: first tile of each bucket
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int4* rn = ranges + (size_t)n * P;
    int* plist = scratch + ((size_t)side * NG + n) * slot_ints(P, H, W);
    int4* tiles = reinterpret_cast<int4*>(plist + round4(P));
    const int T = max_tiles(P, H, W);
    const int seg = (P + BUCKET_WARPS * 32 - 1) / (BUCKET_WARPS * 32) * 32;
    const int p0 = min(P, warp * seg), p1 = min(P, p0 + seg);
    int* own = seen + warp * NB;

    for (int i = tid; i < BUCKET_WARPS * NB; i += BUCKET_THREADS) seen[i] = 0;
    __syncthreads();
    segment_pass(rn, own, plist, p0, p1, side, H, W, false);
    __syncthreads();
    for (int b = tid; b < NB; b += BUCKET_THREADS) {  // each warp's offset within a bucket
        int c = 0;
        for (int w = 0; w < BUCKET_WARPS; ++w) {
            const int v = seen[w * NB + b];
            seen[w * NB + b] = c;
            c += v;
        }
        count[b] = c;
    }
    __syncthreads();
    if (warp == 0) {  // exclusive scans of the pixel and tile counts
        int s = 0, t = 0;
        for (int b0 = 0; b0 < NB; b0 += 32) {
            const int b = b0 + lane;
            const int c = b < NB ? count[b] : 0;
            const int nt = (c + TPB - 1) / TPB;
            int cs = c, ts = nt;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const int u = __shfl_up_sync(FULL, cs, o), v = __shfl_up_sync(FULL, ts, o);
                if (lane >= o) cs += u, ts += v;
            }
            if (b < NB) pstart[b] = s + cs - c, tstart[b] = t + ts - nt;
            s += __shfl_sync(FULL, cs, 31);
            t += __shfl_sync(FULL, ts, 31);
        }
        if (lane == 0) tstart[NB] = t;
    }
    __syncthreads();
    for (int b = tid; b < NB; b += BUCKET_THREADS)
        for (int j = 0; j * TPB < count[b]; ++j)
            tiles[tstart[b] + j] =
                make_int4(pstart[b] + j * TPB, min(TPB, count[b] - j * TPB), b, 0);
    for (int t = tstart[NB] + tid; t < T; t += BUCKET_THREADS) tiles[t] = make_int4(0, 0, 0, 0);
    for (int i = tid; i < BUCKET_WARPS * NB; i += BUCKET_THREADS) seen[i] += pstart[i % NB];
    __syncthreads();
    segment_pass(rn, own, plist, p0, p1, side, H, W, true);
    __syncthreads();  // plist and the tiles are written
    for (int t = warp; t < tstart[NB]; t += BUCKET_WARPS) {  // each tile's last r
        const int4 tl = tiles[t];
        int hi = -1;
        for (int j = lane; j < tl.y; j += 32) {
            const int4 rr = rn[plist[tl.x + j]];
            hi = max(hi, side == 0 ? rr.w : rr.y);
        }
        hi = __reduce_max_sync(FULL, hi);
        if (lane == 0) tiles[t].w = hi;
    }
}

// SIDE 0: out = dA (S = B, R = W, Q = H); SIDE 1: out = dB (S = A, R = H, Q = W)
template <int SIDE>
__global__ void __launch_bounds__(THREADS)
abx_dab_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
               const bf16* __restrict__ S, const int* __restrict__ scratch,
               float* __restrict__ out, int P, int H, int W, int Cg) {
    __shared__ __align__(128) bf16 Gs[2][TPB][LDC];  // g rows of a chunk, by chunk parity
    __shared__ __align__(128) bf16 Xs[2][QT][LDC];   // x[q][c] of one r, by step parity
    __shared__ float Ss[2][TPB];                     // S[p, r] of one r, by step parity
    __shared__ int pix[TPB];

    const int R = SIDE == 0 ? W : H;
    const int Q = SIDE == 0 ? H : W;
    const int n = blockIdx.z, NG = gridDim.z;
    const int q0 = blockIdx.y * QT;
    const int* plist = scratch + ((size_t)SIDE * NG + n) * slot_ints(P, H, W);
    const int4 tile = reinterpret_cast<const int4*>(plist + round4(P))[blockIdx.x];
    const int cnt = tile.y, r0 = tile.z, r1 = tile.w;
    if (cnt == 0) return;  // past this n's last tile

    const int tid = threadIdx.x;
    const int warp = tid / 32, lane = tid % 32;
    const int gr = lane >> 2, tig = lane & 3;
    const int mi = lane >> 3, r8 = lane & 7;
    const bf16* xn = x + (size_t)n * H * W * Cg;
    const bf16* gn = g + (size_t)n * P * Cg;
    const bf16* Sn = S + (size_t)n * P * R;
    float* on = out + (size_t)n * P * Q;
    const int QN = min(QT, Q - q0);
    const int QP = (QN + 15) / 16 * 16;
    const int nt = QP / 8;  // n-tiles of q, even

    if (tid < TPB) pix[tid] = tid < cnt ? plist[tile.x + tid] : -1;
    __syncthreads();
    if (r0 == R) {  // all-zero S rows: zero rows out
        for (int i = tid; i < cnt * QN; i += THREADS)
            on[(size_t)pix[i / QN] * Q + q0 + i % QN] = 0.0f;
        return;
    }
    const int nr = r1 - r0 + 1;
    const int nsteps = (Cg + CC - 1) / CC * nr;

    // step s = (chunk s / nr, r = r0 + s % nr): x[q0 + q, r, c0 ..] (dA) or
    // x[r, q0 + q, ..] (dB) and S[p, r] into half `buf`, and at a chunk's
    // first r the chunk's g rows into half chunk & 1; zero outside the
    // map, past Cg and past the tile's pixels
    auto stage = [&](int s, int buf) {
        const int ci = s / nr, r = r0 + s - ci * nr, c0 = ci * CC;
        if (r == r0) {
            for (int i = tid; i < TPB * (CC / 8); i += THREADS) {
                const int row = i / (CC / 8), c = (i % (CC / 8)) * 8;
                bf16* d = &Gs[ci & 1][row][c];
                const int p = pix[row];
                if (p >= 0 && c0 + c < Cg)
                    __pipeline_memcpy_async(d, gn + (size_t)p * Cg + c0 + c, 16);
                else
                    *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
            }
        }
        for (int i = tid; i < QP * (CC / 8); i += THREADS) {
            const int q = i / (CC / 8), c = (i % (CC / 8)) * 8;
            bf16* d = &Xs[buf][q][c];
            if (q < QN && c0 + c < Cg) {
                const size_t cell = SIDE == 0 ? (size_t)(q0 + q) * W + r : (size_t)r * W + q0 + q;
                __pipeline_memcpy_async(d, xn + cell * Cg + c0 + c, 16);
            } else {
                *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
            }
        }
        if (tid < TPB) {
            const int p = pix[tid];
            Ss[buf][tid] = p >= 0 ? __bfloat162float(Sn[(size_t)p * R + r]) : 0.0f;
        }
    };

    float acc[QT / 8][4];
#pragma unroll
    for (int f = 0; f < QT / 8; ++f) acc[f][0] = acc[f][1] = acc[f][2] = acc[f][3] = 0.0f;
    const bool rows = warp * 16 < cnt;  // this warp holds pixels of the tile

    stage(0, 0);
    __pipeline_commit();
    for (int s = 0; s < nsteps; ++s) {
        if (s + 1 < nsteps) stage(s + 1, (s + 1) & 1);
        __pipeline_commit();
        __pipeline_wait_prior(1);
        __syncthreads();
        if (rows) {
            // the thread's g values of this chunk: rows gr, gr + 8; per
            // k-step the channel pairs 2 tig and 2 tig + 8
            const bf16* gs = &Gs[(s / nr) & 1][warp * 16 + gr][0];
            uint32_t gw[CC / 16][4];
#pragma unroll
            for (int kk = 0; kk < CC / 16; ++kk) {
                const bf16* lo = gs + kk * 16 + 2 * tig;
                const bf16* hi8 = lo + 8 * LDC;
                gw[kk][0] = *reinterpret_cast<const uint32_t*>(lo);
                gw[kk][1] = *reinterpret_cast<const uint32_t*>(hi8);
                gw[kk][2] = *reinterpret_cast<const uint32_t*>(lo + 8);
                gw[kk][3] = *reinterpret_cast<const uint32_t*>(hi8 + 8);
            }
            const float slo = Ss[s & 1][warp * 16 + gr], shi = Ss[s & 1][warp * 16 + gr + 8];
            const bf16* xs = &Xs[s & 1][0][0];
#pragma unroll
            for (int kk = 0; kk < CC / 16; ++kk) {
                const uint32_t a[4] = {scaled_pair(slo, gw[kk][0]), scaled_pair(shi, gw[kk][1]),
                                       scaled_pair(slo, gw[kk][2]), scaled_pair(shi, gw[kk][3])};
#pragma unroll
                for (int f = 0; f < QT / 8; f += 2) {
                    if (f < nt) {
                        uint32_t b[4];
                        ldmatrix_x4(b, xs + ((f + (mi >> 1)) * 8 + r8) * LDC + kk * 16 +
                                           (mi & 1) * 8);
                        mma_bf16(acc[f], a, b[0], b[1]);
                        mma_bf16(acc[f + 1], a, b[2], b[3]);
                    }
                }
            }
        }
        __syncthreads();  // this half is refilled two steps on
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int row = warp * 16 + gr + 8 * h;
        if (row >= cnt) continue;
        float* orow = on + (size_t)pix[row] * Q + q0;
#pragma unroll
        for (int f = 0; f < QT / 8; ++f) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int q = f * 8 + 2 * tig + e;
                if (q < QN) orow[q] = acc[f][2 * h + e];
            }
        }
    }
}

template <int SIDE>
cudaError_t launch(const bf16* x, const bf16* g, const bf16* S, const int* scratch, float* out,
                   int NG, int P, int H, int W, int Cg, cudaStream_t stream) {
    const int Q = SIDE == 0 ? H : W;
    const dim3 grid(max_tiles(P, H, W), (Q + QT - 1) / QT, NG);
    abx_dab_kernel<SIDE><<<grid, THREADS, 0, stream>>>(x, g, S, scratch, out, P, H, W, Cg);
    return cudaGetLastError();
}

}  // namespace

// the ints of scratch deform_sample_dab takes at these sizes
extern "C" long deform_sample_dab_scratch_ints(int NG, int P, int H, int W) {
    return scratch_ints(NG, P, H, W);
}

// x [NG,H,W,Cg], g [NG,P,Cg], A [NG,P,H], B [NG,P,W] bf16; dA [NG,P,H], dB
// [NG,P,W] f32; ranges [NG,P] int4 scratch; scratch
// deform_sample_dab_scratch_ints(NG, P, H, W) ints (both passes' buckets
// and their counts). All contiguous and 16-byte aligned; Cg a multiple
// of 8. Launches the range pass, the buckets, the dA pass and the dB
// pass on `stream`; returns the CUDA error code (0 on success).
extern "C" int deform_sample_dab(const void* x, const void* g, const void* A, const void* B,
                                 void* dA, void* dB, void* ranges, void* scratch, int NG, int P,
                                 int H, int W, int Cg, void* stream) {
    if (NG < 1 || NG > 65535 || P < 1 || H < 1 || W < 1 || Cg < 8 || Cg % 8)
        return (int)cudaErrorInvalidValue;
    const bf16* xx = static_cast<const bf16*>(x);
    const bf16* gg = static_cast<const bf16*>(g);
    const bf16* a = static_cast<const bf16*>(A);
    const bf16* b = static_cast<const bf16*>(B);
    const int4* rr = static_cast<const int4*>(ranges);
    int* sc = static_cast<int*>(scratch);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err =
        hat_ranges_pass::launch(a, b, static_cast<int4*>(ranges), (long)NG * P, H, W, s);
    if (err != cudaSuccess) return (int)err;
    dab_buckets<<<dim3(NG, 2), BUCKET_THREADS, 0, s>>>(rr, sc, P, H, W);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = launch<0>(xx, gg, b, sc, static_cast<float*>(dA), NG, P, H, W, Cg, s);
    if (err != cudaSuccess) return (int)err;
    return (int)launch<1>(xx, gg, a, sc, static_cast<float*>(dB), NG, P, H, W, Cg, s);
}

extern "C" const char* deform_sample_dab_error(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
