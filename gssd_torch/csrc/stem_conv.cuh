// Shared part of the stem conv kernels (stem_conv_fwd.cu, stem_conv_bwd.cu):
// one implicit-GEMM grouped 3x3, stride 1, zero "same" padding conv over
// NCHW tensors on the tensor cores, the forward's conv and the backward's
// dx,
//
//   out[b, grp CO + co, y, x] = T( bias[grp CO + co] + sum_{part p, ci < CI, ky, kx}
//       bf16(in[b, grp CI + ci, y + ky - 1, x + kx - 1]) * w[p][grp CO + co, ci, ky, kx] )
//
// with the input rounded to bf16 as it is staged, bf16 weights in P parts
// (the forward: w as one part, or f32 weights as three bf16 parts whose
// sum is w exactly; dx: the flipped, transposed weights, no bias), every
// product bf16 x bf16 (exact in f32), f32 sums, the f32 bias added to the
// f32 sum and one rounding to T (x's dtype) at the end.
//
// The TPU kernel (gssd_tpu/ops/pallas/stem_conv.py) densifies the groups
// into a block-diagonal [9 Cin, Cout] weight and multiplies im2col patches
// on the MXU. Here the conv is memory-bound (conv1_2 at batch 16 moves 368
// MB for 26.5 GFLOP of grouped products: 0.110 ms of bytes, 0.027 of bf16
// tensor work), so the design streams whole NCHW rows (PERF.md §6
// has the versions before this one and what each measured):
// - The grid fills the card once (two or three blocks an SM); each block
//   takes a contiguous share of all (image, group, column chunk, row),
//   the row fastest. A chunk is up to 304 columns: the whole row at 300 x
//   300, so that every output sector is written whole by one block. A
//   step computes 2 output rows.
// - A step's 2 new input rows are staged a step ahead by cp.async, 8
//   bytes (4 columns) a lane along whole rows, into a planar bf16 stage,
//   then transposed in shared memory (ldmatrix .trans, stmatrix) into a
//   ring of 4 input rows as [pixel][channel]: 16-byte chunks of 8
//   channels, XOR-swizzled by pixel so that 8 pixels of one chunk hit 8
//   bank groups. The tap's column shift is a row pointer.
// - mma.sync.m16n8k16: each warp owns m16 column tiles (the last MT % 8
//   split by output row). A = 16 pixels x 16 channels of one ring row
//   (one ldmatrix_x4 a row and kx, shared by the output rows it feeds),
//   B = the weights, packed once a launch into the fragments' order and
//   held in registers when they fit. One bf16 part of 16 channels sums
//   straight into the output row's f32 accumulator (9 mma a row, as the
//   dx kernel before it); three parts, or more channels, sum each (input
//   row, chunk) in a fresh accumulator, smallest part first, then add it
//   (a long mma chain drifts in its own accumulation, PERF.md §6).
// - conv1_1's 3 channels a group (CI = 3) are folded: a ring pixel holds
//   k = 3 kx + ci, so a row is one k16 step a ky (3 steps, not 9 steps of
//   3 channels padded to 16).
// - The output tile [row][channel][column] (stmatrix .trans of the
//   fragments) is written out early in the next step, beside the
//   transposes: whole rows, 4 columns a lane.
// Every sum runs in one fixed order: no atomics.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sync.cuh"

namespace stem {

typedef __nv_bfloat16 bf16;
using namespace mma16816;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16(v); }

// two values as one bf16 pair, a in the low half
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&v);
}

// Four consecutive elements of a row, raw: one 8-byte (bf16) or 16-byte
// (f32) load where `vec` (W a multiple of 4, 16-byte aligned tensors), else
// four element loads; zeros past the row's end
template <typename T> struct Quad;
template <> struct Quad<bf16> {
    uint2 v;
    __device__ void zero() { v = make_uint2(0, 0); }
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
    __device__ uint2 bf16x4() const { return v; }  // the four as bf16, packed
};
template <> struct Quad<float> {
    float4 v;
    __device__ void zero() { v = make_float4(0.f, 0.f, 0.f, 0.f); }
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
    __device__ float at(int i) const { return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w; }
    __device__ bf16 get(int i) const { return __float2bfloat16(at(i)); }
    __device__ uint2 bf16x4() const {
        return make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
    }
};

inline bool conv_shape_ok(int B, int Cin, int Cout, int G, int H, int W) {
    return B >= 1 && G >= 1 && Cin >= G && Cout >= G && Cin % G == 0 && Cout % G == 0 &&
           H >= 1 && W >= 1;
}

// ---- the implicit-GEMM conv ------------------------------------------------

constexpr int CONV_WARPS = 8;              // warps a block
constexpr int CONV_THREADS = 32 * CONV_WARPS;
constexpr int CONV_R = 2;                  // output rows a step
constexpr int CONV_RING = CONV_R + 2;      // input rows the ring holds
constexpr int CONV_MT = 19;                // most m16 tiles (16 columns) a column chunk
constexpr int CONV_STAGE_QUADS = 2560;     // most quads a step stages
constexpr int MAX_GROUP = 64;              // channels a group in and out

// A launch's shape of the conv. FOLD for CI = 3: a ring pixel holds k =
// 3 kx + ci. KC chunks of 16 input channels (1, 2 or 4). CB blocks of 16
// output channels. WREG: the weights of one chunk and one block, held in
// registers. MT m16 tiles a column chunk: the quads a step stages (R rows x
// CI channels x MT x 16 + 8 columns) stay within CONV_STAGE_QUADS.
struct ConvPlan {
    bool fold, wreg;
    int kc, cb, taps, mt;
};

inline ConvPlan conv_plan(int CI, int CO, int W, int P) {
    ConvPlan p;
    p.fold = CI == 3;
    p.kc = CI <= 16 ? 1 : CI <= 32 ? 2 : 4;
    p.cb = (CO + 15) / 16;
    p.taps = p.fold ? 3 : 9;
    p.wreg = p.kc == 1 && p.cb == 1 && 2 * 2 * P * p.taps <= 40;
    const int most = (CONV_STAGE_QUADS * 4 / (CONV_R * CI) - 8) / 16;
    const int need = (W + 15) / 16;
    p.mt = need < most ? need : most;
    if (p.mt > CONV_MT) p.mt = CONV_MT;
    return p;
}

inline bool conv_ok(int CI, int CO) {
    return CI >= 1 && CI <= MAX_GROUP && CO >= 1 && CO <= MAX_GROUP;
}

// bf16 elements of the packed weights, [G][P][KC][taps][2 CB][32 lanes][4];
// none where the kernel holds its weights in registers (it reads w)
inline long conv_wpack_elems(int CI, int CO, int G, int P) {
    const ConvPlan p = conv_plan(CI, CO, 16, P);
    return p.wreg ? 0 : (long)G * P * p.kc * p.taps * 2 * p.cb * 128;
}

// Element j of lane `lane`'s mma B fragment of output channels 8 nt .. of
// group grp, part p, chunk kc, tap: lane (g = lane / 4, t = lane % 4)
// holds output channel 8 nt + g, k = 2t, 2t + 1 (j = 0, 1: b0) and 2t + 8,
// 2t + 9 (j = 2, 3: b1). k is channel 16 kc + k at tap (ky, kx) = (tap /
// 3, tap % 3), or, folded, channel k % 3 at (tap, k / 3). w [P][G CO][CI]
// [3][3] bf16; zeros past CI, CO and the 9 folded k.
__device__ __forceinline__ bf16 weight_frag(const bf16* __restrict__ w, int G, int CI, int CO,
                                            int grp, int p, int kc, int tap, int nt, int lane,
                                            int j, bool fold) {
    const int k = 2 * (lane % 4) + j % 2 + 8 * (j / 2), co = 8 * nt + lane / 4;
    const int ci = fold ? k % 3 : 16 * kc + k;
    const int ky = fold ? tap : tap / 3, kx = fold ? k / 3 : tap % 3;
    return co < CO && ci < CI && kx < 3
               ? w[(((size_t)p * G * CO + grp * CO + co) * CI + ci) * 9 + ky * 3 + kx]
               : __float2bfloat16(0.0f);
}

// wpack[grp][p][kc][tap][nt][lane][j] = weight_frag(...), for the kernels
// that read their fragments from memory (L1) at each use
__global__ void pack_conv_weights(const bf16* __restrict__ w, bf16* __restrict__ wpack, int G,
                                  int CI, int CO, int P, int KC, int taps, int NT, int fold) {
    const long n = (long)G * P * KC * taps * NT * 128;
    const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    long r = i / 128;
    const int nt = r % NT;
    r /= NT;
    const int tap = r % taps;
    r /= taps;
    const int kc = r % KC;
    r /= KC;
    wpack[i] = weight_frag(w, G, CI, CO, r / P, r % P, kc, tap, nt, i / 4 % 32, i % 4, fold);
}

// 8 bytes global -> shared, asynchronously; zeros where !valid
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
                 "r"(valid ? 8 : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int N> struct Int {
    static constexpr int value = N;
};

// byte offset of 16-byte chunk c (8 channels) of ring pixel p: the chunks
// are XOR-swizzled by pixel, so that 8 consecutive pixels of one logical
// chunk land in 8 different bank groups
template <int KC> __device__ __forceinline__ int chunk_off(int p, int c) {
    constexpr int shift = KC == 1 ? 2 : KC == 2 ? 1 : 0;
    return p * 32 * KC + ((c ^ ((p >> shift) & (2 * KC - 1))) << 4);
}

// The shared-memory layout of a block, all sizes in bytes. Columns of a
// chunk: CW = 16 MT; staged columns x0 - 4 .. x0 + CW + 3 (SP of them, SP /
// 8 odd, so that the 8 channel rows of a transposing ldmatrix hit 8 bank
// groups).
struct ConvSmem {
    int sp, ring_row, ring, stage, opp, os;
    __host__ __device__ ConvSmem(int KC, int CI, int CO, int MT, int tsize) {
        const int cw = 16 * MT;
        sp = cw + 8;
        ring_row = sp * 32 * KC;
        ring = CONV_RING * ring_row;
        const int ch = CI == 3 ? 3 : 16 * KC;
        stage = (CONV_R * ch * sp * 2 + 15) / 16 * 16;
        // the output tile [row][co][opp]: bf16 rows of an odd number of 16
        // bytes (stmatrix of 8 channel rows hits 8 bank groups), f32 rows
        // of 4 mod 16 elements (the fragments' stores hit distinct banks)
        opp = tsize == 2 ? cw + 8 : cw + 4;
        os = 16 * ((CO + 15) / 16) * CONV_R * opp * tsize;
    }
    __host__ __device__ int total() const { return ring + stage + os; }
};

// in [B, G CI, H, W] of type T; w the weights (WREG: read into registers)
// or wpack (pack_conv_weights: read at each use); bias [G CO] f32
// or null; out [B, G CO, H, W] of type T. A block is one work item: a
// column chunk of MT m16 tiles of one image and one group over a band of
// rows (band fastest, then chunk, group, image); grid = the items. `vec`:
// W is a multiple of 4 and in, out are 16-byte aligned.
// Two blocks an SM (the ring, stage and tile take ~80 KB at conv1_2), three
// when folded (~64 KB, at most 85 registers a thread).
template <typename T, int KC, bool FOLD, bool WREG, int P>
__global__ void __launch_bounds__(CONV_THREADS, FOLD ? 3 : 2)
conv3x3_mma_kernel(const T* __restrict__ in, const bf16* __restrict__ w,
                   const bf16* __restrict__ wpack,
                   const float* __restrict__ bias, T* __restrict__ out, int B, int G, int CI,
                   int CO, int H, int W, int MT, int vec) {
    constexpr int R = CONV_R;
    constexpr int KX = FOLD ? 1 : 3;  // column shifts a ring row is read at
    constexpr int TAPS = FOLD ? 3 : 9;
    constexpr int CH = FOLD ? 3 : 16 * KC;  // staged channels (zeros past CI)
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const ConvSmem L(KC, CI, CO, MT, sizeof(T));
    unsigned char* ring = smem_raw;                                 // [RING][SP px][KC chunks]
    bf16* stage = reinterpret_cast<bf16*>(smem_raw + L.ring);       // [R][CH][SP]
    T* os = reinterpret_cast<T*>(smem_raw + L.ring + L.stage);     // [R][16 CB][OPP]
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int lg = lane / 4, lt = lane % 4;
    const int CW = 16 * MT, SP = L.sp, CB = (CO + 15) / 16, NTT = 2 * CB;

    // the block's rows: a contiguous share of all (image, group, column
    // chunk, row), the row fastest; a segment is the part of the share in
    // one (image, group, chunk), begun with its own halo rows
    const int chunks = (W + CW - 1) / CW;
    const long rows_total = (long)B * G * chunks * H;
    const long begin = rows_total * blockIdx.x / gridDim.x;
    const long end = rows_total * (blockIdx.x + 1) / gridDim.x;
    const size_t plane = (size_t)H * W;
    int grp = 0, x0 = 0, y0 = 0, ye = 0;
    const T* inb = in;
    T* outb = out;
    const uint2* wp = reinterpret_cast<const uint2*>(wpack);
    uint2 wr[WREG ? P * TAPS * 2 : 1];

    // zeros: the staged channels past CI, and the ring (a folded pixel's
    // k 9..15 are never written again)
    for (int i = tid; i < (L.ring + L.stage) / 16; i += CONV_THREADS)
        reinterpret_cast<uint4*>(smem_raw)[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();

    // stage rows ybase, ybase + 1 as [row][channel][column] bf16: a warp a
    // channel row at a time, 4 columns a lane (x0 - 4 + 4 q ..); bf16
    // rows with W a multiple of 4 by cp.async (in flight until the next
    // wait), else by loads
    const int Q4 = SP / 4;
    auto stage_rows = [&](int ybase) {
        for (int r = 0; r < R; ++r) {
            for (int c = warp; c < CI; c += CONV_WARPS) {
                const int y = ybase + r;
                const bool yok = y >= 0 && y < H;
                const T* src = inb + (size_t)c * plane + (yok ? (size_t)y * W : 0);
                bf16* dst = stage + (r * CH + c) * SP;
                for (int q = lane; q < Q4; q += 32) {
                    const int gx0 = x0 - 4 + 4 * q;
                    const bool ok = yok && gx0 >= 0 && gx0 < W;
                    if constexpr (sizeof(T) == 2) {
                        if (vec) {
                            cp_async8(dst + 4 * q, src + (ok ? gx0 : 0), ok);
                            continue;
                        }
                    }
                    Quad<T> v;
                    if (ok) v.load(src, gx0, W, vec != 0);
                    else v.zero();
                    *reinterpret_cast<uint2*>(dst + 4 * q) = v.bf16x4();
                }
            }
        }
        cp_async_commit();
    };
    // the staged rows into ring slots s0, s0 + 1 (mod RING) as [pixel][channel]
    auto transpose = [&](int s0) {
        if constexpr (FOLD) {
            // pixel j of the chunk: k = 3 kx + ci holds column x0 + j + kx - 1
            for (int i = tid; i < R * CW; i += CONV_THREADS) {
                const int r = i / CW, j = i % CW;
                const bf16* st = stage + r * CH * SP + j + 3;
                float v[9];
#pragma unroll
                for (int kx = 0; kx < 3; ++kx)
#pragma unroll
                    for (int ci = 0; ci < 3; ++ci) v[3 * kx + ci] = to_f32(st[ci * SP + kx]);
                unsigned char* slot = ring + ((s0 + r) % CONV_RING) * L.ring_row;
                *reinterpret_cast<uint4*>(slot + chunk_off<1>(j, 0)) =
                    make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                               pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
                *reinterpret_cast<uint32_t*>(slot + chunk_off<1>(j, 1)) = pack_bf16(v[8], 0.f);
            }
        } else {
            // 8 columns x 2 units (a row and 16 channels) an op: ldmatrix
            // .trans of the channel rows, stmatrix of the pixel rows
            const int i = lane / 8, rr = lane % 8;
#pragma unroll
            for (int up = 0; up < KC; ++up) {
                const int u = 2 * up + i / 2, r = u / KC, kc = u % KC;
                const bf16* src = stage + (r * CH + 16 * kc + 8 * (i % 2) + rr) * SP;
                unsigned char* slot = ring + ((s0 + r) % CONV_RING) * L.ring_row;
                // two ops a pass, both loads before both stores
                for (int k = warp; k < SP / 8; k += 2 * CONV_WARPS) {
                    const int k2 = k + CONV_WARPS < SP / 8 ? k + CONV_WARPS : k;
                    uint32_t d[4], d2[4];
                    ldmatrix_x4_trans(d, src + 8 * k);
                    ldmatrix_x4_trans(d2, src + 8 * k2);
                    stmatrix_x4(reinterpret_cast<bf16*>(slot + chunk_off<KC>(8 * k + rr,
                                                                             2 * kc + i % 2)),
                                d);
                    stmatrix_x4(reinterpret_cast<bf16*>(slot + chunk_off<KC>(8 * k2 + rr,
                                                                             2 * kc + i % 2)),
                                d2);
                }
            }
        }
    };

    // output rows y0 + s R + ro0 .. + NRO - 1 of column tile m and output
    // channels 16 cb .. + 15 into the output tile; input row y0 + s R - 1 +
    // ri feeds output rows ro = ri - ky
    auto tile = [&](auto nro, int m, int ro0, int cb, int s) {
        constexpr int NRO = decltype(nro)::value;
        float acc[NRO][2][4];
#pragma unroll
        for (int ro = 0; ro < NRO; ++ro)
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
                acc[ro][nt][0] = acc[ro][nt][1] = acc[ro][nt][2] = acc[ro][nt][3] = 0.f;
#pragma unroll
        for (int ri = 0; ri < NRO + 2; ++ri) {
            const unsigned char* row = ring + ((s * R + ro0 + ri) % CONV_RING) * L.ring_row;
#pragma unroll
            for (int kc = 0; kc < KC; ++kc) {
                uint32_t a[KX][4];
#pragma unroll
                for (int kx = 0; kx < KX; ++kx)
                    ldmatrix_x4(a[kx], reinterpret_cast<const bf16*>(row + chunk_off<KC>(
                                           16 * m + lane % 16 + (FOLD ? 0 : kx + 3),
                                           2 * kc + lane / 16)));
#pragma unroll
                for (int ro = 0; ro < NRO; ++ro) {
                    const int ky = ri - ro;
                    if (ky < 0 || ky > 2) continue;
                    // one bf16 part of one chunk: straight into the row's sum
                    // (9 mma a row); else a fresh sum a (row, chunk)
                    constexpr bool chain = P == 1 && KC == 1;
                    float f[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
                    for (int pk = 0; pk < P * KX; ++pk) {
                        // the smallest part first: a part's products join
                        // a sum of their own scale before the larger ones
                        const int p = P - 1 - pk / KX, kx = pk % KX;
                        const int tap = FOLD ? ky : 3 * ky + kx;
#pragma unroll
                        for (int nt = 0; nt < 2; ++nt) {
                            uint2 bw;
                            if constexpr (WREG)
                                bw = wr[(p * TAPS + tap) * 2 + nt];
                            else
                                bw = __ldg(wp + ((((p * KC + kc) * TAPS + tap) * NTT + 2 * cb +
                                                  nt) * 32));
                            if constexpr (chain) mma_bf16(acc[ro][nt], a[kx], bw.x, bw.y);
                            else mma_bf16(f[nt], a[kx], bw.x, bw.y);
                        }
                    }
                    if constexpr (!chain) {
#pragma unroll
                        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
                            for (int e = 0; e < 4; ++e) acc[ro][nt][e] += f[nt][e];
                    }
                }
            }
        }
        // D fragment (e): pixel lg + 8 (e / 2), channel 8 nt + 2 lt + e % 2
        float bv[2][2];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int co = 16 * cb + 8 * nt + 2 * lt + h;
                bv[nt][h] = bias != nullptr && co < CO ? __ldg(bias + grp * CO + co) : 0.f;
            }
#pragma unroll
        for (int ro = 0; ro < NRO; ++ro) {
            T* orow = os + ((ro0 + ro) * CB + cb) * 16 * L.opp + 16 * m;
            if constexpr (sizeof(T) == 2) {
                // matrix i = (nt i / 2, pixels 8 (i % 2) ..): its channel
                // rows hold 8 pixels each
                uint32_t d[4];
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    d[i] = pack_bf16(acc[ro][i / 2][2 * (i % 2)] + bv[i / 2][0],
                                     acc[ro][i / 2][2 * (i % 2) + 1] + bv[i / 2][1]);
                const int i = lane / 8;
                stmatrix_x4_trans(reinterpret_cast<bf16*>(orow + (8 * (i / 2) + lane % 8) * L.opp +
                                                          8 * (i % 2)),
                                  d);
            } else {
#pragma unroll
                for (int nt = 0; nt < 2; ++nt)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        orow[(8 * nt + 2 * lt + e % 2) * L.opp + lg + 8 * (e / 2)] =
                            from_f32<T>(acc[ro][nt][e] + bv[nt][e % 2]);
            }
        }
    };

    // the output tile of step s (rows y0 + s R ..): a warp a channel row at
    // a time, 4 columns a lane
    auto write_out = [&](int s) {
        for (int ro = 0; ro < R; ++ro) {
            const int y = y0 + s * R + ro;
            if (y >= ye) break;
            for (int co = warp; co < CO; co += CONV_WARPS) {
                const T* src = os + (ro * 16 * CB + co) * L.opp;
                T* dst = outb + (size_t)co * plane + (size_t)y * W + x0;
                for (int q = lane; q < CW / 4 && x0 + 4 * q < W; q += 32) {
                    if (vec) {
                        typedef typename std::conditional<sizeof(T) == 2, uint2, float4>::type V;
                        reinterpret_cast<V*>(dst)[q] = reinterpret_cast<const V*>(src)[q];
                    } else {
                        for (int e = 4 * q; e < 4 * q + 4 && x0 + e < W; ++e) dst[e] = src[e];
                    }
                }
            }
        }
    };

    for (long at = begin; at < end;) {
        const long pair = at / H;
        y0 = (int)(at % H);
        ye = (int)min((long)H, y0 + (end - at));
        at += ye - y0;
        const int chunk = pair % chunks, b = pair / chunks / G;
        grp = pair / chunks % G;
        x0 = chunk * CW;
        inb = in + ((size_t)b * G + grp) * CI * plane;
        outb = out + ((size_t)b * G + grp) * CO * plane;
        if constexpr (WREG) {
#pragma unroll
            for (int i = 0; i < P * TAPS * 2; ++i) {
                uint32_t h[4];
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    h[j] = __bfloat16_as_ushort(weight_frag(w, G, CI, CO, grp, i / (2 * TAPS), 0,
                                                            i / 2 % TAPS, i % 2, lane, j, FOLD));
                wr[i] = make_uint2(h[0] | h[1] << 16, h[2] | h[3] << 16);
            }
        } else {
            wp = reinterpret_cast<const uint2*>(wpack) + (size_t)grp * P * KC * TAPS * NTT * 32 +
                 lane;
        }

        // input row y sits in ring slot (y - y0 + 1) % RING; a step's
        // output tile is written out early in the next step, beside the
        // transposes, before its products overwrite it
        stage_rows(y0 - 1);
        cp_async_wait_all();
        __syncthreads();
        transpose(0);
        __syncthreads();
        stage_rows(y0 + 1);
        const int steps = (ye - y0 + R - 1) / R;
        for (int s = 0; s < steps; ++s) {
            cp_async_wait_all();
            __syncthreads();  // this step's rows are staged, the last tile complete
            transpose(s * R + 2);
            if (s > 0) write_out(s - 1);
            __syncthreads();  // the ring holds input rows y0 + s R - 1 .. + R + 1
            if (s + 1 < steps) stage_rows(y0 + 1 + (s + 1) * R);

            // units: each of the first MT - MT % WARPS column tiles with both
            // output rows, then each row of the others, dealt round the warps
            const int full = MT - MT % CONV_WARPS;
            for (int m = warp; m < full; m += CONV_WARPS)
                for (int cb = 0; cb < CB; ++cb) tile(Int<R>(), m, 0, cb, s);
            for (int h = warp; h < R * (MT - full); h += CONV_WARPS)
                for (int cb = 0; cb < CB; ++cb) tile(Int<1>(), full + h / R, h % R, cb, s);
        }
        __syncthreads();
        write_out(steps - 1);
    }
}

template <typename T, int KC, bool FOLD, bool WREG, int P>
cudaError_t launch_conv_as(const void* in, const bf16* w, const bf16* wpack, const float* bias,
                           void* out, int B,
                           int G, int CI, int CO, int H, int W, int MT, bool vec,
                           cudaStream_t stream) {
    const int smem = ConvSmem(KC, CI, CO, MT, sizeof(T)).total();
    auto kernel = conv3x3_mma_kernel<T, KC, FOLD, WREG, P>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    // as many blocks as fit on the card at once, each a contiguous share of
    // the rows (steps of 2 rows, at least 4 a block)
    int dev, sms, per_sm;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, CONV_THREADS,
                                                             smem)) != cudaSuccess)
        return err;
    const long rows = (long)B * G * ((W + 16 * MT - 1) / (16 * MT)) * H;
    long grid = (long)sms * (per_sm > 0 ? per_sm : 1);
    if (grid > (rows + 3) / 4) grid = (rows + 3) / 4;
    kernel<<<(unsigned)grid, CONV_THREADS, smem, stream>>>(
        static_cast<const T*>(in), w, wpack, bias, static_cast<T*>(out), B, G, CI, CO, H, W, MT,
        vec);
    return cudaGetLastError();
}

// The conv of `in` [B, G CI, H, W] (type T) with the P-part bf16 weights w
// [P][G CO][CI][3][3] and the f32 bias (or null) into out [B, G CO, H, W]:
// where the kernel reads its weights at each use, they are first packed
// into `wpack` (conv_wpack_elems bf16). CI, CO <= MAX_GROUP (conv_ok).
template <typename T, int P>
cudaError_t launch_conv(const void* in, const bf16* w, const float* bias, bf16* wpack, void* out,
                        int B, int G, int CI, int CO, int H, int W, cudaStream_t stream) {
    const ConvPlan pl = conv_plan(CI, CO, W, P);
    if (!pl.wreg) {
        const long n = conv_wpack_elems(CI, CO, G, P);
        pack_conv_weights<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
            w, wpack, G, CI, CO, P, pl.kc, pl.taps, 2 * pl.cb, pl.fold);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return err;
    }
    const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
#define STEM_CONV_AS(KC, FOLD, WREG)                                                    \
    launch_conv_as<T, KC, FOLD, WREG, P>(in, w, wpack, bias, out, B, G, CI, CO, H, W, pl.mt, \
                                         vec, stream)
    if (pl.fold) return pl.wreg ? STEM_CONV_AS(1, true, true) : STEM_CONV_AS(1, true, false);
    if (pl.kc == 1) return pl.wreg ? STEM_CONV_AS(1, false, true) : STEM_CONV_AS(1, false, false);
    return pl.kc == 2 ? STEM_CONV_AS(2, false, false) : STEM_CONV_AS(4, false, false);
#undef STEM_CONV_AS
}

}  // namespace stem
