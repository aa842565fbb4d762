// Modulated deformable convolution (DCNv2) backward for Hopper (sm_90a).
//
// Replaces gssd_tpu/ops/pallas/deform_hat.py _bwd_kernel /
// _bwd_kernel_allwin / _bwd_kernel_stacked (the Pallas TPU kernels of
// hat_bwd; their window tiers are TPU scheduling and compute the same
// function). Same arithmetic as hat_bwd, per pixel p, group g, tap k:
//   gb     = bf16(g)                                          [P, Cout]
//   dU_k   = bf16( gb . W_k^T )            (f32 sums)         [P, Cg]
//   for each of the 4 corners q of (py, px) inside the map, with f32
//   hats ay = max(0, 1 - |py - qy|), bx = max(0, 1 - |px - qx|):
//     dS_q = <dU_k[p], x[q]>                                   (f32)
//     dm  += dS_q * ay * bx
//     dpy += m * dS_q * day * bx,  dpx += m * dS_q * ay * dbx
//            (day, dbx = +1 at floor + 1, -1 at floor, also at integer
//             coordinates: the 4-corner subgradient)
//     w_q  = bf16(ay * bx * m)
//     dx[q] += w_q * dU_k[p]                                   (f32)
//   samp   = bf16( sum_q w_q * x[q] )  (the forward's sample, bit for bit)
//   dW_k  += samp^T . gb                   (f32 sums over B*P)
// dx and dW are rounded to bf16 at the end.
//
// What bounds it: dU and dW are each 2*B*P*K*C*Cout operations (4.4e11
// each at batch 32, 38x38, C 1024, Cout 512: 0.88 ms of tensor-core time
// together), the corner terms ~3e9 f32 operations; the scratch below
// adds ~1.7 GB of device-memory traffic at that site (~0.5 ms). The TPU
// kernel avoids gathers with a dense hat matrix over the map; a GPU
// gathers well. One call runs these kernels on one stream, with no
// floating-point atomics, so every output is the same bits on a repeat:
//   1. deform_du_sm90: a persistent loop over tiles of 128 flattened
//      (b, p) rows x one (g, k), the (g, k) index fastest so that the 36
//      tiles of a row range find its gb rows and the x rows they gather
//      in L2: dU = gb . W_k^T by wgmma (two consumer warpgroups of
//      m64n256 at Cg 256; gb [B*P, Cout] and wg[g, k] [Cg, Cout] both
//      K-major, read by TMA through a ring of mbarrier-guarded stages fed
//      by one producer thread, which runs on into the next tile while the
//      consumers finish this one). Its epilogue rounds dU to bf16 into a
//      shared-memory tile; then 11 warps (the consumers and three of the
//      producer warpgroup) take 11 or 12 rows each, 4 to 12 at a time
//      (all their corner loads in flight at once): each gathers a row's
//      four corners of x (lanes over channels, 16 bytes a load), forms
//      dS_q (each lane's channels in order, then the warp's xor-shuffle
//      tree), the bf16 sample (csrc/deform_gather.cuh, the forward's
//      code), stores dU and the sample to scratch, and writes dm, dpy,
//      dpx. Each corner of x is read once. On the H100 at batch 32 this
//      kernel takes 2.55 ms, of which the epilogue's corner loads ~1.2
//      and its stores ~0.6 (tools/ablate_dcn.py); issuing the next rows'
//      loads before using these, in a second register set, spilled and
//      read slower.
//   2. dx as a gather, so that each dx element is one thread's f32 sum
//      in one fixed order, the same on every run (a scatter with atomics
//      would add in the order the blocks happen to run):
//      a. bucket_count: every sample (b, p, g, k) with a corner inside
//         the map is counted (integer atomics) in the bucket of its
//         top-left corner cell (floor(py), floor(px)) in [-1, H-1] x
//         [-1, W-1] of its (b, g); bucket_scan turns the counts into
//         offsets (a block per (b, g)); bucket_fill writes each sample's
//         flat index into its bucket; bucket_sort sorts each bucket by
//         flat index, so that the order no longer depends on which
//         thread placed which entry (insertion sort: ~K entries a bucket;
//         a bucket holding n samples costs n^2 / 2 steps of its thread);
//      b. dx_gather: one warp per (b, qy, qx, g), lanes over channel
//         pairs, visits the cells whose samples can have q as a corner in
//         the order (qy, qx), (qy, qx - 1), (qy - 1, qx), (qy - 1, qx - 1)
//         and each cell's samples by flat index, and adds w_q * dU with
//         the same bf16 w_q = bf16(ay * bx * m) as the corner terms, then
//         rounds the f32 sum once to bf16. Every term w_q * dU is exact
//         in f32 (two bf16 factors).
//   3. deform_dw_sm90: dW_k = samp^T . gb by wgmma, split over B*P: one
//      block per (128 channels of one (g, k), up to 256 Cout columns, one
//      of `splits` contiguous ranges of 64-pixel chunks); A = the samples
//      (MN-major, from the scratch by TMA), B = gb (MN-major, TMA). Each
//      block writes its f32 partial; the splits (enough for ~4 waves on
//      the card, and enough that none sums more than 64 chunks: 12 at
//      batch 32, 38x38) spread dW's 144 tiles over every SM. A longer
//      chain of wgmmas drifts from the f32-exact sum in proportion to
//      its length (tools/dw_witness.py: 3.8e-5 of mean |dW| over 512
//      chunks, 5.1e-6 over 64).
//   4. dw_reduce adds the partials in split order and rounds to bf16.
// Why dW reads the samples from scratch instead of forming them again in
// producer warps (as the forward does): kernel 1 already holds the four
// corners of every sample, so storing its bf16 sample costs 2 bytes
// written and 2 read back per sample (1.7 GB of device memory at batch
// 32, ~0.5 ms), where forming it again would gather 8 bytes per sample
// from L2 once per 256 Cout columns (6.8 GB at Cout 512).
// Scratch: du and samp, B*P*G*K*Cg bf16 each (852 MB each at batch 32,
// 38x38, C 1024), each (g, k) slice of samp padded to a multiple of 8
// channels (a TMA box starts on 16 bytes); the dW partials, splits *
// G*K*Cg*Cout f32 (226 MB there); the buckets 4 bytes a sample and 8 a
// cell.

#include "deform_gather.cuh"
#include "flash_sm90.cuh"

namespace {

using namespace sm90;
using namespace dcn;

constexpr int SMEM_LIMIT = 232448;
constexpr int THREADS = 384;  // two consumer warpgroups + the producer warpgroup
constexpr int DU_BM = 128;    // (b, p) rows of a dU block
constexpr int DW_BM = 128;    // channels of a dW block
constexpr int PCH = 64;       // pixels (the reduction) of a dW stage

template <int NT>
struct DuPlan {
    static constexpr int A_BYTES = DU_BM * 128;   // gb: 128 rows x 64 columns
    static constexpr int B_BYTES = NT * 128;      // W_k: NT rows x 64 columns
    static constexpr int STAGE = A_BYTES + B_BYTES;
    static constexpr int LDU = NT + 8;            // bf16 a row of the dU tile
    static constexpr int DU_BYTES = DU_BM * LDU * 2;
    static constexpr int FIXED = 1024 + DU_BYTES + 256;
    static constexpr int STAGES = (SMEM_LIMIT - FIXED) / STAGE >= 4 ? 4 : (SMEM_LIMIT - FIXED) / STAGE;
    static constexpr int TOTAL = FIXED + STAGES * STAGE;
};

// the epilogue's workers: the 8 consumer warps and 3 warps of the
// producer warpgroup (its first warp issues the TMA loads), each taking
// the rows ew, ew + 11, ... of a dU tile
constexpr int WORKERS = 11;
constexpr int WORKER_ROWS = (DU_BM + WORKERS - 1) / WORKERS;  // 12

// The corner terms of worker ew's rows of one chunk of a dU tile (dU
// rounded to bf16 in `dut`): lane j < WORKER_ROWS holds row ew + 11 j's
// corners (shuffled to the warp row by row) and sums its dS over the
// chunks in my_ds; the lanes own NT / 32 channels of a row, ROWS rows
// with all their corner loads in flight at once.
template <int NT, bool VEC, int LDU>
__device__ __forceinline__ void corner_terms(
    const bf16* dut, const bf16* __restrict__ x, const float* __restrict__ py,
    const float* __restrict__ px, const float* __restrict__ mk, bf16* __restrict__ du,
    bf16* __restrict__ samp, float* __restrict__ dpy, float* __restrict__ dpx,
    float* __restrict__ dm, int H, int W, int C, int G, int K, int P, int BP, int cg8, int r0,
    int gk, int chunk, int nchunk, int ew, int lane, float (&my_ds)[4]) {
    constexpr int CPL = NT / 32;      // channels a lane
    constexpr int WPL = CPL / 2;      // their words
    // rows whose corner loads are in flight at once (5 WPL + 4 registers a
    // row; a divisor of WORKER_ROWS)
    constexpr int ROWS = NT == 256 ? 4 : NT == 128 ? 6 : 12;
    const int Cg = C / G, GK = G * K, g = gk / K;
    const int my_ri = ew + WORKERS * lane;
    const bool mine = lane < WORKER_ROWS && my_ri < DU_BM && r0 + my_ri < BP;
    const size_t my_wi = (size_t)(mine ? r0 + my_ri : 0) * GK + gk;
    const float my_m = mine ? mk[my_wi] : 0.0f;
    const Corners mc = corners_of(mine ? py[my_wi] : 0.0f, mine ? px[my_wi] : 0.0f, my_m, H, W);
    const int my_img = (mine ? (r0 + my_ri) / P : 0) * H * W;
    const int cc = chunk * NT + lane * CPL;  // this lane's channels in the group
    const int left = Cg - cc;
    for (int j0 = 0; j0 < WORKER_ROWS; j0 += ROWS) {
        if (ew + WORKERS * j0 >= DU_BM || r0 + ew + WORKERS * j0 >= BP) break;
        uint32_t u[ROWS][WPL], v[ROWS][4][WPL];
        float w[ROWS][4];
#pragma unroll
        for (int jj = 0; jj < ROWS; ++jj) {
            const int j = j0 + jj, ri = ew + WORKERS * j;
            const bool valid = j < WORKER_ROWS && ri < DU_BM && r0 + ri < BP;
#pragma unroll
            for (int i = 0; i < WPL; ++i)
                u[jj][i] = valid ? *reinterpret_cast<const uint32_t*>(dut + ri * LDU + lane * CPL +
                                                                      2 * i)
                                 : 0u;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int pix = __shfl_sync(0xffffffffu, my_img + mc.pix[q], j & 31);
                const bool in = __shfl_sync(0xffffffffu, (int)mc.in[q], j & 31) != 0;
                w[jj][q] = __shfl_sync(0xffffffffu, mc.w[q], j & 31);
                load_words<WPL, VEC>(v[jj][q], x + (size_t)pix * C + g * Cg + cc,
                                     valid && in ? left : 0);
            }
        }
#pragma unroll
        for (int jj = 0; jj < ROWS; ++jj) {
            const int j = j0 + jj, ri = ew + WORKERS * j;
            if (j >= WORKER_ROWS || ri >= DU_BM || r0 + ri >= BP) break;
            float ds[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                ds[q] = 0.0f;
#pragma unroll
                for (int i = 0; i < WPL; ++i) {
                    ds[q] = fmaf(lo_f(u[jj][i]), lo_f(v[jj][q][i]), ds[q]);
                    ds[q] = fmaf(hi_f(u[jj][i]), hi_f(v[jj][q][i]), ds[q]);
                }
#pragma unroll
                for (int off = 16; off > 0; off >>= 1)
                    ds[q] += __shfl_xor_sync(0xffffffffu, ds[q], off);
                if (lane == j) my_ds[q] += ds[q];
            }
            uint32_t o[WPL];
            blend<WPL>(o, v[jj], w[jj]);
            const size_t wi = (size_t)(r0 + ri) * GK + gk;
            store_words<WPL, VEC>(du + wi * Cg + cc, u[jj], left);
            store_words<WPL, VEC>(samp + wi * cg8 + cc, o, left);
        }
    }
    if (mine && chunk + 1 == nchunk) {
        float sm = 0.0f, sy = 0.0f, sx = 0.0f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            if (!mc.in[q]) continue;
            const float mdS = my_ds[q] * my_m;
            const float day = (q >> 1) ? 1.0f : -1.0f;
            const float dbx = (q & 1) ? 1.0f : -1.0f;
            sm += my_ds[q] * (mc.ay[q] * mc.bx[q]);
            sy += mdS * day * mc.bx[q];
            sx += mdS * mc.ay[q] * dbx;
        }
        dm[my_wi] = sm;
        dpy[my_wi] = sy;
        dpx[my_wi] = sx;
    }
}

// A persistent loop over tiles of dU, 128 rows x one (g, k) each, the
// (g, k) index fastest (the 36 tiles of a row range share its gb rows and
// the x rows its samples gather, in L2); for each, every term that needs
// dU and the corners of x (corner_terms).
template <int NT, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
deform_du_sm90(const __grid_constant__ CUtensorMap tg,  // gb [1][B*P][Cout8]
               const __grid_constant__ CUtensorMap tw,  // wg [G*K][Cg][Cout8]
               const bf16* __restrict__ x,              // [B, H, W, C]
               const float* __restrict__ py,            // [B*P, G, K]
               const float* __restrict__ px,
               const float* __restrict__ mk,
               bf16* __restrict__ du,                   // [B*P, G, K, Cg]
               bf16* __restrict__ samp,                 // [B*P, G*K, Cg8]
               float* __restrict__ dpy,                 // [B*P, G, K]
               float* __restrict__ dpx,
               float* __restrict__ dm,
               int H, int W, int C, int G, int K, int P, int BP, int Cout8, int cg8,
               int tiles) {
    using Plan = DuPlan<NT>;
    constexpr int STAGES = Plan::STAGES;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* base = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    unsigned char* ring = base;                                         // [STAGES][A | B]
    bf16* dut = reinterpret_cast<bf16*>(ring + STAGES * Plan::STAGE);   // [DU_BM][LDU]
    uint64_t* full = reinterpret_cast<uint64_t*>(dut + DU_BM * Plan::LDU);
    uint64_t* empty = full + STAGES;

    const int Cg = C / G;
    const int GK = G * K;
    const int nchunk = (Cg + NT - 1) / NT;
    const int nk = (Cout8 + 63) / 64;
    const int wgi = threadIdx.x / 128;
    const int lane = threadIdx.x % 32;
    const int warp = threadIdx.x / 32;

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 256);
        }
        mbar_fence_init();
    }
    __syncthreads();

    auto terms = [&](int tile, int chunk, int ew, float (&my_ds)[4]) {
        corner_terms<NT, VEC, Plan::LDU>(dut, x, py, px, mk, du, samp, dpy, dpx, dm, H, W, C, G,
                                         K, P, BP, cg8, (tile / GK) * DU_BM, tile % GK, chunk,
                                         nchunk, ew, lane, my_ds);
    };

    if (wgi == 2) {
        if (warp == 8) {
            // ---- producer ----
            if (lane == 0) {
                int it = 0;
                for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
                    const int gk = tile % GK, r0 = (tile / GK) * DU_BM;
                    for (int chunk = 0; chunk < nchunk; ++chunk)
                        for (int kc = 0; kc < nk; ++kc, ++it) {
                            const int st = it % STAGES;
                            unsigned char* stage = ring + st * Plan::STAGE;
                            mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);
                            mbar_expect_tx(&full[st], Plan::STAGE);
                            tma_load_3d(stage, &tg, &full[st], kc * 64, r0, 0);
                            tma_load_3d(stage + Plan::A_BYTES, &tw, &full[st], kc * 64,
                                        chunk * NT, gk);
                        }
                }
            }
            return;
        }
        // ---- the other three warps: epilogue workers 8..10 ----
        for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
            float my_ds[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            for (int chunk = 0; chunk < nchunk; ++chunk) {
                named_sync(1, 32 * WORKERS);  // the chunk's dU tile is written
                terms(tile, chunk, warp - 1, my_ds);
                if (tile + (int)gridDim.x < tiles || chunk + 1 < nchunk)
                    named_sync(1, 32 * WORKERS);  // its rows are read
            }
        }
        return;
    }

    // ---- consumers: warpgroup wgi owns rows 64 wgi .. + 64 ----
    const int tt = threadIdx.x % 128;
    const int rr = 64 * wgi + 16 * (tt / 32) + lane / 4;
    const int q2 = 2 * (lane % 4);
    int it = 0;
    bool first = true;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        float my_ds[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int chunk = 0; chunk < nchunk; ++chunk) {
            float acc[NT / 2];
#pragma unroll
            for (int i = 0; i < NT / 2; ++i) acc[i] = 0.0f;
            for (int kc = 0; kc < nk; ++kc, ++it) {
                const int st = it % STAGES;
                mbar_wait(&full[st], (it / STAGES) & 1);
                const uint32_t a_a = smem_u32(ring + st * Plan::STAGE) + 64 * wgi * 128;
                const uint32_t b_a = smem_u32(ring + st * Plan::STAGE + Plan::A_BYTES);
                fence_regs(acc);
                wgmma_fence();
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    wgmma_ss<NT, 0, 0>(acc, make_desc(a_a + 32 * j, 16, 1024, 1),
                                       make_desc(b_a + 32 * j, 16, 1024, 1), 1);
                wgmma_commit();
                wgmma_wait<1>();
                fence_regs(acc);
                if (kc > 0) mbar_arrive(&empty[(it - 1) % STAGES]);
            }
            wgmma_wait<0>();
            fence_regs(acc);
            mbar_arrive(&empty[(it - 1) % STAGES]);

            // dU rounded to bf16 into the tile, once every worker has read
            // the last one
            if (!first) named_sync(1, 32 * WORKERS);
            first = false;
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int c = 0; c < NT / 8; ++c)
                    *reinterpret_cast<uint32_t*>(dut + (rr + 8 * h) * Plan::LDU + 8 * c + q2) =
                        pack2(acc[4 * c + 2 * h], acc[4 * c + 2 * h + 1]);
            named_sync(1, 32 * WORKERS);
            terms(tile, chunk, warp, my_ds);
        }
    }
}

template <int NT>
struct DwPlan {
    static constexpr int A_BYTES = PCH * DW_BM * 2;  // samples: 64 pixels x 128 channels
    static constexpr int B_BYTES = PCH * NT * 2;     // gb: 64 pixels x NT columns
    static constexpr int STAGE = A_BYTES + B_BYTES;
    static constexpr int FIXED = 1024 + 256;
    static constexpr int STAGES = (SMEM_LIMIT - FIXED) / STAGE >= 4 ? 4 : (SMEM_LIMIT - FIXED) / STAGE;
    static constexpr int TOTAL = FIXED + STAGES * STAGE;
};

// the f32 partial of dW[g, k, c0:c0+128, n0:n0+NT] over one split's pixels
template <int NT>
__global__ void __launch_bounds__(THREADS, 1)
deform_dw_sm90(const __grid_constant__ CUtensorMap ts,  // samp [1][B*P][G*K*Cg8]
               const __grid_constant__ CUtensorMap tg,  // gb [1][B*P][Cout8]
               float* __restrict__ part,                // [splits][G*K][Cg][Cout]
               int Cg, int cg8, int GK, int Cout, int chunks, int splits) {
    using Plan = DwPlan<NT>;
    constexpr int STAGES = Plan::STAGES;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* base = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    unsigned char* ring = base;
    uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * Plan::STAGE);
    uint64_t* empty = full + STAGES;

    const int n0 = blockIdx.x * NT;
    const int ncg = (Cg + DW_BM - 1) / DW_BM;
    const int gk = blockIdx.y / ncg;
    const int c0 = (blockIdx.y % ncg) * DW_BM;
    const int s = blockIdx.z;
    const int lo = (int)((long)s * chunks / splits), hi = (int)((long)(s + 1) * chunks / splits);
    const int wgi = threadIdx.x / 128;

    if (threadIdx.x == 0) {
        for (int i = 0; i < STAGES; ++i) {
            mbar_init(&full[i], 1);
            mbar_init(&empty[i], 256);
        }
        mbar_fence_init();
    }
    __syncthreads();

    if (wgi == 2) {
        if (threadIdx.x == 256) {
            for (int ch = lo, it = 0; ch < hi; ++ch, ++it) {
                const int st = it % STAGES;
                unsigned char* stage = ring + st * Plan::STAGE;
                mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);
                mbar_expect_tx(&full[st], Plan::STAGE);
                for (int bx = 0; bx < DW_BM / 64; ++bx)
                    tma_load_3d(stage + bx * PCH * 128, &ts, &full[st], gk * cg8 + c0 + 64 * bx,
                                ch * PCH, 0);
                for (int bx = 0; bx < NT / 64; ++bx)
                    tma_load_3d(stage + Plan::A_BYTES + bx * PCH * 128, &tg, &full[st],
                                n0 + 64 * bx, ch * PCH, 0);
            }
        }
        return;
    }

    // ---- consumers: warpgroup wgi owns channels c0 + 64 wgi .. + 64 ----
    const int tt = threadIdx.x % 128;
    const int lane = tt % 32;
    const int rr = 16 * (tt / 32) + lane / 4;
    const int q2 = 2 * (lane % 4);
    float acc[NT / 2];
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[i] = 0.0f;
    for (int ch = lo, it = 0; ch < hi; ++ch, ++it) {
        const int st = it % STAGES;
        mbar_wait(&full[st], (it / STAGES) & 1);
        const uint32_t a_a = smem_u32(ring + st * Plan::STAGE) + wgi * PCH * 128;
        const uint32_t b_a = smem_u32(ring + st * Plan::STAGE + Plan::A_BYTES);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < PCH / 16; ++j)
            wgmma_ss<NT, 1, 1>(acc, make_desc(a_a + j * 16 * 128, 16, 1024, 1),
                               make_desc(b_a + j * 16 * 128, PCH * 128, 1024, 1), 1);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(acc);
        if (ch > lo) mbar_arrive(&empty[(it - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(acc);

    const bool pairs = (Cout % 2) == 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int c = c0 + 64 * wgi + rr + 8 * h;
        if (c >= Cg) continue;
        float* row = part + (((size_t)s * GK + gk) * Cg + c) * Cout;
#pragma unroll
        for (int j = 0; j < NT / 8; ++j) {
            const int n = n0 + 8 * j + q2;
            const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
            if (pairs && n + 1 < Cout) {
                *reinterpret_cast<float2*>(row + n) = make_float2(v0, v1);
            } else {
                if (n < Cout) row[n] = v0;
                if (n + 1 < Cout) row[n + 1] = v1;
            }
        }
    }
}

// dwg = bf16(sum of the partials, in split order)
__global__ void dw_reduce(const float* __restrict__ part, bf16* __restrict__ dwg, long n,
                          int splits) {
    for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += (long)gridDim.x * blockDim.x) {
        float s = part[i];
        for (int sp = 1; sp < splits; ++sp) s += part[(long)sp * n + i];
        dwg[i] = __float2bfloat16(s);
    }
}

// The bucket of sample wi (flat index of py/px/m [B, P, G, K]): its
// top-left corner cell (floor(py), floor(px)) in [-1, H-1] x [-1, W-1]
// of its (b, g), or -1 where no corner lies inside the map (NaN too).
__device__ __forceinline__ int bucket_of(const float* __restrict__ py,
                                         const float* __restrict__ px, long wi, int H, int W,
                                         int G, int K, int P) {
    const float y0 = floorf(py[wi]), x0 = floorf(px[wi]);
    if (!(y0 >= -1.0f && y0 <= (float)(H - 1) && x0 >= -1.0f && x0 <= (float)(W - 1)))
        return -1;
    const int g = (int)((wi / K) % G);
    const int b = (int)(wi / ((long)G * K * P));
    return (((b * G + g) * (H + 1)) + (int)y0 + 1) * (W + 1) + (int)x0 + 1;
}

// counts per cell, and per (b, g) the samples with a cell in seg_total
__global__ void bucket_count(const float* __restrict__ py, const float* __restrict__ px,
                             int* __restrict__ count, int* __restrict__ seg_total, long total,
                             int H, int W, int G, int K, int P) {
    const long wi = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (wi >= total) return;
    const int c = bucket_of(py, px, wi, H, W, G, K, P);
    if (c >= 0) atomicAdd(count + c, 1);
    // one add per (b, g) a warp: neighbouring samples share their (b, g)
    const int seg = c >= 0 ? c / ((H + 1) * (W + 1)) : -1;
    const unsigned peers = __match_any_sync(__activemask(), seg);
    if (seg >= 0 && __ffs(peers) - 1 == (int)(threadIdx.x % 32))
        atomicAdd(seg_total + seg, __popc(peers));
}

constexpr int SCAN_THREADS = 512;

// One block per (b, g): offset[i] = sum of count[j < i] over the cells of
// that (b, g) and all before it (the earlier ones through seg_total);
// offset[nb] = the sum of all. count is left zeroed, as bucket_fill's
// cursors.
__global__ void __launch_bounds__(SCAN_THREADS)
bucket_scan(int* __restrict__ count, const int* __restrict__ seg_total, int* __restrict__ offset,
            int cells) {
    __shared__ int sums[SCAN_THREADS];
    const int t = threadIdx.x, seg = blockIdx.x;
    int base = 0;
    for (int s = t; s < seg; s += SCAN_THREADS) base += seg_total[s];
    sums[t] = base;
    __syncthreads();
    for (int d = SCAN_THREADS / 2; d > 0; d >>= 1) {  // the block's sum of base
        if (t < d) sums[t] += sums[t + d];
        __syncthreads();
    }
    base = sums[0];
    __syncthreads();
    int* cnt = count + (long)seg * cells;
    int* off = offset + (long)seg * cells;
    const int chunk = (cells + SCAN_THREADS - 1) / SCAN_THREADS;
    const int lo = min(cells, t * chunk), hi = min(cells, lo + chunk);
    int s = 0;
    for (int i = lo; i < hi; ++i) s += cnt[i];
    sums[t] = s;
    __syncthreads();
    for (int d = 1; d < SCAN_THREADS; d <<= 1) {  // inclusive scan of the chunk sums
        const int v = t >= d ? sums[t - d] : 0;
        __syncthreads();
        sums[t] += v;
        __syncthreads();
    }
    int run = base + sums[t] - s;
    for (int i = lo; i < hi; ++i) {
        off[i] = run;
        run += cnt[i];
        cnt[i] = 0;
    }
    if (seg == gridDim.x - 1 && t == SCAN_THREADS - 1) off[cells] = base + sums[t];
}

__global__ void bucket_fill(const float* __restrict__ py, const float* __restrict__ px,
                            const int* __restrict__ offset, int* __restrict__ cursor,
                            int* __restrict__ entries, long total, int H, int W, int G, int K,
                            int P) {
    const long wi = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (wi >= total) return;
    const int c = bucket_of(py, px, wi, H, W, G, K, P);
    if (c >= 0) entries[offset[c] + atomicAdd(cursor + c, 1)] = (int)wi;
}

__global__ void bucket_sort(const int* __restrict__ offset, int* __restrict__ entries, int nb) {
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= nb) return;
    int* e = entries + offset[c];
    const int n = offset[c + 1] - offset[c];
    for (int i = 1; i < n; ++i) {
        const int v = e[i];
        int j = i - 1;
        while (j >= 0 && e[j] > v) {
            e[j + 1] = e[j];
            --j;
        }
        e[j + 1] = v;
    }
}

constexpr int GATHER_THREADS = 256;
constexpr int MAX_PAIR_STEPS = 8;  // C/G <= 64 * MAX_PAIR_STEPS

// one warp per (b, qy, qx, g); lane pairs c = 2 * lane + 64 * i
__global__ void __launch_bounds__(GATHER_THREADS)
dx_gather(const float* __restrict__ py, const float* __restrict__ px,
          const float* __restrict__ mk, const bf16* __restrict__ dU,  // [B, P, G, K, Cg]
          const int* __restrict__ offset, const int* __restrict__ entries,
          bf16* __restrict__ dx,  // [B, H, W, C]
          int B, int H, int W, int C, int G) {
    const long wid = (long)blockIdx.x * (GATHER_THREADS / 32) + threadIdx.x / 32;
    if (wid >= (long)B * H * W * G) return;
    const int lane = threadIdx.x % 32;
    const int Cg = C / G;
    const int g = (int)(wid % G);
    const long pix = wid / G;  // (b * H + qy) * W + qx
    const int qx = (int)(pix % W);
    const int qy = (int)((pix / W) % H);
    const int b = (int)(pix / ((long)H * W));
    const int steps = (Cg + 63) / 64;

    float acc[MAX_PAIR_STEPS][2];
#pragma unroll
    for (int i = 0; i < MAX_PAIR_STEPS; ++i) acc[i][0] = acc[i][1] = 0.0f;

#pragma unroll 1
    for (int q = 0; q < 4; ++q) {
        const int dy = q >> 1, dxx = q & 1;  // q is corner (dy, dxx) of the cell's samples
        const int cell = ((b * G + g) * (H + 1) + qy - dy + 1) * (W + 1) + qx - dxx + 1;
        const int e0 = offset[cell], n = offset[cell + 1] - e0;
        for (int j0 = 0; j0 < n; j0 += 32) {
            // each lane fetches one entry and its corner weight
            int wi_l = 0;
            float sw_l = 0.0f;
            if (j0 + lane < n) {
                wi_l = entries[e0 + j0 + lane];
                const float fy = py[wi_l], fx = px[wi_l], m = mk[wi_l];
                const float cy = floorf(fy) + (float)dy;
                const float cx = floorf(fx) + (float)dxx;
                const float ay = fmaxf(0.0f, 1.0f - fabsf(fy - cy));
                const float bx = fmaxf(0.0f, 1.0f - fabsf(fx - cx));
                sw_l = __bfloat162float(__float2bfloat16(ay * bx * m));
            }
            const int cnt = min(32, n - j0);
#pragma unroll 4
            for (int j = 0; j < cnt; ++j) {
                const int wi = __shfl_sync(0xffffffffu, wi_l, j);
                const float sw = __shfl_sync(0xffffffffu, sw_l, j);
                const bf16* du = dU + (long)wi * Cg;
#pragma unroll
                for (int i = 0; i < MAX_PAIR_STEPS; ++i) {
                    const int c = 2 * lane + 64 * i;
                    if (i < steps && c < Cg) {
                        const __nv_bfloat162 u2 = *reinterpret_cast<const __nv_bfloat162*>(du + c);
                        acc[i][0] = __fadd_rn(acc[i][0], __fmul_rn(sw, __low2float(u2)));
                        acc[i][1] = __fadd_rn(acc[i][1], __fmul_rn(sw, __high2float(u2)));
                    }
                }
            }
        }
    }
    bf16* out = dx + pix * C + (long)g * Cg;
#pragma unroll
    for (int i = 0; i < MAX_PAIR_STEPS; ++i) {
        const int c = 2 * lane + 64 * i;
        if (i < steps && c < Cg)
            *reinterpret_cast<__nv_bfloat162*>(out + c) = __floats2bfloat162_rn(acc[i][0], acc[i][1]);
    }
}

template <int NT, bool VEC>
cudaError_t launch_du(const CUtensorMap& tg, const void* x, const float* py, const float* px,
                      const float* m, const void* wg, bf16* du, bf16* samp, float* dpy,
                      float* dpx, float* dm, int B, int H, int W, int C, int G, int K, int P,
                      int Cout8, int cg8, cudaStream_t s) {
    using Plan = DuPlan<NT>;
    CUtensorMap tw;
    if (!sm90_host::tensor_map_cached(&tw, wg, G * K, C / G, Cout8, NT, 64))
        return cudaErrorInvalidValue;
    auto kernel = deform_du_sm90<NT, VEC>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Plan::TOTAL);
    if (err != cudaSuccess) return err;
    const int BP = B * P;
    const int tiles = (BP + DU_BM - 1) / DU_BM * G * K;
    const int grid = tiles < sm90_host::sm_count() ? tiles : sm90_host::sm_count();
    kernel<<<grid, THREADS, Plan::TOTAL, s>>>(tg, tw, static_cast<const bf16*>(x), py, px, m, du,
                                              samp, dpy, dpx, dm, H, W, C, G, K, P, BP, Cout8,
                                              cg8, tiles);
    return cudaGetLastError();
}

template <int NT>
cudaError_t launch_dw(const void* samp, const void* gb, float* part, int BP, int Cg, int cg8,
                      int GK, int Cout, int Cout8, int splits, cudaStream_t s) {
    using Plan = DwPlan<NT>;
    CUtensorMap ts, tg;
    if (!sm90_host::tensor_map_cached(&ts, samp, 1, BP, GK * cg8, PCH, 64) ||
        !sm90_host::tensor_map_cached(&tg, gb, 1, BP, Cout8, PCH, 64))
        return cudaErrorInvalidValue;
    auto kernel = deform_dw_sm90<NT>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Plan::TOTAL);
    if (err != cudaSuccess) return err;
    const int chunks = (BP + PCH - 1) / PCH;
    const dim3 grid((Cout + NT - 1) / NT, GK * ((Cg + DW_BM - 1) / DW_BM), splits);
    kernel<<<grid, THREADS, Plan::TOTAL, s>>>(ts, tg, part, Cg, cg8, GK, Cout, chunks, splits);
    return cudaGetLastError();
}

}  // namespace

// x [B,H,W,C] bf16; py, px, m [B,P,G,K] f32; wg [G,K,C/G,Cout8] bf16 and
// gb [B,P,Cout8] bf16 (the output gradient rounded to bf16), Cout8 =
// Cout rounded up to a multiple of 8, the columns past Cout zero.
// Outputs: dpy, dpx, dm [B,P,G,K] f32; dx [B,H,W,C] bf16; dwg
// [G,K,C/G,Cout] bf16. Scratch: du [B,P,G,K,C/G] bf16; samp [B*P, G*K,
// Cg8] bf16 (Cg8 = C/G rounded up to a multiple of 8: every TMA box of
// the samples starts on 16 bytes); part [splits,
// G*K*C/G*Cout] f32 (1 <= splits <= ceil(B*P / 64)); buckets int32 of
// 2 * B*G*(H+1)*(W+1) + 1 + B*G + B*P*G*K elements. All contiguous and
// 16-byte aligned; C/G even and <= 512. Returns the CUDA error code of
// the launches (0 on success).
extern "C" int deform_conv_bwd(const void* x, const void* py, const void* px, const void* m,
                               const void* wg, const void* gb, void* dpy, void* dpx, void* dm,
                               void* dx, void* dwg, void* du, void* samp, void* part,
                               void* buckets, int B, int H, int W, int C, int G, int K, int P,
                               int Cout, int Cout8, int splits, void* stream) {
    if (B < 1 || H < 1 || W < 1 || G < 1 || C % G || (C / G) % 2 || C / G > 64 * MAX_PAIR_STEPS ||
        K < 1 || P < 1 || Cout < 1 || Cout8 < Cout || Cout8 % 8 || splits < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int Cg = C / G;
    const int cg8 = (Cg + 7) / 8 * 8;
    const int GK = G * K;
    const long BP = (long)B * P;
    const long total = BP * GK;
    const long nb = (long)B * G * (H + 1) * (W + 1);
    if (BP > 0x7fffffffL || total > 0x7fffffffL || nb + 1 > 0x7fffffffL ||
        (long)B * H * W > 0x7fffffffL || splits > (BP + PCH - 1) / PCH)
        return (int)cudaErrorInvalidValue;
    const float* pyp = static_cast<const float*>(py);
    const float* pxp = static_cast<const float*>(px);
    const float* mp = static_cast<const float*>(m);
    bf16* dup = static_cast<bf16*>(du);
    bf16* sp = static_cast<bf16*>(samp);
    float* pp = static_cast<float*>(part);
    int* count = static_cast<int*>(buckets);
    int* seg_total = count + nb;
    int* offset = seg_total + (long)B * G;
    int* entries = offset + nb + 1;
    // 1. dU, the corner terms and the bf16 samples
    CUtensorMap tg;
    if (!sm90_host::tensor_map_cached(&tg, gb, 1, (int)BP, Cout8, DU_BM, 64))
        return (int)cudaErrorInvalidValue;
    float* dpyp = static_cast<float*>(dpy);
    float* dpxp = static_cast<float*>(dpx);
    float* dmp = static_cast<float*>(dm);
    cudaError_t err;
    if (Cg <= 64)
        err = launch_du<64, true>(tg, x, pyp, pxp, mp, wg, dup, sp, dpyp, dpxp, dmp, B, H, W, C, G, K, P, Cout8, cg8, s);
    else if (Cg <= 128)
        err = Cg % 4 == 0 ? launch_du<128, true>(tg, x, pyp, pxp, mp, wg, dup, sp, dpyp, dpxp, dmp, B, H, W, C, G, K, P, Cout8, cg8, s)
                          : launch_du<128, false>(tg, x, pyp, pxp, mp, wg, dup, sp, dpyp, dpxp, dmp, B, H, W, C, G, K, P, Cout8, cg8, s);
    else
        err = Cg % 8 == 0 ? launch_du<256, true>(tg, x, pyp, pxp, mp, wg, dup, sp, dpyp, dpxp, dmp, B, H, W, C, G, K, P, Cout8, cg8, s)
                          : launch_du<256, false>(tg, x, pyp, pxp, mp, wg, dup, sp, dpyp, dpxp, dmp, B, H, W, C, G, K, P, Cout8, cg8, s);
    if (err != cudaSuccess) return (int)err;
    // 2. dx: the samples bucketed by corner cell, then gathered per element
    err = cudaMemsetAsync(count, 0, (nb + (long)B * G) * sizeof(int), s);
    if (err != cudaSuccess) return (int)err;
    const unsigned sample_blocks = (unsigned)((total + 255) / 256);
    bucket_count<<<sample_blocks, 256, 0, s>>>(pyp, pxp, count, seg_total, total, H, W, G, K, P);
    bucket_scan<<<B * G, SCAN_THREADS, 0, s>>>(count, seg_total, offset, (H + 1) * (W + 1));
    bucket_fill<<<sample_blocks, 256, 0, s>>>(pyp, pxp, offset, count, entries, total, H, W, G,
                                              K, P);
    bucket_sort<<<(unsigned)((nb + 255) / 256), 256, 0, s>>>(offset, entries, (int)nb);
    const long warps = (long)B * H * W * G;
    dx_gather<<<(unsigned)((warps + GATHER_THREADS / 32 - 1) / (GATHER_THREADS / 32)),
                GATHER_THREADS, 0, s>>>(pyp, pxp, mp, dup, offset, entries,
                                        static_cast<bf16*>(dx), B, H, W, C, G);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    // 3. dW partials over the splits of B*P, 4. their sum in split order
    if (Cout8 <= 64) err = launch_dw<64>(samp, gb, pp, (int)BP, Cg, cg8, GK, Cout, Cout8, splits, s);
    else if (Cout8 <= 128) err = launch_dw<128>(samp, gb, pp, (int)BP, Cg, cg8, GK, Cout, Cout8, splits, s);
    else err = launch_dw<256>(samp, gb, pp, (int)BP, Cg, cg8, GK, Cout, Cout8, splits, s);
    if (err != cudaSuccess) return (int)err;
    const long n = (long)GK * Cg * Cout;
    const long blocks = (n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096;
    dw_reduce<<<(unsigned)blocks, 256, 0, s>>>(pp, static_cast<bf16*>(dwg), n, splits);
    return (int)cudaGetLastError();
}

extern "C" const char* deform_conv_bwd_error(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
