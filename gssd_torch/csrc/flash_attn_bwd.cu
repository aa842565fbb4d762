// Fused SAGAN attention backward for Hopper (sm_90a):
//   given q, k, v (bf16), lse (f32), dO (bf16) and D = rowsum(dO * O) (f32),
//   P  = exp(q k^T - lse)             (recomputed once, f32)
//   dV = bf16(P)^T dO                 (bf16 products, f32 sums)
//   dP = dO V^T                       (bf16 products, f32 sums)
//   dS = P * (dP - D)                 (f32)
//   dQ = dS K,  dK = dS^T Q           (f32-exact products, f32 sums)
// dK and dV are written in bf16 by the kernel; dQ is summed in f32 in a
// fixed order and rounded to bf16 by a second kernel of the same launch.
//
// Replaces gssd_tpu/ops/pallas/flash_attn.py _bwd_kernel (the Pallas TPU
// kernel) with the same arithmetic. dS stays f32 as there (its comment
// measured ~1.6% gradient error with a bf16 dS). Here the two dk-deep
// products that consume it run on the tensor cores all the same: dS is
// split into three bf16 parts, hi = bf16(dS), mid = bf16(dS - hi), lo =
// bf16(dS - hi - mid), which sum back to dS exactly, and every part
// product with the bf16 K or Q is exact in f32, so hi.K + mid.K + lo.K
// is dS.K with f32 sums: three bf16 wgmmas instead of f32 FMAs on the
// CUDA cores (no TF32, no bf16 dS).
//
// What bounds it here: 2*N*M*(dk + 2 dv) bf16 operations plus the two
// f32-exact dk-deep products (3 x 2*N*M*2 dk as bf16 passes), and one
// exp per logit, against a few MB of q/k/v/dO.
//
// Design: one block per (image, key tile of 64 keys per consumer
// warpgroup; two warpgroups, 128 keys, unless shared memory only holds
// one). K and V of the tile stay in shared memory; the block walks all
// query tiles (64 queries), which TMA brings into a ring of stages
// (Q, dO) guarded by mbarriers; thread 0 issues the copies. For each
// query tile, in sub-steps of 64 queries (32 where dV takes 256 columns):
//   S^T = K Q^T and dP^T = V dO^T      wgmma, both operands in shared memory
//   P^T = exp2((S^T - lse) * log2 e)   one MUFU ex2 per logit
//   dV += bf16(P^T) dO                 wgmma, A from the registers, dO as
//                                      an MN-major B (the transpose bit)
//   dS^T = P^T * (dP^T - D)            f32 in registers
//   dK += hi Q + mid Q + lo Q          three register-A wgmmas
// and the parts go to shared memory (swizzled as TMA would write them)
// for the transposed product of the tile,
//   dQ = hi^T K + mid^T K + lo^T K     wgmma with an MN-major A,
// stored in f32 as the partial of this warpgroup's 64 keys: a scratch
// [slots, B, N, dk] with one slot per 64-key tile (slot = 2 * block +
// warpgroup). dq_reduce, launched behind the kernel on the same stream,
// adds the slots of every dQ element in slot order and rounds once to
// bf16. No atomics: the sums are the same bits on every run, whatever
// the blocks' schedule. The scratch is ceil(M / 64) * B * N * dk f32
// (1.0 GB at N = M = 5625, dk 32, batch 16; 0.27 GB at the 1444 site,
// batch 32): one extra write and read of it, ~0.6 ms at 3.35 TB/s at
// the largest site. dK and dV are summed in registers.
// dV of up to 256 columns stays in registers beside dK; wider dv (512,
// the fc7 sites only) takes a second walk over the query tiles for the
// columns 256 .. 511, which recomputes S^T and P^T (a second exp per
// logit at that site only): 128 more accumulator registers a thread do
// not fit, and keeping dV in shared memory would leave no room for the
// K, V and dO tiles. Key rows past M and query rows past N come in as
// zeros (TMA) and add nothing; their outputs are not stored.
// dV's chain of wgmmas into its registers ends every DV_FLUSH query tiles
// (1024 queries): the tensor cores' sums drift from the f32-exact sum in
// proportion to the chain's length (tools/flash_bwd_witness.py: dV read
// 2.65e-5 of its mean against the contract in f64 over the 22,500 queries
// of PixelLink++ 2s, 6.1e-6 over 5625). Each thread adds its segment's
// sum in f32 into its own elements of a scratch dv_run [B, M, dv] f32
// (no other thread touches them; in tile order, so the same bits on
// every run), and the walk's end adds the last segment and rounds once.

#include "flash_sm90.cuh"

namespace {

using namespace sm90;

constexpr int QT = 64;          // queries per tile
constexpr int DV_FLUSH = 16;    // query tiles a chain of dV wgmmas sums
constexpr int MAX_STAGES = 3;
constexpr int SMEM_LIMIT = 232448;
constexpr int PART_BYTES = 64 * QT * 2;  // one bf16 part of dS^T, 64 keys x 64 queries
constexpr float LOG2E = 1.4426950408889634f;

struct Plan {
    int nwg, stages, k_bytes, v_bytes, q_bytes, do_bytes, total;
};

template <int DK>
__host__ __device__ Plan make_plan(int nwg, int stages, int dvp) {
    Plan p;
    p.nwg = nwg;
    p.stages = stages;
    p.k_bytes = 64 * nwg * DK * 2;
    p.v_bytes = 64 * nwg * dvp * 2;
    p.q_bytes = QT * DK * 2;
    p.do_bytes = QT * dvp * 2;
    p.total = 1024 + p.k_bytes + p.v_bytes + stages * (p.q_bytes + p.do_bytes) +
              nwg * 3 * PART_BYTES + 256;
    return p;
}

// DVC: dV columns a walk accumulates in registers; SUB: queries a sub-step
template <int DK, int DVC, int SUB>
__global__ void __launch_bounds__(256, 1)
flash_bwd_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dq_part, bf16* __restrict__ dk_out, bf16* __restrict__ dv_out,
               float* __restrict__ dv_run, int N, int M, int dk, int dv, int dvp, int stages) {
    extern __shared__ unsigned char smem_raw[];
    const int nwg = blockDim.x / 128;
    const Plan plan = make_plan<DK>(nwg, stages, dvp);
    const int KT = 64 * nwg;
    unsigned char* base = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    unsigned char* ks = base;
    unsigned char* vs = ks + plan.k_bytes;
    unsigned char* ring = vs + plan.v_bytes;
    const int stage_bytes = plan.q_bytes + plan.do_bytes;
    unsigned char* parts = ring + stages * stage_bytes;
    uint64_t* bars = reinterpret_cast<uint64_t*>(parts + nwg * 3 * PART_BYTES);
    uint64_t* full = bars;
    uint64_t* empty = bars + MAX_STAGES;
    uint64_t* kvbar = bars + 2 * MAX_STAGES;

    const int b = blockIdx.y;
    const int k0 = blockIdx.x * KT;
    const int nqt = (N + QT - 1) / QT;
    const int npass = (dv + DVC - 1) / DVC;
    const int ntiles = npass * nqt;

    auto load_tile = [&](int it) {  // thread 0: Q and dO of tile `it`
        const int st = it % stages;
        const int n0 = (it % nqt) * QT;
        unsigned char* qd = ring + st * stage_bytes;
        mbar_expect_tx(&full[st], stage_bytes);
        for (int bx = 0; bx < Tile<DK>::NB; ++bx)
            tma_load_3d(qd + bx * QT * Tile<DK>::RB, &tq, &full[st], bx * Tile<DK>::BW, n0, b);
        for (int bx = 0; bx < dvp / 64; ++bx)
            tma_load_3d(qd + plan.q_bytes + bx * QT * 128, &tdo, &full[st], bx * 64, n0, b);
    };

    if (threadIdx.x == 0) {
        for (int s = 0; s < stages; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], blockDim.x);
        }
        mbar_init(kvbar, 1);
        mbar_fence_init();
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        mbar_expect_tx(kvbar, plan.k_bytes + plan.v_bytes);
        for (int bx = 0; bx < Tile<DK>::NB; ++bx)
            tma_load_3d(ks + bx * KT * Tile<DK>::RB, &tk, kvbar, bx * Tile<DK>::BW, k0, b);
        for (int bx = 0; bx < dvp / 64; ++bx)
            tma_load_3d(vs + bx * KT * 128, &tv, kvbar, bx * 64, k0, b);
        for (int it = 0; it < stages && it < ntiles; ++it) load_tile(it);
    }
    // thread 0 refills a stage as soon as both warpgroups have released
    // it: without waiting (between sub-steps), or waiting where the tile
    // it is about to consume has not been issued yet
    int next_load = stages;
    auto pump = [&](int need) {
        while (next_load < ntiles) {
            const int old = next_load - stages;
            if (!mbar_test(&empty[old % stages], (old / stages) & 1)) {
                if (next_load > need) break;
                mbar_wait(&empty[old % stages], (old / stages) & 1);
            }
            load_tile(next_load++);
        }
    };

    const int w = threadIdx.x / 128;  // this warpgroup owns keys k0 + 64 w .. + 64
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int r = 16 * (t / 32) + lane / 4;  // key rows r and r + 8 of the warpgroup
    const int q2 = 2 * (lane % 4);
    const uint32_t ks_a = smem_u32(ks);
    const uint32_t vs_a = smem_u32(vs);
    const uint32_t ring_a = smem_u32(ring);
    const uint32_t parts_a = smem_u32(parts) + w * 3 * PART_BYTES;
    unsigned char* my_parts = parts + w * 3 * PART_BYTES;
    const float* lse_b = lse + (size_t)b * N;
    // The tensor cores sum a wgmma chain into its accumulator with their
    // own rounding, which drifts over hundreds of k-steps (dK read ~1e-5
    // of its mean at N = 5625). Where registers allow, each sub-step's dK
    // goes into a fresh accumulator added to the running one in f32, as
    // the plain version's sums round; dV's chain is cut every DV_FLUSH
    // tiles instead (the file's head).
    constexpr bool DK_TMP = !(DK == 128 && DVC == 256);
    // dS parts issued to the tensor cores before one wait (their bf16
    // fragments held in registers at once: 3 x SUB / 4)
    constexpr int PG = SUB == 32 ? 3 : 1;
    const float* delta_b = delta + (size_t)b * N;

    float dv_acc[DVC / 2];
    float dk_acc[DK / 2];
#pragma unroll
    for (int i = 0; i < DVC / 2; ++i) dv_acc[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < DK / 2; ++i) dk_acc[i] = 0.0f;

    mbar_wait(kvbar, 0);

    for (int it = 0; it < ntiles; ++it) {
        if (threadIdx.x == 0) pump(it);
        const int st = it % stages;
        const int pass = it / nqt;
        const int n0 = (it % nqt) * QT;
        mbar_wait(&full[st], (it / stages) & 1);
        const uint32_t qs_a = ring_a + st * stage_bytes;
        const uint32_t dos_a = qs_a + plan.q_bytes;

        if (pass == 0) named_sync(1 + w, 128);  // the parts of the last tile are read
#pragma unroll
        for (int sub = 0; sub < QT / SUB; ++sub) {
            const int c_sub = sub * SUB;  // first query of the sub-step in the tile
            float s[SUB / 2], dp[SUB / 2];
            // lse and D of the thread's queries (n0 + c_sub + 8 c + q2 + e),
            // loaded before the products so that the loads overlap them
            float lse_c[SUB / 4], d_c[SUB / 4];
#pragma unroll
            for (int c = 0; c < SUB / 8; ++c)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int n = n0 + c_sub + 8 * c + q2 + e;
                    lse_c[2 * c + e] = n < N ? __ldg(lse_b + n) : 0.0f;
                    d_c[2 * c + e] = n < N ? __ldg(delta_b + n) : 0.0f;
                }
            fence_regs(s);
            fence_regs(dp);
            wgmma_fence();
#pragma unroll
            for (int j = 0; j < DK / 16; ++j)
                wgmma_ss<SUB, 0, 0>(s, Tile<DK>::kmajor(ks_a, KT, 64 * w, j),
                                    Tile<DK>::kmajor(qs_a, QT, c_sub, j), j > 0);
            if (pass == 0) {
                for (int j = 0; j < dvp / 16; ++j) {
                    const int box = j / 4, off = (j % 4) * 32;
                    wgmma_ss<SUB, 0, 0>(
                        dp, make_desc(vs_a + box * KT * 128 + 64 * w * 128 + off, 16, 1024, 1),
                        make_desc(dos_a + box * QT * 128 + c_sub * 128 + off, 16, 1024, 1), j > 0);
                }
            }
            wgmma_commit();
            if (threadIdx.x == 0) pump(-1);
            wgmma_wait<0>();
            fence_regs(s);
            fence_regs(dp);

#pragma unroll
            for (int i = 0; i < SUB / 2; ++i)
                s[i] = ex2((s[i] - lse_c[2 * (i / 4) + i % 2]) * LOG2E);

            uint32_t pa[SUB / 16][4];
#pragma unroll
            for (int kk = 0; kk < SUB / 16; ++kk) acc_to_frag(pa[kk], s, kk);
            fence_regs(dv_acc);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < SUB / 16; ++kk)
                wgmma_rs<DVC, 1>(dv_acc, pa[kk],
                                 make_desc(dos_a + pass * (DVC / 64) * QT * 128 +
                                               (c_sub + 16 * kk) * 128,
                                           QT * 128, 1024, 1),
                                 1);
            wgmma_commit();
            if (pass == 0) {
#pragma unroll
                for (int i = 0; i < SUB / 2; ++i)
                    dp[i] = s[i] * (dp[i] - d_c[2 * (i / 4) + i % 2]);  // dS^T, f32
            }
            wgmma_wait<0>();
            fence_regs(dv_acc);
            if (pass != 0) continue;

            // dS^T as hi + mid + lo: each part the bf16 rounding of what
            // the earlier ones leave; dK of the sub-step into a fresh
            // accumulator where registers allow (DK_TMP)
            auto dk_mma = [&](float (&d)[DK / 2], bool fresh) {
#pragma unroll
                for (int p0 = 0; p0 < 3; p0 += PG) {
                    uint32_t fr[PG][SUB / 16][4];
#pragma unroll
                    for (int pp = 0; pp < PG; ++pp)
#pragma unroll
                        for (int kk = 0; kk < SUB / 16; ++kk)
#pragma unroll
                            for (int e4 = 0; e4 < 4; ++e4) {
                                const int i = 8 * kk + 2 * e4;
                                const __nv_bfloat162 h = __floats2bfloat162_rn(dp[i], dp[i + 1]);
                                fr[pp][kk][e4] = *reinterpret_cast<const uint32_t*>(&h);
                                dp[i] -= __low2float(h);
                                dp[i + 1] -= __high2float(h);
                                // dS^T[key row][query] into the part (128-byte
                                // rows, swizzled as TMA writes them)
                                const int row = r + 8 * (e4 % 2);
                                const int chunk = (c_sub >> 3) + 2 * kk + e4 / 2;
                                *reinterpret_cast<uint32_t*>(my_parts + (p0 + pp) * PART_BYTES +
                                                             row * 128 +
                                                             ((chunk ^ (row & 7)) << 4) + q2 * 2) =
                                    fr[pp][kk][e4];
                            }
                    fence_regs(d);
                    wgmma_fence();
#pragma unroll
                    for (int pp = 0; pp < PG; ++pp)
#pragma unroll
                        for (int kk = 0; kk < SUB / 16; ++kk)
                            wgmma_rs<DK, 1>(d, fr[pp][kk], Tile<DK>::mnmajor(qs_a, QT, c_sub, kk),
                                            !fresh || p0 + pp > 0 || kk > 0);
                    wgmma_commit();
                    wgmma_wait<0>();
                    fence_regs(d);
                }
            };
            if constexpr (DK_TMP) {
                float dk_tmp[DK / 2];
                dk_mma(dk_tmp, true);
#pragma unroll
                for (int i = 0; i < DK / 2; ++i) dk_acc[i] += dk_tmp[i];
            } else {
                dk_mma(dk_acc, false);
            }
        }

        if (pass == 0) {
            // dQ of the tile's 64 queries over this warpgroup's 64 keys
            fence_async_smem();
            named_sync(1 + w, 128);
            float dq[DK / 2];
            fence_regs(dq);
            wgmma_fence();
#pragma unroll
            for (int part = 0; part < 3; ++part)
#pragma unroll
                for (int kk = 0; kk < 4; ++kk)
                    wgmma_ss<DK, 1, 1>(
                        dq, make_desc(parts_a + part * PART_BYTES + kk * 16 * 128, 16, 1024, 1),
                        Tile<DK>::mnmajor(ks_a, KT, 64 * w, kk), part > 0 || kk > 0);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(dq);
            const size_t slot = (size_t)blockIdx.x * nwg + w;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int n = n0 + r + 8 * h;
                if (n >= N) continue;
                float* row = dq_part + ((slot * gridDim.y + b) * N + n) * dk;
#pragma unroll
                for (int c = 0; c < DK / 8; ++c) {
                    const int col = 8 * c + q2;
                    if (col < dk)
                        *reinterpret_cast<float2*>(row + col) =
                            make_float2(dq[4 * c + 2 * h], dq[4 * c + 2 * h + 1]);
                }
            }
        }
        mbar_arrive(&empty[st]);

        const int tile = it % nqt;
        if (tile % DV_FLUSH == DV_FLUSH - 1 && tile != nqt - 1) {
            // the end of a segment of dV's chain: its sum into dv_run
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int m = k0 + 64 * w + r + 8 * h;
                if (m >= M) continue;
                float* run = dv_run + ((size_t)b * M + m) * dv + pass * DVC;
#pragma unroll
                for (int c = 0; c < DVC / 8; ++c) {
                    const int col = 8 * c + q2;
                    if (pass * DVC + col < dv) {
                        float2 sum = make_float2(dv_acc[4 * c + 2 * h], dv_acc[4 * c + 2 * h + 1]);
                        if (tile >= DV_FLUSH) {
                            const float2 prev = *reinterpret_cast<const float2*>(run + col);
                            sum = make_float2(prev.x + sum.x, prev.y + sum.y);
                        }
                        *reinterpret_cast<float2*>(run + col) = sum;
                    }
                }
            }
#pragma unroll
            for (int i = 0; i < DVC / 2; ++i) dv_acc[i] = 0.0f;
        }

        if (tile == nqt - 1) {
            // the end of a walk: its dV columns (and dK after the first)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int m = k0 + 64 * w + r + 8 * h;
                if (m >= M) continue;
                bf16* vrow = dv_out + ((size_t)b * M + m) * dv + pass * DVC;
                const float* run = dv_run + ((size_t)b * M + m) * dv + pass * DVC;
#pragma unroll
                for (int c = 0; c < DVC / 8; ++c) {
                    const int col = 8 * c + q2;
                    if (pass * DVC + col < dv) {
                        float2 sum = make_float2(dv_acc[4 * c + 2 * h], dv_acc[4 * c + 2 * h + 1]);
                        if (nqt > DV_FLUSH) {
                            const float2 prev = *reinterpret_cast<const float2*>(run + col);
                            sum = make_float2(prev.x + sum.x, prev.y + sum.y);
                        }
                        *reinterpret_cast<__nv_bfloat162*>(vrow + col) =
                            __floats2bfloat162_rn(sum.x, sum.y);
                    }
                }
                if (pass == 0) {
                    bf16* krow = dk_out + ((size_t)b * M + m) * dk;
#pragma unroll
                    for (int c = 0; c < DK / 8; ++c) {
                        const int col = 8 * c + q2;
                        if (col < dk)
                            *reinterpret_cast<__nv_bfloat162*>(krow + col) =
                                __floats2bfloat162_rn(dk_acc[4 * c + 2 * h],
                                                      dk_acc[4 * c + 2 * h + 1]);
                    }
                }
            }
#pragma unroll
            for (int i = 0; i < DVC / 2; ++i) dv_acc[i] = 0.0f;
        }
    }
}

// dq[i .. i + 3] = bf16(sum over s < slots of part[s * n + i ..]), s
// ascending (n = B * N * dk, a multiple of 4)
__global__ void __launch_bounds__(256)
dq_reduce(const float* __restrict__ part, bf16* __restrict__ dq, int slots, size_t n) {
    const size_t i = 4 * ((size_t)blockIdx.x * blockDim.x + threadIdx.x);
    if (i >= n) return;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int s = 0; s < slots; ++s) {
        const float4 v = __ldcs(reinterpret_cast<const float4*>(part + s * n + i));
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
    }
    __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(dq + i);
    out[0] = __floats2bfloat162_rn(acc.x, acc.y);
    out[1] = __floats2bfloat162_rn(acc.z, acc.w);
}

template <int DK, int DVC, int SUB>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dO, const float* lse,
                   const float* delta, float* dq_part, int max_slots, bf16* dq, bf16* dk_out,
                   bf16* dv_out, float* dv_run, int B, int N, int M, int dk, int dv,
                   cudaStream_t stream) {
    const int dvp = (dv + 63) / 64 * 64;
    int nwg = 2, stages = MAX_STAGES;
    while (make_plan<DK>(nwg, stages, dvp).total > SMEM_LIMIT) {
        if (stages > 1) --stages;
        else if (nwg == 2) nwg = 1, stages = MAX_STAGES;
        else return cudaErrorInvalidValue;
    }
    const int smem = make_plan<DK>(nwg, stages, dvp).total;
    const int kt = 64 * nwg;
    const int slots = (M + kt - 1) / kt * nwg;
    if (slots > max_slots) return cudaErrorInvalidValue;
    CUtensorMap tq, tk, tv, tdo;
    const int bw = Tile<DK>::BW;
    if (!sm90_host::tensor_map_cached(&tq, q, B, N, dk, QT, bw) ||
        !sm90_host::tensor_map_cached(&tk, k, B, M, dk, kt, bw) ||
        !sm90_host::tensor_map_cached(&tv, v, B, M, dv, kt, 64) ||
        !sm90_host::tensor_map_cached(&tdo, dO, B, N, dv, QT, 64))
        return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_sm90<DK, DVC, SUB>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((M + kt - 1) / kt, B);
    flash_bwd_sm90<DK, DVC, SUB><<<grid, 128 * nwg, smem, stream>>>(
        tq, tk, tv, tdo, lse, delta, dq_part, dk_out, dv_out, dv_run, N, M, dk, dv, dvp, stages);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const size_t n = (size_t)B * N * dk;
    dq_reduce<<<(unsigned)((n / 4 + 255) / 256), 256, 0, stream>>>(dq_part, dq, slots, n);
    return cudaGetLastError();
}

template <int DK>
cudaError_t launch_dk(const void* q, const void* k, const void* v, const void* dO,
                      const float* lse, const float* delta, float* dq_part, int max_slots,
                      bf16* dq, bf16* dk_out, bf16* dv_out, float* dv_run, int B, int N, int M,
                      int dk, int dv, cudaStream_t s) {
    if (dv <= 128)
        return launch<DK, 128, 64>(q, k, v, dO, lse, delta, dq_part, max_slots, dq, dk_out,
                                   dv_out, dv_run, B, N, M, dk, dv, s);
    return launch<DK, 256, 32>(q, k, v, dO, lse, delta, dq_part, max_slots, dq, dk_out, dv_out,
                               dv_run, B, N, M, dk, dv, s);
}

}  // namespace

// q [B,N,dk], k [B,M,dk], v [B,M,dv], dO [B,N,dv] bf16; lse, delta [B,N]
// f32 (delta = rowsum(f32(dO) * O)); dq_part [max_slots,B,N,dk] f32
// scratch, max_slots >= 2 * ceil(M / 128); dq [B,N,dk], dk_out [B,M,dk],
// dv_out [B,M,dv] bf16; dv_run [B,M,dv] f32 scratch (used where N > 64 *
// DV_FLUSH). All contiguous and 16-byte aligned; dk in 16..128 and dv in
// 16..512, multiples of 16. Launches the kernel and dq_reduce on
// `stream` and returns the CUDA error code (0 on success).
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v, const void* dO,
                              const void* lse, const void* delta, void* dq_part, void* dq,
                              void* dk_out, void* dv_out, void* dv_run, int B, int N, int M,
                              int dk, int dv, int max_slots, void* stream) {
    if (B < 1 || N < 1 || M < 1 || dk % 16 || dk < 16 || dk > 128 || dv % 16 || dv < 16 ||
        dv > 512)
        return (int)cudaErrorInvalidValue;
    const float* ll = static_cast<const float*>(lse);
    const float* dd = static_cast<const float*>(delta);
    float* dp = static_cast<float*>(dq_part);
    bf16* dqq = static_cast<bf16*>(dq);
    bf16* dkk = static_cast<bf16*>(dk_out);
    bf16* dvv = static_cast<bf16*>(dv_out);
    float* dvr = static_cast<float*>(dv_run);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (dk <= 32)
        err = launch_dk<32>(q, k, v, dO, ll, dd, dp, max_slots, dqq, dkk, dvv, dvr, B, N, M, dk,
                            dv, s);
    else if (dk <= 64)
        err = launch_dk<64>(q, k, v, dO, ll, dd, dp, max_slots, dqq, dkk, dvv, dvr, B, N, M, dk,
                            dv, s);
    else
        err = launch_dk<128>(q, k, v, dO, ll, dd, dp, max_slots, dqq, dkk, dvv, dvr, B, N, M, dk,
                             dv, s);
    return (int)err;
}

extern "C" const char* flash_attn_bwd_error(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
