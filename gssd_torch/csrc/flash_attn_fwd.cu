// Fused SAGAN attention forward for Hopper (sm_90a):
//   o = softmax(q k^T) v,   lse = logsumexp(q k^T)   per image.
//
// Replaces gssd_tpu/ops/pallas/flash_attn.py _fwd_kernel (the Pallas TPU
// kernel). Same arithmetic: f32 logits with no 1/sqrt(dk) scale, the
// exact two-pass softmax (row max and sum first, then P = exp(s - lse)
// normalised in f32 and THEN rounded to bf16), P.V with f32 sums, f32
// output plus the row lse. An online softmax would round the
// unnormalised P and is another function at the bf16 level.
//
// What bounds it here: 2*N*M*(dk + dv) tensor-core operations and one
// exp per logit per pass, against a few MB of q/k/v/o. At the 75x75
// PixelLink++ site (dk 32) the two exps per logit on the MUFU unit
// (16 a clock per SM) cost as much as the products.
//
// Design (one block = 128 query rows of one image and up to 256 value
// columns; 3 warpgroups):
// - warpgroup 2 is the producer: one thread streams Q once and then the
//   key tiles by TMA into a ring of shared-memory stages, each guarded by
//   a "full" and an "empty" mbarrier; it gives its registers to the
//   consumers (setmaxnreg);
// - warpgroups 0 and 1 own 64 query rows each. Pass 1 walks the K tiles
//   (64 keys): S = Q K^T by wgmma (both operands in shared memory), and a
//   per-thread running max and sum of exp; pass 2 walks K and V again:
//   S again, P = exp2((s - lse) * log2 e) (one MUFU ex2 per logit) packed
//   to bf16 straight from the accumulator registers, which are the
//   A-operand layout, and O += P V by wgmma with V read from shared memory
//   in its row-major [M, dv] layout (MN-major B, the transpose bit).
// - Swizzle by dk: 64-byte rows at dk 32, 128-byte rows at dk 64, two
//   64-column boxes at dk 128; other dk take the next of these widths
//   and TMA fills the extra columns with zeros, as it fills key rows past
//   M (masked to -inf in the last tile only) and query rows past N.
// - dv <= 128 is one 128-column accumulator, dv <= 256 one of 256 (128
//   registers a thread); wider dv (the fc7 sites, 512) splits over
//   blockIdx.y, each slice recomputing S and P.

#include "flash_sm90.cuh"

#include <math.h>

namespace {

using namespace sm90;

constexpr int BM = 128;           // query rows per block
constexpr int TM = 64;            // keys per tile
constexpr int THREADS = 384;      // 2 consumer warpgroups + the producer
constexpr int MAX_STAGES = 4;
constexpr int SMEM_LIMIT = 232448;
constexpr float LOG2E = 1.4426950408889634f;

struct Smem {
    int q_bytes, k_bytes, v_bytes, stages, total;
};

template <int DK, int DVT>
__host__ __device__ Smem smem_plan(int stages) {
    Smem s;
    s.q_bytes = BM * DK * 2;
    s.k_bytes = TM * DK * 2;
    s.v_bytes = TM * DVT * 2;
    s.stages = stages;
    s.total = 1024 + s.q_bytes + stages * (s.k_bytes + s.v_bytes) + 256;
    return s;
}

template <int DK, int DVT>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, float* __restrict__ o,
               float* __restrict__ lse, int N, int M, int dv, int stages) {
    extern __shared__ unsigned char smem_raw[];
    const Smem plan = smem_plan<DK, DVT>(stages);
    unsigned char* base = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    unsigned char* qs = base;
    unsigned char* ring = qs + plan.q_bytes;
    const int stage_bytes = plan.k_bytes + plan.v_bytes;
    uint64_t* bars = reinterpret_cast<uint64_t*>(ring + stages * stage_bytes);
    uint64_t* full = bars;
    uint64_t* empty = bars + MAX_STAGES;
    uint64_t* qbar = bars + 2 * MAX_STAGES;

    const int b = blockIdx.z;
    const int n0 = blockIdx.x * BM;
    const int c0 = blockIdx.y * DVT;
    const int T = (M + TM - 1) / TM;
    const int wg = threadIdx.x / 128;

    if (threadIdx.x == 0) {
        for (int s = 0; s < stages; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 256);
        }
        mbar_init(qbar, 1);
        mbar_fence_init();
    }
    __syncthreads();

    if (wg == 2) {
        // ---- producer ----
        reg_dealloc<24>();
        if (threadIdx.x == 256) {
            mbar_expect_tx(qbar, plan.q_bytes);
            for (int bx = 0; bx < Tile<DK>::NB; ++bx)
                tma_load_3d(qs + bx * BM * Tile<DK>::RB, &tq, qbar, bx * Tile<DK>::BW, n0, b);
            for (int it = 0; it < 2 * T; ++it) {
                const int st = it % stages;
                const bool pass2 = it >= T;
                const int m0 = (pass2 ? it - T : it) * TM;
                mbar_wait(&empty[st], ((it / stages) & 1) ^ 1);
                unsigned char* ks = ring + st * stage_bytes;
                mbar_expect_tx(&full[st], plan.k_bytes + (pass2 ? plan.v_bytes : 0));
                for (int bx = 0; bx < Tile<DK>::NB; ++bx)
                    tma_load_3d(ks + bx * TM * Tile<DK>::RB, &tk, &full[st],
                                bx * Tile<DK>::BW, m0, b);
                if (pass2)
                    for (int bx = 0; bx < DVT / 64; ++bx)
                        tma_load_3d(ks + plan.k_bytes + bx * TM * 128, &tv, &full[st],
                                    c0 + bx * 64, m0, b);
            }
        }
        return;
    }

    // ---- consumers: warpgroup wg owns query rows n0 + 64 wg .. + 64 ----
    reg_alloc<240>();
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int r = 16 * (t / 32) + lane / 4;  // rows r and r + 8 of the warpgroup
    const int q2 = 2 * (lane % 4);          // first of the thread's two columns per chunk
    const uint32_t qs_a = smem_u32(qs);
    const uint32_t ring_a = smem_u32(ring);
    const int ragged = M - (T - 1) * TM;  // valid keys of the last tile

    auto logits = [&](float (&s)[32], int st) {
        const uint32_t ks_a = ring_a + st * stage_bytes;
        fence_regs(s);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < DK / 16; ++j)
            wgmma_ss<TM, 0, 0>(s, Tile<DK>::kmajor(qs_a, BM, 64 * wg, j),
                               Tile<DK>::kmajor(ks_a, TM, 0, j), j > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
    };
    auto mask_last = [&](float (&s)[32], int tile) {
        if (tile == T - 1 && ragged < TM) {
#pragma unroll
            for (int i = 0; i < 32; ++i)
                if (8 * (i / 4) + q2 + (i % 2) >= ragged) s[i] = -INFINITY;
        }
    };

    mbar_wait(qbar, 0);

    // pass 1: per-thread max and sum of exp over its own columns of rows
    // r (h = 0) and r + 8 (h = 1)
    float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.0f, 0.0f};
    for (int it = 0; it < T; ++it) {
        const int st = it % stages;
        mbar_wait(&full[st], (it / stages) & 1);
        float s[32];
        logits(s, st);
        mbar_arrive(&empty[st]);
        mask_last(s, it);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            float mx = -INFINITY;
#pragma unroll
            for (int c = 0; c < 8; ++c) mx = fmaxf(mx, fmaxf(s[4 * c + 2 * h], s[4 * c + 2 * h + 1]));
            const float m_new = fmaxf(m_r[h], mx);
            if (m_new == -INFINITY) continue;  // no valid column of this row yet
            float sum = 0.0f;
#pragma unroll
            for (int c = 0; c < 8; ++c)
                sum += ex2((s[4 * c + 2 * h] - m_new) * LOG2E) +
                       ex2((s[4 * c + 2 * h + 1] - m_new) * LOG2E);
            l_r[h] = l_r[h] * ex2((m_r[h] - m_new) * LOG2E) + sum;
            m_r[h] = m_new;
        }
    }
    float row_lse[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        float m = m_r[h];
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        float l = m_r[h] == -INFINITY ? 0.0f : l_r[h] * ex2((m_r[h] - m) * LOG2E);
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        row_lse[h] = m + logf(l);
    }
    if (blockIdx.y == 0 && q2 == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int n = n0 + 64 * wg + r + 8 * h;
            if (n < N) lse[(size_t)b * N + n] = row_lse[h];
        }
    }

    // pass 2: normalised bf16 P from the logit registers, O += P V
    float acc[DVT / 2];
#pragma unroll
    for (int i = 0; i < DVT / 2; ++i) acc[i] = 0.0f;
    for (int it = T; it < 2 * T; ++it) {
        const int st = it % stages;
        mbar_wait(&full[st], (it / stages) & 1);
        float s[32];
        logits(s, st);
        mask_last(s, it - T);
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = ex2((s[i] - row_lse[(i / 2) % 2]) * LOG2E);
        uint32_t pa[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) acc_to_frag(pa[kk], s, kk);
        const uint32_t vs_a = ring_a + st * stage_bytes + plan.k_bytes;
        // the tile's P V into a fresh accumulator added to the running
        // one in f32 where registers allow (DVT 128): a wgmma chain's own
        // rounding drifts over hundreds of k-steps (N = 5625)
        float tmp[DVT == 128 ? DVT / 2 : 1];
        float (&dst)[DVT / 2] = *reinterpret_cast<float (*)[DVT / 2]>(DVT == 128 ? tmp : acc);
        fence_regs(acc);
        fence_regs(dst);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            // V rows 16 kk .. + 16 (the reduction), DVT columns in 64-column boxes
            const uint64_t db = make_desc(vs_a + kk * 16 * 128, TM * 128, 1024, 1);
            wgmma_rs<DVT, 1>(dst, pa[kk], db, DVT == 128 ? kk > 0 : 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dst);
        mbar_arrive(&empty[st]);
        if constexpr (DVT == 128) {
#pragma unroll
            for (int i = 0; i < DVT / 2; ++i) acc[i] += tmp[i];
        }
        fence_regs(acc);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int n = n0 + 64 * wg + r + 8 * h;
        if (n >= N) continue;
        float* orow = o + ((size_t)b * N + n) * dv + c0;
#pragma unroll
        for (int c = 0; c < DVT / 8; ++c) {
            const int col = 8 * c + q2;
            if (c0 + col < dv)
                *reinterpret_cast<float2*>(orow + col) =
                    make_float2(acc[4 * c + 2 * h], acc[4 * c + 2 * h + 1]);
        }
    }
}

template <int DK, int DVT>
cudaError_t launch(const void* q, const void* k, const void* v, float* o, float* lse, int B,
                   int N, int M, int dk, int dv, cudaStream_t stream) {
    int stages = MAX_STAGES;
    while (stages > 2 && smem_plan<DK, DVT>(stages).total > SMEM_LIMIT) --stages;
    const int smem = smem_plan<DK, DVT>(stages).total;
    if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
    CUtensorMap tq, tk, tv;
    const int bw = Tile<DK>::BW;
    if (!sm90_host::tensor_map_cached(&tq, q, B, N, dk, BM, bw) ||
        !sm90_host::tensor_map_cached(&tk, k, B, M, dk, TM, bw) ||
        !sm90_host::tensor_map_cached(&tv, v, B, M, dv, TM, 64))
        return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_sm90<DK, DVT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((N + BM - 1) / BM, (dv + DVT - 1) / DVT, B);
    flash_fwd_sm90<DK, DVT><<<grid, THREADS, smem, stream>>>(tq, tk, tv, o, lse, N, M, dv, stages);
    return cudaGetLastError();
}

template <int DK>
cudaError_t launch_dk(const void* q, const void* k, const void* v, float* o, float* lse, int B,
                      int N, int M, int dk, int dv, cudaStream_t s) {
    return dv <= 128 ? launch<DK, 128>(q, k, v, o, lse, B, N, M, dk, dv, s)
                     : launch<DK, 256>(q, k, v, o, lse, B, N, M, dk, dv, s);
}

}  // namespace

// q [B,N,dk], k [B,M,dk], v [B,M,dv] bf16; o [B,N,dv] f32; lse [B,N] f32.
// All contiguous and 16-byte aligned; dk, dv multiples of 16, dk <= 128.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                              int B, int N, int M, int dk, int dv, void* stream) {
    if (B < 1 || N < 1 || M < 1 || dk % 16 || dk > 128 || dk < 16 || dv % 16 || dv < 16)
        return (int)cudaErrorInvalidValue;
    float* oo = static_cast<float*>(o);
    float* ll = static_cast<float*>(lse);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (dk <= 32) err = launch_dk<32>(q, k, v, oo, ll, B, N, M, dk, dv, s);
    else if (dk <= 64) err = launch_dk<64>(q, k, v, oo, ll, B, N, M, dk, dv, s);
    else err = launch_dk<128>(q, k, v, oo, ll, B, N, M, dk, dv, s);
    return (int)err;
}

extern "C" const char* flash_attn_fwd_error(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
