// Modulated deformable convolution (DCNv2) forward for Hopper (sm_90a).
//
//   out[b, p, n] = bias[n] + sum_{g, k, c} samp[b, p, g, k, c] * wg[g, k, c, n]
//   samp         = bf16( sum_{4 corners} bf16(ay * bx * m[b, p, g, k]) * x[b, corner, g*Cg + c] )
//
// Replaces gssd_tpu/ops/pallas/deform_hat.py _fwd_kernel /
// _fwd_kernel_allwin / _fwd_kernel_stacked (the Pallas TPU kernels behind
// deform_conv2d_hat). The TPU kernel writes bilinear sampling as a dense
// "hat" matrix product over the whole flattened map, because a TPU
// gathers badly. A GPU gathers well, so this kernel samples the four
// corners directly (csrc/deform_gather.cuh: the plain version's corner
// weights, blend order and roundings, so every bf16 sample equals
// deform_conv_fwd_plain's bit for bit), and the samples times the
// weights is a GEMM of [B*P] x [G*K*Cg] by [G*K*Cg] x [Cout], bf16
// operands, f32 sums.
//
// What bounds it: the GEMM is 2*B*P*K*C*Cout operations (436 GFLOP at
// batch 32, 38x38, C 1024, Cout 512: 0.44 ms of tensor-core time) against
// tens of MB from device memory; what the design must also feed is the
// L2: every 64-pixel tile reads all of wg (9.4 MB at that site) and
// gathers 4 corners x 2 bytes per sample (4.7 MB a tile, 3.4 GB at batch
// 32).
//
// Design: a persistent loop over tiles of flattened (b, p) pixels across
// ALL of Cout, so that each sample is gathered and blended once:
// - two consumer warpgroups run wgmma on a ring of shared-memory stages,
//   one stage per (g, k, 64-channel chunk): at Cout 257..512 both take
//   the same 64 pixels, each m64n256 over half of Cout; at Cout <= 256
//   each takes 64 of a 128-pixel tile over all of Cout (n64, n128 or
//   n256), so that each weight slice serves twice the pixels. A = the
//   pixels x 64 bf16 sample tile (K-major, 128-byte rows, swizzled as
//   TMA would write them), B = the 64 x Cout weight slice wg[g, k,
//   c0:c0+64, :] read by TMA in 64-column boxes (MN-major, the transpose
//   bit);
// - a producer warpgroup: one thread issues the weight TMA of a stage,
//   the warpgroup builds the corner table of a (g, k) once (a pixel a
//   thread: 4 corner indices and bf16 weights), then forms the samples,
//   4 or 8 (pixel, 8-channel) items a thread in parts of two, loading
//   each corner 16 bytes (8 channels) at a time, each part's 8 loads
//   issued before the part before it is blended (software-pipelined
//   across stages), and writes them into the stage, then
//   fence.proxy.async and arrives on the stage's "full" mbarrier;
// - the consumers release a stage on its "empty" mbarrier once its
//   wgmma has retired (one group kept in flight), and add the bias in the
//   epilogue (f32 pairs straight from the accumulator registers) while
//   the producers already fill the ring for the next tile;
// - the tiles go in pairs to 2-CTA clusters that walk the same stages:
//   each CTA loads every other 64-column box of a weight slice, by TMA
//   multicast into both, so the weights stream from L2 once per two
//   tiles (at 38x38, batch 32, 3.4 GB where it would be 6.8); a stage is
//   free again when the consumers of both CTAs have released it (lane 0
//   of every warp arrives on both CTAs' "empty" barrier).
// At n256 that is 128 f32 accumulators a consumer thread, in a block of
// 384 threads (168 registers each: ptxas compiles every role to the
// launch bound, so the producers keep as many).
// Cout > 512 loops over 512-column slices (each gathers again). The
// weights go through a 3-d tensor map [G*K][Cg][Cout] whose rows past Cg
// and columns past Cout read as zeros (the wrapper pads Cout to a
// multiple of 8 for TMA's 16-byte strides); samples past Cg and pixels
// past B*P are zeros. Coordinates py/px arrive precomputed (base + tap +
// offset, f32), so one kernel serves every map size, stride and dilation.

#include "deform_gather.cuh"
#include "flash_sm90.cuh"

namespace {

using namespace sm90;
using namespace dcn;

constexpr int KC = 64;          // channels a stage (128-byte rows)
constexpr int PRODUCERS = 128;  // one warpgroup
constexpr int SMEM_LIMIT = 232448;

// MW x NW consumer warpgroups of m64nNT: MW along the pixels (a tile is
// 64 MW pixels), NW along Cout (a tile is NW NT columns)
template <int MW, int NW, int NT>
struct FwdPlan {
    static constexpr int BM = 64 * MW;               // pixels a tile
    static constexpr int CONSUMERS = MW * NW * 128;
    static constexpr int THREADS = CONSUMERS + PRODUCERS;
    static constexpr int COLS = NW * NT;             // Cout columns a tile
    static constexpr int B_BYTES = KC * COLS * 2;    // weight slice of a stage
    static constexpr int A_BYTES = BM * KC * 2;      // sample tile of a stage
    static constexpr int STAGE = B_BYTES + A_BYTES;
    static constexpr int TABLE = BM * 4 * 8;         // corner index + weight
    static constexpr int FIXED = 1024 + TABLE + 256;
    static constexpr int STAGES = (SMEM_LIMIT - FIXED) / STAGE >= 4 ? 4 : (SMEM_LIMIT - FIXED) / STAGE;
    static constexpr int TOTAL = FIXED + STAGES * STAGE;
    static constexpr int PARTS = 2 * MW;             // producer parts of two items a stage
};

// The consumers: warpgroup (mwi, nwi) owns pixels r0 + 64 mwi .. + 64
// and columns n0 + NT nwi .. + NT of each tile; a stage is released on
// both CTAs' "empty" barriers by lane 0 of every warp once its wgmma has
// retired.
template <int MW, int NW, int NT>
__device__ __forceinline__ void consume(unsigned char* asm_, unsigned char* bsm, uint64_t* full,
                                        uint64_t* empty, const float* __restrict__ bias,
                                        float* __restrict__ out, int BP, int Cout, int steps,
                                        int pairs_m, int pairs, uint32_t rank, int cluster,
                                        int clusters) {
    using Plan = FwdPlan<MW, NW, NT>;
    constexpr int STAGES = Plan::STAGES;
    const int wgi = threadIdx.x / 128;
    const int mwi = wgi / NW, nwi = wgi % NW;
    const int tt = threadIdx.x % 128;
    const int lane = tt % 32;
    const int rr = 64 * mwi + 16 * (tt / 32) + lane / 4;  // rows rr and rr + 8 of the tile
    const int q2 = 2 * (lane % 4);
    const bool pairs_out = (Cout % 2) == 0;
    auto release = [&](int st) {
        if (lane == 0) {
            mbar_arrive(&empty[st]);
            mbar_arrive_remote(&empty[st], rank ^ 1);
        }
    };
    int it = 0;
    for (int pair = cluster; pair < pairs; pair += clusters) {
        const int r0 = (2 * (pair % pairs_m) + (int)rank) * Plan::BM;
        const int n0 = (pair / pairs_m) * Plan::COLS + nwi * NT;
        float acc[NT / 2];
#pragma unroll
        for (int i = 0; i < NT / 2; ++i) acc[i] = 0.0f;
        for (int s = 0; s < steps; ++s, ++it) {
            const int st = it % STAGES;
            mbar_wait(&full[st], (it / STAGES) & 1);
            const uint32_t a_a = smem_u32(asm_ + st * Plan::A_BYTES) + mwi * 64 * 128;
            const uint32_t b_a = smem_u32(bsm + st * Plan::B_BYTES) + nwi * (NT / 64) * KC * 128;
            fence_regs(acc);
            wgmma_fence();
#pragma unroll
            for (int j = 0; j < KC / 16; ++j)
                wgmma_ss<NT, 0, 1>(acc, make_desc(a_a + 32 * j, 16, 1024, 1),
                                   make_desc(b_a + j * 16 * 128, KC * 128, 1024, 1), 1);
            wgmma_commit();
            wgmma_wait<1>();
            fence_regs(acc);
            if (s > 0) release((it - 1) % STAGES);
        }
        wgmma_wait<0>();
        fence_regs(acc);
        release((it - 1) % STAGES);

#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = r0 + rr + 8 * h;
            if (r >= BP) continue;
            float* orow = out + (size_t)r * Cout;
#pragma unroll
            for (int c = 0; c < NT / 8; ++c) {
                const int n = n0 + 8 * c + q2;
                const float v0 = acc[4 * c + 2 * h], v1 = acc[4 * c + 2 * h + 1];
                if (pairs_out && n + 1 < Cout) {
                    *reinterpret_cast<float2*>(orow + n) = make_float2(v0 + bias[n], v1 + bias[n + 1]);
                } else {
                    if (n < Cout) orow[n] = v0 + bias[n];
                    if (n + 1 < Cout) orow[n + 1] = v1 + bias[n + 1];
                }
            }
        }
    }
}

template <int MW, int NW, int NT, bool VEC>
__global__ void __launch_bounds__(FwdPlan<MW, NW, NT>::THREADS, 1)
deform_fwd_sm90(const __grid_constant__ CUtensorMap tw,  // wg [G*K][Cg][Cout8]
                const bf16* __restrict__ x,              // [B, H, W, C]
                const float* __restrict__ py,            // [B*P, G, K]
                const float* __restrict__ px,
                const float* __restrict__ mk,
                const float* __restrict__ bias,          // [Cout]
                float* __restrict__ out,                 // [B*P, Cout]
                int H, int W, int C, int G, int K, int P, int BP, int Cout, int pairs_m,
                int pairs) {
    using Plan = FwdPlan<MW, NW, NT>;
    constexpr int STAGES = Plan::STAGES;
    constexpr int BM = Plan::BM;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* base = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    unsigned char* bsm = base;                             // [STAGES][B_BYTES]
    unsigned char* asm_ = bsm + STAGES * Plan::B_BYTES;    // [STAGES][A_BYTES]
    int* tpix = reinterpret_cast<int*>(asm_ + STAGES * Plan::A_BYTES);  // [BM][4]
    float* tw4 = reinterpret_cast<float*>(tpix + BM * 4);              // [BM][4]
    uint64_t* full = reinterpret_cast<uint64_t*>(tw4 + BM * 4);
    uint64_t* empty = full + STAGES;

    const int Cg = C / G;
    const int GK = G * K;
    const int nc = (Cg + KC - 1) / KC;  // stages per (g, k)
    // the two CTAs of a cluster take the two tiles of a pair, in step
    const uint32_t rank = cluster_rank();
    const int cluster = blockIdx.x / 2, clusters = gridDim.x / 2;

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], 1 + PRODUCERS);  // the TMA's expect_tx + every producer
            // every consumer warp of both CTAs: both read the weights this
            // CTA's TMA writes
            mbar_init(&empty[s], 2 * Plan::CONSUMERS / 32);
        }
        mbar_fence_init();
    }
    cluster_sync();

    if (threadIdx.x >= Plan::CONSUMERS) {
        // ---- producers ----
        const int t = threadIdx.x - Plan::CONSUMERS;
        // a stage's BM x 64 samples are 8 BM (pixel, 8-channel) items, 4 MW
        // a thread, formed in PARTS parts of two: each part's 8 corner
        // loads are issued before the part before it is blended, so that
        // loads are always in flight (item e = t + 128 (2 part + i))
        struct Part {
            uint32_t v[2][4][4];  // the corners of two items
            float w[2][4];        // their corner weights
        };
        auto issue = [&](Part& pt, int g, int c0, int part) {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const int e = t + PRODUCERS * (2 * part + i);
                const int row = e >> 3;
                const int c = c0 + 8 * (e & 7);
                const int4 pix = *reinterpret_cast<const int4*>(tpix + row * 4);
                const float4 w = *reinterpret_cast<const float4*>(tw4 + row * 4);
                const int corner[4] = {pix.x, pix.y, pix.z, pix.w};
#pragma unroll
                for (int q = 0; q < 4; ++q)
                    load_words<4, VEC>(pt.v[i][q], x + (size_t)corner[q] * C + g * Cg + c, Cg - c);
                pt.w[i][0] = w.x, pt.w[i][1] = w.y, pt.w[i][2] = w.z, pt.w[i][3] = w.w;
            }
        };
        auto blend_into = [&](Part& pt, int st, int part) {
            unsigned char* as = asm_ + st * Plan::A_BYTES;
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const int e = t + PRODUCERS * (2 * part + i);
                const int row = e >> 3, oct = e & 7;
                uint32_t o[4];
                blend<4>(o, pt.v[i], pt.w[i]);
                *reinterpret_cast<uint4*>(as + row * 128 + ((oct ^ (row & 7)) << 4)) =
                    make_uint4(o[0], o[1], o[2], o[3]);
            }
            if (part == Plan::PARTS - 1) {  // the stage's samples are complete
                fence_async_smem();
                mbar_arrive(&full[st]);
            }
        };
        Part even, odd;
        int it = 0, pend_st = -1, pend_part = 0;  // the part still to blend (in `odd`)
        for (int pair = cluster; pair < pairs; pair += clusters) {
            const int r0 = (2 * (pair % pairs_m) + (int)rank) * BM;
            const int n0 = (pair / pairs_m) * Plan::COLS;
            for (int gk = 0; gk < GK; ++gk) {
                const int g = gk / K;
                named_sync(1, PRODUCERS);  // every load of the previous table is issued
                if (t < BM) {
                    const int r = r0 + t;
                    float fy = 0.0f, fx = 0.0f, m = 0.0f;
                    int img = 0;
                    if (r < BP) {
                        const size_t o = (size_t)r * GK + gk;
                        fy = py[o], fx = px[o], m = mk[o];
                        img = r / P;
                    }
                    const Corners cn = corners_of(fy, fx, m, H, W);
#pragma unroll
                    for (int q = 0; q < 4; ++q) {
                        tpix[t * 4 + q] = img * H * W + cn.pix[q];
                        tw4[t * 4 + q] = r < BP ? cn.w[q] : 0.0f;
                    }
                }
                named_sync(1, PRODUCERS);
                for (int ci = 0; ci < nc; ++ci, ++it) {
                    const int st = it % STAGES;
                    const int c0 = ci * KC;
                    mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);
                    if (t == 0) {
                        // the weight slice: this CTA's boxes (every other
                        // one) into both CTAs, the other CTA's arrive here
                        mbar_expect_tx(&full[st], Plan::B_BYTES);
                        for (int bx = rank; bx < Plan::COLS / 64; bx += 2)
                            tma_load_3d_mc(bsm + st * Plan::B_BYTES + bx * KC * 128, &tw,
                                           &full[st], n0 + bx * 64, c0, gk, 0x3);
                    }
#pragma unroll
                    for (int part = 0; part < Plan::PARTS; part += 2) {
                        issue(even, g, c0, part);
                        if (pend_st >= 0) blend_into(odd, pend_st, pend_part);
                        issue(odd, g, c0, part + 1);
                        blend_into(even, st, part);
                        pend_st = st, pend_part = part + 1;
                    }
                }
            }
        }
        if (pend_st >= 0) blend_into(odd, pend_st, pend_part);
    } else {
        consume<MW, NW, NT>(asm_, bsm, full, empty, bias, out, BP, Cout, GK * nc, pairs_m,
                            pairs, rank, cluster, clusters);
    }
    cluster_sync();  // no CTA leaves while the other may still arrive on its barriers
}

template <int MW, int NW, int NT, bool VEC>
cudaError_t launch(const void* x, const void* py, const void* px, const void* m, const void* wg,
                   const void* bias, void* out, int B, int H, int W, int C, int G, int K, int P,
                   int Cout, int Cout8, cudaStream_t stream) {
    using Plan = FwdPlan<MW, NW, NT>;
    CUtensorMap tw;
    if (!sm90_host::tensor_map_cached(&tw, wg, G * K, C / G, Cout8, KC, 64))
        return cudaErrorInvalidValue;
    auto kernel = deform_fwd_sm90<MW, NW, NT, VEC>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Plan::TOTAL);
    if (err != cudaSuccess) return err;
    const int BP = B * P;
    const int tiles = (BP + Plan::BM - 1) / Plan::BM;
    const int pairs_m = (tiles + 1) / 2;
    const int pairs = pairs_m * ((Cout + Plan::COLS - 1) / Plan::COLS);
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 2;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.blockDim = dim3(Plan::THREADS);
    cfg.dynamicSmemBytes = Plan::TOTAL;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cfg.gridDim = dim3(2 * pairs);
    int fit = 0;  // clusters resident at once
    if (cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg) != cudaSuccess || fit < 1)
        fit = sm90_host::sm_count() / 2;
    cfg.gridDim = dim3(2 * (pairs < fit ? pairs : fit));
    return cudaLaunchKernelEx(&cfg, kernel, tw, static_cast<const bf16*>(x),
                              static_cast<const float*>(py), static_cast<const float*>(px),
                              static_cast<const float*>(m), static_cast<const float*>(bias),
                              static_cast<float*>(out), H, W, C, G, K, P, BP, Cout, pairs_m,
                              pairs);
}

// Cout <= 256: two warpgroups along the pixels share each weight slice
// (128-pixel tiles, half the weight traffic a pixel); Cout <= 512: two
// along Cout, each sample gathered once for all of Cout
template <bool VEC>
cudaError_t launch_cols(const void* x, const void* py, const void* px, const void* m,
                        const void* wg, const void* bias, void* out, int B, int H, int W, int C,
                        int G, int K, int P, int Cout, int Cout8, cudaStream_t s) {
    if (Cout <= 64) return launch<2, 1, 64, VEC>(x, py, px, m, wg, bias, out, B, H, W, C, G, K, P, Cout, Cout8, s);
    if (Cout <= 128) return launch<2, 1, 128, VEC>(x, py, px, m, wg, bias, out, B, H, W, C, G, K, P, Cout, Cout8, s);
    if (Cout <= 256) return launch<2, 1, 256, VEC>(x, py, px, m, wg, bias, out, B, H, W, C, G, K, P, Cout, Cout8, s);
    return launch<1, 2, 256, VEC>(x, py, px, m, wg, bias, out, B, H, W, C, G, K, P, Cout, Cout8, s);
}

}  // namespace

// x [B,H,W,C] bf16; py, px, m [B,P,G,K] f32 (absolute sample coordinates
// and modulation); wg [G,K,C/G,Cout8] bf16 (Cout8 = Cout rounded up to a
// multiple of 8, the columns past Cout zero); bias [Cout] f32; out
// [B,P,Cout] f32. All contiguous and 16-byte aligned; C/G even. Returns
// the CUDA error code of the launch (0 on success).
extern "C" int deform_conv_fwd(const void* x, const void* py, const void* px, const void* m,
                               const void* wg, const void* bias, void* out, int B, int H, int W,
                               int C, int G, int K, int P, int Cout, int Cout8, void* stream) {
    if (B < 1 || H < 1 || W < 1 || G < 1 || C % G || (C / G) % 2 || K < 1 || P < 1 || Cout < 1 ||
        Cout8 < Cout || Cout8 % 8 || (long)B * P * G * K > 0x7fffffffL ||
        (long)B * H * W > 0x7fffffffL)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = (C / G) % 8 == 0
                          ? launch_cols<true>(x, py, px, m, wg, bias, out, B, H, W, C, G, K, P, Cout, Cout8, s)
                          : launch_cols<false>(x, py, px, m, wg, bias, out, B, H, W, C, G, K, P, Cout, Cout8, s);
    return (int)err;
}

extern "C" const char* deform_conv_fwd_error(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
