// K7 and K8: one persistent cooperative kernel that walks a table of stages,
// with a grid-wide barrier between dependent stages.
//
// Replaces, from the JAX package:
//   K7  _resblock_pair_kernel (research/pallas_unet2d.py:170; wrapper
//       resblock_pair :414): two ResnetBlocks in one launch;
//   K8  unet2d_mega_apply (research/pallas_unet2d_mega.py:283; pallas_call
//       :392): the whole UNet2D forward between the init conv and the final
//       1x1 conv in one launch.
// The Python side (kernels/unet2d_mega.py) records the stage table once per
// weight pack and input shape, from the same block sequence the per-block
// forward runs, and allocates every intermediate in one workspace tensor.
//
// What carried over from the TPU and what did not. The Pallas mega-kernel
// kept all bf16 weights in VMEM and ran a batch grid; here the fp32 weights
// (143 MB at full width) are far larger than 132 x 227 KB of shared memory,
// so weights stream from L2/HBM as in K1-K6. What carries over is one launch
// per forward instead of ~100: no host gaps between blocks. Each stage
// spreads its work items over the fixed grid with a loop; a barrier
// (cooperative_groups grid sync) separates a stage from the next one that
// reads its output.
//
// Bound: operations, as K1 (the convs are ~97% of the flops), at the 3xTF32
// rate: 3 x flops / 495 TFLOP/s. So every stage runs the tensor-core body of
// the per-block kernel it stands for, as a device function called for each
// work item of a grid-stride loop:
//   kConv      K1's 3xTF32 wgmma tile (igemm_tc.cuh: igemm_tc_tile) with its
//              gather (conv_gathers.cuh): 3x3 / 1x1, two sources (skip
//              concat), nearest-2x upsample; 128 x 128 or 128 x 64 tiles and
//              split-K from the host's plan for this grid. With a split, each
//              (tile, split) writes its partial to the workspace; the CTA
//              that finishes a tile's last split (a per-tile arrival counter:
//              __threadfence, then atomicAdd) adds all its partials in split
//              order, then the bias, as K1's reduce launch does;
//   kDown      K2's gather on the same tile;
//   kGnStats   K3's per-(sample, group, chunk) mean and sum of squared
//              deviations; kGnApply merges a row's chunks with Chan's
//              formula in a fixed order, then normalises, FiLM, SiLU and the
//              residual (no float atomics);
//   kLaContext K5a (linear_attention_tc.cuh: la_context_body) per (chunk,
//              sample, head group); the CTA that finishes a sample's last
//              chunk runs K5's merge (la_merge_body) for it, in chunk order;
//   kLaOutput  K5b (la_output_body) per (64-token tile, sample);
//   kAttQkv, kAttCore, kAttOut   K6a, K6b and K6c (attention.cuh): the qkv
//              projection of token tiles across samples, the online softmax
//              over 64-key tiles per (64 queries, head, sample), two such
//              items side by side on the block's two 128-thread halves (named
//              barriers 1 and 2), and the out-projection with its bias and
//              residual. Any token count.
// The arrival counters are the first n_counters ints of the workspace,
// zeroed at the start of the launch (then one barrier); each is used once.
// Every sum runs in a fixed order, whichever CTA arrives last, so two
// launches on the same inputs are bit-equal.
//
// Coherence: activations are written by other blocks earlier in the same
// launch, so every read of the workspace goes through L2 only (cp.async.cg,
// __ldcg), never the non-coherent read-only path or a stale L1 line;
// weights, the FiLM vector and the bound inputs are never written in a
// launch and may use __ldg.
//
// Grid: one 256-thread CTA per SM (two warpgroups: igemm_tc's 128-row
// tile), with the largest stage's shared memory (float: K5b at 512
// channels, 220 KB; the 128 x 128 conv tile takes 193 KB; bf16: the bf16
// K5b at 512 channels, 226 KB, and the conv ring's mbarriers).
//
// bf16 weights (unet2d_persistent_bf16): the kernel is a template on the
// matmul weights' type TW, instantiated twice, so the float instance
// carries no branch on it and no register for it. With TW = __nv_bfloat16
// every matmul rounds its fp32 activation to bf16 at the product and sums
// in fp32, as the Pallas mega kernel does on its bf16 packs
// (research/pallas_unet2d_mega.py _mm :113-114, the wide conv :93-94, the
// downsample :224-225), and every stage runs the Hopper body of the
// per-block bf16 kernel it stands for:
//   kConv, kDown   igemm_bf16.cuh's tile (K1's and K2's bf16 core): 64-deep
//                  ring stages, the weight by TMA read as stored by wgmma,
//                  products kept in flight, one accumulation chain per
//                  split; the A tile by TMA boxes where igemm_bf16::launch's
//                  rule allows them (the stage's `boxes`), else the cp.async
//                  gather; tiles of MEGA_TILES_BF16 (128 x 256 for conv
//                  stages by boxes, 128 x 128, 128 x 64). Through the
//                  nearest-2x upsample by boxes the
//                  tiles walk the source grid per output parity class, and
//                  a split tile's reduce walks its rows the same way;
//   kLaContext     attention_bf16.cuh's context_body (K5a: resident TMA
//                  weight stages, wgmma k | v projections, the 3xTF32
//                  context), then la_merge_body as above;
//   kLaOutput      output_body (K5b) over la_output_plan's tiles of 32 or 64
//                  flattened tokens, each CTA (work item) over a contiguous
//                  share of them (`ctas` items; several tiles an item at
//                  C <= 128);
//   kAttQkv, kAttOut   qkv_body and attn_out_body (K6a, K6c) on 64-token
//                  tiles; kAttCore, GroupNorm and the merge as above.
// GroupNorm, the channel norms, the softmaxes, K5's context and K6's core
// stay fp32 (3xTF32 where they use the tensor cores); biases, gains and the
// FiLM vector stay fp32. The host plan (kernels/unet2d_mega.py:
// check_kernel_plan) holds every matmul weight of a plan to one type, with
// rows of a multiple of 8 for bf16. Bound: max(flops / 989 TFLOP/s, bytes /
// 3.35 TB/s), the weights at 2 bytes.
//
// What the bf16 instance adds to the loop:
// - Tensor maps. TMA reads a map from memory, and a table of stages cannot
//   pass its maps as __grid_constant__ parameters, so the host encodes them
//   (unet2d_persistent_maps) into a device array of 128-byte records, 64-byte
//   aligned, one per (weight, box geometry of an activation); a stage holds
//   their indices (map_w, map_a, map_b). Activation maps hold absolute
//   addresses (the workspace, the call's inputs), so every launch has its
//   maps encoded and written anew (kernels/unet2d_mega.py). Thread 0 of
//   each CTA acquires a stage's maps for the TMA unit before its copies
//   (fence.proxy.tensormap), which the writer released.
// - mbarriers. The conv tiles' ring mbarriers live past the stage region,
//   are made once per launch, and carry each slot's phase parity from tile
//   to tile and stage to stage (Ring). K5's and K6's bodies make theirs in
//   the stage region and invalidate them when done.
// - Proxies. TMA (the async proxy) reads activations that other CTAs stored
//   with ordinary stores before a grid barrier: every thread fences its
//   stores to the async proxy before the barrier (fence.proxy.async.global),
//   and the thread that issues the copies fences again after it. Without the
//   fences the failure would be a rare wrong tile, not a crash.
// - Activations that the bf16 bodies read with ordinary loads go through L2
//   only, as above (attention_bf16.cuh).
//
// Two translation units instantiate the kernel: unet2d_persistent.cu the
// float instance (with the grid shared by both), unet2d_persistent_bf16.cu
// the bf16 one (with its tensor maps). Apart, each compiles alone: the
// float instance's code stays as it was before the bf16 instance had bodies
// of its own (a noinline stage function that both call takes its calling
// convention from both), and the two build in parallel.
#pragma once

#include <cooperative_groups.h>
#include <stdint.h>

#include <type_traits>

#include "attention.cuh"
#include "attention_bf16.cuh"
#include "conv_gathers.cuh"
#include "hopper_tma.cuh"
#include "igemm_bf16.cuh"
#include "igemm_tc.cuh"

namespace cg = cooperative_groups;

// Each translation unit instantiates one instance, so the other's stage
// functions go unreferenced there.
#pragma nv_diag_suppress 177

namespace {

using namespace attn_tc;  // K5's and K6's bodies and constants

constexpr int kBM = 128;  // igemm_tc's tile rows at 256 threads
static_assert(igemm_tc::Tile<kBM, 64>::THREADS == kThreads, "one 128-row tile per block");
static_assert(2 * kCoreThreads == kThreads, "two K6b bodies per block");

// Stage ops and pointer slots; kernels/unet2d_mega.py writes the same codes.
enum Op : int {
  kConv = 0,
  kDown = 1,
  kGnStats = 2,
  kGnApply = 3,
  kLaContext = 4,
  kLaOutput = 5,
  kAttQkv = 6,
  kAttCore = 7,
  kAttOut = 8,
};
// Slot use by op (unused slots are null):
//   kConv      X xa, X2 xb, W w, BIAS b, OUT, SCR split partials, CNT counters
//   kDown      X, W, BIAS, OUT, SCR split partials, CNT counters
//   kGnStats   X, SCR partials
//   kGnApply   X, SCR partials, W gamma, BIAS beta, AUX FiLM ss, RES residual, OUT
//   kLaContext X, W norm_g, AUX wqkv, SCR chunk partials, OUT context, CNT counters
//   kLaOutput  X, W norm_g, AUX wqkv, SCR context, X2 wo, BIAS bo, RES out_g, OUT
//   kAttQkv    X, W norm_g, AUX wqkv, OUT qkv (B n, 384)
//   kAttCore   X qkv, OUT attention output (B n, 128)
//   kAttOut    X (the residual), SCR attention output, X2 wo, BIAS bo, OUT
enum Slot : int { X = 0, X2 = 1, W = 2, BIAS = 3, OUT = 4, SCR = 5, AUX = 6, RES = 7, CNT = 8 };
constexpr int kSlots = 9;
constexpr int kBases = 8;

// One stage as the host writes it: 38 int64. A pointer is bases[base[k]] +
// off[k]; base 0 is the null base (absolute addresses: weights), the others
// the workspace and the call's tensors. Conv / down: (bm, bn, splits, per)
// the tile plan; linear attention: (chunk, S, hg) K5's chunk plan; full
// attention: tr, K6's token tile.
struct Stage {
  long long op, sync, B, H, W, ca, cb, co, ks, up, groups, chunk, S, ss_stride, bm, bn, splits,
      per, hg, tr;
  long long off[kSlots];
  long long base[kSlots];
};
static_assert(sizeof(Stage) == 38 * 8, "the host writes 38 int64 per stage");
// The bf16 instance's record, 43 int64: also boxes (conv / down: the A tile
// by TMA boxes), ctas (K5b's work items, each a contiguous share of its
// tr-token tiles) and the indices of the stage's tensor maps, -1 for none:
// map_w the weight's (K5b: wqkv, with wo's at map_w + 1 = map_a; K6c: wo),
// map_a / map_b the boxes of xa / xb. (The float instance takes the first
// 38 columns, so that its code stays as it was.)
struct StageBf16 : Stage {
  long long boxes, ctas, map_w, map_a, map_b;
};
static_assert(sizeof(StageBf16) == 43 * 8, "the host writes 43 int64 per bf16 stage");
template <class TW>
using StageOf = std::conditional_t<std::is_same_v<TW, float>, Stage, StageBf16>;

struct Bases {
  long long b[kBases];
};

// The current stage, resolved into shared memory by the kernel loop.
struct StageArgs {
  float* p[kSlots];
  int op, sync, B, H, W, ca, cb, co, ks, up, groups, chunk, S, ss_stride, bn, splits, per, hg,
      tr;
};
// the bf16 instance's (the float instance's shared memory stays as it was)
struct StageArgsBf16 : StageArgs {
  int boxes, ctas, map_w, map_a, map_b;
};
template <class TW>
using ArgsOf = std::conditional_t<std::is_same_v<TW, float>, StageArgs, StageArgsBf16>;

constexpr int kMax2(int a, int b) { return a > b ? a : b; }
constexpr int kStageSmemBytes = kMax2(
    kMax2(igemm_tc::Tile<kBM, 128>::SMEM_BYTES, 4 * context_smem_floats(kMaxC)),
    kMax2(kMax2(4 * output_smem_floats(kMaxC), 4 * qkv_smem_floats(64, kMaxC)),
          kMax2(4 * 2 * kCoreSmemFloats, 4 * out_smem_floats(64))));
// bf16: the conv tiles (the 128 x 256 and 128 x 128 rings are the largest),
// K5a (4 heads a CTA only where C <= 256), K5b (one tile, or several staged
// at C <= 128), K6a, K6c, K6b; then the conv ring's mbarriers
constexpr int kRingSlots = 4;  // igemm_bf16's ring stages, at most
constexpr int kStageSmemBf16 =
    (kMax2(kMax2(kMax2(igemm_bf16::Tile<kBM, 256>::SMEM_BYTES,
                       igemm_bf16::Tile<kBM, 128>::SMEM_BYTES),
                 kMax2(attn_bf16::context_smem_bytes(4, 256),
                       attn_bf16::context_smem_bytes(2, kMaxC))),
           kMax2(kMax2(attn_bf16::output_smem_bytes(kMaxC, false),
                       attn_bf16::output_smem_bytes(128, true)),
                 kMax2(kMax2(attn_bf16::qkv_smem_bytes(kMaxC), attn_bf16::kOutProjSmem),
                       4 * 2 * kCoreSmemFloats))) +
     15) / 16 * 16;
static_assert(igemm_bf16::Tile<kBM, 64>::STAGES <= kRingSlots &&
                  igemm_bf16::Tile<kBM, 256>::STAGES <= kRingSlots,
              "the ring's mbarriers");
template <class TW>
constexpr int kSmemBytes =
    std::is_same_v<TW, float> ? kStageSmemBytes : kStageSmemBf16 + 8 * kRingSlots;
static_assert(kStageSmemBf16 + 8 * kRingSlots + sizeof(StageArgsBf16) + 64 <= attn_bf16::kMaxSmem,
              "one CTA per SM");

// Stage clocks, compiled in only with -DMEGA_PHASE_CLOCKS (the build that
// tools/mega_stage_clocks.py makes): thread 0 of each CTA writes clock64()
// when stage i starts, when its work ends and when its barrier ends.
#ifdef MEGA_PHASE_CLOCKS
constexpr int kStampStages = 1024, kStampGrid = 256;
__device__ long long mega_stamps[kStampStages * kStampGrid * 3];
#define MEGA_STAMP(i, k)                                                               \
  do {                                                                                 \
    if (threadIdx.x == 0 && (i) < kStampStages && blockIdx.x < kStampGrid)             \
      mega_stamps[((i) * kStampGrid + blockIdx.x) * 3 + (k)] = clock64();              \
  } while (0)
#else
#define MEGA_STAMP(i, k) \
  do {                   \
  } while (0)
#endif

// Sum over a warp by a shuffle tree (the same order every time).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the block in a fixed order (warp trees, then warps 0..7).
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) t += red[i];
  __syncthreads();  // red is rewritten by the next call
  return t;
}

// True in every thread of the block that is the last of `total` arrivals at
// counter *cnt: every thread's global writes before the call are visible to
// that block's reads after it (the threadFenceReduction pattern).
__device__ __forceinline__ bool last_arrival(int* cnt, int total, int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *flag = atomicAdd(cnt, 1) == total - 1;
  __syncthreads();
  const bool last = *flag;
  if (last) __threadfence();
  return last;
}

// out[m0.., n0..] = bias + ws[0] + ws[1] + ... over one BM x BN tile, the
// partials in split order as K1's reduce launch adds them.
template <int BN>
__device__ __forceinline__ void reduce_tile(const float* ws, const float* bias, float* out,
                                            int M, int N, int splits, int m0, int n0) {
  const size_t mn = static_cast<size_t>(M) * N;
  for (int i = threadIdx.x; i < kBM * BN / 4; i += kThreads) {
    const int m = m0 + i / (BN / 4), n = n0 + 4 * (i % (BN / 4));
    if (m >= M || n >= N) continue;  // N % 4 == 0: the vector is wholly in or out
    const size_t idx = static_cast<size_t>(m) * N + n;
    float4 v = __ldcg(reinterpret_cast<const float4*>(ws + idx));
    for (int z = 1; z < splits; ++z) {
      const float4 p = __ldcg(reinterpret_cast<const float4*>(ws + z * mn + idx));
      v.x += p.x;
      v.y += p.y;
      v.z += p.z;
      v.w += p.w;
    }
    const float4 b = __ldg(reinterpret_cast<const float4*>(bias + n));
    *reinterpret_cast<float4*>(out + idx) = make_float4(v.x + b.x, v.y + b.y, v.z + b.z, v.w + b.w);
  }
}

// Every (tile, split) of an M x co GEMM on the host's plan (a.splits splits
// of a.per K slices) over the grid, tile index fastest (K1's grid order).
// Unsplit, a tile goes straight to the output with its bias; split, each
// split writes its partial (a.p[SCR]: splits x M x co) and the last split
// of the tile to finish adds them in split order, then the bias.
template <class G, int BN>
__device__ __forceinline__ void conv_tiles(const G& g, const StageArgs& a, int M, int K,
                                           unsigned char* smem, int* flag) {
  const int N = a.co, splits = a.splits, per = a.per;
  const int mt = (M + kBM - 1) / kBM, tiles = mt * ((N + BN - 1) / BN);
  const float* w = a.p[W];
  for (int t = blockIdx.x; t < tiles * splits; t += gridDim.x) {
    const int z = t / tiles, tile = t - z * tiles;
    const int bx = tile % mt, by = tile / mt;
    if (splits == 1) {
      igemm_tc::igemm_tc_tile<G, kBM, BN>(g, w, a.p[BIAS], a.p[OUT], M, N, K, per, bx, by, 0,
                                          smem);
      continue;
    }
    igemm_tc::igemm_tc_tile<G, kBM, BN>(g, w, nullptr, a.p[SCR], M, N, K, per, bx, by, z, smem);
    if (last_arrival(reinterpret_cast<int*>(a.p[CNT]) + tile, splits, flag))
      reduce_tile<BN>(a.p[SCR], a.p[BIAS], a.p[OUT], M, N, splits, bx * kBM, by * BN);
    __syncthreads();  // flag is rewritten by the next tile
  }
}

template <class G>
__device__ __forceinline__ void conv_stage(const G& g, const StageArgs& a, int M, int K,
                                           unsigned char* smem, int* flag) {
  if (a.bn == 128)
    conv_tiles<G, 128>(g, a, M, K, smem, flag);
  else
    conv_tiles<G, 64>(g, a, M, K, smem, flag);
}

// The stages that run wgmma are inlined into the kernel: a wgmma pipeline in
// a called function is serialized (ptxas C7510). The others are functions
// of their own, so that their registers do not add to the conv tile's.
__device__ __forceinline__ void stage_conv(const StageArgs& a, unsigned char* smem, int* flag) {
  const auto g = igemm::make_conv_gather(a.p[X], a.p[X2], a.H, a.W, a.ca, a.cb, a.ks, a.up);
  conv_stage(g, a, a.B * a.H * a.W, a.ks * a.ks * (a.ca + a.cb), smem, flag);
}

__device__ __forceinline__ void stage_down(const StageArgs& a, unsigned char* smem, int* flag) {
  const auto g = igemm::make_down_gather(a.p[X], a.H, a.W, a.ca);
  conv_stage(g, a, a.B * (a.H / 2) * (a.W / 2), 4 * a.ca, smem, flag);
}

// Element e of GroupNorm row (b, g) lies at pixel e / Cg, channel
// g * Cg + e % Cg (NHWC, channels fastest), as in K3. Cg is a multiple of 4
// (the plan checks) and chunks start at multiples of 4, so every thread
// moves 4 elements of one pixel as one 16-byte vector.
__device__ __forceinline__ size_t gn_offset(int e, int Cg, int C) {
  return static_cast<size_t>(e / Cg) * C + e % Cg;
}

// GroupNorm moves 4 elements per thread per load and keeps kGnLoads loads
// in flight per thread (one CTA of 8 warps per SM: a loop with one load at a
// time waits on memory latency, not bandwidth).
constexpr int kGnLoads = 4;
constexpr int kGnStep = 4 * kThreads;  // elements per load over the block

__device__ __noinline__ void stage_gn_stats(const StageArgs& a, float* smem) {
  const float* x = a.p[X];
  float* part = a.p[SCR];
  const int C = a.co, G = a.groups, Cg = C / G, L = a.H * a.W * Cg;
  const int items = a.B * G * a.S;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int row = it / a.S, s = it - row * a.S;
    const int b = row / G, g = row - b * G;
    const float* xr = x + static_cast<size_t>(b) * L * G + g * Cg;
    const int start = s * a.chunk, end = min(start + a.chunk, L);
    float sum = 0.f;
    for (int e0 = start + 4 * threadIdx.x; e0 < end; e0 += kGnLoads * kGnStep) {
      float4 v[kGnLoads];
#pragma unroll
      for (int u = 0; u < kGnLoads; ++u) {
        const int e = e0 + u * kGnStep;
        v[u] = e < end ? __ldcg(reinterpret_cast<const float4*>(xr + gn_offset(e, Cg, C)))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kGnLoads; ++u) sum += (v[u].x + v[u].y) + (v[u].z + v[u].w);
    }
    const float mean = block_sum(sum, smem) / (end - start);
    float m2 = 0.f;
    for (int e0 = start + 4 * threadIdx.x; e0 < end; e0 += kGnLoads * kGnStep) {
      float4 v[kGnLoads];
#pragma unroll
      for (int u = 0; u < kGnLoads; ++u) {
        const int e = e0 + u * kGnStep;
        v[u] = e < end ? __ldcg(reinterpret_cast<const float4*>(xr + gn_offset(e, Cg, C)))
                       : make_float4(mean, mean, mean, mean);  // no deviation
      }
#pragma unroll
      for (int u = 0; u < kGnLoads; ++u) {
        const float d0 = v[u].x - mean, d1 = v[u].y - mean, d2 = v[u].z - mean,
                    d3 = v[u].w - mean;
        m2 += (d0 * d0 + d1 * d1) + (d2 * d2 + d3 * d3);
      }
    }
    m2 = block_sum(m2, smem);
    if (threadIdx.x == 0) {
      part[2 * it] = mean;
      part[2 * it + 1] = m2;
    }
  }
}

__device__ __forceinline__ float silu(float y) { return y * (1.f / (1.f + expf(-y))); }

__device__ __noinline__ void stage_gn_apply(const StageArgs& a, float* smem) {
  const float* x = a.p[X];
  const float* part = a.p[SCR];
  const float* gamma = a.p[W];
  const float* beta = a.p[BIAS];
  const float* ss = a.p[AUX];
  const float* res = a.p[RES];
  float* out = a.p[OUT];
  const int C = a.co, G = a.groups, Cg = C / G, L = a.H * a.W * Cg;
  const int items = a.B * G * a.S;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int row = it / a.S, s = it - row * a.S;
    const int b = row / G, g = row - b * G;
    if (threadIdx.x < 32) {  // Chan's merge of the row's S chunks: lane-strided, then
                             // a shuffle tree (a fixed order, so repeats are bit-equal)
      const float* pr = part + 2 * row * a.S;
      float wsum = 0.f;
      for (int i = threadIdx.x; i < a.S; i += 32)
        wsum += min(a.chunk, L - i * a.chunk) * __ldcg(pr + 2 * i);
      const float mean = warp_sum(wsum) / L;
      float m2 = 0.f, dev = 0.f;
      for (int i = threadIdx.x; i < a.S; i += 32) {
        const float d = __ldcg(pr + 2 * i) - mean;
        m2 += __ldcg(pr + 2 * i + 1);
        dev += min(a.chunk, L - i * a.chunk) * d * d;
      }
      m2 = warp_sum(m2);
      dev = warp_sum(dev);
      if (threadIdx.x == 0) {
        smem[0] = mean;
        smem[1] = 1.f / sqrtf((m2 + dev) / L + 1e-5f);
      }
    }
    __syncthreads();
    const float mean = smem[0], rstd = smem[1];
    const size_t base = static_cast<size_t>(b) * L * G + g * Cg;
    const float* ssb = ss ? ss + static_cast<size_t>(b) * a.ss_stride : nullptr;
    const int start = s * a.chunk, end = min(start + a.chunk, L);
    for (int e0 = start + 4 * threadIdx.x; e0 < end; e0 += kGnLoads * kGnStep) {
      float4 v[kGnLoads], r[kGnLoads];
#pragma unroll
      for (int u = 0; u < kGnLoads; ++u) {
        const int e = e0 + u * kGnStep;
        if (e < end) {
          const size_t addr = base + gn_offset(e, Cg, C);
          v[u] = __ldcg(reinterpret_cast<const float4*>(x + addr));
          if (res) r[u] = __ldcg(reinterpret_cast<const float4*>(res + addr));
        }
      }
#pragma unroll
      for (int u = 0; u < kGnLoads; ++u) {
        const int e = e0 + u * kGnStep;
        if (e >= end) break;
        const size_t addr = base + gn_offset(e, Cg, C);
        const int c = g * Cg + e % Cg;
        const float4 ga = __ldg(reinterpret_cast<const float4*>(gamma + c));
        const float4 be = __ldg(reinterpret_cast<const float4*>(beta + c));
        float y[4] = {(v[u].x - mean) * rstd * ga.x + be.x, (v[u].y - mean) * rstd * ga.y + be.y,
                      (v[u].z - mean) * rstd * ga.z + be.z, (v[u].w - mean) * rstd * ga.w + be.w};
        if (ssb) {
          const float4 sc = __ldg(reinterpret_cast<const float4*>(ssb + c));
          const float4 sh = __ldg(reinterpret_cast<const float4*>(ssb + C + c));
          y[0] = y[0] * (sc.x + 1.f) + sh.x;
          y[1] = y[1] * (sc.y + 1.f) + sh.y;
          y[2] = y[2] * (sc.z + 1.f) + sh.z;
          y[3] = y[3] * (sc.w + 1.f) + sh.w;
        }
        float4 o = make_float4(silu(y[0]), silu(y[1]), silu(y[2]), silu(y[3]));
        if (res) {
          o.x += r[u].x;
          o.y += r[u].y;
          o.z += r[u].z;
          o.w += r[u].w;
        }
        *reinterpret_cast<float4*>(out + addr) = o;
      }
    }
    __syncthreads();  // smem[0..1] is rewritten by the next item
  }
}

// K5a per (chunk s, sample b, head group hg), s fastest; the last chunk of
// a sample to finish merges the sample's partials into its context.
__device__ __noinline__ void stage_la_context(const StageArgs& a, float* smem, int* flag) {
  const int n = a.H * a.W, S = a.S, hg = a.hg;
  const float* wqkv = a.p[AUX];
  for (int it = blockIdx.x; it < S * a.B * hg; it += gridDim.x) {
    const int s = it % S, b = (it / S) % a.B, h = it / (S * a.B);
    if (hg == 1)
      la_context_body<4>(a.p[X], a.p[W], wqkv, a.p[SCR], n, a.co, a.chunk, s, b, 0, S, smem);
    else
      la_context_body<2>(a.p[X], a.p[W], wqkv, a.p[SCR], n, a.co, a.chunk, s, b, h, S, smem);
    if (last_arrival(reinterpret_cast<int*>(a.p[CNT]) + b, S * hg, flag))
      la_merge_body(a.p[SCR], a.p[OUT], S, b);
    __syncthreads();  // flag and the body's shared memory are rewritten next
  }
}

// K5b per (64-token tile, sample), tile fastest.
__device__ __noinline__ void stage_la_output(const StageArgs& a, float* smem) {
  const int n = a.H * a.W, tiles = (n + kRows - 1) / kRows;
  for (int it = blockIdx.x; it < a.B * tiles; it += gridDim.x) {
    la_output_body(a.p[X], a.p[W], a.p[AUX], a.p[SCR], a.p[X2], a.p[BIAS], a.p[RES], a.p[OUT], n,
                   a.co, it % tiles, it / tiles, smem);
    __syncthreads();
  }
}

// K6a per (token tile, pass), tile fastest; tiles of a.tr tokens across samples.
template <int TR>
__device__ __forceinline__ void att_qkv_tiles(const StageArgs& a, float* smem) {
  const int T = a.B * a.H * a.W, tiles = (T + TR - 1) / TR;
  for (int it = blockIdx.x; it < 3 * tiles; it += gridDim.x) {
    attn_qkv_body<TR>(a.p[X], a.p[W], a.p[AUX], a.p[OUT], T, a.co, it % tiles, it / tiles, smem);
    __syncthreads();
  }
}

__device__ __noinline__ void stage_att_qkv(const StageArgs& a, float* smem) {
  if (a.tr == 32)
    att_qkv_tiles<32>(a, smem);
  else
    att_qkv_tiles<64>(a, smem);
}

// K6b per (64 queries, head, sample), queries fastest: the block's two
// 128-thread halves take alternate items, each with its own shared memory
// and named barrier.
__device__ __noinline__ void stage_att_core(const StageArgs& a, float* smem) {
  const int n = a.H * a.W, qt = (n + kQTile - 1) / kQTile;
  const int half = threadIdx.x / kCoreThreads, tid = threadIdx.x % kCoreThreads;
  float* hs = smem + half * kCoreSmemFloats;
  for (int it = 2 * blockIdx.x + half; it < qt * kHeads * a.B; it += 2 * gridDim.x) {
    attn_core_body(a.p[X], a.p[OUT], n, it % qt, (it / qt) % kHeads, it / (qt * kHeads), tid,
                   1 + half, hs);
    core_sync(1 + half);  // the half's last reads of its tiles are done
  }
}

// K6c per (token tile, 128 output channels), tile fastest.
template <int TR>
__device__ __forceinline__ void att_out_tiles(const StageArgs& a, float* smem) {
  const int T = a.B * a.H * a.W, tiles = (T + TR - 1) / TR;
  for (int it = blockIdx.x; it < tiles * ((a.co + kCols - 1) / kCols); it += gridDim.x) {
    attn_out_body<TR>(a.p[SCR], a.p[X2], a.p[BIAS], a.p[X], a.p[OUT], T, a.co, it % tiles,
                      it / tiles, smem);
    __syncthreads();
  }
}

__device__ __noinline__ void stage_att_out(const StageArgs& a, float* smem) {
  if (a.tr == 32)
    att_out_tiles<32>(a, smem);
  else
    att_out_tiles<64>(a, smem);
}

// ---------------------------------------------------------------------------
// the bf16 instance's stages
// ---------------------------------------------------------------------------

// The conv tiles' ring: kRingSlots mbarriers past the stage region, made
// once per launch; bit s of `phase` is the parity of slot s's next
// completion (igemm_bf16::tile advances it). Every thread holds the same.
struct Ring {
  uint32_t bars, phase;
};

// igemm_bf16::tile's geometry of a conv or down stage, as igemm_bf16::launch
// makes it (down: a.H, a.W are the input's size; conv: the output's).
__device__ __forceinline__ igemm_bf16::Geom conv_geom(const StageArgsBf16& a, bool down) {
  igemm_bf16::Geom g;
  g.H = down ? a.H / 2 : a.H;
  g.W = down ? a.W / 2 : a.W;
  g.gh = a.up ? a.H / 2 : g.H;
  g.gw = a.up ? a.W / 2 : g.W;
  g.ks = down ? 2 : a.ks;
  g.pad = down ? 0 : (a.ks - 1) / 2;
  g.scale = down ? 2 : 1;
  g.ci = a.ca + a.cb;
  g.ca = a.ca;
  g.batch = a.B;
  g.up = a.up;
  g.mc = (a.B * g.gh * g.gw + kBM - 1) / kBM * kBM;
  return g;
}

// reduce_tile for a tile that walks the source grid of a nearest-2x
// upsample by parity class (igemm_bf16::tile's TMA_A epilogue): tile row r
// is output pixel (2y + py, 2x + px) of class r / mc, or none past the batch.
template <int BN>
__device__ __forceinline__ void reduce_tile_classes(const float* ws, const float* bias,
                                                    float* out, int M, int N, int splits, int r0,
                                                    int n0, const igemm_bf16::Geom& geo) {
  const size_t mn = static_cast<size_t>(M) * N;
  const int img = geo.gh * geo.gw;
  for (int i = threadIdx.x; i < kBM * BN / 4; i += kThreads) {
    const int r = r0 + i / (BN / 4), n = n0 + 4 * (i % (BN / 4));
    const int c2 = r / geo.mc, rc = r - c2 * geo.mc, b = rc / img, rem = rc - b * img;
    const int y = rem / geo.gw, x = rem - y * geo.gw;
    if (b >= geo.batch || n >= N) continue;
    const size_t idx =
        static_cast<size_t>((b * geo.H + 2 * y + (c2 >> 1)) * geo.W + 2 * x + (c2 & 1)) * N + n;
    float4 v = __ldcg(reinterpret_cast<const float4*>(ws + idx));
    for (int z = 1; z < splits; ++z) {
      const float4 p = __ldcg(reinterpret_cast<const float4*>(ws + z * mn + idx));
      v.x += p.x;
      v.y += p.y;
      v.z += p.z;
      v.w += p.w;
    }
    const float4 bv = __ldg(reinterpret_cast<const float4*>(bias + n));
    *reinterpret_cast<float4*>(out + idx) =
        make_float4(v.x + bv.x, v.y + bv.y, v.z + bv.z, v.w + bv.w);
  }
}

// conv_tiles on igemm_bf16's tile: BOXES, the A tile by TMA boxes (through
// the upsample, 4 * mc / 128 tile rows: the parity classes, as
// igemm_bf16::launch_mode counts them), else by the gather.
template <class G, int BN, bool BOXES>
__device__ __forceinline__ void conv_tiles_bf16(const G& g, const StageArgsBf16& a,
                                                const igemm_bf16::Geom& geo,
                                                const CUtensorMap* maps, int M, int K,
                                                unsigned char* smem, int* flag, Ring& ring) {
  const int N = a.co, splits = a.splits, per = a.per;
  const bool classes = BOXES && geo.up;
  const int mt = classes ? 4 * geo.mc / kBM : (M + kBM - 1) / kBM;
  const int tiles = mt * ((N + BN - 1) / BN);
  const auto* w = reinterpret_cast<const __nv_bfloat16*>(a.p[W]);
  const CUtensorMap* mw = maps + a.map_w;
  const CUtensorMap* mxa = BOXES ? maps + a.map_a : nullptr;
  const CUtensorMap* mxb = BOXES && a.map_b >= 0 ? maps + a.map_b : nullptr;
  for (int t = blockIdx.x; t < tiles * splits; t += gridDim.x) {
    const int z = t / tiles, tile = t - z * tiles;
    const int bx = tile % mt, by = tile / mt;
    if (splits == 1) {
      igemm_bf16::tile<G, kBM, BN, BOXES>(g, mw, mxa, mxb, geo, w, a.p[BIAS], a.p[OUT], M, N, K,
                                          per, bx, by, 0, smem, ring.bars, ring.phase);
      continue;
    }
    igemm_bf16::tile<G, kBM, BN, BOXES>(g, mw, mxa, mxb, geo, w, nullptr, a.p[SCR], M, N, K, per,
                                        bx, by, z, smem, ring.bars, ring.phase);
    if (last_arrival(reinterpret_cast<int*>(a.p[CNT]) + tile, splits, flag)) {
      if (classes)
        reduce_tile_classes<BN>(a.p[SCR], a.p[BIAS], a.p[OUT], M, N, splits, bx * kBM, by * BN,
                                geo);
      else
        reduce_tile<BN>(a.p[SCR], a.p[BIAS], a.p[OUT], M, N, splits, bx * kBM, by * BN);
    }
    __syncthreads();  // flag is rewritten by the next tile
  }
}

// WIDE: 128 x 256 tiles too. The host plans them for conv stages by TMA
// boxes alone (check_kernel_plan), the only ones that pick them, so the
// instance compiles 9 tile bodies, not 12.
template <class G, bool BOXES, bool WIDE>
__device__ __forceinline__ void conv_stage_bf16(const G& g, const StageArgsBf16& a,
                                                const igemm_bf16::Geom& geo,
                                                const CUtensorMap* maps, int M, int K,
                                                unsigned char* smem, int* flag, Ring& ring) {
  if constexpr (WIDE) {
    if (a.bn == 256) {
      conv_tiles_bf16<G, 256, BOXES>(g, a, geo, maps, M, K, smem, flag, ring);
      return;
    }
  }
  if (a.bn == 128)
    conv_tiles_bf16<G, 128, BOXES>(g, a, geo, maps, M, K, smem, flag, ring);
  else
    conv_tiles_bf16<G, 64, BOXES>(g, a, geo, maps, M, K, smem, flag, ring);
}

__device__ __forceinline__ void stage_conv_bf16(const StageArgsBf16& a, const CUtensorMap* maps,
                                                unsigned char* smem, int* flag, Ring& ring) {
  const auto g = igemm::make_conv_gather(a.p[X], a.p[X2], a.H, a.W, a.ca, a.cb, a.ks, a.up);
  const igemm_bf16::Geom geo = conv_geom(a, false);
  const int M = a.B * a.H * a.W, K = a.ks * a.ks * (a.ca + a.cb);
  if (a.boxes)
    conv_stage_bf16<decltype(g), true, true>(g, a, geo, maps, M, K, smem, flag, ring);
  else
    conv_stage_bf16<decltype(g), false, false>(g, a, geo, maps, M, K, smem, flag, ring);
}

__device__ __forceinline__ void stage_down_bf16(const StageArgsBf16& a, const CUtensorMap* maps,
                                                unsigned char* smem, int* flag, Ring& ring) {
  const auto g = igemm::make_down_gather(a.p[X], a.H, a.W, a.ca);
  const igemm_bf16::Geom geo = conv_geom(a, true);
  const int M = a.B * (a.H / 2) * (a.W / 2), K = 4 * a.ca;
  if (a.boxes)
    conv_stage_bf16<decltype(g), true, false>(g, a, geo, maps, M, K, smem, flag, ring);
  else
    conv_stage_bf16<decltype(g), false, false>(g, a, geo, maps, M, K, smem, flag, ring);
}

// The attention bodies issue wgmma, so they are inlined here (a wgmma
// pipeline in a called function is serialized). Before each work item,
// thread 0 orders the earlier generic accesses to the shared memory (the
// last item's or stage's, past the barrier that ended them) before the
// body's TMA copies into it.
__device__ __forceinline__ void before_tma_item() {
  if (threadIdx.x == 0) attn_bf16::fence_async_smem();
}

// K5a per (chunk s, sample b, head group h), s fastest, on context_body;
// the last chunk of a sample to finish merges the sample's partials.
// J: float4s a thread per token of the ChanLN, 4 ceil(C / 128) (16 above 256).
template <int kHpc, int J>
__device__ __forceinline__ void la_context_bf16(const StageArgsBf16& a, const CUtensorMap* maps,
                                                unsigned char* smem, int* flag) {
  const int n = a.H * a.W, S = a.S, hg = a.hg;
  for (int it = blockIdx.x; it < S * a.B * hg; it += gridDim.x) {
    const int s = it % S, b = (it / S) % a.B, h = it / (S * a.B);
    before_tma_item();
    attn_bf16::context_body<kHpc, J>(a.p[X], a.p[W], maps + a.map_w, a.p[SCR], n, a.co, a.chunk, s,
                                     b, h, S, smem);
    if (last_arrival(reinterpret_cast<int*>(a.p[CNT]) + b, S * hg, flag))
      la_merge_body(a.p[SCR], a.p[OUT], S, b);
    __syncthreads();  // flag and the body's shared memory are rewritten next
  }
}

__device__ __forceinline__ void stage_la_context_bf16(const StageArgsBf16& a,
                                                      const CUtensorMap* maps,
                                                      unsigned char* smem, int* flag) {
  if (a.hg == 1) {  // the plan's 4 heads a CTA: C <= 256
    if (a.co <= 128)
      la_context_bf16<4, 4>(a, maps, smem, flag);
    else
      la_context_bf16<4, 8>(a, maps, smem, flag);
  } else if (a.co <= 128) {
    la_context_bf16<2, 4>(a, maps, smem, flag);
  } else if (a.co <= 256) {
    la_context_bf16<2, 8>(a, maps, smem, flag);
  } else {
    la_context_bf16<2, 16>(a, maps, smem, flag);
  }
}

// K5b: `ctas` work items, item i over tr-token tiles [i T' / ctas, (i + 1)
// T' / ctas) of the T' = ceil(B n / tr) tiles, as the per-block kernel's
// CTAs; several tiles an item (kMulti) only at C <= 128.
template <int NB, bool kMulti>
__device__ __forceinline__ void la_output_bf16(const StageArgsBf16& a, const CUtensorMap* maps,
                                               unsigned char* smem) {
  const int n = a.H * a.W, T = a.B * n, tr = a.tr, ctas = a.ctas;
  const long long tiles = (T + tr - 1) / tr;
  const auto& om = *reinterpret_cast<const attn_bf16::OutMaps*>(maps + a.map_w);
  for (int it = blockIdx.x; it < ctas; it += gridDim.x) {
    before_tma_item();
    attn_bf16::output_body<NB, 4 * NB, kMulti>(
        a.p[X], a.p[W], om, a.p[SCR], a.p[BIAS], a.p[RES], a.p[OUT], n, T, a.co, tr,
        static_cast<int>(it * tiles / ctas), static_cast<int>((it + 1) * tiles / ctas), smem);
    __syncthreads();
  }
}

__device__ __forceinline__ void stage_la_output_bf16(const StageArgsBf16& a,
                                                     const CUtensorMap* maps,
                                                     unsigned char* smem) {
  if (a.co <= 128) {
    if (a.ctas < (a.B * a.H * a.W + a.tr - 1) / a.tr)
      la_output_bf16<1, true>(a, maps, smem);
    else
      la_output_bf16<1, false>(a, maps, smem);
  } else if (a.co <= 256) {
    la_output_bf16<2, false>(a, maps, smem);
  } else {
    la_output_bf16<4, false>(a, maps, smem);
  }
}

// K6a per (64-token tile, pass), tile fastest, on qkv_body: its ChanLN
// takes the 512-channel width at every C (one body to compile; K6 runs
// once a forward, at the bottleneck).
__device__ __forceinline__ void stage_att_qkv_bf16(const StageArgsBf16& a,
                                                   const CUtensorMap* maps,
                                                   unsigned char* smem) {
  const int T = a.B * a.H * a.W, tiles = (T + attn_bf16::kRows - 1) / attn_bf16::kRows;
  for (int it = blockIdx.x; it < 3 * tiles; it += gridDim.x) {
    before_tma_item();
    attn_bf16::qkv_body<16>(a.p[X], a.p[W], maps + a.map_w, a.p[OUT], T, a.co, it % tiles,
                            it / tiles, smem);
    __syncthreads();
  }
}

// K6c per (64-token tile, 128 output channels), tile fastest, on attn_out_body.
__device__ __forceinline__ void stage_att_out_bf16(const StageArgsBf16& a,
                                                   const CUtensorMap* maps,
                                                   unsigned char* smem) {
  const int T = a.B * a.H * a.W, tiles = (T + attn_bf16::kRows - 1) / attn_bf16::kRows;
  for (int it = blockIdx.x; it < tiles * ((a.co + 127) / 128); it += gridDim.x) {
    before_tma_item();
    attn_bf16::attn_out_body(a.p[SCR], maps + a.map_w, a.p[BIAS], a.p[X], a.p[OUT], T, a.co,
                             it % tiles, it / tiles, smem);
    __syncthreads();
  }
}

__device__ __forceinline__ const CUtensorMap* maps_of() { return nullptr; }
__device__ __forceinline__ const CUtensorMap* maps_of(const CUtensorMap* maps) { return maps; }

// TW: the matmul weights' type, float (3xTF32) or __nv_bfloat16. Maps: the
// bf16 instance's one more parameter, its tensor maps (the float instance
// has the parameters it had before the bf16 one took its maps).
template <class TW, class... Maps>
__global__ void __launch_bounds__(kThreads, 1)
    persistent_kernel(const StageOf<TW>* __restrict__ stages, int n_stages, Bases bases,
                      int n_counters, Maps... maps_arg) {
  constexpr bool kBf16 = std::is_same_v<TW, __nv_bfloat16>;
  [[maybe_unused]] const CUtensorMap* __restrict__ maps = maps_of(maps_arg...);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ ArgsOf<TW> a;
  __shared__ int flag;
  float* smem = reinterpret_cast<float*>(smem_raw);
  cg::grid_group grid = cg::this_grid();
  [[maybe_unused]] Ring ring = {0u, 0u};
  if constexpr (kBf16) {  // the conv ring's mbarriers, past the stage region
    ring.bars = igemm_tc::smem_u32(smem_raw + kStageSmemBf16);
    if (threadIdx.x == 0) {
      for (int k = 0; k < kRingSlots; ++k) hopper_tma::mbar_init(ring.bars + 8 * k);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  if (n_counters > 0) {  // the arrival counters: workspace ints 0 .. n_counters - 1
    int* cnt = reinterpret_cast<int*>(bases.b[1]);
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < n_counters; i += gridDim.x * kThreads)
      cnt[i] = 0;
    grid.sync();
  }
  for (int i = 0; i < n_stages; ++i) {
    MEGA_STAMP(i, 0);
    const StageOf<TW>* s = stages + i;
    if (threadIdx.x < kSlots) {
      const int k = threadIdx.x;
      const long long bi = s->base[k];
      long long base = 0;
#pragma unroll
      for (int j = 0; j < kBases; ++j) base = bi == j ? bases.b[j] : base;
      a.p[k] = reinterpret_cast<float*>(base + s->off[k]);
    } else if (threadIdx.x == 32) {
      a.op = static_cast<int>(s->op);
      a.sync = static_cast<int>(s->sync);
      a.B = static_cast<int>(s->B);
      a.H = static_cast<int>(s->H);
      a.W = static_cast<int>(s->W);
      a.ca = static_cast<int>(s->ca);
      a.cb = static_cast<int>(s->cb);
      a.co = static_cast<int>(s->co);
      a.ks = static_cast<int>(s->ks);
      a.up = static_cast<int>(s->up);
      a.groups = static_cast<int>(s->groups);
      a.chunk = static_cast<int>(s->chunk);
      a.S = static_cast<int>(s->S);
      a.ss_stride = static_cast<int>(s->ss_stride);
      a.bn = static_cast<int>(s->bn);
      a.splits = static_cast<int>(s->splits);
      a.per = static_cast<int>(s->per);
      a.hg = static_cast<int>(s->hg);
      a.tr = static_cast<int>(s->tr);
    }
    if constexpr (kBf16) {
      if (threadIdx.x == 64) {
        a.boxes = static_cast<int>(s->boxes);
        a.ctas = static_cast<int>(s->ctas);
        a.map_w = static_cast<int>(s->map_w);
        a.map_a = static_cast<int>(s->map_a);
        a.map_b = static_cast<int>(s->map_b);
      }
    }
    __syncthreads();
    const int op = a.op, sync = a.sync;
    if constexpr (kBf16) {
      if (threadIdx.x == 0) {  // the thread that issues the stage's TMA copies
        asm volatile("fence.proxy.async.global;\n" ::: "memory");
        if (a.map_w >= 0) hopper_tma::tensormap_acquire(maps + a.map_w);
        if (a.map_a >= 0) hopper_tma::tensormap_acquire(maps + a.map_a);
        if (a.map_b >= 0) hopper_tma::tensormap_acquire(maps + a.map_b);
      }
      switch (op) {
        case kConv: stage_conv_bf16(a, maps, smem_raw, &flag, ring); break;
        case kDown: stage_down_bf16(a, maps, smem_raw, &flag, ring); break;
        case kGnStats: stage_gn_stats(a, smem); break;
        case kGnApply: stage_gn_apply(a, smem); break;
        case kLaContext: stage_la_context_bf16(a, maps, smem_raw, &flag); break;
        case kLaOutput: stage_la_output_bf16(a, maps, smem_raw); break;
        case kAttQkv: stage_att_qkv_bf16(a, maps, smem_raw); break;
        case kAttCore: stage_att_core(a, smem); break;
        case kAttOut: stage_att_out_bf16(a, maps, smem_raw); break;
        default: break;
      }
    } else {
      switch (op) {
        case kConv: stage_conv(a, smem_raw, &flag); break;
        case kDown: stage_down(a, smem_raw, &flag); break;
        case kGnStats: stage_gn_stats(a, smem); break;
        case kGnApply: stage_gn_apply(a, smem); break;
        case kLaContext: stage_la_context(a, smem, &flag); break;
        case kLaOutput: stage_la_output(a, smem); break;
        case kAttQkv: stage_att_qkv(a, smem); break;
        case kAttCore: stage_att_core(a, smem); break;
        case kAttOut: stage_att_out(a, smem); break;
        default: break;
      }
    }
    __syncthreads();  // a and the stage's shared memory are rewritten next
    MEGA_STAMP(i, 1);
    if (sync) {
      // this thread's stores, before other CTAs' TMA copies read them
      if constexpr (kBf16) asm volatile("fence.proxy.async.global;\n" ::: "memory");
      grid.sync();
    }
    MEGA_STAMP(i, 2);
  }
}

// The kernel of an instance.
template <class TW>
void* kernel_of() {
  if constexpr (std::is_same_v<TW, float>)
    return reinterpret_cast<void*>(persistent_kernel<float>);
  else
    return reinterpret_cast<void*>(persistent_kernel<__nv_bfloat16, const CUtensorMap*>);
}

// Blocks of an instance an SM at its shared memory (and the limit set).
template <class TW>
cudaError_t occupancy(int* per_sm) {
  const void* kernel = kernel_of<TW>();
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes<TW>);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kThreads, kSmemBytes<TW>);
}

}  // namespace

// The number of blocks unet2d_persistent_f32 (and _bf16) launches on the
// current device (the host plans its tiles for it): unet2d_persistent.cu.
extern "C" int unet2d_persistent_grid(int* blocks);

namespace {

template <class TW>
int launch(const void* stages, int n_stages, const long long* bases, int n_counters,
           int* grid_out, void* stream, const void* maps) {
  if (n_stages <= 0 || bases == nullptr || bases[0] != 0 || n_counters < 0 ||
      reinterpret_cast<uintptr_t>(maps) % 64)
    return static_cast<int>(cudaErrorInvalidValue);
  Bases b;
  for (int k = 0; k < kBases; ++k) b.b[k] = bases[k];
  int blocks = 0;
  const int err = unet2d_persistent_grid(&blocks);
  if (err != 0) return err;
  const StageOf<TW>* st = static_cast<const StageOf<TW>*>(stages);
  const CUtensorMap* m = static_cast<const CUtensorMap*>(maps);
  void* args[] = {&st, &n_stages, &b, &n_counters, &m};  // the float kernel reads 4
  const cudaError_t e = cudaLaunchCooperativeKernel(kernel_of<TW>(), dim3(blocks), dim3(kThreads),
                                                    args, kSmemBytes<TW>,
                                                    static_cast<cudaStream_t>(stream));
  if (grid_out != nullptr) *grid_out = blocks;
  return static_cast<int>(e);
}

}  // namespace
