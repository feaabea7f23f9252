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
// tile), with the largest stage's shared memory (K5b at 512 channels,
// 220 KB; the 128 x 128 conv tile takes 193 KB).
//
// bf16 weights (unet2d_persistent_bf16): the kernel is a template on the
// matmul weights' type TW, instantiated twice, so the float instance
// carries no branch on it and no register for it. With TW = __nv_bfloat16
// every matmul runs the bf16 variant of the body it stands for, as the
// Pallas mega kernel does on its bf16 packs (research/pallas_unet2d_mega.py
// _mm :113-114, the wide conv :93-94, the downsample :224-225): the conv
// and downsample stages igemm_tc_tile<G, 128, BN, bf16> (wgmma .bf16 with the
// fp32 activation rounded to bf16 at the product, fp32 sums), K5's
// projections and K6's qkv and out-projections gemm_tile<MT, bf16>
// (mma.sync .bf16). GroupNorm, the channel norms, the softmaxes, K5's
// context and K6's core stay fp32 (3xTF32 where they use the tensor
// cores); biases, gains and the FiLM vector stay fp32. The host plan
// (kernels/unet2d_mega.py: check_kernel_plan) holds every matmul weight of
// a plan to one type, with rows of a multiple of 8 for bf16. Bound:
// max(flops / 989 TFLOP/s, bytes / 3.35 TB/s), the weights at 2 bytes.
#include <cooperative_groups.h>

#include "attention.cuh"
#include "conv_gathers.cuh"
#include "igemm_tc.cuh"

namespace cg = cooperative_groups;

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

struct Bases {
  long long b[kBases];
};

// The current stage, resolved into shared memory by the kernel loop.
struct StageArgs {
  float* p[kSlots];
  int op, sync, B, H, W, ca, cb, co, ks, up, groups, chunk, S, ss_stride, bn, splits, per, hg,
      tr;
};

constexpr int kMax2(int a, int b) { return a > b ? a : b; }
constexpr int kStageSmemBytes = kMax2(
    kMax2(igemm_tc::Tile<kBM, 128>::SMEM_BYTES, 4 * context_smem_floats(kMaxC)),
    kMax2(kMax2(4 * output_smem_floats(kMaxC), 4 * qkv_smem_floats(64, kMaxC)),
          kMax2(4 * 2 * kCoreSmemFloats, 4 * out_smem_floats(64))));

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
template <class TW, class G, int BN>
__device__ __forceinline__ void conv_tiles(const G& g, const StageArgs& a, int M, int K,
                                           unsigned char* smem, int* flag) {
  const int N = a.co, splits = a.splits, per = a.per;
  const int mt = (M + kBM - 1) / kBM, tiles = mt * ((N + BN - 1) / BN);
  const TW* w = reinterpret_cast<const TW*>(a.p[W]);
  for (int t = blockIdx.x; t < tiles * splits; t += gridDim.x) {
    const int z = t / tiles, tile = t - z * tiles;
    const int bx = tile % mt, by = tile / mt;
    if (splits == 1) {
      igemm_tc::igemm_tc_tile<G, kBM, BN, TW>(g, w, a.p[BIAS], a.p[OUT], M, N, K, per, bx, by,
                                              0, smem);
      continue;
    }
    igemm_tc::igemm_tc_tile<G, kBM, BN, TW>(g, w, nullptr, a.p[SCR], M, N, K, per, bx, by, z,
                                            smem);
    if (last_arrival(reinterpret_cast<int*>(a.p[CNT]) + tile, splits, flag))
      reduce_tile<BN>(a.p[SCR], a.p[BIAS], a.p[OUT], M, N, splits, bx * kBM, by * BN);
    __syncthreads();  // flag is rewritten by the next tile
  }
}

template <class TW, class G>
__device__ __forceinline__ void conv_stage(const G& g, const StageArgs& a, int M, int K,
                                           unsigned char* smem, int* flag) {
  if (a.bn == 128)
    conv_tiles<TW, G, 128>(g, a, M, K, smem, flag);
  else
    conv_tiles<TW, G, 64>(g, a, M, K, smem, flag);
}

// The stages that run wgmma are inlined into the kernel: a wgmma pipeline in
// a called function is serialized (ptxas C7510). The others are functions
// of their own, so that their registers do not add to the conv tile's.
template <class TW>
__device__ __forceinline__ void stage_conv(const StageArgs& a, unsigned char* smem, int* flag) {
  const auto g = igemm::make_conv_gather(a.p[X], a.p[X2], a.H, a.W, a.ca, a.cb, a.ks, a.up);
  conv_stage<TW>(g, a, a.B * a.H * a.W, a.ks * a.ks * (a.ca + a.cb), smem, flag);
}

template <class TW>
__device__ __forceinline__ void stage_down(const StageArgs& a, unsigned char* smem, int* flag) {
  const auto g = igemm::make_down_gather(a.p[X], a.H, a.W, a.ca);
  conv_stage<TW>(g, a, a.B * (a.H / 2) * (a.W / 2), 4 * a.ca, smem, flag);
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
template <class TW>
__device__ __noinline__ void stage_la_context(const StageArgs& a, float* smem, int* flag) {
  const int n = a.H * a.W, S = a.S, hg = a.hg;
  const TW* wqkv = reinterpret_cast<const TW*>(a.p[AUX]);
  for (int it = blockIdx.x; it < S * a.B * hg; it += gridDim.x) {
    const int s = it % S, b = (it / S) % a.B, h = it / (S * a.B);
    if (hg == 1)
      la_context_body<4, TW>(a.p[X], a.p[W], wqkv, a.p[SCR], n, a.co, a.chunk, s, b, 0, S, smem);
    else
      la_context_body<2, TW>(a.p[X], a.p[W], wqkv, a.p[SCR], n, a.co, a.chunk, s, b, h, S, smem);
    if (last_arrival(reinterpret_cast<int*>(a.p[CNT]) + b, S * hg, flag))
      la_merge_body(a.p[SCR], a.p[OUT], S, b);
    __syncthreads();  // flag and the body's shared memory are rewritten next
  }
}

// K5b per (64-token tile, sample), tile fastest.
template <class TW>
__device__ __noinline__ void stage_la_output(const StageArgs& a, float* smem) {
  const int n = a.H * a.W, tiles = (n + kRows - 1) / kRows;
  const TW* wqkv = reinterpret_cast<const TW*>(a.p[AUX]);
  const TW* wo = reinterpret_cast<const TW*>(a.p[X2]);
  for (int it = blockIdx.x; it < a.B * tiles; it += gridDim.x) {
    la_output_body<TW>(a.p[X], a.p[W], wqkv, a.p[SCR], wo, a.p[BIAS], a.p[RES], a.p[OUT], n,
                       a.co, it % tiles, it / tiles, smem);
    __syncthreads();
  }
}

// K6a per (token tile, pass), tile fastest; tiles of a.tr tokens across samples.
template <int TR, class TW>
__device__ __forceinline__ void att_qkv_tiles(const StageArgs& a, float* smem) {
  const int T = a.B * a.H * a.W, tiles = (T + TR - 1) / TR;
  const TW* wqkv = reinterpret_cast<const TW*>(a.p[AUX]);
  for (int it = blockIdx.x; it < 3 * tiles; it += gridDim.x) {
    attn_qkv_body<TR, TW>(a.p[X], a.p[W], wqkv, a.p[OUT], T, a.co, it % tiles, it / tiles, smem);
    __syncthreads();
  }
}

template <class TW>
__device__ __noinline__ void stage_att_qkv(const StageArgs& a, float* smem) {
  if (a.tr == 32)
    att_qkv_tiles<32, TW>(a, smem);
  else
    att_qkv_tiles<64, TW>(a, smem);
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
template <int TR, class TW>
__device__ __forceinline__ void att_out_tiles(const StageArgs& a, float* smem) {
  const int T = a.B * a.H * a.W, tiles = (T + TR - 1) / TR;
  const TW* wo = reinterpret_cast<const TW*>(a.p[X2]);
  for (int it = blockIdx.x; it < tiles * ((a.co + kCols - 1) / kCols); it += gridDim.x) {
    attn_out_body<TR, TW>(a.p[SCR], wo, a.p[BIAS], a.p[X], a.p[OUT], T, a.co, it % tiles,
                          it / tiles, smem);
    __syncthreads();
  }
}

template <class TW>
__device__ __noinline__ void stage_att_out(const StageArgs& a, float* smem) {
  if (a.tr == 32)
    att_out_tiles<32, TW>(a, smem);
  else
    att_out_tiles<64, TW>(a, smem);
}

// TW: the matmul weights' type, float (3xTF32) or __nv_bfloat16.
template <class TW>
__global__ void __launch_bounds__(kThreads, 1)
    persistent_kernel(const Stage* __restrict__ stages, int n_stages, Bases bases,
                      int n_counters) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ StageArgs a;
  __shared__ int flag;
  float* smem = reinterpret_cast<float*>(smem_raw);
  cg::grid_group grid = cg::this_grid();
  if (n_counters > 0) {  // the arrival counters: workspace ints 0 .. n_counters - 1
    int* cnt = reinterpret_cast<int*>(bases.b[1]);
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < n_counters; i += gridDim.x * kThreads)
      cnt[i] = 0;
    grid.sync();
  }
  for (int i = 0; i < n_stages; ++i) {
    MEGA_STAMP(i, 0);
    const Stage* s = stages + i;
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
    __syncthreads();
    const int op = a.op, sync = a.sync;
    switch (op) {
      case kConv: stage_conv<TW>(a, smem_raw, &flag); break;
      case kDown: stage_down<TW>(a, smem_raw, &flag); break;
      case kGnStats: stage_gn_stats(a, smem); break;
      case kGnApply: stage_gn_apply(a, smem); break;
      case kLaContext: stage_la_context<TW>(a, smem, &flag); break;
      case kLaOutput: stage_la_output<TW>(a, smem); break;
      case kAttQkv: stage_att_qkv<TW>(a, smem); break;
      case kAttCore: stage_att_core(a, smem); break;
      case kAttOut: stage_att_out<TW>(a, smem); break;
      default: break;
    }
    __syncthreads();  // a and the stage's shared memory are rewritten next
    MEGA_STAMP(i, 1);
    if (sync) grid.sync();
    MEGA_STAMP(i, 2);
  }
}

// The cooperative grid on the current device: one block per SM as the
// occupancy calculator finds it at the kernel's shared memory, worked out
// once per device for both instantiations together (the host plans one
// grid, whichever the plan's weight type).
cudaError_t grid_size(int* blocks) {
  static int grid_dev = -1, grid_blocks = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev != grid_dev) {
    int sms = 0, per_sm = 0;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return e;
    const void* kernels[] = {reinterpret_cast<const void*>(persistent_kernel<float>),
                             reinterpret_cast<const void*>(persistent_kernel<__nv_bfloat16>)};
    for (int i = 0; i < 2; ++i) {
      e = cudaFuncSetAttribute(kernels[i], cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kStageSmemBytes);
      if (e != cudaSuccess) return e;
      int n = 0;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernels[i], kThreads,
                                                        kStageSmemBytes);
      if (e != cudaSuccess) return e;
      per_sm = (i == 0 || n < per_sm) ? n : per_sm;
    }
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    grid_dev = dev;
    grid_blocks = per_sm * sms;
  }
  *blocks = grid_blocks;
  return cudaSuccess;
}

template <class TW>
int launch(const void* stages, int n_stages, const long long* bases, int n_counters,
           int* grid_out, void* stream) {
  if (n_stages <= 0 || bases == nullptr || bases[0] != 0 || n_counters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Bases b;
  for (int k = 0; k < kBases; ++k) b.b[k] = bases[k];
  int blocks = 0;
  cudaError_t e = grid_size(&blocks);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Stage* st = static_cast<const Stage*>(stages);
  void* args[] = {&st, &n_stages, &b, &n_counters};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(persistent_kernel<TW>), dim3(blocks),
                                  dim3(kThreads), args, kStageSmemBytes,
                                  static_cast<cudaStream_t>(stream));
  if (grid_out != nullptr) *grid_out = blocks;
  return static_cast<int>(e);
}

}  // namespace

// The number of blocks unet2d_persistent_f32 (and _bf16) launches on the
// current device (the host plans its tiles for it).
extern "C" int unet2d_persistent_grid(int* blocks) { return static_cast<int>(grid_size(blocks)); }

// stages: n_stages Stage records in device memory; bases: kBases host int64
// (bases[0] = 0, bases[1] the workspace, whose first n_counters ints are the
// arrival counters); grid_out (may be null): the number of blocks launched.
// One cooperative launch on `stream` of as many 256-thread blocks as fit on
// the card at once (one per SM). Returns the first cudaError_t that is not
// cudaSuccess (cudaErrorCooperativeLaunchTooLarge is returned, not retried
// smaller).
extern "C" int unet2d_persistent_f32(const void* stages, int n_stages, const long long* bases,
                                     int n_counters, int* grid_out, void* stream) {
  return launch<float>(stages, n_stages, bases, n_counters, grid_out, stream);
}

// The same with every matmul weight of the stage table bf16.
extern "C" int unet2d_persistent_bf16(const void* stages, int n_stages, const long long* bases,
                                      int n_counters, int* grid_out, void* stream) {
  return launch<__nv_bfloat16>(stages, n_stages, bases, n_counters, grid_out, stream);
}

#ifdef MEGA_PHASE_CLOCKS
// Copies the first n stamps ((stage * 256 + block) * 3 + {start, work end,
// barrier end}) to host.
extern "C" int mega_stamps_read(long long* host, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, mega_stamps, sizeof(long long) * n));
}
#endif
