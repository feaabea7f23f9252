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
// spreads its work items (conv tiles, GroupNorm chunks, attention rows) over
// the fixed grid with a loop; a barrier (cooperative_groups grid sync)
// separates a stage from the next one that reads its output.
//
// Stages (Op), each the arithmetic of an earlier kernel:
//   kConv      K1's implicit-GEMM tile loop (igemm_nhwc.cuh) with its gather:
//              3x3 / 1x1, two sources (skip concat), nearest-2x upsample;
//   kDown      K2's gather (2x2 stride-2 conv);
//   kGnStats   K3's per-(sample, group, chunk) mean and sum of squared
//              deviations; kGnApply merges a row's chunks with Chan's
//              formula in a fixed order, then normalises, FiLM, SiLU and the
//              residual (K3's math in CUDA, no float atomics: results
//              repeat bit for bit);
//   kLaContext, kLaOutput   K5a and K5b (linear_attention.cuh); the context
//              of every (sample, head) is finished before a barrier, then
//              the output tiles read it;
//   kAttHeads  full attention per (sample, head) over up to 128 tokens
//              (K6's math; K6 itself holds at most 32), written to a
//              scratch (B, n, 128); kAttOutput the out-projection, bias and
//              residual per 32-token tile.
//
// Coherence: activations are written by other blocks earlier in the same
// launch, so every read of the workspace goes through __ldcg (L2, never the
// non-coherent read-only path or a stale L1 line); weights, the FiLM vector
// and the bound inputs are never written in a launch and keep __ldg.
//
// Bound: operations, as K1 (the convs are ~97% of the FLOPs). A simple
// design first: fp32 FMA on CUDA cores, 256 threads, two blocks per SM
// (105 KB of shared memory each, sized by K5b at 512 channels), no wgmma,
// TMA or clusters.
#include <cooperative_groups.h>

#include "conv_gathers.cuh"
#include "linear_attention.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace attn;

constexpr int kThreads = 256;  // K1's 128 x 64 tile and K5's block
constexpr int kBM = 128;
constexpr int kMaxFullTokens = 128;
constexpr int kNP = kMaxFullTokens + 4;  // row stride of the [c][t] chunk of kAttHeads
constexpr int kKP = kDimHead + 1;        // row stride of q, k, v rows: lane-indexed rows hit 32 banks

// Stage ops and pointer slots; kernels/unet2d_mega.py writes the same codes.
enum Op : int {
  kConv = 0,
  kDown = 1,
  kGnStats = 2,
  kGnApply = 3,
  kLaContext = 4,
  kLaOutput = 5,
  kAttHeads = 6,
  kAttOutput = 7,
};
// Slot use by op (unused slots are null):
//   kConv      X xa, X2 xb, W w, BIAS b, OUT
//   kDown      X, W, BIAS, OUT
//   kGnStats   X, SCR partials
//   kGnApply   X, SCR partials, W gamma, BIAS beta, AUX FiLM ss, RES residual, OUT
//   kLaContext X, W norm_g, AUX wqkv, SCR context
//   kLaOutput  X, W norm_g, AUX wqkv, SCR context, X2 wo, BIAS bo, RES out_g, OUT
//   kAttHeads  X, W norm_g, AUX wqkv, SCR attention output (B, n, 128)
//   kAttOutput X, SCR attention output, X2 wo, BIAS bo, OUT
enum Slot : int { X = 0, X2 = 1, W = 2, BIAS = 3, OUT = 4, SCR = 5, AUX = 6, RES = 7 };
constexpr int kSlots = 8;
constexpr int kBases = 8;

// One stage as the host writes it: 32 int64 (256 bytes). A pointer is
// bases[base[k]] + off[k]; base 0 is the null base (absolute addresses:
// weights), the others the workspace and the call's tensors.
struct Stage {
  long long op, sync, B, H, W, ca, cb, co, ks, up, groups, chunk, S, ss_stride, unused0, unused1;
  long long off[kSlots];
  long long base[kSlots];
};
static_assert(sizeof(Stage) == 256, "the host writes 32 int64 per stage");

struct Bases {
  long long b[kBases];
};

// The current stage, resolved into shared memory by the kernel loop.
struct StageArgs {
  float* p[kSlots];
  int op, sync, B, H, W, ca, cb, co, ks, up, groups, chunk, S, ss_stride;
};
constexpr int kArgsFloats = 32;  // 128 bytes >= sizeof(StageArgs), keeps 16-byte alignment
static_assert(sizeof(StageArgs) <= kArgsFloats * sizeof(float), "StageArgs fits its slot");

constexpr int kConvSmem = 2 * igemm::BK * (kBM + 4) + 2 * igemm::BK * (igemm::BN + 4);
constexpr int kAttHeadsSmem = 2 * kMaxFullTokens + kCC * kNP + 3 * kMaxFullTokens * kKP;
constexpr int kAttOutputSmem = kHidden * kTP;
constexpr int kMax2(int a, int b) { return a > b ? a : b; }
constexpr int kStageSmem =
    kMax2(kMax2(kConvSmem, kLaContextSmem),
          kMax2(kMax2(la_output_smem(kMaxC), kAttHeadsSmem), kAttOutputSmem));

__device__ __forceinline__ float ldc(const float* p) { return __ldcg(p); }

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

template <class G, int BM>
__device__ __forceinline__ void conv_tiles_bm(const G& g, const StageArgs& a, int M, int K,
                                              float* smem) {
  const int N = a.co;
  const int mt = (M + BM - 1) / BM, nt = (N + igemm::BN - 1) / igemm::BN;
  float* As = smem;
  float* Bs = smem + 2 * igemm::BK * (BM + 4);
  for (int t = blockIdx.x; t < mt * nt; t += gridDim.x)
    igemm::igemm_tile<G, BM, BM * igemm::BN / (igemm::TN * kThreads)>(
        g, a.p[W], a.p[BIAS], a.p[OUT], M, N, K, (t % mt) * BM, (t / mt) * igemm::BN, As, Bs);
}

// The tile on the persistent grid: 64 x 64 (4 x 4 outputs per thread) when
// those tiles still fit in one pass over the blocks, so a small level
// spreads over twice as many of them; else 128 x 64 (8 x 4 per thread, more
// FMAs per shared-memory load).
template <class G>
__device__ __forceinline__ void conv_tiles(const G& g, const StageArgs& a, int M, int K,
                                           float* smem) {
  const int tiles64 = (M + kBM / 2 - 1) / (kBM / 2) * ((a.co + igemm::BN - 1) / igemm::BN);
  if (tiles64 <= static_cast<int>(gridDim.x)) {
    conv_tiles_bm<G, kBM / 2>(g, a, M, K, smem);
  } else {
    conv_tiles_bm<G, kBM>(g, a, M, K, smem);
  }
}

__device__ __noinline__ void stage_conv(const StageArgs& a, float* smem) {
  const auto g = igemm::make_conv_gather<true>(a.p[X], a.p[X2], a.H, a.W, a.ca, a.cb, a.ks, a.up);
  conv_tiles(g, a, a.B * a.H * a.W, a.ks * a.ks * (a.ca + a.cb), smem);
}

__device__ __noinline__ void stage_down(const StageArgs& a, float* smem) {
  const auto g = igemm::make_down_gather<true>(a.p[X], a.H, a.W, a.ca);
  conv_tiles(g, a, a.B * (a.H / 2) * (a.W / 2), 4 * a.ca, smem);
}

// Element e of GroupNorm row (b, g) lies at pixel e / Cg, channel
// g * Cg + e % Cg (NHWC, channels fastest), as in K3. Cg is a multiple of 4
// (the plan checks) and chunks start at multiples of 4, so every thread
// moves 4 elements of one pixel as one 16-byte vector.
__device__ __forceinline__ size_t gn_offset(int e, int Cg, int C) {
  return static_cast<size_t>(e / Cg) * C + e % Cg;
}

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
    for (int e = start + 4 * threadIdx.x; e < end; e += 4 * kThreads) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(xr + gn_offset(e, Cg, C)));
      sum += (v.x + v.y) + (v.z + v.w);
    }
    const float mean = block_sum(sum, smem) / (end - start);
    float m2 = 0.f;
    for (int e = start + 4 * threadIdx.x; e < end; e += 4 * kThreads) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(xr + gn_offset(e, Cg, C)));
      const float d0 = v.x - mean, d1 = v.y - mean, d2 = v.z - mean, d3 = v.w - mean;
      m2 += (d0 * d0 + d1 * d1) + (d2 * d2 + d3 * d3);
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
    if (threadIdx.x == 0) {  // Chan's merge of the row's S chunks, in order
      const float* pr = part + 2 * row * a.S;
      float mean = 0.f;
      for (int i = 0; i < a.S; ++i) mean += min(a.chunk, L - i * a.chunk) * ldc(pr + 2 * i);
      mean /= L;
      float m2 = 0.f, dev = 0.f;
      for (int i = 0; i < a.S; ++i) {
        const float d = ldc(pr + 2 * i) - mean;
        m2 += ldc(pr + 2 * i + 1);
        dev += min(a.chunk, L - i * a.chunk) * d * d;
      }
      smem[0] = mean;
      smem[1] = 1.f / sqrtf((m2 + dev) / L + 1e-5f);
    }
    __syncthreads();
    const float mean = smem[0], rstd = smem[1];
    const size_t base = static_cast<size_t>(b) * L * G + g * Cg;
    const float* ssb = ss ? ss + static_cast<size_t>(b) * a.ss_stride : nullptr;
    const int start = s * a.chunk, end = min(start + a.chunk, L);
    for (int e = start + 4 * threadIdx.x; e < end; e += 4 * kThreads) {
      const size_t addr = base + gn_offset(e, Cg, C);
      const int c = g * Cg + e % Cg;
      const float4 v = __ldcg(reinterpret_cast<const float4*>(x + addr));
      const float4 ga = __ldg(reinterpret_cast<const float4*>(gamma + c));
      const float4 be = __ldg(reinterpret_cast<const float4*>(beta + c));
      float y[4] = {(v.x - mean) * rstd * ga.x + be.x, (v.y - mean) * rstd * ga.y + be.y,
                    (v.z - mean) * rstd * ga.z + be.z, (v.w - mean) * rstd * ga.w + be.w};
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
        const float4 r = __ldcg(reinterpret_cast<const float4*>(res + addr));
        o.x += r.x;
        o.y += r.y;
        o.z += r.z;
        o.w += r.w;
      }
      *reinterpret_cast<float4*>(out + addr) = o;
    }
    __syncthreads();  // smem[0..1] is rewritten by the next item
  }
}

__device__ __noinline__ void stage_la_context(const StageArgs& a, float* smem) {
  const int n = a.H * a.W;
  for (int it = blockIdx.x; it < a.B * kHeads; it += gridDim.x) {
    la_context_body<true>(a.p[X], a.p[W], a.p[AUX], a.p[SCR], n, a.co, it / kHeads, it % kHeads,
                          smem);
    __syncthreads();
  }
}

__device__ __noinline__ void stage_la_output(const StageArgs& a, float* smem) {
  const int n = a.H * a.W, tiles = (n + kTok - 1) / kTok;
  for (int it = blockIdx.x; it < a.B * tiles; it += gridDim.x) {
    la_output_body<true>(a.p[X], a.p[W], a.p[AUX], a.p[SCR], a.p[X2], a.p[BIAS], a.p[RES],
                         a.p[OUT], n, a.co, it / tiles, (it % tiles) * kTok, smem);
    __syncthreads();
  }
}

// Full attention of one (sample, head) over n <= 128 tokens: q, k, v of the
// head (thread: column `col` of q, k and v, tokens tg*16 .. tg*16+15), then
// one warp per query with four keys per lane, the fp32 softmax and P v.
__device__ __noinline__ void stage_att_heads(const StageArgs& a, float* smem) {
  float* mean = smem;                       // kMaxFullTokens
  float* rstd = mean + kMaxFullTokens;      // kMaxFullTokens
  float* hT = rstd + kMaxFullTokens;        // kCC x kNP
  float* q = hT + kCC * kNP;                // kMaxFullTokens x kKP, scaled by 32^-0.5
  float* k = q + kMaxFullTokens * kKP;
  float* v = k + kMaxFullTokens * kKP;
  const int n = a.H * a.W, C = a.co;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int col = lane, tg = warp;
  for (int it = blockIdx.x; it < a.B * kHeads; it += gridDim.x) {
    const int b = it / kHeads, h = it % kHeads;
    const float* xb = a.p[X] + static_cast<size_t>(b) * n * C;
    for (int t0 = 0; t0 < n; t0 += kTok)
      token_stats<true>(xb, n, C, t0, mean + t0, rstd + t0);
    __syncthreads();
    float aq[16], ak[16], av[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) aq[i] = ak[i] = av[i] = 0.f;
    for (int cc = 0; cc < C; cc += kCC) {
      load_norm_chunk<true, kMaxFullTokens, kNP>(xb, a.p[W], n, C, 0, cc, mean, rstd, hT);
      __syncthreads();
      const int cmax = min(kCC, C - cc);
      for (int c = 0; c < cmax; ++c) {
        const float* wr = a.p[AUX] + static_cast<size_t>(cc + c) * kQKV + h * kDimHead + col;
        const float* hr = hT + c * kNP + tg * 16;
        fma_row<16>(aq, hr, __ldg(wr));
        fma_row<16>(ak, hr, __ldg(wr + kHidden));
        fma_row<16>(av, hr, __ldg(wr + 2 * kHidden));
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int t = tg * 16 + i;
      q[t * kKP + col] = aq[i] * kScale;
      k[t * kKP + col] = ak[i];
      v[t * kKP + col] = av[i];
    }
    __syncthreads();
    for (int i = warp; i < n; i += kThreads / 32) {  // uniform across the warp
      float s[4];
      float m = -INFINITY;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = lane + 32 * r;
        s[r] = -INFINITY;
        if (j < n) {
          float acc = 0.f;
#pragma unroll
          for (int dd = 0; dd < kDimHead; ++dd) acc += q[i * kKP + dd] * k[j * kKP + dd];
          s[r] = acc;
        }
        m = fmaxf(m, s[r]);
      }
      m = warp_max(m);  // every lane takes part in the shuffles
      float p[4], l = 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        p[r] = lane + 32 * r < n ? expf(s[r] - m) : 0.f;
        l += p[r];
      }
      l = warp_sum(l);
      float o = 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float pn = p[r] / l;
        for (int jj = 0; jj < 32 && 32 * r + jj < n; ++jj)
          o += __shfl_sync(0xffffffffu, pn, jj) * v[(32 * r + jj) * kKP + lane];
      }
      a.p[SCR][(static_cast<size_t>(b) * n + i) * kHidden + h * kDimHead + lane] = o;
    }
    __syncthreads();
  }
}

// out = x + (o wo + bo) for one tile of kTok tokens (K6's epilogue).
__device__ __noinline__ void stage_att_output(const StageArgs& a, float* smem) {
  float* oT = smem;  // kHidden x kTP
  const int n = a.H * a.W, C = a.co, tiles = (n + kTok - 1) / kTok;
  for (int it = blockIdx.x; it < a.B * tiles; it += gridDim.x) {
    const int b = it / tiles, tok0 = (it % tiles) * kTok;
    for (int i = threadIdx.x; i < kTok * kHidden; i += kThreads) {
      const int t = i / kHidden, jj = i - t * kHidden;
      const int tok = tok0 + t;
      oT[jj * kTP + t] =
          tok < n ? ldc(a.p[SCR] + (static_cast<size_t>(b) * n + tok) * kHidden + jj) : 0.f;
    }
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += kThreads) {
      float acc[kTok];
#pragma unroll
      for (int i = 0; i < kTok; ++i) acc[i] = 0.f;
      for (int jj = 0; jj < kHidden; ++jj)
        fma_row<kTok>(acc, oT + jj * kTP, __ldg(a.p[X2] + static_cast<size_t>(jj) * C + c));
      const float bias = __ldg(a.p[BIAS] + c);
#pragma unroll
      for (int i = 0; i < kTok; ++i)
        if (tok0 + i < n) {
          const size_t idx = (static_cast<size_t>(b) * n + tok0 + i) * C + c;
          a.p[OUT][idx] = ldc(a.p[X] + idx) + (acc[i] + bias);
        }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    persistent_kernel(const Stage* __restrict__ stages, int n_stages, Bases bases) {
  extern __shared__ __align__(16) float smem_raw[];
  StageArgs* a = reinterpret_cast<StageArgs*>(smem_raw);
  float* smem = smem_raw + kArgsFloats;
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < n_stages; ++i) {
    const Stage* s = stages + i;
    if (threadIdx.x < kSlots) {
      const int k = threadIdx.x;
      const long long bi = s->base[k];
      long long base = 0;
#pragma unroll
      for (int j = 0; j < kBases; ++j) base = bi == j ? bases.b[j] : base;
      a->p[k] = reinterpret_cast<float*>(base + s->off[k]);
    } else if (threadIdx.x == 32) {
      a->op = static_cast<int>(s->op);
      a->sync = static_cast<int>(s->sync);
      a->B = static_cast<int>(s->B);
      a->H = static_cast<int>(s->H);
      a->W = static_cast<int>(s->W);
      a->ca = static_cast<int>(s->ca);
      a->cb = static_cast<int>(s->cb);
      a->co = static_cast<int>(s->co);
      a->ks = static_cast<int>(s->ks);
      a->up = static_cast<int>(s->up);
      a->groups = static_cast<int>(s->groups);
      a->chunk = static_cast<int>(s->chunk);
      a->S = static_cast<int>(s->S);
      a->ss_stride = static_cast<int>(s->ss_stride);
    }
    __syncthreads();
    const int op = a->op, sync = a->sync;
    switch (op) {
      case kConv: stage_conv(*a, smem); break;
      case kDown: stage_down(*a, smem); break;
      case kGnStats: stage_gn_stats(*a, smem); break;
      case kGnApply: stage_gn_apply(*a, smem); break;
      case kLaContext: stage_la_context(*a, smem); break;
      case kLaOutput: stage_la_output(*a, smem); break;
      case kAttHeads: stage_att_heads(*a, smem); break;
      case kAttOutput: stage_att_output(*a, smem); break;
      default: break;
    }
    __syncthreads();  // a and the stage's shared memory are rewritten next
    if (sync) grid.sync();
  }
}

}  // namespace

// stages: n_stages Stage records in device memory; bases: kBases host int64
// (bases[0] = 0); grid_out (may be null): the number of blocks launched.
// One cooperative launch on `stream` of as many 256-thread blocks as fit
// on the card at once (two per SM). Returns the first cudaError_t that is
// not cudaSuccess (cudaErrorCooperativeLaunchTooLarge is returned, not
// retried smaller).
extern "C" int unet2d_persistent_f32(const void* stages, int n_stages, const long long* bases,
                                     int* grid_out, void* stream) {
  if (n_stages <= 0 || bases == nullptr || bases[0] != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Bases b;
  for (int k = 0; k < kBases; ++k) b.b[k] = bases[k];
  const int smem = (kArgsFloats + kStageSmem) * static_cast<int>(sizeof(float));
  // the grid of the current device, worked out at its first launch
  static int grid_dev = -1, grid_blocks = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev != grid_dev) {
    e = cudaFuncSetAttribute(persistent_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    int sms = 0, per_sm = 0;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return static_cast<int>(e);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, persistent_kernel, kThreads, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    grid_dev = dev;
    grid_blocks = per_sm * sms;
  }
  const Stage* st = static_cast<const Stage*>(stages);
  void* args[] = {&st, &n_stages, &b};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(persistent_kernel), dim3(grid_blocks),
                                  dim3(kThreads), args, smem, static_cast<cudaStream_t>(stream));
  if (grid_out != nullptr) *grid_out = grid_blocks;
  return static_cast<int>(e);
}
