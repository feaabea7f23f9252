// K5 and K6 on bf16 activations: the UNet2D attention blocks under flax's
// dtype=bfloat16 (linear_attention_bf16act, attention_bf16act).
//
// Replace, in the JAX net's bf16 compute dtype, the blocks that
// diffphycon_tpu/research/pallas_unet2d.py runs as _linear_attention_kernel
// (:194) and _attention_kernel (:229): flax's LinearAttentionBlock and
// AttentionBlock (diffphycon_tpu/nets/blocks.py:105-211) with dtype=bf16.
// The plain versions are kernels/attention.py: _linear_bf16_plain and
// _full_bf16_plain; each rounding below is one of theirs, in their order.
//
// x and out: (B, n, C) bf16 token rows (NHWC, n = H * W); wqkv (C, 384) and
// wo (128, C) bf16; norm_g, bo, out_g fp32; 4 heads of 32.
//
// K5 (six launches):
// - K5a, per 64-token tile of the B n flattened tokens and per q, k or v:
//   ChanLN (below), rounded to bf16 as the 1x1 conv takes it; the 128
//   columns of q, k or v = bf16(x_ln wqkv),
//   products summed in fp32 (mma.sync m16n8k16 bf16, the weight streamed
//   through shared memory in 64-row slices); q's softmax over each head's
//   32 channels in registers (the row's 32 values lie on 4 lanes), times
//   bf16(32^-0.5); q, raw k and v stored bf16 to the scratch (tokens x
//   384; a head-major layout, each head's k and v contiguous, timed slower
//   over K5a, K5b and K5c together: 1.576 against 1.478 ms a forward).
// - K5b, per (sample, head, chunk of 256 tokens), four launches: k's
//   softmax over the tokens in flax's exact order, not online: a max pass,
//   then a pass summing the bf16-rounded exps in fp32, rounded to bf16,
//   then the probabilities bf16(e / sum), normalised before the context
//   product (an online softmax would normalise after it and round other
//   values); the chunks' fp32 context partials, summed in chunk order and
//   rounded. So its only gap to the plain version is summation order
//   (chip_smoke.py phase 18 holds it within two bf16 steps).
// - K5c, per 64-token tile: out = bf16(context^T q) per head, the
//   out-projection bf16(bf16(out wo) + bf16(bo)) (mma.sync), the out-ChanLN
//   times the fp32 gain, and y = bf16(x + that): flax's fp32 block output,
//   which only convs read, rounding it to bf16 (kernels/attention.py).
// K6 (three launches):
// - K6a: K5a's ChanLN and projection; q = bf16(q * bf16(32^-0.5)), k, v.
// - K6b, per (sample, head, 64 queries): one query a thread, scores s =
//   bf16(q . k) in fp32, the softmax in fp32 in exact order (max pass, sum
//   pass, then bf16(e / sum) as flax's softmax(sim.astype(f32)).astype(
//   bf16)), out = bf16(sum_j p v_j).
// - K6c, per 64-token tile: bf16(bf16(o wo) + bf16(bo)), y = bf16(x + that).
// ChanLN (flax ChanLayerNorm on bf16, eps 1e-3): mean and variance (around
// the fp32 mean) in fp32, each rounded to bf16; bf16(x - mean), rstd =
// bf16(1 / sqrt(bf16(var + bf16(1e-3)))), their product rounded, times the
// fp32 gain. Every rounding is to nearest even, and no multiply-add is
// fused where the plain version rounds between the two.
//
// Bound: bytes at the 2048-token sites (the projections' 2 * 384 flops per
// 2-byte input channel are below the bf16 ridge), operations at the 32-token
// sites; chip_smoke.py prints each call's bound from its shapes. A simple
// kernel: the projections are warp-level mma.sync products, the token
// softmaxes and the context plain fp32 loops.
//
// Contract (the wrapper checks): C a multiple of 8 up to 512, every pointer
// 16-byte aligned, B * n * 384 < 2^31.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTR = 64;        // tokens per tile (K5a, K5c, K6a, K6c)
constexpr int kThreads = 128;  // 4 warps, 16 tile rows each
constexpr int kHeads = 4, kDh = 32, kHidden = kHeads * kDh;
constexpr int kQkv = 3 * kHidden;
constexpr int kNP = 128;        // columns per product pass
constexpr int kKC = 64;         // weight rows staged per step
constexpr int kWS = kNP + 8;    // a staged weight row, in elements (padded)
constexpr int kAS = kHidden + 8;  // a 128-channel tile row (padded)
constexpr int kMaxC = 512;
constexpr int kCtxThreads = 256;  // K5b
constexpr int kAttnQ = 64;        // K6b: queries a CTA, one a thread
constexpr int kSplitTiles = 132;  // K5a / K6a: fewer tiles than an H100's SMs take 3 CTAs each

__device__ __forceinline__ float rb(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

__device__ __forceinline__ float f(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack2f(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the C padded to the product's k steps
__host__ __device__ __forceinline__ int padded(int c) { return (c + 15) / 16 * 16; }

// d += a (16 x 16, row-major fragments) * b (16 x 8, col-major), bf16 in,
// fp32 sums
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[j] (fragment rows warp * 16 + g and + 8, columns col0 + 8 j + 2 t, + 1)
// = the tile As (kTR x Kp bf16, row stride lda, columns past K zero) times
// W[0 .. K)[col0 .. col0 + kNP) (W: (K, N) bf16 row-major; columns past N
// read as zeros). Ws: kKC x kWS bf16 of shared memory. Called by all
// kThreads threads; starts and ends with a barrier.
__device__ void gemm_pass(const bf16* As, int lda, const bf16* __restrict__ W, int K, int N,
                          int col0, bf16* Ws, float (&acc)[kNP / 8][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < kNP / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int Kp = padded(K);
  for (int k0 = 0; k0 < Kp; k0 += kKC) {
    __syncthreads();  // the last step's readers of Ws are done
    for (int i = threadIdx.x; i < kKC * (kNP / 8); i += kThreads) {
      const int r = i / (kNP / 8), c8 = (i % (kNP / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < K && col0 + c8 < N)
        v = __ldg(reinterpret_cast<const uint4*>(W + static_cast<size_t>(k0 + r) * N + col0 + c8));
      *reinterpret_cast<uint4*>(Ws + r * kWS + c8) = v;
    }
    __syncthreads();
    for (int kk = 0; kk < kKC && k0 + kk < Kp; kk += 16) {
      const bf16* ar = As + (warp * 16 + g) * lda + k0 + kk + 2 * t;
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(ar);
      a[1] = *reinterpret_cast<const uint32_t*>(ar + 8 * lda);
      a[2] = *reinterpret_cast<const uint32_t*>(ar + 8);
      a[3] = *reinterpret_cast<const uint32_t*>(ar + 8 * lda + 8);
#pragma unroll
      for (int j = 0; j < kNP / 8; ++j) {
        const bf16* wc = Ws + (kk + 2 * t) * kWS + 8 * j + g;
        mma16816(acc[j], a, pack2(wc[0], wc[kWS]), pack2(wc[8 * kWS], wc[9 * kWS]));
      }
    }
  }
  __syncthreads();
}

// tokens [t0, t0 + kTR) of x (bf16 rows of C) into As (row stride lda),
// zeros past the last token and in the columns C .. padded(C)
__device__ void load_rows(const bf16* __restrict__ x, int tokens, int C, int t0, bf16* As,
                          int lda) {
  const int cp = padded(C), v8 = cp / 8;
  for (int i = threadIdx.x; i < kTR * v8; i += kThreads) {
    const int r = i / v8, c = (i - r * v8) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (t0 + r < tokens && c < C)
      v = __ldg(reinterpret_cast<const uint4*>(x + static_cast<size_t>(t0 + r) * C + c));
    *reinterpret_cast<uint4*>(As + r * lda + c) = v;
  }
}

// flax ChanLayerNorm of a bf16 row (C values at row, lane-strided): writes
// bf16(ln * g) back in place (in) or returns nothing; one warp a row.
// mean, var: fp32 reductions rounded to bf16; then bf16(x - mean),
// bf16(1/sqrt(bf16(var + bf16(1e-3)))), their product rounded, times g.
struct LnStats {
  float mean, rstd;
};

__device__ __forceinline__ LnStats ln_stats(const bf16* row, int C, int lane) {
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += f(row[c]);
  const float mean = warp_sum(s) / static_cast<float>(C);
  float q = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = f(row[c]) - mean;
    q += d * d;
  }
  const float var = warp_sum(q) / static_cast<float>(C);
  const float eps = rb(1e-3f);
  return {rb(mean), rb(__frsqrt_rn(rb(rb(var) + eps)))};
}

// the normalised value before the gain: bf16(bf16(x - mean) * rstd)
__device__ __forceinline__ float ln_unit(float x, const LnStats& st) {
  return rb(rb(x - st.mean) * st.rstd);
}

// every row of the tile As through ChanLN, rounded to bf16 (the 1x1 conv's
// input); warp w takes rows 16 w .. 16 w + 15
__device__ void chan_ln_tile(bf16* As, int lda, int C, const float* __restrict__ g) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp * 16; r < warp * 16 + 16; ++r) {
    bf16* row = As + r * lda;
    const LnStats st = ln_stats(row, C, lane);
    for (int c = lane; c < C; c += 32)
      row[c] = __float2bfloat16_rn(ln_unit(f(row[c]), st) * __ldg(g + c));
  }
}

// K5a / K6a: ChanLN, the q | k | v projection; q softmaxed over each head's
// channels and scaled (K5: linear) or only scaled (K6), k and v raw; all
// stored bf16 to qkv (tokens x 384). CTA (tile, y) takes the passes y, y +
// gridDim.y, .. of q, k, v: with fewer tiles than SMs (the 32- and
// 128-token sites at batch 50: 25 and 100 tiles) three CTAs a tile, each
// repeating the tile's ChanLN, spread the weight slices over more SMs;
// with more (400 and 1600) one CTA a tile does all three (timed: the
// split took 149 -> 218 us at the 2048-token sites, 76 -> 42 at the
// 32-token ones; NVIDIA H100 80GB HBM3, 700 W).
template <bool LINEAR>
__global__ void __launch_bounds__(kThreads)
qkv_kernel(const bf16* __restrict__ x, const float* __restrict__ norm_g,
           const bf16* __restrict__ wqkv, bf16* __restrict__ qkv, int tokens, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lda = padded(C) + 8;
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Ws = As + kTR * lda;
  const int t0 = blockIdx.x * kTR;
  load_rows(x, tokens, C, t0, As, lda);
  __syncthreads();
  chan_ln_tile(As, lda, C, norm_g);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float scale = rb(0.17677669529663687f);  // 32^-0.5 as a bf16 constant
  float acc[kNP / 8][4];
  for (int pass = blockIdx.y; pass < 3; pass += gridDim.y) {  // q, k, v: 128 columns each
    gemm_pass(As, lda, wqkv, C, kQkv, pass * kNP, Ws, acc);
#pragma unroll
    for (int j = 0; j < kNP / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = rb(acc[j][i]);
    if (pass == 0) {
      if (LINEAR) {
        // per head: its 32 columns are the n-tiles 4 hd .. 4 hd + 3, two
        // columns each on the 4 lanes of a row (lanes 4 g .. 4 g + 3)
#pragma unroll
        for (int hd = 0; hd < kHeads; ++hd) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float m = -INFINITY;
#pragma unroll
            for (int j = 4 * hd; j < 4 * hd + 4; ++j)
              m = fmaxf(m, fmaxf(acc[j][2 * half], acc[j][2 * half + 1]));
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
            float s = 0.f;
#pragma unroll
            for (int j = 4 * hd; j < 4 * hd + 4; ++j)
#pragma unroll
              for (int i = 2 * half; i < 2 * half + 2; ++i) {
                acc[j][i] = rb(expf(rb(acc[j][i] - m)));
                s += acc[j][i];
              }
            s += __shfl_xor_sync(0xffffffffu, s, 1);
            s += __shfl_xor_sync(0xffffffffu, s, 2);
            const float sb = rb(s);
#pragma unroll
            for (int j = 4 * hd; j < 4 * hd + 4; ++j)
#pragma unroll
              for (int i = 2 * half; i < 2 * half + 2; ++i)
                acc[j][i] = rb(rb(__fdiv_rn(acc[j][i], sb)) * scale);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < kNP / 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[j][i] = rb(acc[j][i] * scale);
      }
    }
    const int r0 = t0 + warp * 16 + g;
#pragma unroll
    for (int j = 0; j < kNP / 8; ++j) {
      const int col = pass * kNP + 8 * j + 2 * t;
      if (r0 < tokens)
        *reinterpret_cast<uint32_t*>(qkv + static_cast<size_t>(r0) * kQkv + col) =
            pack2f(acc[j][0], acc[j][1]);
      if (r0 + 8 < tokens)
        *reinterpret_cast<uint32_t*>(qkv + static_cast<size_t>(r0 + 8) * kQkv + col) =
            pack2f(acc[j][2], acc[j][3]);
    }
  }
}

// K5b: per (sample, head) the softmax of k over the sample's n tokens in
// exact order, and context[d][e] = bf16(sum_n p[n][d] v[n][e]); ctx: (B,
// heads, 32, 32) bf16. Four launches over (sample, head, chunk of kChunk
// tokens), so that the 2048-token sites run 1600 CTAs, not 200: the chunks'
// maxima (their max is exact in any order), the chunks' sums of the
// bf16-rounded exps against the global max, the chunks' fp32 context
// partials with p = bf16(e / bf16(sum of the chunk sums in chunk order)),
// and their sum in chunk order, rounded. part: fp32 scratch of
// ctx_part_floats(B, n).
constexpr int kChunk = 256;  // tokens a K5b CTA

__host__ __device__ __forceinline__ int n_chunks(int n) { return (n + kChunk - 1) / kChunk; }

// (B, heads, S, 32) maxima, then sums, then (B, heads, S, 32, 32) contexts
__host__ __device__ __forceinline__ size_t ctx_part_floats(int B, int n) {
  return static_cast<size_t>(B) * kHeads * n_chunks(n) * (2 * kDh + kDh * kDh);
}

struct CtxPart {
  float *mx, *sum, *ctx;
  __host__ __device__ CtxPart(float* part, int B, int n) {
    const size_t rows = static_cast<size_t>(B) * kHeads * n_chunks(n);
    mx = part;
    sum = part + rows * kDh;
    ctx = part + 2 * rows * kDh;
  }
};

// the chunk's k column d, stripe-strided: thread (d, stripe) of kCtxThreads
__device__ __forceinline__ const bf16* chunk_k(const bf16* qkv, int n, int b, int hd) {
  return qkv + static_cast<size_t>(b) * n * kQkv + kHidden + hd * kDh;
}

// stage 0: the chunk's max per k column; stage 1: the chunk's sum of
// bf16(exp(bf16(k - max))) against the global max (the max of the chunks'
// maxima). grid (heads, B, S).
template <int STAGE>
__global__ void __launch_bounds__(kCtxThreads)
ctx_stats_kernel(const bf16* __restrict__ qkv, float* __restrict__ part, int B, int n) {
  __shared__ float red[kCtxThreads / 32][kDh];
  const int hd = blockIdx.x, b = blockIdx.y, sc = blockIdx.z, S = gridDim.z;
  const int d = threadIdx.x & 31, stripe = threadIdx.x >> 5;
  const CtxPart pt(part, B, n);
  const size_t row0 = (static_cast<size_t>(b) * kHeads + hd) * S;
  const bf16* kb = chunk_k(qkv, n, b, hd);
  const int i1 = min(n, (sc + 1) * kChunk);
  float v;
  if (STAGE == 0) {
    v = -INFINITY;
#pragma unroll 4
    for (int i = sc * kChunk + stripe; i < i1; i += kCtxThreads / 32)
      v = fmaxf(v, f(kb[static_cast<size_t>(i) * kQkv + d]));
  } else {
    float m = -INFINITY;
    for (int s2 = 0; s2 < S; ++s2) m = fmaxf(m, pt.mx[(row0 + s2) * kDh + d]);
    v = 0.f;
#pragma unroll 4
    for (int i = sc * kChunk + stripe; i < i1; i += kCtxThreads / 32)
      v += rb(expf(rb(f(kb[static_cast<size_t>(i) * kQkv + d]) - m)));
  }
  red[stripe][d] = v;
  __syncthreads();
  if (stripe == 0) {
    for (int k = 1; k < kCtxThreads / 32; ++k)
      v = STAGE == 0 ? fmaxf(v, red[k][d]) : v + red[k][d];
    (STAGE == 0 ? pt.mx : pt.sum)[(row0 + sc) * kDh + d] = v;
  }
}

// stage 2: the chunk's fp32 context partial sum_n p[n][d] v[n][e], by
// mma.sync (p and v are bf16 values: their products are exact in fp32):
// per 64 tokens, p and v staged transposed (d or e rows, tokens along a row,
// the pairs an mma fragment takes contiguous), warp w on the 16 x 8 block
// (d 16 (w % 2).., e 8 (w / 2)..). grid (heads, B, S).
constexpr int kPS = 64 + 8;  // a staged row of 64 tokens (padded)

__global__ void __launch_bounds__(kCtxThreads)
ctx_partial_kernel(const bf16* __restrict__ qkv, float* __restrict__ part, int B, int n) {
  __shared__ float mx[kDh], sb[kDh];
  __shared__ __align__(16) bf16 Pt[kDh][kPS], Vt[kDh][kPS];
  const int hd = blockIdx.x, b = blockIdx.y, sc = blockIdx.z, S = gridDim.z;
  const CtxPart pt(part, B, n);
  const size_t row0 = (static_cast<size_t>(b) * kHeads + hd) * S;
  const bf16* kb = chunk_k(qkv, n, b, hd);
  const bf16* vb = kb + kHidden;
  if (threadIdx.x < kDh) {
    const int d = threadIdx.x;
    float m = -INFINITY, s = 0.f;
    for (int s2 = 0; s2 < S; ++s2) {
      m = fmaxf(m, pt.mx[(row0 + s2) * kDh + d]);
      s += pt.sum[(row0 + s2) * kDh + d];  // chunk order
    }
    mx[d] = m;
    sb[d] = rb(s);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int mt = warp & 1, nt = warp >> 1;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const int i1 = min(n, (sc + 1) * kChunk);
  for (int c0 = sc * kChunk; c0 < i1; c0 += 64) {
    for (int i = threadIdx.x; i < 64 * kDh; i += kCtxThreads) {
      const int r = i / kDh, c = i % kDh;
      float p = 0.f, v = 0.f;
      if (c0 + r < i1) {
        const size_t row = static_cast<size_t>(c0 + r) * kQkv;
        p = rb(__fdiv_rn(rb(expf(rb(f(kb[row + c]) - mx[c]))), sb[c]));
        v = f(vb[row + c]);
      }
      Pt[c][r] = __float2bfloat16_rn(p);
      Vt[c][r] = __float2bfloat16_rn(v);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const bf16* ar = &Pt[mt * 16 + g][ks * 16 + 2 * t];
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(ar);
      a[1] = *reinterpret_cast<const uint32_t*>(ar + 8 * kPS);
      a[2] = *reinterpret_cast<const uint32_t*>(ar + 8);
      a[3] = *reinterpret_cast<const uint32_t*>(ar + 8 * kPS + 8);
      const bf16* br = &Vt[nt * 8 + g][ks * 16 + 2 * t];
      mma16816(acc, a, *reinterpret_cast<const uint32_t*>(br),
               *reinterpret_cast<const uint32_t*>(br + 8));
    }
    __syncthreads();
  }
  float* out = pt.ctx + (row0 + sc) * kDh * kDh;
  const int d = mt * 16 + g, e = nt * 8 + 2 * t;
  out[d * kDh + e] = acc[0];
  out[d * kDh + e + 1] = acc[1];
  out[(d + 8) * kDh + e] = acc[2];
  out[(d + 8) * kDh + e + 1] = acc[3];
}

// stage 3: ctx = bf16(the chunks' partials summed in chunk order).
// grid (heads, B), 1024 threads: one context value each.
__global__ void __launch_bounds__(kDh * kDh)
ctx_merge_kernel(const float* __restrict__ part, bf16* __restrict__ ctx, int B, int n) {
  const int hd = blockIdx.x, b = blockIdx.y, S = n_chunks(n);
  const CtxPart pt(const_cast<float*>(part), B, n);
  const size_t row0 = (static_cast<size_t>(b) * kHeads + hd) * S;
  float s = 0.f;
  for (int s2 = 0; s2 < S; ++s2) s += pt.ctx[(row0 + s2) * kDh * kDh + threadIdx.x];
  ctx[(static_cast<size_t>(b) * kHeads + hd) * kDh * kDh + threadIdx.x] =
      __float2bfloat16_rn(s);
}

// K6b: per (sample, head, kAttnQ queries), one query a thread: s_j =
// bf16(q . k_j), p_j = bf16(exp(s_j - max) / sum) in fp32, o =
// bf16(sum_j p_j v_j); ao: (tokens, 128) bf16, head hd's columns.
__global__ void __launch_bounds__(kAttnQ)
attn_core_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ ao, int n) {
  __shared__ float Ks[64][kDh + 1], Vs[64][kDh + 1];
  const int b = blockIdx.z, hd = blockIdx.y;
  const int i = blockIdx.x * kAttnQ + threadIdx.x;
  const bool live = i < n;
  const bf16* base = qkv + static_cast<size_t>(b) * n * kQkv + hd * kDh;
  float q[kDh];
#pragma unroll
  for (int d = 0; d < kDh; ++d) q[d] = live ? f(base[static_cast<size_t>(i) * kQkv + d]) : 0.f;

  auto stage = [&](int c0) {
    __syncthreads();
    for (int e = threadIdx.x; e < 64 * kDh; e += kAttnQ) {
      const int r = e / kDh, c = e % kDh;
      const bool in = c0 + r < n;
      const size_t row = static_cast<size_t>(c0 + r) * kQkv;
      Ks[r][c] = in ? f(base[row + kHidden + c]) : 0.f;
      Vs[r][c] = in ? f(base[row + 2 * kHidden + c]) : 0.f;
    }
    __syncthreads();
  };
  auto score = [&](int r) {
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < kDh; ++d) s += q[d] * Ks[r][d];
    return rb(s);
  };

  float m = -INFINITY;
  for (int c0 = 0; c0 < n; c0 += 64) {
    stage(c0);
    for (int r = 0; r < min(64, n - c0); ++r) m = fmaxf(m, score(r));
  }
  float sum = 0.f;
  for (int c0 = 0; c0 < n; c0 += 64) {
    stage(c0);
    for (int r = 0; r < min(64, n - c0); ++r) sum += expf(score(r) - m);
  }
  float o[kDh];
#pragma unroll
  for (int e = 0; e < kDh; ++e) o[e] = 0.f;
  for (int c0 = 0; c0 < n; c0 += 64) {
    stage(c0);
    for (int r = 0; r < min(64, n - c0); ++r) {
      const float p = rb(__fdiv_rn(expf(score(r) - m), sum));
#pragma unroll
      for (int e = 0; e < kDh; ++e) o[e] += p * Vs[r][e];
    }
  }
  if (!live) return;
  bf16* out = ao + (static_cast<size_t>(b) * n + i) * kHidden + hd * kDh;
#pragma unroll
  for (int e = 0; e < kDh; e += 2)
    *reinterpret_cast<uint32_t*>(out + e) = pack2f(o[e], o[e + 1]);
}

// K5c / K6c: per 64-token tile, the 128 attention channels (K5: bf16(ctx^T
// q) from q and the contexts; K6: the K6b output) through the
// out-projection, bf16(bf16(. wo) + bf16(bo)); K5 then the out-ChanLN times
// out_g; y = bf16(x + h) stored to out.
template <bool LINEAR>
__global__ void __launch_bounds__(kThreads)
output_kernel(const bf16* __restrict__ x, const bf16* __restrict__ src,
              const bf16* __restrict__ ctx, const bf16* __restrict__ wo,
              const float* __restrict__ bo, const float* __restrict__ out_g,
              bf16* __restrict__ out, int tokens, int n, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldo = padded(C) + 8;
  bf16* As = reinterpret_cast<bf16*>(smem);  // kTR x kAS: the 128 attention channels
  bf16* Qs = As + kTR * kAS;                  // kTR x kAS: K5's q
  bf16* Os = Qs + kTR * kAS;                  // kTR x ldo: the projected rows
  bf16* Xs = Os + kTR * ldo;                  // kTR x ldo: the residual's x rows
  bf16* Ws = Xs + kTR * ldo;
  const int t0 = blockIdx.x * kTR;
  load_rows(x, tokens, C, t0, Xs, ldo);  // read while the products run (the first barrier)
  if (LINEAR) {
    for (int i = threadIdx.x; i < kTR * (kHidden / 8); i += kThreads) {
      const int r = i / (kHidden / 8), c = (i % (kHidden / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (t0 + r < tokens)
        v = __ldg(reinterpret_cast<const uint4*>(src + static_cast<size_t>(t0 + r) * kQkv + c));
      *reinterpret_cast<uint4*>(Qs + r * kAS + c) = v;
    }
    __syncthreads();
    // out[r][hd 32 + e] = bf16(sum_d q[r][hd 32 + d] ctx[b][hd][d][e]), warp
    // w on rows 16 w .. 16 w + 15: one mma.sync chain a head where those
    // rows are one sample's (every main-path site: n a multiple of 16), else
    // lane e of each head, row by row
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int r0 = warp * 16;
    const int first = min(t0 + r0, tokens - 1), last = min(t0 + r0 + 15, tokens - 1);
    if (first / n == last / n) {
      const bf16* cb = ctx + static_cast<size_t>(first / n) * kHeads * kDh * kDh;
#pragma unroll
      for (int hd = 0; hd < kHeads; ++hd) {
        float acc[4][4] = {};
#pragma unroll
        for (int ks = 0; ks < kDh / 16; ++ks) {
          const bf16* ar = Qs + (r0 + g) * kAS + hd * kDh + ks * 16 + 2 * t;
          uint32_t a[4];
          a[0] = *reinterpret_cast<const uint32_t*>(ar);
          a[1] = *reinterpret_cast<const uint32_t*>(ar + 8 * kAS);
          a[2] = *reinterpret_cast<const uint32_t*>(ar + 8);
          a[3] = *reinterpret_cast<const uint32_t*>(ar + 8 * kAS + 8);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const bf16* bc = cb + (hd * kDh + ks * 16 + 2 * t) * kDh + nt * 8 + g;
            mma16816(acc[nt], a, pack2(bc[0], bc[kDh]), pack2(bc[8 * kDh], bc[9 * kDh]));
          }
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          bf16* o = As + (r0 + g) * kAS + hd * kDh + nt * 8 + 2 * t;
          *reinterpret_cast<uint32_t*>(o) = pack2f(acc[nt][0], acc[nt][1]);
          *reinterpret_cast<uint32_t*>(o + 8 * kAS) = pack2f(acc[nt][2], acc[nt][3]);
        }
      }
    } else {
      for (int r = r0; r < r0 + 16; ++r)
        for (int hd = 0; hd < kHeads; ++hd) {
          float acc = 0.f;
          if (t0 + r < tokens) {
            const bf16* cb =
                ctx + (static_cast<size_t>((t0 + r) / n) * kHeads + hd) * kDh * kDh + lane;
            for (int d = 0; d < kDh; ++d) acc += f(cb[d * kDh]) * f(Qs[r * kAS + hd * kDh + d]);
          }
          As[r * kAS + hd * kDh + lane] = __float2bfloat16_rn(acc);
        }
    }
  } else {
    for (int i = threadIdx.x; i < kTR * (kHidden / 8); i += kThreads) {
      const int r = i / (kHidden / 8), c = (i % (kHidden / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (t0 + r < tokens)
        v = __ldg(reinterpret_cast<const uint4*>(src + static_cast<size_t>(t0 + r) * kHidden + c));
      *reinterpret_cast<uint4*>(As + r * kAS + c) = v;
    }
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float acc[kNP / 8][4];
  for (int col0 = 0; col0 < C; col0 += kNP) {
    gemm_pass(As, kAS, wo, kHidden, C, col0, Ws, acc);
    const int r = warp * 16 + g;
#pragma unroll
    for (int jj = 0; jj < kNP / 8; ++jj) {
      const int c = col0 + 8 * jj + 2 * t;
      if (c < C) {
        const float b0 = rb(__ldg(bo + c)), b1 = rb(__ldg(bo + c + 1));
        *reinterpret_cast<uint32_t*>(Os + r * ldo + c) =
            pack2f(rb(acc[jj][0]) + b0, rb(acc[jj][1]) + b1);
        *reinterpret_cast<uint32_t*>(Os + (r + 8) * ldo + c) =
            pack2f(rb(acc[jj][2]) + b0, rb(acc[jj][3]) + b1);
      }
    }
  }
  __syncthreads();

  for (int r = warp * 16; r < warp * 16 + 16; ++r) {
    if (t0 + r >= tokens) break;
    const bf16* row = Os + r * ldo;
    const bf16* xr = Xs + r * ldo;
    bf16* yr = out + static_cast<size_t>(t0 + r) * C;
    if (LINEAR) {
      const LnStats st = ln_stats(row, C, lane);
      for (int c = lane; c < C; c += 32)
        yr[c] = __float2bfloat16_rn(
            __fadd_rn(f(xr[c]), __fmul_rn(ln_unit(f(row[c]), st), __ldg(out_g + c))));
    } else {
      for (int c = lane; c < C; c += 32) yr[c] = __float2bfloat16_rn(f(xr[c]) + f(row[c]));
    }
  }
}

template <class K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

int qkv_smem(int C) { return (kTR * (padded(C) + 8) + kKC * kWS) * 2; }
int out_smem(int C) { return (2 * kTR * kAS + 2 * kTR * (padded(C) + 8) + kKC * kWS) * 2; }

template <bool LINEAR>
cudaError_t launch_qkv(const bf16* x, const float* norm_g, const bf16* wqkv, bf16* qkv,
                       int tokens, int C, cudaStream_t stream) {
  static bool set = false;  // > 48 KB of dynamic shared memory: once per instantiation
  if (!set) {
    const cudaError_t e = set_smem(qkv_kernel<LINEAR>, qkv_smem(kMaxC));
    if (e != cudaSuccess) return e;
    set = true;
  }
  const int tiles = (tokens + kTR - 1) / kTR;
  qkv_kernel<LINEAR><<<dim3(tiles, tiles < kSplitTiles ? 3 : 1), kThreads, qkv_smem(C), stream>>>(
      x, norm_g, wqkv, qkv, tokens, C);
  return cudaGetLastError();
}

template <bool LINEAR>
cudaError_t launch_out(const bf16* x, const bf16* src, const bf16* ctx, const bf16* wo,
                       const float* bo, const float* out_g, bf16* out, int tokens, int n, int C,
                       cudaStream_t stream) {
  static bool set = false;
  if (!set) {
    const cudaError_t e = set_smem(output_kernel<LINEAR>, out_smem(kMaxC));
    if (e != cudaSuccess) return e;
    set = true;
  }
  output_kernel<LINEAR><<<(tokens + kTR - 1) / kTR, kThreads, out_smem(C), stream>>>(
      x, src, ctx, wo, bo, out_g, out, tokens, n, C);
  return cudaGetLastError();
}

bool bad_dims(int B, int n, int C) {
  return B < 1 || B > 65535 || n < 1 || C < 8 || C > kMaxC || C % 8 ||
         static_cast<long long>(B) * n * kQkv > 0x7fffffffLL ||
         static_cast<long long>(B) * n * C > 0x7fffffffLL;
}

}  // namespace

// K5 on bf16 activations. dims: {B, n, C}. scratch: B n 384 + B 4096 bf16
// (q | k | v rows, the contexts), then the context stages' fp32 partials,
// ctx_part_floats(B, n) (kernels/attention.py sizes it alike). Six launches
// on `stream`.
extern "C" int linear_attention_bf16act(const bf16* x, const float* norm_g, const bf16* wqkv,
                                        const bf16* wo, const float* bo, const float* out_g,
                                        bf16* scratch, bf16* out, const int* dims,
                                        void* stream) {
  const int B = dims[0], n = dims[1], C = dims[2];
  if (bad_dims(B, n, C)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tokens = B * n;
  bf16* qkv = scratch;
  bf16* ctx = scratch + static_cast<size_t>(tokens) * kQkv;
  float* part = reinterpret_cast<float*>(ctx + static_cast<size_t>(B) * kHeads * kDh * kDh);
  cudaError_t e = launch_qkv<true>(x, norm_g, wqkv, qkv, tokens, C, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 chunks(kHeads, B, n_chunks(n));
  ctx_stats_kernel<0><<<chunks, kCtxThreads, 0, s>>>(qkv, part, B, n);
  ctx_stats_kernel<1><<<chunks, kCtxThreads, 0, s>>>(qkv, part, B, n);
  ctx_partial_kernel<<<chunks, kCtxThreads, 0, s>>>(qkv, part, B, n);
  ctx_merge_kernel<<<dim3(kHeads, B), kDh * kDh, 0, s>>>(part, ctx, B, n);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_out<true>(x, qkv, ctx, wo, bo, out_g, out, tokens, n, C, s));
}

// K6 on bf16 activations. dims: {B, n, C}. scratch: B n 384 + B n 128 bf16
// (q | k | v rows, then the attention output). Three launches on `stream`.
extern "C" int attention_bf16act(const bf16* x, const float* norm_g, const bf16* wqkv,
                                 const bf16* wo, const float* bo, bf16* out, bf16* scratch,
                                 const int* dims, void* stream) {
  const int B = dims[0], n = dims[1], C = dims[2];
  if (bad_dims(B, n, C)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tokens = B * n;
  bf16* qkv = scratch;
  bf16* ao = scratch + static_cast<size_t>(tokens) * kQkv;
  cudaError_t e = launch_qkv<false>(x, norm_g, wqkv, qkv, tokens, C, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  attn_core_kernel<<<dim3((n + kAttnQ - 1) / kAttnQ, kHeads, B), kAttnQ, 0, s>>>(qkv, ao, n);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(
      launch_out<false>(x, ao, nullptr, wo, bo, nullptr, out, tokens, n, C, s));
}
