// K5: the UNet2D linear-attention block on NHWC fp32,
//   out = x + ChanLN(out_proj(linear_attention(ChanLN(x))), out_g),
// with q softmaxed over each head's 32 channels and then scaled by 32^-0.5,
// k softmaxed over all tokens, context = k v^T per (sample, head) and
// out = context^T q (4 heads x 32).
//
// Replaces _linear_attention_kernel in diffphycon_tpu/research/pallas_unet2d.py
// (:194-226; wrapper linear_attention_block :447-457). The Pallas kernel
// holds a whole sample in VMEM; on Hopper a block cannot hold 2048 tokens x
// 64 channels and the k softmax and the context sum run over all tokens, so
// the block is two launches:
//   K5a, grid (B, head): walks the sample's tokens in tiles of 32, projects
//        each tile onto the head's 32 k and 32 v columns, and keeps the 32x32
//        context with a running max and sum per k row (the online softmax of
//        flash attention), then writes context / sum to a (B, 4, 32, 32)
//        scratch;
//   K5b, grid (B, token tile): projects the tile onto q (all heads), softmaxes
//        and scales it, applies context^T, the out-projection with its bias,
//        the out-ChanLN and the residual.
// Both projections together read wqkv once per token: K5a its k/v columns,
// K5b its q columns. No atomics: every output is written by one thread, so
// the result is the same from run to run.
//
// Bound: operations. ~534 MFLOP per sample over the 8 Burgers sites against
// ~3 MB of activations: ~180 flops per byte, far above the fp32 ridge of
// 67 TFLOP/s / 3.35 TB/s = 20. The design keeps every intermediate (the
// normalised input, q, k, v, the attention output, the projected rows) in
// shared memory or registers and spends its effort on FMAs: each thread owns
// 8 (K5a) or 16 (K5b) tokens of one output column, so one weight load from
// L2 feeds 8-16 FMAs and the activations come as 16-byte broadcasts.
// Plain fp32 FMA on CUDA cores, no tensor cores (a simple kernel first).
#include "attention_common.cuh"

namespace {

using namespace attn;

constexpr int kThreads = 256;

// K5a. ctx: (B, kHeads, 32 (d), 32 (e)) = softmax_n(k)[d] . v[e].
__global__ void __launch_bounds__(kThreads) la_context_kernel(const float* __restrict__ x,
                                                              const float* __restrict__ g,
                                                              const float* __restrict__ wqkv,
                                                              float* __restrict__ ctx, int n,
                                                              int C) {
  extern __shared__ __align__(16) float smem[];
  float* hT = smem;               // kCC x kTP normalised input chunk, [c][t]
  float* kv = hT + kCC * kTP;     // kTok x 64: k (d) in 0..31, v (e) in 32..63
  float* mean = kv + kTok * 64;   // kTok
  float* rstd = mean + kTok;      // kTok
  float* mrow = rstd + kTok;      // 32 running max per k row
  float* scl = mrow + kDimHead;   // 32 rescale factors of the current tile

  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const float* xb = x + static_cast<size_t>(b) * n * C;
  // projection: column j of the head's [k | v] columns, tokens tg*8 .. tg*8+7
  const int j = tid & 63, tg = tid >> 6;
  const int wcol = (j < kDimHead ? kHidden : 2 * kHidden) + h * kDimHead + (j & 31);
  // context: row d, columns e0 .. e0+3
  const int d = tid >> 3, e0 = (tid & 7) * 4;
  float c0 = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f, l = 0.f;
  if (tid < kDimHead) mrow[tid] = -INFINITY;

  for (int tok0 = 0; tok0 < n; tok0 += kTok) {
    token_stats(xb, n, C, tok0, mean, rstd);
    __syncthreads();
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int cc = 0; cc < C; cc += kCC) {
      load_norm_chunk(xb, g, n, C, tok0, cc, mean, rstd, hT);
      __syncthreads();
      const int cmax = min(kCC, C - cc);
      for (int c = 0; c < cmax; ++c) {
        const float w = __ldg(wqkv + static_cast<size_t>(cc + c) * kQKV + wcol);
        fma_row<8>(acc, hT + c * kTP + tg * 8, w);
      }
      __syncthreads();
    }
    // k rows past n are -inf (weight 0 after the softmax), v rows 0
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = tg * 8 + i;
      kv[t * 64 + j] = (tok0 + t < n) ? acc[i] : (j < kDimHead ? -INFINITY : 0.f);
    }
    __syncthreads();
    if (tid < kDimHead) {
      const float m_old = mrow[tid];
      float m = m_old;
      for (int t = 0; t < kTok; ++t) m = fmaxf(m, kv[t * 64 + tid]);
      scl[tid] = expf(m_old - m);  // 0 on the first tile (m_old = -inf)
      mrow[tid] = m;
    }
    __syncthreads();
    for (int i = tid; i < kTok * kDimHead; i += kThreads) {
      const int t = i >> 5, dd = i & 31;
      kv[t * 64 + dd] = expf(kv[t * 64 + dd] - mrow[dd]);
    }
    __syncthreads();
    const float s = scl[d];
    c0 *= s;
    c1 *= s;
    c2 *= s;
    c3 *= s;
    l *= s;
    for (int t = 0; t < kTok; ++t) {
      const float p = kv[t * 64 + d];
      const float4 v = *reinterpret_cast<const float4*>(kv + t * 64 + kDimHead + e0);
      c0 += p * v.x;
      c1 += p * v.y;
      c2 += p * v.z;
      c3 += p * v.w;
      l += p;
    }
    __syncthreads();  // the next tile rewrites kv and the statistics
  }
  const float inv = 1.f / l;
  float* o = ctx + ((static_cast<size_t>(b) * kHeads + h) * kDimHead + d) * kDimHead + e0;
  *reinterpret_cast<float4*>(o) = make_float4(c0 * inv, c1 * inv, c2 * inv, c3 * inv);
}

// K5b. out = x + ChanLN(out_proj(context^T softmax_d(q) * 32^-0.5), og) for
// one tile of kTok tokens.
__global__ void __launch_bounds__(kThreads) la_output_kernel(
    const float* __restrict__ x, const float* __restrict__ g, const float* __restrict__ wqkv,
    const float* __restrict__ ctx, const float* __restrict__ wo, const float* __restrict__ bo,
    const float* __restrict__ og, float* __restrict__ out, int n, int C) {
  extern __shared__ __align__(16) float smem[];
  float* cS = smem;                          // kHeads x 32 x 32 context
  float* hT = cS + kHeads * kDimHead * kDimHead;  // kCC x kTP
  float* qT = hT + kCC * kTP;                // kHidden x kTP: q, then the attention output
  float* y = qT + kHidden * kTP;             // kTok x C projected rows
  float* mean = y + kTok * C;                // kTok
  float* rstd = mean + kTok;                 // kTok

  const int b = blockIdx.x, tok0 = blockIdx.y * kTok, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const float* xb = x + static_cast<size_t>(b) * n * C;
  const float* cb = ctx + static_cast<size_t>(b) * kHeads * kDimHead * kDimHead;
  for (int i = tid; i < kHeads * kDimHead * kDimHead; i += kThreads) cS[i] = cb[i];
  token_stats(xb, n, C, tok0, mean, rstd);
  __syncthreads();

  // q projection: column j (head j / 32), tokens tg*16 .. tg*16+15
  const int j = tid & (kHidden - 1), tg = tid >> 7;
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  for (int cc = 0; cc < C; cc += kCC) {
    load_norm_chunk(xb, g, n, C, tok0, cc, mean, rstd, hT);
    __syncthreads();
    const int cmax = min(kCC, C - cc);
    for (int c = 0; c < cmax; ++c) {
      const float w = __ldg(wqkv + static_cast<size_t>(cc + c) * kQKV + j);
      fma_row<16>(acc, hT + c * kTP + tg * 16, w);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 16; i += 4)
    *reinterpret_cast<float4*>(qT + j * kTP + tg * 16 + i) =
        make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
  __syncthreads();

  // softmax over each head's 32 channels, then the 32^-0.5 scale: one warp
  // per (token, head) row, lane = channel
  for (int r = warp; r < kTok * kHeads; r += kThreads / 32) {
    const int t = r / kHeads, hh = r - t * kHeads;
    float* q = qT + (hh * kDimHead + lane) * kTP + t;
    const float v = *q;
    const float e = expf(v - warp_max(v));
    *q = e / warp_sum(e) * kScale;
  }
  __syncthreads();

  // attention output o[t][h*32 + e] = sum_d context[h][d][e] q[t][h*32 + d]
  const int hh = j >> 5, e = j & 31;
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  for (int dd = 0; dd < kDimHead; ++dd)
    fma_row<16>(acc, qT + (hh * kDimHead + dd) * kTP + tg * 16,
                cS[(hh * kDimHead + dd) * kDimHead + e]);
  __syncthreads();  // every thread has read q
#pragma unroll
  for (int i = 0; i < 16; i += 4)
    *reinterpret_cast<float4*>(qT + j * kTP + tg * 16 + i) =
        make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
  __syncthreads();

  // out-projection + bias into y, 128 output channels at a time
  for (int c0 = 0; c0 < C; c0 += kHidden) {
    const int c = c0 + j;
    if (c < C) {
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i] = 0.f;
      for (int jj = 0; jj < kHidden; ++jj)
        fma_row<16>(acc, qT + jj * kTP + tg * 16, __ldg(wo + static_cast<size_t>(jj) * C + c));
      const float bias = bo[c];
#pragma unroll
      for (int i = 0; i < 16; ++i) y[(tg * 16 + i) * C + c] = acc[i] + bias;
    }
  }
  __syncthreads();

  // out-ChanLN and the residual: one warp per token
  for (int t = warp; t < kTok; t += kThreads / 32) {
    const int tok = tok0 + t;
    if (tok >= n) continue;  // uniform across the warp
    const float* yr = y + t * C;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += yr[c];
    const float m = warp_sum(s) / C;
    float v = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float dv = yr[c] - m;
      v += dv * dv;
    }
    const float r = rsqrtf(warp_sum(v) / C + kLnEps);
    const float* xr = xb + static_cast<size_t>(tok) * C;
    float* orow = out + (static_cast<size_t>(b) * n + tok) * C;
    for (int c = lane; c < C; c += 32) orow[c] = xr[c] + (yr[c] - m) * r * og[c];
  }
}

}  // namespace

// x, out: (B, n, C) fp32 (an NHWC tensor with n = H*W); g, bo, og: (C,);
// wqkv: (C, 384); wo: (128, C); ctx: (B, 4, 32, 32) scratch. 1 <= C <= 512
// (the wrapper checks). Launches K5a then K5b on `stream`; returns the first
// cudaError_t that is not cudaSuccess.
extern "C" int linear_attention_f32(const float* x, const float* g, const float* wqkv,
                                    const float* wo, const float* bo, const float* og,
                                    float* ctx, float* out, int B, int n, int C,
                                    void* stream) {
  if (B <= 0 || n <= 0 || C <= 0 || C > kMaxC) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem_a = (kCC * kTP + kTok * 64 + 2 * kTok + 2 * kDimHead) * sizeof(float);
  la_context_kernel<<<dim3(B, kHeads), kThreads, smem_a, st>>>(x, g, wqkv, ctx, n, C);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int smem_b =
      (kHeads * kDimHead * kDimHead + kCC * kTP + kHidden * kTP + kTok * C + 2 * kTok) *
      sizeof(float);
  e = cudaFuncSetAttribute(la_output_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_b);
  if (e != cudaSuccess) return static_cast<int>(e);
  la_output_kernel<<<dim3(B, (n + kTok - 1) / kTok), kThreads, smem_b, st>>>(
      x, g, wqkv, ctx, wo, bo, og, out, n, C);
  return static_cast<int>(cudaGetLastError());
}
