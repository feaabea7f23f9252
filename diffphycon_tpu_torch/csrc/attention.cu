// K6: the UNet2D full-attention block (the bottleneck) on NHWC fp32,
//   out = x + out_proj(softmax(q k^T * 32^-0.5) v),  q, k, v = ChanLN(x) wqkv,
// over all n <= 32 tokens of a sample, 4 heads x 32, the softmax in fp32.
//
// Replaces _attention_kernel in diffphycon_tpu/research/pallas_unet2d.py
// (:229-256; wrapper attention_block :459-468). On the Burgers net it runs
// once per forward, at the 2x16 bottleneck (n = 32, C = 512).
//
// One block of 384 threads per sample does the whole block: the ChanLN
// statistics; the qkv projection (thread j owns column j of wqkv for all 32
// tokens, so one weight load from L2 feeds 32 FMAs, the normalised input
// streamed through shared memory in 32-channel chunks); per (head, query) a
// warp with one key per lane for the scores, the fp32 softmax and P v; then
// the out-projection, the bias and the residual, one output channel per
// thread. q, k, v and the attention output never leave shared memory.
//
// Bound: operations. 17.3 MFLOP per sample against 128 KB of activations in
// and out (~130 flops per byte, above the fp32 ridge of ~20). At batch 50 the
// grid is 50 blocks on 132 SMs: the block is latency-bound, not the card;
// splitting a sample over heads or token tiles is later work.
#include "attention_common.cuh"

namespace {

using namespace attn;

constexpr int kThreads = kQKV;   // 384: one qkv column per thread
constexpr int kQP = kQKV + 1;    // row stride of the qkv tile: lane-indexed k rows hit 32 banks

__global__ void __launch_bounds__(kThreads) attention_kernel(
    const float* __restrict__ x, const float* __restrict__ g, const float* __restrict__ wqkv,
    const float* __restrict__ wo, const float* __restrict__ bo, float* __restrict__ out, int n,
    int C) {
  extern __shared__ __align__(16) float smem[];
  float* hT = smem;                // kCC x kTP normalised input chunk
  float* qkv = hT + kCC * kTP;     // kTok x kQP: [q * 32^-0.5 | k | v]
  float* oT = qkv + kTok * kQP;    // kHidden x kTP attention output, [j][t]
  float* mean = oT + kHidden * kTP;
  float* rstd = mean + kTok;

  const int b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const float* xb = x + static_cast<size_t>(b) * n * C;
  token_stats(xb, n, C, 0, mean, rstd);
  __syncthreads();

  float acc[kTok];
#pragma unroll
  for (int i = 0; i < kTok; ++i) acc[i] = 0.f;
  for (int cc = 0; cc < C; cc += kCC) {
    load_norm_chunk(xb, g, n, C, 0, cc, mean, rstd, hT);
    __syncthreads();
    const int cmax = min(kCC, C - cc);
    for (int c = 0; c < cmax; ++c) {
      const float w = __ldg(wqkv + static_cast<size_t>(cc + c) * kQKV + tid);
      fma_row<kTok>(acc, hT + c * kTP, w);
    }
    __syncthreads();
  }
  const float qs = tid < kHidden ? kScale : 1.f;
#pragma unroll
  for (int t = 0; t < kTok; ++t) qkv[t * kQP + tid] = acc[t] * qs;
  __syncthreads();

  // one warp per (head, query i); lane = key j
  for (int r = warp; r < kHeads * kTok; r += kThreads / 32) {
    const int hh = r / kTok, i = r - hh * kTok;
    if (i >= n) continue;  // uniform across the warp
    const float* qi = qkv + i * kQP + hh * kDimHead;
    float s = -INFINITY;
    if (lane < n) {
      const float* kj = qkv + lane * kQP + kHidden + hh * kDimHead;
      s = 0.f;
#pragma unroll
      for (int dd = 0; dd < kDimHead; ++dd) s += qi[dd] * kj[dd];
    }
    const float m = warp_max(s);  // every lane takes part in the shuffles
    const float p = lane < n ? expf(s - m) : 0.f;
    const float pn = p / warp_sum(p);
    const float* vcol = qkv + 2 * kHidden + hh * kDimHead + lane;
    float o = 0.f;
    for (int jj = 0; jj < n; ++jj) o += __shfl_sync(0xffffffffu, pn, jj) * vcol[jj * kQP];
    oT[(hh * kDimHead + lane) * kTP + i] = o;
  }
  __syncthreads();

  // out-projection + bias + residual, one output channel per thread
  for (int c = tid; c < C; c += kThreads) {
#pragma unroll
    for (int i = 0; i < kTok; ++i) acc[i] = 0.f;
    for (int jj = 0; jj < kHidden; ++jj)
      fma_row<kTok>(acc, oT + jj * kTP, __ldg(wo + static_cast<size_t>(jj) * C + c));
    const float bias = bo[c];
#pragma unroll
    for (int i = 0; i < kTok; ++i)
      if (i < n) {
        const size_t idx = static_cast<size_t>(i) * C + c;
        out[static_cast<size_t>(b) * n * C + idx] = xb[idx] + (acc[i] + bias);
      }
  }
}

}  // namespace

// x, out: (B, n, C) fp32 (an NHWC tensor with n = H*W); g, bo: (C,); wqkv:
// (C, 384); wo: (128, C). 1 <= n <= 32, 1 <= C <= 512 (the wrapper checks).
// Returns the launch's cudaError_t.
extern "C" int attention_f32(const float* x, const float* g, const float* wqkv,
                             const float* wo, const float* bo, float* out, int B, int n, int C,
                             void* stream) {
  if (B <= 0 || n <= 0 || n > kTok || C <= 0 || C > kMaxC)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = (kCC * kTP + kTok * kQP + kHidden * kTP + 2 * kTok) * sizeof(float);
  cudaError_t e =
      cudaFuncSetAttribute(attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  attention_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(x, g, wqkv, wo, bo,
                                                                             out, n, C);
  return static_cast<int>(cudaGetLastError());
}
