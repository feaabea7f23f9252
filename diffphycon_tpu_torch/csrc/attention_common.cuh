// Pieces shared by K5 (linear_attention_tc.cuh), K6 (attention.cu) and the
// persistent kernel's attention stages (linear_attention.cuh): the
// UNet2D attention geometry, warp reductions, the ChanLayerNorm statistics
// of a tile of tokens, and the normalised input chunk both projections read.
//
// Activations are read through load_act<kCoherent>: plain loads for K5 and
// K6, __ldcg (L2 only, never the non-coherent path) in the persistent kernel,
// whose activations are written by other blocks earlier in the same launch.
//
// Layouts: x is NHWC fp32 viewed as (B, n, C) tokens; wqkv is (C, 384) with
// columns [q | k | v], each (head, d); wo is (128, C). Weights are read from
// device memory with __ldg (a column per thread, so a warp reads 128
// contiguous bytes); activations go through shared memory transposed, [c][t]
// with a padded row stride, so a thread's run of tokens is a few 16-byte
// broadcast loads.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace attn {

constexpr int kHeads = 4;
constexpr int kDimHead = 32;
constexpr int kHidden = kHeads * kDimHead;  // 128
constexpr int kQKV = 3 * kHidden;           // 384 columns of wqkv
constexpr int kMaxC = 512;                  // widest UNet2D level of the Burgers net
constexpr int kTok = 32;                    // tokens per tile
constexpr int kTP = kTok + 4;               // padded row stride of [c][t] tiles (16-byte rows)
constexpr int kCC = 32;                     // channels per normalised input chunk
constexpr float kLnEps = 1e-5f;             // ChanLayerNorm eps in fp32
constexpr float kScale = 0.17677669529663687f;  // kDimHead^-0.5

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <bool kCoherent>
__device__ __forceinline__ float load_act(const float* p) {
  if constexpr (kCoherent) {
    return __ldcg(p);
  } else {
    return *p;
  }
}

// ChanLayerNorm statistics of tokens tok0 .. tok0 + kTok - 1 of one sample
// (xb: (n, C)): one warp per token, the mean, then the biased variance of
// the deviations, as the plain version computes them. Tokens past n get 0.
template <bool kCoherent = false>
__device__ __forceinline__ void token_stats(const float* xb, int n, int C, int tok0,
                                            float* mean, float* rstd) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (int t = warp; t < kTok; t += nw) {
    const int tok = tok0 + t;
    float m = 0.f, r = 0.f;
    if (tok < n) {  // uniform across the warp
      const float* row = xb + static_cast<size_t>(tok) * C;
      float s = 0.f;
      for (int c = lane; c < C; c += 32) s += load_act<kCoherent>(row + c);
      m = warp_sum(s) / C;
      float v = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float d = load_act<kCoherent>(row + c) - m;
        v += d * d;
      }
      r = rsqrtf(warp_sum(v) / C + kLnEps);
    }
    if (lane == 0) {
      mean[t] = m;
      rstd[t] = r;
    }
  }
}

// hT[c * kStride + t] = ChanLN(x)[tok0 + t][c0 + c] * g[c0 + c] for kT
// tokens and one chunk of kCC channels; 0 past n or C.
template <bool kCoherent = false, int kT = kTok, int kStride = kTP>
__device__ __forceinline__ void load_norm_chunk(const float* xb, const float* g, int n, int C,
                                                int tok0, int c0, const float* mean,
                                                const float* rstd, float* hT) {
  for (int i = threadIdx.x; i < kT * kCC; i += blockDim.x) {
    const int t = i / kCC, c = i - t * kCC;
    const int tok = tok0 + t, ch = c0 + c;
    float v = 0.f;
    if (tok < n && ch < C)
      v = (load_act<kCoherent>(xb + static_cast<size_t>(tok) * C + ch) - mean[t]) * rstd[t] * g[ch];
    hT[c * kStride + t] = v;
  }
}

// acc[i] += h[i] * w for TT consecutive tokens of a [c][t] row (h 16-byte
// aligned, TT a multiple of 4).
template <int TT>
__device__ __forceinline__ void fma_row(float (&acc)[TT], const float* h, float w) {
#pragma unroll
  for (int i = 0; i < TT; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(h + i);
    acc[i] += v.x * w;
    acc[i + 1] += v.y * w;
    acc[i + 2] += v.z * w;
    acc[i + 3] += v.w * w;
  }
}

}  // namespace attn
