// SIMT implicit-GEMM tile of the persistent kernel (unet2d_persistent.cu:
// K7 resblock_pair, K8 unet2d_mega). K1 and K2 run on the tensor-core core,
// igemm_tc.cuh.
//
// out[m, n] = bias[n] + sum_k A[m, k] * Wt[k, n], where m walks the output
// pixels (b, oh, ow) of an NHWC tensor, n the output channels and k the
// (tap, input channel) pairs. A is never materialised: a `Gather` functor
// (conv_gathers.cuh) reads it straight from the NHWC input(s), so im2col,
// the skip concat and the nearest-2x upsample all happen at load time.
//
// Design: plain fp32 FMA on CUDA cores. A BM x 64 output tile, K walked in
// 16-deep slices through two shared-memory buffers: the next slice is loaded
// into registers while the current one is multiplied, then stored to the
// other buffer (one barrier per slice). Each thread owns TMT x 4 outputs. A,
// the weights and the output move as 16-byte vectors of 4 channels, so the
// gather computes one address per 4 values (channel counts are multiples of
// 4, pointers 16-byte aligned). Bound: operations, at 67 TFLOP/s fp32
// outside the tensor cores.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace igemm {

constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 8;  // outputs per thread along m (igemm_tile's default)
constexpr int TN = 4;  // outputs per thread along n

// Gather contract (k4 is a multiple of 4; the 4 values k4..k4+3 share a tap
// and a source tensor):
//   struct Row;                         per-output-pixel context
//   struct Tap;                         per-k4 context
//   Row row(int m) const;               m < 0 marks a row past the end
//   Tap tap(int k4) const;
//   float4 load4(const Row&, const Tap&) const;   0 outside the image
//   const float* ptr4(const Row&, const Tap&) const;  the 4 values' address,
//                                       nullptr outside the image (igemm_tc.cuh)
//
// One BM x BN output tile at (m0, n0). As and Bs are the tile's shared
// buffers, [2][BK][BM + 4] and [2][BK][BN + 4] floats. Called by every
// thread of a (BM / TMT) * (BN / TN)-thread block, each thread owning
// TMT x TN outputs (TMT 8; the persistent kernel also runs 64-row tiles on
// 256 threads with TMT 4). It ends with all threads past their last
// shared-memory read, so the caller may start the next tile (the persistent
// kernel walks tiles in a loop) without another barrier.
template <class G, int BM, int TMT = TM>
__device__ __forceinline__ void igemm_tile(const G& g, const float* __restrict__ w,
                                           const float* __restrict__ bias,
                                           float* __restrict__ out, int M, int N, int K,
                                           int m0, int n0, float* As_, float* Bs_) {
  constexpr int THREADS = (BM / TMT) * (BN / TN);
  constexpr int A_PER_THREAD = BM * BK / 4 / THREADS;  // float4s per thread
  constexpr int A_ROW_STEP = THREADS / (BK / 4);
  constexpr int B_PER_THREAD = BK * BN / 4 / THREADS;
  constexpr int B_K_STEP = THREADS / (BN / 4);
  auto As = reinterpret_cast<float (*)[BK][BM + 4]>(As_);
  auto Bs = reinterpret_cast<float (*)[BK][BN + 4]>(Bs_);

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);  // n = tx*4 .. tx*4+3
  const int ty = tid / (BN / TN);  // m = ty*TMT .. ty*TMT+TMT-1

  // A staging: k-lanes 4*a_k4 .. +3 of rows a_m + A_ROW_STEP*j.
  const int a_k4 = tid % (BK / 4);
  const int a_m = tid / (BK / 4);
  typename G::Row rows[A_PER_THREAD];
#pragma unroll
  for (int j = 0; j < A_PER_THREAD; ++j) {
    const int m = m0 + a_m + A_ROW_STEP * j;
    rows[j] = g.row(m < M ? m : -1);
  }
  // B staging: columns 4*b_n4 .. +3, k-lanes b_k + B_K_STEP*j.
  const int b_n4 = tid % (BN / 4);
  const int b_k = tid / (BN / 4);
  const int n_load = n0 + 4 * b_n4;

  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 ra[A_PER_THREAD];
  float4 rb[B_PER_THREAD];
  auto load_regs = [&](int k0) {
    const int k = k0 + 4 * a_k4;
    if (k < K) {  // K is a multiple of 4: a vector is wholly in or out
      const typename G::Tap tp = g.tap(k);
#pragma unroll
      for (int j = 0; j < A_PER_THREAD; ++j) ra[j] = g.load4(rows[j], tp);
    } else {
#pragma unroll
      for (int j = 0; j < A_PER_THREAD; ++j) ra[j] = zero;
    }
#pragma unroll
    for (int j = 0; j < B_PER_THREAD; ++j) {
      const int kk = k0 + b_k + B_K_STEP * j;
      rb[j] = (kk < K && n_load < N)
                  ? __ldg(reinterpret_cast<const float4*>(w + (size_t)kk * N + n_load))
                  : zero;
    }
  };
  auto store_regs = [&](int buf) {
#pragma unroll
    for (int j = 0; j < A_PER_THREAD; ++j) {
      const int m = a_m + A_ROW_STEP * j;
      As[buf][4 * a_k4 + 0][m] = ra[j].x;
      As[buf][4 * a_k4 + 1][m] = ra[j].y;
      As[buf][4 * a_k4 + 2][m] = ra[j].z;
      As[buf][4 * a_k4 + 3][m] = ra[j].w;
    }
#pragma unroll
    for (int j = 0; j < B_PER_THREAD; ++j)
      *reinterpret_cast<float4*>(&Bs[buf][b_k + B_K_STEP * j][4 * b_n4]) = rb[j];
  };

  float acc[TMT][TN];
#pragma unroll
  for (int i = 0; i < TMT; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  load_regs(0);
  store_regs(0);
  __syncthreads();
  int cur = 0;
  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool more = k0 + BK < K;
    if (more) load_regs(k0 + BK);  // global loads in flight during the FMAs
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TMT];
#pragma unroll
      for (int i = 0; i < TMT; i += 4) {
        const float4 a4 = *reinterpret_cast<const float4*>(&As[cur][kk][ty * TMT + i]);
        av[i] = a4.x;
        av[i + 1] = a4.y;
        av[i + 2] = a4.z;
        av[i + 3] = a4.w;
      }
      const float4 b = *reinterpret_cast<const float4*>(&Bs[cur][kk][tx * TN]);
      const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TMT; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) store_regs(cur ^ 1);  // the other buffer: nobody reads it now
    __syncthreads();
    cur ^= 1;
  }

  const int n = n0 + tx * TN;
  if (n < N) {  // N is a multiple of 4: the vector is wholly in or out
    const float4 bb = __ldg(reinterpret_cast<const float4*>(bias + n));
#pragma unroll
    for (int i = 0; i < TMT; ++i) {
      const int m = m0 + ty * TMT + i;
      if (m < M)
        *reinterpret_cast<float4*>(out + (size_t)m * N + n) =
            make_float4(acc[i][0] + bb.x, acc[i][1] + bb.y, acc[i][2] + bb.z, acc[i][3] + bb.w);
    }
  }
}

}  // namespace igemm
