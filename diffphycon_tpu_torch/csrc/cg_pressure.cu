// K4: the whole conjugate-gradient pressure solve A p = div in one launch,
// A the masked 5-point Laplacian of a fluid domain with obstacles.
//
// Replaces _cg_kernel in diffphycon_tpu/physics/fluids/pallas_cg.py (one
// pallas_call program per batch element, every field resident in VMEM for
// the whole loop). Same CG variant as the reference: a = <p,r>/<p,Ap>,
// x += a p, r -= a Ap, b = -<r,Ap>/<p,Ap>, p = r + b p; the loop test
// max|r| >= accuracy && i < max_iterations comes before each body and is per
// batch element.
//
// Bound: neither bytes nor FLOPs. After its first load a block touches
// device memory only to write x. One iteration does ~21 flops per cell
// (16 cells per thread), but the ~450 iterations of a 127x127 smoke solve at
// accuracy 1e-6 form one dependent chain, and each iteration needs two
// block-wide reductions (two barriers each) and one barrier between the p
// update and the stencil. The time is that chain's latency.
//
// Design: one 1024-thread block per batch element, thread t owning cells
// t, t + 1024, ... (coalesced, bank-conflict free). x, r and p live in
// dynamic shared memory (3 * H * W floats, 194 KB at 127x127); only p is
// read by neighbours. A p stays in the registers of the owning thread, and
// the five stencil coefficients of its 16 cells stay packed, one byte per
// cell, in four registers (bits 0-3: neighbour y+1, y-1, x+1, x-1 present;
// bits 4-6: the negated centre, 1..4). The two reductions of an iteration
// are fused: (<p,Ap>, <p,r>) after the stencil, (<r,Ap>, max|r|) after the
// x/r update. At batch 8 this fills 8 of the 132 SMs; splitting an element
// over a thread-block cluster is later work (ROADMAP.md).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;  // == 32: warp 0 reduces the partials
constexpr int kCells = 16;             // cells per thread: H * W <= 16384

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

// Block-wide sum of a and sum (kMaxB false) or max (kMaxB true) of b; every
// thread gets both. One scratch/result pair serves every call: warp 0 reads
// the partials between the two barriers, and each thread reads the result
// before it can reach the next call's first barrier.
template <bool kMaxB>
__device__ __forceinline__ void block_reduce2(float& a, float& b, float* scratch,
                                              float* result) {
  a = warp_sum(a);
  b = kMaxB ? warp_max(b) : warp_sum(b);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    scratch[warp] = a;
    scratch[kWarps + warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    float x = warp_sum(scratch[lane]);
    float y = scratch[kWarps + lane];
    y = kMaxB ? warp_max(y) : warp_sum(y);
    if (lane == 0) {
      result[0] = x;
      result[1] = y;
    }
  }
  __syncthreads();
  a = result[0];
  b = result[1];
}

// (A p)[c] in the order of masked_laplacian: centre, y+1, y-1, x+1, x-1.
__device__ __forceinline__ float stencil(const float* p, int c, uint32_t code, int W) {
  float s = -static_cast<float>((code >> 4) & 7u) * p[c];
  if (code & 1u) s += p[c + W];
  if (code & 2u) s += p[c - W];
  if (code & 4u) s += p[c + 1];
  if (code & 8u) s += p[c - 1];
  return s;
}

__global__ void __launch_bounds__(kThreads, 1)
cg_pressure_kernel(const float* __restrict__ div, const uint8_t* __restrict__ packed,
                   float* __restrict__ out, int* __restrict__ iters, int H, int W,
                   float accuracy, int max_iterations) {
  extern __shared__ float fields[];
  __shared__ float scratch[2 * kWarps];
  __shared__ float result[2];
  const int n = H * W;
  float* x = fields;
  float* r = fields + n;
  float* p = fields + 2 * n;
  const float* d = div + static_cast<size_t>(blockIdx.x) * n;
  const int tid = threadIdx.x;

  uint32_t code[kCells / 4];
  float ap[kCells];
#pragma unroll
  for (int k = 0; k < kCells / 4; ++k) code[k] = 0u;
#pragma unroll
  for (int k = 0; k < kCells; ++k) {
    const int c = tid + k * kThreads;
    if (c < n) {
      const float v = d[c];
      x[c] = 0.f;
      r[c] = v;
      p[c] = v;
      code[k >> 2] |= static_cast<uint32_t>(packed[c]) << (8 * (k & 3));
    }
  }
  __syncthreads();

  float pap = 0.f, pr = 0.f, rmax = 0.f, unused = 0.f;
#pragma unroll
  for (int k = 0; k < kCells; ++k) {
    const int c = tid + k * kThreads;
    ap[k] = 0.f;
    if (c < n) {
      ap[k] = stencil(p, c, (code[k >> 2] >> (8 * (k & 3))) & 0xffu, W);
      pap += p[c] * ap[k];
      pr += p[c] * r[c];
      rmax = fmaxf(rmax, fabsf(r[c]));
    }
  }
  block_reduce2<false>(pap, pr, scratch, result);
  block_reduce2<true>(unused, rmax, scratch, result);

  int it = 0;
  // rmax, pap and pr are block-uniform, so every thread leaves together
  while (rmax >= accuracy && it < max_iterations) {
    const float a = pr / pap;
    float rap = 0.f;
    rmax = 0.f;
#pragma unroll
    for (int k = 0; k < kCells; ++k) {
      const int c = tid + k * kThreads;
      if (c < n) {
        x[c] += a * p[c];
        const float rn = r[c] - a * ap[k];
        r[c] = rn;
        rap += rn * ap[k];
        rmax = fmaxf(rmax, fabsf(rn));
      }
    }
    block_reduce2<true>(rap, rmax, scratch, result);
    const float b = -rap / pap;
#pragma unroll
    for (int k = 0; k < kCells; ++k) {
      const int c = tid + k * kThreads;
      if (c < n) p[c] = r[c] + b * p[c];
    }
    __syncthreads();  // the stencil reads the neighbours' new p
    pap = 0.f;
    pr = 0.f;
#pragma unroll
    for (int k = 0; k < kCells; ++k) {
      const int c = tid + k * kThreads;
      if (c < n) {
        ap[k] = stencil(p, c, (code[k >> 2] >> (8 * (k & 3))) & 0xffu, W);
        pap += p[c] * ap[k];
        pr += p[c] * r[c];
      }
    }
    block_reduce2<false>(pap, pr, scratch, result);
    ++it;
  }

  float* o = out + static_cast<size_t>(blockIdx.x) * n;
#pragma unroll
  for (int k = 0; k < kCells; ++k) {
    const int c = tid + k * kThreads;
    if (c < n) o[c] = x[c];
  }
  if (tid == 0) iters[blockIdx.x] = it;
}

}  // namespace

// div, out: (B, H, W) float32; packed: (H, W) uint8 stencil codes; iters:
// (B,) int32. H * W <= 16384 (the wrapper checks). Returns the launch's
// cudaError_t.
extern "C" int cg_pressure_f32(const float* div, const uint8_t* packed, float* out,
                               int* iters, int B, int H, int W, float accuracy,
                               int max_iterations, void* stream) {
  const int n = H * W;
  if (n <= 0 || n > kThreads * kCells || B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 3 * n * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(cg_pressure_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cg_pressure_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      div, packed, out, iters, H, W, accuracy, max_iterations);
  return static_cast<int>(cudaGetLastError());
}
