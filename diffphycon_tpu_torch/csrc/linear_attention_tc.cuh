// The block-level pieces of K5 (linear_attention_tc.cu): a 64 x 128 tile
// GEMM on the tensor cores in 3xTF32, the x-tile copy and its
// ChanLayerNorm. See linear_attention_tc.cu for the design.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace la_tc {

using attn::kDimHead;
using attn::kHeads;
using attn::kHidden;
using attn::kLnEps;
using attn::kMaxC;
using attn::kQKV;
using attn::kScale;
using attn::warp_sum;

constexpr int kThreads = 256;         // 8 warps
constexpr int kRows = 64;             // tokens per tile, in both stages
constexpr int kCols = 128;            // output columns per GEMM pass
constexpr int kSlice = 32;            // K per weight slice in shared memory
constexpr int kWStride = kCols + 8;   // weight slice rows: B fragments conflict-free
constexpr int kKStride = kCols + 8;   // [token][column] tiles of k and v (conflict-free fragments)
constexpr int kTStride = kRows + 8;   // [column][token] tiles of q and the attention output
constexpr int kWFloats = 2 * kSlice * kWStride;  // two weight slices
constexpr int kPartStride = kDimHead + 2;        // a context row, its max and its sum
constexpr int kCtxStride = kDimHead + 8;         // context rows in shared memory

// Row stride of K5a's x tile, whose region it reuses for v (kKStride
// apart); K5b's x tile, reused for the projected rows, takes C + 4. A stride
// of 4 or 12 modulo 32 keeps the A fragments conflict-free.
__host__ __device__ constexpr int x_stride(int C) {
  return C + 4 > kKStride ? C + 4 : kKStride + 4;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x rounded to TF32, nearest, ties away from zero (cvt.rna, as igemm_tc.cuh),
// and the rest: x ~ hi + lo, both TF32.
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);  // exact in fp32
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// d (16 x 8) += a (16 x 8, row) * b (8 x 8, col), TF32 in, fp32 sums.
// Fragments (g = lane / 4, t = lane % 4): a0 (g, t), a1 (g + 8, t), a2 (g,
// t + 4), a3 (g + 8, t + 4); b0 (k t, n g), b1 (k t + 4, n g); d0 (g, 2t),
// d1 (g, 2t + 1), d2 (g + 8, 2t), d3 (g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// This warp's block of a 64 x 128 tile (MT = 2: 32 x 32, warps 2 x 4) or
// of a 64 x 64 tile (MT = 1: 16 x 32, warps 4 x 2): rows wr .. , columns
// wc .. wc + 31; acc[mt][nt] is the 16 x 8 piece (rows wr + 16 mt, columns
// wc + 8 nt) in the mma's d layout.
template <int MT>
struct WarpTile {
  int wr, wc, g, t;
  __device__ WarpTile() {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    wr = MT == 2 ? (warp & 1) * 32 : (warp & 3) * 16;
    wc = MT == 2 ? (warp >> 1) * 32 : (warp >> 2) * 32;
    g = lane >> 2;
    t = lane & 3;
  }
  // tile row and column of element e (0..3) of acc[mt][nt]
  __device__ int row(int mt, int e) const { return wr + 16 * mt + g + (e >> 1) * 8; }
  __device__ int col(int nt, int e) const { return wc + 8 * nt + 2 * t + (e & 1); }
};

// acc[mt][nt] (rows r0 + 16 mt, columns n0 + 8 nt of this warp) += A (rows
// x K) * B (K x columns), both in shared memory: A's (r, k) at A[r * ars +
// k * aks], B's (k, n) at B[k * bks + n * bns]; K a multiple of 32. 3xTF32
// as gemm_tile, each 32-deep slice summed afresh and added to acc in fp32.
// One warp; no barrier.
template <int MT, int NT>
__device__ __forceinline__ void mma_smem(const float* A, int ars, int aks, const float* B,
                                         int bks, int bns, int K, int r0, int n0,
                                         float (&acc)[MT][NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int k32 = 0; k32 < K; k32 += 32) {
    float part[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.f;
#pragma unroll
    for (int k0 = k32; k0 < k32 + 32; k0 += 8) {
      uint32_t ahi[MT][4], alo[MT][4], bhi[NT][2], blo[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          tf32_split(A[(r0 + 16 * mt + g + (e & 1) * 8) * ars + (k0 + t + (e >> 1) * 4) * aks],
                     ahi[mt][e], alo[mt][e]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          tf32_split(B[(k0 + t + 4 * h) * bks + (n0 + 8 * nt + g) * bns], bhi[nt][h], blo[nt][h]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_tf32(part[mt][nt], alo[mt], bhi[nt][0], bhi[nt][1]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_tf32(part[mt][nt], ahi[mt], blo[nt][0], blo[nt][1]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_tf32(part[mt][nt], ahi[mt], bhi[nt][0], bhi[nt][1]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];
  }
}

// One GEMM pass's weight: 128 columns of W (K x ldw, row-major, device
// memory), the pass's columns 0..63 from n0 .. n0 + 63 and 64..127 from n1
// .. n1 + 63 (n1 = n0 + 64 for 128 adjacent columns); pass columns at or
// past nvalid (a multiple of 4) read as 0, and so do rows k >= K.
struct WeightPass {
  const float* W;
  int ldw, n0, nvalid, K, n1;
};

// Issue (and commit as one cp.async group) slice s of pass p, rows 32 s ..
// 32 s + 31, into weight buffer `slot` & 1: 16-byte copies, zero-filled
// past the pass's rows and columns.
__device__ __forceinline__ void load_w_slice(const WeightPass& p, int s, float* wbuf, int slot) {
  float* dst = wbuf + (slot & 1) * kSlice * kWStride;
#pragma unroll
  for (int i = 0; i < kSlice * kCols / 4 / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx >> 5, ch = idx & 31;
    const int k = s * kSlice + r;
    const bool ok = k < p.K && 4 * ch < p.nvalid;
    const int col = 4 * ch < kCols / 2 ? p.n0 + 4 * ch : p.n1 + 4 * ch - kCols / 2;
    cp_async16(dst + r * kWStride + 4 * ch,
               ok ? p.W + static_cast<size_t>(k) * p.ldw + col : p.W, ok);
  }
  cp_async_commit();
}

// acc = A (64 x p.K, shared memory; element (r, k) at A[r * a_rs + k *
// a_ks]; rows past `rows` count as 0) times pass p's 128 weight columns (MT = 2; MT = 1: its first 64,
// for a pass of at most 64 valid columns, so that no warp idles), in 3xTF32: a * b ~ lo(a) hi(b)
// + hi(a) lo(b) + hi(a) hi(b), small terms first. The weight comes through
// shared memory in 32-deep slices (two buffers: the next slice's copies
// overlap this slice's products), so each weight byte is read once per 64
// tokens. Slice 0 must have been issued into buffer `slot` (the most recent
// cp.async group); while the last slice's products run, slice 0 of the
// pass `next` (if not null) is issued into the other buffer, so a chain of
// passes never waits for its first slice. `slot` advances by the pass's
// slices. Each slice's products are summed afresh and added to acc in fp32
// (the tensor cores' own accumulation truncates; igemm_tc.cuh does the
// same). All threads of the block call it; each slice sits between two
// barriers.
template <int MT>
__device__ __forceinline__ void gemm_tile(const float* A, int a_rs, int a_ks, int rows,
                                          const WeightPass& p, const WeightPass* next,
                                          float* wbuf, int& slot, float (&acc)[MT][4][4]) {
  const WarpTile<MT> wt;
  const int K = p.K;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const int slices = (K + kSlice - 1) / kSlice;
  // warp-uniform: a warp past the valid columns or past the tile's `rows`
  // valid rows idles (its accumulators stay 0)
  const bool active = wt.wc < p.nvalid && wt.wr < rows;
  for (int s = 0; s < slices; ++s) {
    if (s + 1 < slices) {
      load_w_slice(p, s + 1, wbuf, slot + s + 1);
      cp_async_wait<1>();
    } else if (next != nullptr) {
      load_w_slice(*next, 0, wbuf, slot + s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // slice s is in; every thread is done with slice s - 1
    if (active) {
      const float* ws = wbuf + ((slot + s) & 1) * kSlice * kWStride;
      float part[MT][4][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kSlice / 8; ++kk) {
        const int k0 = s * kSlice + 8 * kk;
        if (k0 >= K) break;  // uniform
        uint32_t ahi[MT][4], alo[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = wt.wr + 16 * mt + wt.g + (e & 1) * 8;
            const int k = k0 + wt.t + (e >> 1) * 4;
            const float v = k < K ? A[r * a_rs + k * a_ks] : 0.f;
            tf32_split(v, ahi[mt][e], alo[mt][e]);
          }
        }
        uint32_t bhi[4][2], blo[4][2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int nn = wt.wc + 8 * nt + wt.g;
          tf32_split(ws[(8 * kk + wt.t) * kWStride + nn], bhi[nt][0], blo[nt][0]);
          tf32_split(ws[(8 * kk + wt.t + 4) * kWStride + nn], bhi[nt][1], blo[nt][1]);
        }
        // one product over all 8 pieces before the next: 8 independent
        // mmas between two into the same accumulator
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_tf32(part[mt][nt], alo[mt], bhi[nt][0], bhi[nt][1]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_tf32(part[mt][nt], ahi[mt], blo[nt][0], blo[nt][1]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_tf32(part[mt][nt], ahi[mt], bhi[nt][0], bhi[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];
    }
    __syncthreads();  // the buffer of slice s is free for slice s + 2
  }
  slot += slices;
}

// Copy tokens 0 .. rows - 1 of xt (rows x C, row-major, device memory) into
// the tile X (kRows x ldx); rows past `rows` are filled with 0. Commits one
// cp.async group.
__device__ __forceinline__ void load_x_tile(float* X, int ldx, const float* xt, int rows, int C) {
  const int c4 = C / 4;
  for (int i = threadIdx.x; i < kRows * c4; i += kThreads) {
    const int r = i / c4, ch = i - r * c4;
    const bool ok = r < rows;
    cp_async16(X + r * ldx + 4 * ch, ok ? xt + static_cast<size_t>(r) * C + 4 * ch : xt, ok);
  }
  cp_async_commit();
}

// ChanLayerNorm statistics of rows 0 .. rows - 1 of a tile (kRows x ld, C
// columns), four threads per row, each over every fourth float4 of it,
// joined by two shuffles: the mean, then the biased variance of the
// deviations, as the plain version takes them. mean, rstd: kRows floats;
// rows past `rows` get 0. All threads call it.
__device__ __forceinline__ void row_stats(const float* T, int ld, int rows, int C, float* mean,
                                          float* rstd) {
  static_assert(kThreads == 4 * kRows, "four threads per row");
  const int r = threadIdx.x >> 2, q = threadIdx.x & 3;
  const float* tr = T + r * ld;
  const bool ok = r < rows;
  float s = 0.f;
  if (ok) {
    for (int c = 4 * q; c < C; c += 16) {
      const float4 v = *reinterpret_cast<const float4*>(tr + c);
      s += (v.x + v.y) + (v.z + v.w);
    }
  }
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  const float m = s / C;
  float v2 = 0.f;
  if (ok) {
    for (int c = 4 * q; c < C; c += 16) {
      const float4 v = *reinterpret_cast<const float4*>(tr + c);
      const float a0 = v.x - m, a1 = v.y - m, a2 = v.z - m, a3 = v.w - m;
      v2 += (a0 * a0 + a1 * a1) + (a2 * a2 + a3 * a3);
    }
  }
  v2 += __shfl_xor_sync(0xffffffffu, v2, 1);
  v2 += __shfl_xor_sync(0xffffffffu, v2, 2);
  if (q == 0) {
    mean[r] = ok ? m : 0.f;
    rstd[r] = ok ? rsqrtf(v2 / C + kLnEps) : 0.f;
  }
}

// ChanLayerNorm of the x tile in place: X = (X - mean) * rstd * g for rows
// 0 .. rows - 1 (rows past `rows` hold 0 and stay 0), the statistics by
// row_stats, the update elementwise over all threads. The caller syncs
// before the tile is read.
__device__ __forceinline__ void norm_x_tile(float* X, int ldx, const float* __restrict__ gvec,
                                            int rows, int C, float* mean, float* rstd) {
  row_stats(X, ldx, rows, C, mean, rstd);
  __syncthreads();
  const int c4 = C / 4;
  for (int i = threadIdx.x; i < rows * c4; i += kThreads) {
    const int r = i / c4, c = 4 * (i - r * c4);
    float4* p = reinterpret_cast<float4*>(X + r * ldx + c);
    const float4 gv = __ldg(reinterpret_cast<const float4*>(gvec + c));
    const float m = mean[r], rs = rstd[r];
    float4 v = *p;
    v.x = (v.x - m) * rs * gv.x;
    v.y = (v.y - m) * rs * gv.y;
    v.z = (v.z - m) * rs * gv.z;
    v.w = (v.w - m) * rs * gv.w;
    *p = v;
  }
}

}  // namespace la_tc
