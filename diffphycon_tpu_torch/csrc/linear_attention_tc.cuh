// The block-level pieces of K5 (linear_attention_tc.cu), shared with K6
// (attention.cu) and the persistent kernel (unet2d_persistent.cu): a
// 64 x 128 tile GEMM on the tensor cores in 3xTF32, the x-tile copy and its
// ChanLayerNorm, and K5's three bodies (K5a, the merge, K5b) as device
// functions of a block index. See linear_attention_tc.cu for the design.
// The bf16 variants run attention_bf16.cuh, which takes la_tc's geometry,
// its TF32 helpers and la_merge_body from here.
//
// Layouts: x is NHWC fp32 viewed as (B, n, C) tokens; wqkv is (C, 384) with
// columns [q | k | v], each (head, d); wo is (128, C).
//
// Coherence: the persistent kernel runs these bodies on activations that
// other blocks wrote earlier in the same launch, so every read of an
// activation or a partial goes through L2 only (cp.async.cg, __ldcg), never
// the non-coherent read-only path; only weights are read with __ldg.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Phase clocks of K5's bodies: linear_attention_tc.cu defines LA_STAMP(i)
// under -DLA_PHASE_CLOCKS before it includes this header; elsewhere a stamp
// is nothing.
#ifndef LA_STAMP
#define LA_STAMP(i) \
  do {              \
  } while (0)
#endif

namespace la_tc {

constexpr int kHeads = 4;
constexpr int kDimHead = 32;
constexpr int kHidden = kHeads * kDimHead;  // 128
constexpr int kQKV = 3 * kHidden;           // 384 columns of wqkv
constexpr int kMaxC = 512;                  // widest UNet2D level of the Burgers net
constexpr float kLnEps = 1e-5f;             // ChanLayerNorm eps in fp32
constexpr float kScale = 0.17677669529663687f;  // kDimHead^-0.5

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
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
// 32 s + 31, into weight buffer `slot` & 1: 16-byte copies, zero-filled past
// the pass's rows and columns.
__device__ __forceinline__ void load_w_slice(const WeightPass& p, int s, float* wbuf, int slot) {
  float* room = wbuf + (slot & 1) * kSlice * kWStride;
#pragma unroll
  for (int i = 0; i < kSlice * kCols / 4 / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / (kCols / 4), ch = idx % (kCols / 4);
    const int k = s * kSlice + r;
    const bool ok = k < p.K && 4 * ch < p.nvalid;
    const int col = 4 * ch < kCols / 2 ? p.n0 + 4 * ch : p.n1 + 4 * ch - kCols / 2;
    cp_async16(room + r * kWStride + 4 * ch, ok ? p.W + static_cast<size_t>(k) * p.ldw + col : p.W,
               ok);
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

constexpr int kCtxFloats = kHeads * kDimHead * kDimHead;  // one sample's context

__host__ __device__ constexpr int context_smem_floats(int C) {
  // x tile (then v), k tile, weight slices; running max, sum, rescale; the
  // two row halves' column maxima and sums; the tile's row statistics
  return kRows * x_stride(C) + kRows * kKStride + kWFloats + 3 * kHidden + 4 * kHidden +
         2 * kRows;
}

__host__ __device__ constexpr int output_smem_floats(int C) {
  // x tile (then the projected rows), q (then the attention output)
  // transposed, the merged context, weight slices, the row statistics
  return kRows * (C + 4) + kHidden * kTStride + kHidden * kCtxStride + kWFloats + 2 * kRows;
}

// K5a: chunk s of sample b (of S chunks), tokens [s * chunk, min(n, (s + 1)
// * chunk)), heads kHpc * hg .. + kHpc - 1; smem: context_smem_floats(C)
// floats. Writes (context, max, sum) of the chunk to part[b][s]. With all
// 4 heads a tile takes two 128-column passes (k, then v); with 2 (the
// host's plan where B * S CTAs would leave SMs idle) one pass holds
// both heads' k (columns 0..63) and v (64..127), and twice as many CTAs
// share the work.
template <int kHpc>
__device__ __forceinline__ void la_context_body(const float* __restrict__ x,
                                                const float* __restrict__ g,
                                                const float* __restrict__ wqkv,
                                                float* __restrict__ part, int n, int C, int chunk,
                                                int s, int b, int hg, int S, float* smem) {
  static_assert(kHpc == 4 || kHpc == 2, "4 or 2 heads per CTA");
  constexpr int kJ = kHpc * kDimHead;  // this CTA's k columns (and v columns)
  constexpr int kNT = kHpc == 4 ? 2 : 1;  // context columns per warp / 8
  const int ldx = x_stride(C);
  float* X = smem;                     // kRows x ldx: the normalised x tile, then v
  float* Kt = X + kRows * ldx;         // kRows x kKStride: exp(k - max)
  float* wbuf = Kt + kRows * kKStride;
  float* mrow = wbuf + kWFloats;       // running max per (head, d)
  float* lrow = mrow + kHidden;        // running sum per (head, d)
  float* scl = lrow + kHidden;         // this tile's rescale per (head, d)
  float* pmax = scl + kHidden;         // [row half][column] max of k over the half's rows
  float* psum = pmax + 2 * kHidden;    // [row half][column] sum of exp(k - max)
  float* mean = psum + 2 * kHidden;    // row statistics of the x tile
  float* rstd = mean + kRows;

  const int tid = threadIdx.x, warp = tid >> 5;
  const int h0 = kHpc * hg;
  const int t_begin = s * chunk, t_end = min(n, t_begin + chunk);
  const float* xb = x + static_cast<size_t>(b) * n * C;
  // the partial context of local head ch, columns ce .. ce + 8 kNT - 1 (all
  // 32 rows d), on the tensor cores: cacc[mt][nt] as mma_smem's acc
  const int ch = kHpc == 4 ? warp >> 1 : warp >> 2;
  const int ce = kHpc == 4 ? (warp & 1) * 16 : (warp & 3) * 8;
  float cacc[2][kNT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) cacc[mt][nt][e] = 0.f;
  if (tid < kJ) {
    mrow[tid] = -INFINITY;
    lrow[tid] = 0.f;
  }
  const WarpTile<2> wt;
  const int half = wt.wr >> 5;  // this warp's half of the tile's rows
  const bool kwarp = wt.wc < kJ;  // this warp's columns are k (else v)
  float acc[2][4][4];
  // 4 heads: k (columns 128 .. 255 of wqkv), then v (256 .. 383); 2 heads:
  // their k and v columns in one pass
  const WeightPass kpass{wqkv, kQKV, kHidden + h0 * kDimHead, kCols, C,
                         kHpc == 4 ? kHidden + 64 : 2 * kHidden + h0 * kDimHead};
  const WeightPass vpass{wqkv, kQKV, 2 * kHidden, kCols, C, 2 * kHidden + 64};
  int slot = 0;
  load_w_slice(kpass, 0, wbuf, slot);  // later tiles': issued by the tile before

  for (int tile0 = t_begin; tile0 < t_end; tile0 += kRows) {
    const int rows = min(kRows, t_end - tile0);
    const bool more = tile0 + kRows < t_end;
    [[maybe_unused]] const int stamp = 8 * ((tile0 - t_begin) / kRows);  // LA_STAMP slots
    LA_STAMP(stamp);
    load_x_tile(X, ldx, xb + static_cast<size_t>(tile0) * C, rows, C);
    cp_async_wait<0>();
    __syncthreads();
    LA_STAMP(stamp + 1);
    norm_x_tile(X, ldx, g, rows, C, mean, rstd);
    LA_STAMP(stamp + 2);
    gemm_tile(X, ldx, 1, rows, kpass, kHpc == 4 ? &vpass : (more ? &kpass : nullptr), wbuf, slot,
              acc);
    LA_STAMP(stamp + 3);

    // the online softmax over tokens, from the k accumulators: per column,
    // the max over this warp's valid rows (lanes of one t hold one column
    // pair: shuffles over g), joined with the other row half and the
    // running max; then exp(k - max) into Kt and its column sums. With 2
    // heads the v warps store v into the x tile meanwhile (its last reader
    // finished before gemm_tile's closing barrier).
    if (kwarp) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float m = -INFINITY;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              if (wt.row(mt, 2 * h + j) < rows) m = fmaxf(m, acc[mt][nt][2 * h + j]);
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 4));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 8));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 16));
          if (wt.g == 0) pmax[half * kHidden + wt.col(nt, j)] = m;
        }
    } else {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            X[wt.row(mt, e) * kKStride + wt.col(nt, e) - kJ] = acc[mt][nt][e];
    }
    __syncthreads();
    if (tid < kJ) {
      const float m_old = mrow[tid];
      const float m = fmaxf(m_old, fmaxf(pmax[tid], pmax[kHidden + tid]));
      scl[tid] = expf(m_old - m);  // 0 on the first tile (m_old = -inf)
      mrow[tid] = m;
    }
    __syncthreads();
    if (kwarp) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = wt.col(nt, j);
          const float m = mrow[col];
          float sum = 0.f;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = wt.row(mt, 2 * h + j);
              const float p = r < rows ? expf(acc[mt][nt][2 * h + j] - m) : 0.f;
              Kt[r * kKStride + col] = p;
              sum += p;
            }
          sum += __shfl_xor_sync(0xffffffffu, sum, 4);
          sum += __shfl_xor_sync(0xffffffffu, sum, 8);
          sum += __shfl_xor_sync(0xffffffffu, sum, 16);
          if (wt.g == 0) psum[half * kHidden + col] = sum;
        }
    }
    LA_STAMP(stamp + 4);
    if constexpr (kHpc == 4) {
      // v, into the x tile; the next tile's first k slice is issued meanwhile
      gemm_tile(X, ldx, 1, rows, vpass, more ? &kpass : nullptr, wbuf, slot, acc);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            X[wt.row(mt, e) * kKStride + wt.col(nt, e)] = acc[mt][nt][e];
    }
    __syncthreads();
    LA_STAMP(stamp + 5);
    if (tid < kJ) lrow[tid] = lrow[tid] * scl[tid] + (psum[tid] + psum[kHidden + tid]);
    // context[d][e] = context[d][e] * rescale[d] + sum_t p[t][d] v[t][e]
    // (rows past the chunk have p = 0 and v = 0)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float sc = scl[ch * kDimHead + wt.row(mt, e) - wt.wr];
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) cacc[mt][nt][e] *= sc;
      }
    mma_smem(Kt + ch * kDimHead, 1, kKStride, X + ch * kDimHead, kKStride, 1, kRows, 0, ce, cacc);
    __syncthreads();  // the next tile rewrites X, Kt and the statistics
    LA_STAMP(stamp + 6);
  }
  float* o = part + ((static_cast<size_t>(b) * S + s) * kHidden + h0 * kDimHead) * kPartStride;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int d = wt.row(mt, 2 * h) - wt.wr, e = ce + 8 * nt + 2 * wt.t;
        *reinterpret_cast<float2*>(o + (ch * kDimHead + d) * kPartStride + e) =
            make_float2(cacc[mt][nt][2 * h], cacc[mt][nt][2 * h + 1]);
      }
  if (tid < kJ)
    *reinterpret_cast<float2*>(o + tid * kPartStride + kDimHead) =
        make_float2(mrow[tid], lrow[tid]);
}

// The merge of sample b: the S partials in order s = 0 .. S-1 with the
// online-softmax rescale, then / sum, into ctx (B, 4, 32, 32). Reads the
// partials through L2 (__ldcg): in the persistent kernel other blocks wrote
// them in the same launch.
__device__ __forceinline__ void la_merge_body(const float* __restrict__ part,
                                              float* __restrict__ ctx, int S, int b) {
  const int tid = threadIdx.x;
  const int hd = tid >> 1, e0 = (tid & 1) * 16;
  const size_t step = static_cast<size_t>(kHidden) * kPartStride;
  const float* pb = part + static_cast<size_t>(b) * S * step + hd * kPartStride;
  float m = -INFINITY;
#pragma unroll 8
  for (int s = 0; s < S; ++s) m = fmaxf(m, __ldcg(pb + s * step + kDimHead));
  float c[16], l = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) c[i] = 0.f;
#pragma unroll 4
  for (int s = 0; s < S; ++s) {
    const float* ps = pb + s * step;
    const float w = expf(__ldcg(ps + kDimHead) - m);
    l += w * __ldcg(ps + kDimHead + 1);
#pragma unroll
    for (int i = 0; i < 16; i += 2) {
      const float2 v = __ldcg(reinterpret_cast<const float2*>(ps + e0 + i));
      c[i] += w * v.x;
      c[i + 1] += w * v.y;
    }
  }
  const float inv = 1.f / l;
  float* o = ctx + static_cast<size_t>(b) * kCtxFloats + hd * kDimHead + e0;
#pragma unroll
  for (int i = 0; i < 16; i += 4)
    *reinterpret_cast<float4*>(o + i) =
        make_float4(c[i] * inv, c[i + 1] * inv, c[i + 2] * inv, c[i + 3] * inv);
}

// K5b: tokens tile * 64 .. + 63 of sample b; smem: output_smem_floats(C)
// floats.
__device__ __forceinline__ void la_output_body(const float* __restrict__ x,
                                               const float* __restrict__ g,
                                               const float* __restrict__ wqkv,
                                               const float* __restrict__ ctx,
                                               const float* __restrict__ wo,
                                               const float* __restrict__ bo,
                                               const float* __restrict__ og,
                                               float* __restrict__ out, int n, int C, int tile,
                                               int b, float* smem) {
  const int ldx = C + 4;
  float* X = smem;                        // kRows x ldx: normalised x, then the projected rows
  float* QT = X + kRows * ldx;            // kHidden x kTStride: q, then the attention output
  float* cS = QT + kHidden * kTStride;    // [head][d][e] the context, rows kCtxStride apart
  float* wbuf = cS + kHidden * kCtxStride;
  float* mean = wbuf + kWFloats;          // row statistics of the x tile, then of the rows
  float* rstd = mean + kRows;

  const int tid = threadIdx.x;
  const int tile0 = tile * kRows;
  const int rows = min(kRows, n - tile0);
  const float* xt = x + (static_cast<size_t>(b) * n + tile0) * C;
  // q: columns 0 .. 127 of wqkv; then the out-projection in passes of 128
  // output channels. The first q slice, the x tile and the context are
  // copied together.
  LA_STAMP(0);
  const WeightPass qpass{wqkv, kQKV, 0, kCols, C, 64};
  int slot = 0;
  load_w_slice(qpass, 0, wbuf, slot);
  const float* cb = ctx + static_cast<size_t>(b) * kCtxFloats;
  for (int i = tid; i < kCtxFloats / 4; i += kThreads)
    cp_async16(cS + (i >> 3) * kCtxStride + 4 * (i & 7), cb + 4 * i, true);
  load_x_tile(X, ldx, xt, rows, C);
  cp_async_wait<0>();
  __syncthreads();
  LA_STAMP(1);
  norm_x_tile(X, ldx, g, rows, C, mean, rstd);
  LA_STAMP(2);

  // q, stored transposed
  const WarpTile<2> wt;
  float acc[2][4][4];
  const WeightPass opass0{wo, C, 0, min(kCols, C), kHidden, 64};
  gemm_tile(X, ldx, 1, rows, qpass, &opass0, wbuf, slot, acc);
  LA_STAMP(3);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) QT[wt.col(nt, e) * kTStride + wt.row(mt, e)] = acc[mt][nt][e];
  __syncthreads();

  {  // softmax over each head's 32 channels, then the 32^-0.5 scale: thread
     // (token t, head h)
    const int t = tid & (kRows - 1), h = tid >> 6;
    float* q = QT + h * kDimHead * kTStride + t;
    float v[kDimHead];
    float m = -INFINITY;
#pragma unroll
    for (int d = 0; d < kDimHead; ++d) {
      v[d] = q[d * kTStride];
      m = fmaxf(m, v[d]);
    }
    float sum = 0.f;
#pragma unroll
    for (int d = 0; d < kDimHead; ++d) {
      v[d] = expf(v[d] - m);
      sum += v[d];
    }
    const float inv = 1.f / sum;
#pragma unroll
    for (int d = 0; d < kDimHead; ++d) q[d * kTStride] = v[d] * inv * kScale;
  }
  __syncthreads();
  LA_STAMP(4);

  {  // o[t][h*32 + e] = sum_d q[t][h*32 + d] context[h][d][e] on the
     // tensor cores: warp (head h, tokens th .. th + 31) reads and then
     // overwrites only its own block of QT
    const int h = (tid >> 5) >> 1, th = ((tid >> 5) & 1) * 32;
    float o[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[mt][nt][e] = 0.f;
    mma_smem(QT + h * kDimHead * kTStride, 1, kTStride, cS + h * kDimHead * kCtxStride,
             kCtxStride, 1, kDimHead, th, 0, o);
    __syncwarp();
    const int lane = tid & 31;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = th + 16 * mt + (lane >> 2) + (e >> 1) * 8;
          const int j = h * kDimHead + 8 * nt + 2 * (lane & 3) + (e & 1);
          QT[j * kTStride + t] = o[mt][nt][e];
        }
  }
  // (the barrier before gemm_tile's first slice orders these writes before its reads)
  LA_STAMP(5);

  // out-projection + bias into the x tile, 128 output channels per pass
  // (64 when at most 64 are left: all 8 warps then take 16 x 32 blocks)
  auto store_y = [&](auto& a, const auto& w, int n0, int nvalid) {
#pragma unroll
    for (int mt = 0; mt < static_cast<int>(sizeof(a) / sizeof(a[0])); ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = w.col(nt, 0);  // even; c < nvalid means c + 1 < nvalid too
        if (c < nvalid) {
          const float b0 = __ldg(bo + n0 + c), b1 = __ldg(bo + n0 + c + 1);
          *reinterpret_cast<float2*>(X + w.row(mt, 0) * ldx + n0 + c) =
              make_float2(a[mt][nt][0] + b0, a[mt][nt][1] + b1);
          *reinterpret_cast<float2*>(X + w.row(mt, 2) * ldx + n0 + c) =
              make_float2(a[mt][nt][2] + b0, a[mt][nt][3] + b1);
        }
      }
  };
  for (int n0 = 0; n0 < C; n0 += kCols) {
    const int nvalid = min(kCols, C - n0);
    const WeightPass opass{wo, C, n0, nvalid, kHidden, n0 + 64},
        onext{wo, C, n0 + kCols, min(kCols, C - n0 - kCols), kHidden, n0 + kCols + 64};
    const WeightPass* next = n0 + kCols < C ? &onext : nullptr;
    if (nvalid > kCols / 2) {
      gemm_tile(QT, 1, kTStride, rows, opass, next, wbuf, slot, acc);
      store_y(acc, wt, n0, nvalid);
    } else {
      float acc1[1][4][4];
      gemm_tile(QT, 1, kTStride, rows, opass, next, wbuf, slot, acc1);
      store_y(acc1, WarpTile<1>(), n0, nvalid);
    }
  }
  __syncthreads();

  LA_STAMP(6);
  // out-ChanLN and the residual: the rows' statistics, then elementwise
  // with 16-byte loads and stores
  row_stats(X, ldx, rows, C, mean, rstd);
  __syncthreads();
  const int c4 = C / 4;
  float* ob = out + (static_cast<size_t>(b) * n + tile0) * C;
  for (int i = tid; i < rows * c4; i += kThreads) {
    const int r = i / c4, c = 4 * (i - r * c4);
    const float4 y = *reinterpret_cast<const float4*>(X + r * ldx + c);
    const float4 xv = __ldcg(reinterpret_cast<const float4*>(xt + static_cast<size_t>(r) * C + c));
    const float4 gv = __ldg(reinterpret_cast<const float4*>(og + c));
    const float m = mean[r], rs = rstd[r];
    *reinterpret_cast<float4*>(ob + static_cast<size_t>(r) * C + c) =
        make_float4(xv.x + (y.x - m) * rs * gv.x, xv.y + (y.y - m) * rs * gv.y,
                    xv.z + (y.z - m) * rs * gv.z, xv.w + (y.w - m) * rs * gv.w);
  }
  LA_STAMP(7);
}


}  // namespace la_tc
