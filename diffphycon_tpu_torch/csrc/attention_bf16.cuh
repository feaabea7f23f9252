// The bf16 variants of K5 (linear_attention_tc_bf16) and K6 (attention_bf16),
// designed for Hopper's bf16 tensor cores.
//
// Replaces, under weight_dtype=bfloat16, _linear_attention_kernel
// (diffphycon_tpu/research/pallas_unet2d.py:194-226, wrapper :447) and
// _attention_kernel (:229-256, wrapper :459): every projection is the
// Pallas _matmul (:98-101), the fp32 operand rounded to bf16 (cvt.rn, to
// nearest even), bf16 weights, fp32 sums; the linear block's context
// exp(k)^T v and its application, and the full block's softmax core, stay
// fp32-accurate (3xTF32 on the tensor cores), as Pallas computes them in
// fp32.
//
// Bound: bytes. At the bf16 rate the projections (2 n C 384 + 2 n 128 C
// flops) cost less than moving the fp32 activations (x read, out written:
// 8 C bytes a token), so the floor of a call is its activations' bytes over
// 3.35 TB/s. The earlier bf16 bodies (linear_attention_tc.cuh: gemm_tile's
// bf16 branch, mma.sync m16n8k16) stood 15-36x above that floor: each warp
// converted its own copy of the fp32 A tile for each of its mma.syncs,
// built B fragments from 16-bit shared loads, and streamed the weight in
// 32-deep slices behind two barriers each, one slice in flight, so a
// 32-token site waited on L2 once per slice (~1,140 clocks a slice: 68-71%
// of a CTA's clocks there, tools/k5_phase_clocks.py --bf16; PERF.md).
//
// Design:
// 1. One A tile, written once. ChanLN with eight threads a token (the
//    statistics by shuffles; every load of a pass issued before the first
//    is used), each value rounded to bf16 once (cvt.rn) into the K-major
//    128-byte swizzle a wgmma descriptor reads (16-byte chunk c of row r at
//    c ^ (r & 7); 64-k blocks of [64 rows][128 B], zero past C and past
//    the tile's rows). K5b's out-projection and K6c round the fp32
//    attention output the same way.
// 2. Weights by TMA, read as stored. One thread loads each (64 k, 128
//    column) stage of wqkv or wo as two 64 x 64 boxes into the 128-byte
//    swizzle (hopper_tma.cuh; columns past C and rows past K arrive as
//    zeros), completing on the stage's mbarrier; wgmma reads them MN-major
//    (desc_mn, imm-trans-b = 1). The ring is issued at the start, so a CTA
//    waits on L2 once, not once per slice, and where it holds every stage
//    (K5a's k | v columns always: two heads a CTA where C > 256; K5b at C
//    <= 256; K6a) the stages stay resident for all of the CTA's tiles.
// 3. wgmma.mma_async m64nNk16 bf16 with both operands in shared memory,
//    one accumulation chain over K = C (bf16 products are exact in fp32),
//    the two warpgroups of a CTA on the same tokens and different columns:
//    K5a k | v, K5b q heads 0-1 | 2-3 and each 128-column block of the
//    out-projection 64 | 64, K6a and K6c 64 | 64 of their 128 columns.
// 4. Softmaxes: K5a's over tokens per (head, d) column, all 8 warps on k
//    stored [token][column] in shared memory, 2-4 threads a column, the
//    running max and sum as before, exp on the SFU (exp_sfu); K5b's on the q
//    accumulators in registers (shuffles among a row's four lanes, expf).
//    K5b applies the context to q straight from the registers, in 3xTF32 on
//    wgmma m64n32k8 (the accumulator's (2t, 2t + 1) column pair feeds the A
//    fragment's k slots t and t + 4; the context's hi and lo tiles, built
//    through a conflict-free staging copy that cp.async fills while the
//    ChanLN and q run, hold its rows in that order), so q never goes
//    through shared memory; K5a's context stays 3xTF32 mma.sync from shared
//    memory (la_tc::mma_smem).
// 5. Tiles over the flattened (B n) tokens for K5b, K6a and K6c (the
//    projections, ChanLNs and the residual are per token): a K5b tile
//    applies its samples' contexts one after another and each row keeps
//    its own sample's products. K5a keeps per-sample chunks, whose context
//    it sums. The host's plan (kernels/attention.py: la_output_plan) gives
//    K5b 32-token tiles where 64-token ones would leave most SMs idle (the
//    32-token sites: 50 CTAs, not 25; the measurement overruled the plan of
//    no half-empty tiles there, since those sites wait on each CTA's x
//    loads and stores, not on the tensor cores), and at C <= 128 one CTA an
//    SM over a contiguous share of the tiles, a sample's context tiles
//    built once for all of them and the next x tile copied into shared
//    memory (cp.async) while one is finished; the residual reads that copy.
// K5's merge and K6b are linear_attention_tc.cuh's la_merge_body and
// attention.cuh's attn_core_body, unchanged. No atomics: two calls on the
// same inputs are bit-equal.
//
// The persistent kernel (unet2d_persistent.cuh) runs the same bodies for the
// attention stages of its bf16 instance. So the activations (x, the
// attention output, the context) are read through L2 only (__ldcg), since
// in that kernel other CTAs wrote them earlier in the same launch and the
// read-only path or L1 may hold stale lines of a reused buffer, and each
// body ends by invalidating its mbarriers, whose shared memory the next
// stage takes for other data. The per-block kernels run the same code: K5
// took as long as with the read-only path and cp.async, K6 0.4 us (1.5%)
// longer a forward (tools/step_times.py --attention --bf16, PERF.md
// section 6, PR 17).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_tma.cuh"
#include "igemm_tc.cuh"             // swz, desc_sw128, bf16x2_rn, wgmma fences
#include "linear_attention_tc.cuh"  // la_tc's geometry, tf32 mma, mma_smem, LA_STAMP

namespace attn_bf16 {

using hopper_tma::desc_mn;
using hopper_tma::mbar_expect_tx;
using hopper_tma::mbar_init;
using hopper_tma::mbar_wait;
using hopper_tma::tma_2d;
using igemm_tc::bf16x2_rn;
using igemm_tc::desc_sw128;
using igemm_tc::smem_u32;
using igemm_tc::swz;
using la_tc::kDimHead;
using la_tc::kHeads;
using la_tc::kHidden;
using la_tc::kLnEps;
using la_tc::kPartStride;
using la_tc::kQKV;
using la_tc::kScale;

constexpr int kThreads = 256;            // two warpgroups
constexpr int kRows = 64;                // tokens per tile: one wgmma M
constexpr int kBlock = kRows * 128;      // one 64-k block of the A tile: [64 rows][128 B]
constexpr int kAtom = 64 * 128;          // one 64 x 64 bf16 weight box
constexpr int kStage = 2 * kAtom;        // a ring stage: 64 k x 128 columns
constexpr int kCtxTile = kDimHead * 128;  // one head's context as a tf32 wgmma B tile: [32 e][128 B]
constexpr int kCtxBytes = kHeads * 2 * kCtxTile;  // a sample's context, hi and lo tiles per head
constexpr int kRingBytes = 128 * 1024;   // the most a weight ring takes
constexpr int kMaxSmem = 232448;         // dynamic shared memory a block may take

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }
// bytes of an A tile of 64 tokens x C channels, C padded to 64-k blocks
__host__ __device__ constexpr int a_bytes(int C) { return ceil_div(C, 64) * kBlock; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A load of an activation: through L2 only.
template <class T>
__device__ __forceinline__ T ld_act(const T* p) {
  return __ldcg(p);
}

// The end of a body: its n mbarriers at `bars` are invalidated once every
// thread is past its waits (a barrier first).
__device__ __forceinline__ void release_bars(uint32_t bars, int n) {
  __syncthreads();
  if (threadIdx.x == 0)
    for (int i = 0; i < n; ++i) hopper_tma::mbar_inval(bars + 8 * i);
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// exp(x) as 2^(x log2 e) on the SFU (ex2.approx), for K5a's token softmax:
// for its arguments (x <= 0) within 2 ulp plus |x| 2^-24 of the exact
// value, ~1e-6 relative where the result is above 2^-24 of the largest
// term, and the context sums it over the chunk's tokens; expf's longer
// sequence took 40% of the softmax phase's clocks (tools/k5_phase_clocks.py
// --bf16). K5b's head softmax keeps expf: each q feeds one row's output,
// which is rounded to bf16 for the out-projection, and an error of 1e-6
// there flips that rounding 16x as often as expf's.
__device__ __forceinline__ float exp_sfu(float x) { return exp2f(x * 1.4426950408889634f); }

// d (64 x N per warpgroup) += A (64 x 16, shared memory, K-major, 128-byte
// swizzle) * B (16 x N, shared memory, MN-major: imm-trans-b = 1). d[4j +
// {0, 1}]: row g, columns 8j + 2t + {0, 1}; d[4j + {2, 3}]: row g + 8 (g =
// lane / 4, t = lane % 4, rows relative to the warp's 16).
template <int N>
struct MmaSS;

template <>
struct MmaSS<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct MmaSS<128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
          "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
          "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

// acc += A (64 x 64 block at a_blk, 4 k16 steps) * the warpgroup's N
// columns of one weight stage (64 k rows at w_atom, atoms 8 KB apart).
template <int N>
__device__ __forceinline__ void mma_block(float (&acc)[N / 2], uint32_t a_blk, uint32_t w_atom) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    MmaSS<N>::run(acc, desc_sw128(a_blk + 32 * ks), desc_mn(w_atom + 2048 * ks));
}

// d (64 x 32 per warpgroup) += A (64 x 8 tf32, registers: a0 (g, t), a1 (g
// + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)) * B (8 x 32 tf32, shared
// memory, K-major, 128-byte swizzle); d as MmaSS's.
struct MmaTf32RS32 {
  static __device__ __forceinline__ void run(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// One sample's context c (4 heads x 32 d x 32 e, fp32) as tf32 wgmma B
// tiles at T (kCtxBytes, 1024-aligned): per head a hi tile and a lo tile
// (c ~ hi + lo, each rounded to tf32 by cvt.rna), [32 e][128 B] K-major in
// the 128-byte swizzle, the 8 d of k step kk in the order 8kk, 8kk + 2, ..,
// 8kk + 6, 8kk + 1, 8kk + 3, .., 8kk + 7 (the A fragments' k slots, see
// output_body). ctx_copy loads c through L2 and stores it into a staging
// copy at the end of T ([4 * 32 (h, d)][33]), ctx_tiles transposes: the
// stores, the loads of a tile row's 32 d and the tile stores, a row's 128
// bytes a warp, are all free of bank conflicts. All
// threads call both; ctx_tiles syncs twice (the staging copy overlaps the
// tiles of heads 2 and 3), and the caller fences and syncs before wgmma
// reads the tiles, and syncs before ctx_copy overwrites tiles in use;
// ctx_tiles's first barrier orders ctx_copy's stores before its reads.
constexpr int kCtxStg = kHidden * (kDimHead + 1) * 4;  // the staging copy's bytes
__device__ __forceinline__ void ctx_copy(const float* __restrict__ c, unsigned char* T, int tid) {
  constexpr int kPer = kHidden * kDimHead / kThreads;
  // L2 only (cp.async's 4-byte copies go through L1): loads, then stores
  float* stg = reinterpret_cast<float*>(T + kCtxBytes - kCtxStg);
  float v[kPer];
#pragma unroll
  for (int it = 0; it < kPer; ++it) v[it] = __ldcg(c + tid + it * kThreads);
#pragma unroll
  for (int it = 0; it < kPer; ++it) {
    const int i = tid + it * kThreads;
    stg[(i >> 5) * (kDimHead + 1) + (i & 31)] = v[it];
  }
}

__device__ __forceinline__ void ctx_tiles(unsigned char* T, int tid) {
  const float* stg = reinterpret_cast<const float*>(T + kCtxBytes - kCtxStg);
  la_tc::cp_async_wait<0>();
  __syncthreads();
  // warp w: tile rows (h, e) = 16 w .. 16 w + 15; lane k: k slot k, channel d
  const int k = tid & 31, row0 = 16 * (tid >> 5);
  const int d = (k & ~7) + 2 * (k & 3) + ((k >> 2) & 1);
  float val[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int h = (row0 + r) >> 5, e = (row0 + r) & 31;
    val[r] = stg[(h * kDimHead + d) * (kDimHead + 1) + e];
  }
  __syncthreads();  // the staging copy overlaps the tiles of heads 2 and 3
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int h = (row0 + r) >> 5, e = (row0 + r) & 31;
    uint32_t hi, lo;
    la_tc::tf32_split(val[r], hi, lo);
    unsigned char* t = T + h * 2 * kCtxTile + swz(e, k >> 2) + 4 * (k & 3);
    *reinterpret_cast<uint32_t*>(t) = hi;
    *reinterpret_cast<uint32_t*>(t + kCtxTile) = lo;
  }
}

// ChanLayerNorm of `rows` tokens (xt: rows x C fp32, row-major) into the A
// tile at A (a_bytes(C) bytes, 1024-aligned): row r, channel k at 64-k block
// k / 64, chunk (k % 64) / 8 of the row in the 128-byte swizzle, rounded to
// bf16 (cvt.rn); rows past `rows` and channels C .. 64 ceil(C / 64) - 1 are
// 0. Eight threads per token, each over every eighth float4 of it, joined
// by shuffles: the mean, then the biased variance of the deviations, as the
// plain version takes them. J float4s a thread per token, J >= 2 ceil(C /
// 64) (J = 4 ceil(C / 128) in every caller). In two halves: ln_load issues
// the loads of P 32-token passes (all in flight together: past the tile or
// the row they read row 0, column 0, then zero), ln_store finishes them;
// ln_to_a runs both for all 64 tokens. All threads call them; the caller
// fences and syncs before wgmma reads the tile.
template <int J, int P>
struct XRows {
  float4 v[P][J];
};

template <int J, int P>
__device__ __forceinline__ void ln_load(const float* __restrict__ xt, int rows, int C, int p0,
                                        XRows<J, P>& xr, int tid) {
  const int q = tid & 7, r8 = tid >> 3, nf4 = C / 4;
#pragma unroll
  for (int pp = 0; pp < P; ++pp) {
    const int r = 32 * (p0 + pp) + r8;
    const float4* src =
        reinterpret_cast<const float4*>(xt + static_cast<size_t>(r < rows ? r : 0) * C);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int f = q + 8 * j;
      const float4 t = ld_act(src + (f < nf4 ? f : 0));
      xr.v[pp][j] = r < rows && f < nf4 ? t : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

template <int J, int P>
__device__ __forceinline__ void ln_store(const XRows<J, P>& xr, int rows, int C, int p0,
                                         const float* __restrict__ gvec, unsigned char* A,
                                         int tid) {
  const int q = tid & 7, r8 = tid >> 3;
  const int nf4 = C / 4, nf4p = ceil_div(C, 64) * 16;
#pragma unroll
  for (int pp = 0; pp < P; ++pp) {
    const int r = 32 * (p0 + pp) + r8;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j)
      s += (xr.v[pp][j].x + xr.v[pp][j].y) + (xr.v[pp][j].z + xr.v[pp][j].w);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    s += __shfl_xor_sync(0xffffffffu, s, 4);
    const float m = s / C;
    float v2 = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (q + 8 * j < nf4) {
        const float4 t = xr.v[pp][j];
        const float a0 = t.x - m, a1 = t.y - m, a2 = t.z - m, a3 = t.w - m;
        v2 += (a0 * a0 + a1 * a1) + (a2 * a2 + a3 * a3);
      }
    }
    v2 += __shfl_xor_sync(0xffffffffu, v2, 1);
    v2 += __shfl_xor_sync(0xffffffffu, v2, 2);
    v2 += __shfl_xor_sync(0xffffffffu, v2, 4);
    const float rs = rsqrtf(v2 / C + kLnEps);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int f = q + 8 * j;
      if (f < nf4p) {
        uint2 w = make_uint2(0u, 0u);
        const float4 gv = __ldg(reinterpret_cast<const float4*>(gvec) + (f < nf4 ? f : 0));
        if (r < rows && f < nf4) {
          const float4 t = xr.v[pp][j];
          w.x = bf16x2_rn((t.x - m) * rs * gv.x, (t.y - m) * rs * gv.y);
          w.y = bf16x2_rn((t.z - m) * rs * gv.z, (t.w - m) * rs * gv.w);
        }
        const int k = 4 * f;
        *reinterpret_cast<uint2*>(A + (k >> 6) * kBlock + swz(r, (k & 63) >> 3) + 2 * (k & 7)) =
            w;
      }
    }
  }
}

template <int J>
__device__ __forceinline__ void ln_to_a(const float* __restrict__ xt, int rows, int C,
                                        const float* __restrict__ gvec, unsigned char* A,
                                        int tid) {
  constexpr int P = J <= 8 ? 2 : 1;  // passes whose loads are issued together
#pragma unroll 1
  for (int p0 = 0; p0 < kRows / 32; p0 += P) {
    XRows<J, P> xr;
    ln_load(xt, rows, C, p0, xr, tid);
    ln_store(xr, rows, C, p0, gvec, A, tid);
  }
}

// Copy tokens 0 .. rows - 1 of xt (rows x C fp32) into the staged x tile X
// (kRows rows, C + 4 floats apart) with 16-byte cp.async copies, rows past
// `rows` zero-filled; commits one group.
__device__ __forceinline__ void x_copy(const float* __restrict__ xt, int rows, int C, float* X,
                                       int tid) {
  const int c4 = C / 4;
  for (int i = tid; i < kRows * c4; i += kThreads) {
    const int r = i / c4, ch = i - r * c4;
    const bool ok = r < rows;
    la_tc::cp_async16(X + r * (C + 4) + 4 * ch, ok ? xt + static_cast<size_t>(r) * C + 4 * ch : xt,
                      ok);
  }
  la_tc::cp_async_commit();
}

// ln_to_a from a staged x tile (kRows rows, C + 4 floats apart).
template <int J>
__device__ __forceinline__ void ln_staged_to_a(const float* X, int rows, int C,
                                               const float* __restrict__ gvec, unsigned char* A,
                                               int tid) {
  const int q = tid & 7, r8 = tid >> 3, nf4 = C / 4;
  XRows<J, 2> xr;
#pragma unroll
  for (int pp = 0; pp < 2; ++pp)
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int f = q + 8 * j;
      xr.v[pp][j] = f < nf4 ? *reinterpret_cast<const float4*>(X + (32 * pp + r8) * (C + 4) + 4 * f)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  ln_store(xr, rows, C, 0, gvec, A, tid);
}

// Store the bf16x2 of (lo, hi) at row r, columns k, k + 1 (k even) of a
// K-major swizzled A tile.
__device__ __forceinline__ void store_a2(unsigned char* A, int r, int k, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(A + (k >> 6) * kBlock + swz(r, (k & 63) >> 3) + 2 * (k & 7)) =
      bf16x2_rn(lo, hi);
}

// ---------------------------------------------------------------------------
// K5a: the context partials
// ---------------------------------------------------------------------------

// Shared memory of a K5a CTA with kHpc heads (KB 64-k blocks of C): the
// resident k | v stages, then a region that holds the A tile and, after the
// projection, exp(k - max) and v (kRows x (kJ + 8) fp32 each), then the
// mbarriers and the softmax's running values.
__host__ __device__ constexpr int ctx_ks(int kHpc) { return kHpc * kDimHead + 8; }
__host__ __device__ constexpr int ctx_region(int kHpc, int C) {
  return imax(a_bytes(C), 2 * kRows * ctx_ks(kHpc) * 4);
}
__host__ __device__ constexpr int context_smem_bytes(int kHpc, int C) {
  // ring, region, 8 mbarriers, mrow / lrow / scl, pmax / psum per warp, 1024 to align
  return ceil_div(C, 64) * kHpc * kAtom + ctx_region(kHpc, C) + 64 + 3 * kHidden * 4 +
         2 * 4 * kHidden * 4 + 1024;
}

// K5a: chunk s of sample b (of S chunks), tokens [s * chunk, min(n, (s + 1)
// * chunk)), heads kHpc * hg .. + kHpc - 1. Warpgroup 0 projects each
// 64-token tile onto the heads' k columns, warpgroup 1 onto their v
// columns (N = 32 kHpc each); the weight stages (KB = ceil(C / 64), kHpc
// 64 x 64 boxes each: k atoms, then v atoms) come by TMA once and stay.
// Writes (context, max, sum) of the chunk to part[b][s], as
// la_context_body. J: float4s per thread of a token's ChanLN.
template <int kHpc, int J>
__device__ __forceinline__ void context_body(const float* __restrict__ x,
                                             const float* __restrict__ g,
                                             const CUtensorMap* wmap, float* __restrict__ part,
                                             int n, int C, int chunk, int s, int b, int hg, int S,
                                             unsigned char* smem_raw) {
  constexpr int kJ = kHpc * kDimHead;    // this CTA's k columns (and v columns)
  constexpr int kNA = kHpc / 2;          // 64-column atoms per warpgroup
  constexpr int kKS = kJ + 8;            // row stride of Kt and V (floats)
  constexpr int kNT = kHpc == 4 ? 2 : 1;  // context columns per warp / 8
  const int KB = ceil_div(C, 64);
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sbase = smem_raw + (base - raw);
  const int ring_bytes = KB * kHpc * kAtom;
  unsigned char* R = sbase + ring_bytes;  // the A tile, then Kt and V
  float* Kt = reinterpret_cast<float*>(R);
  float* V = Kt + kRows * kKS;
  const uint32_t bars = base + ring_bytes + ctx_region(kHpc, C);
  float* mrow = reinterpret_cast<float*>(sbase + ring_bytes + ctx_region(kHpc, C) + 64);
  float* lrow = mrow + kHidden;
  float* scl = lrow + kHidden;
  float* pmax = scl + kHidden;  // [warp of warpgroup 0][column]
  float* psum = pmax + 4 * kHidden;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wg = tid >> 7;
  const int wi = warp & 3, gq = lane >> 2, tq = lane & 3;
  const int h0 = kHpc * hg;
  const int t_begin = s * chunk, t_end = min(n, t_begin + chunk);
  const float* xb = x + static_cast<size_t>(b) * n * C;

  if (tid == 0) {
    for (int kb = 0; kb < KB; ++kb) mbar_init(bars + 8 * kb);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int kb = 0; kb < KB; ++kb) {
      const uint32_t bar = bars + 8 * kb;
      mbar_expect_tx(bar, kHpc * kAtom);
#pragma unroll
      for (int a = 0; a < kHpc; ++a)
        tma_2d(base + (kb * kHpc + a) * kAtom, wmap, bar,
               (a < kNA ? kHidden : 2 * kHidden) + h0 * kDimHead + 64 * (a % kNA), 64 * kb);
    }
  }
  if (tid < kJ) {
    mrow[tid] = -INFINITY;
    lrow[tid] = 0.f;
  }
  // the partial context of local head ch, columns ce .. ce + 8 kNT - 1 (all
  // 32 rows d), on the tensor cores in 3xTF32: cacc as la_tc::mma_smem's acc
  const int ch = kHpc == 4 ? warp >> 1 : warp >> 2;
  const int ce = kHpc == 4 ? (warp & 1) * 16 : (warp & 3) * 8;
  float cacc[2][kNT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) cacc[mt][nt][e] = 0.f;

#pragma unroll 1
  for (int tile0 = t_begin; tile0 < t_end; tile0 += kRows) {
    const int rows = min(kRows, t_end - tile0);
    [[maybe_unused]] const int stamp = 8 * ((tile0 - t_begin) / kRows);  // LA_STAMP slots
    LA_STAMP(stamp);
    ln_to_a<J>(xb + static_cast<size_t>(tile0) * C, rows, C, g, R, tid);
    fence_async_smem();
    __syncthreads();
    LA_STAMP(stamp + 1);

    float acc[kJ / 2];  // warpgroup 0: k, warpgroup 1: v
#pragma unroll
    for (int i = 0; i < kJ / 2; ++i) acc[i] = 0.f;
    igemm_tc::wgmma_fence();
#pragma unroll 1
    for (int kb = 0; kb < KB; ++kb) {
      mbar_wait(bars + 8 * kb, 0);  // resident: phase 0 completes once
      igemm_tc::fence_acc(acc);
      mma_block<kJ>(acc, base + ring_bytes + kb * kBlock,
                    base + (kb * kHpc + wg * kNA) * kAtom);
      igemm_tc::wgmma_commit();
    }
    wgmma_wait<0>();
    igemm_tc::fence_acc(acc);
    __syncthreads();  // both warpgroups are done with the A tile: R takes Kt and V
    LA_STAMP(stamp + 2);

    // k and v into R as [token][column] (rows past the tile's are 0: their
    // A rows are)
    {
      float* dst = wg == 0 ? Kt : V;
      const int r0 = 16 * wi + gq;
#pragma unroll
      for (int j = 0; j < kJ / 8; ++j) {
        *reinterpret_cast<float2*>(dst + r0 * kKS + 8 * j + 2 * tq) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<float2*>(dst + (r0 + 8) * kKS + 8 * j + 2 * tq) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
    __syncthreads();
    LA_STAMP(stamp + 3);
    // the online softmax over tokens, per (head, d) column: kParts threads a
    // column, each over kRows / kParts rows (all 8 warps; neighbouring lanes
    // read neighbouring columns), joined through pmax and psum
    {
      constexpr int kParts = kThreads / kJ, kPR = kRows / kParts;
      const int col = tid % kJ, part = tid / kJ, rb = part * kPR;
      float* kc = Kt + rb * kKS + col;
      float m = -INFINITY;
#pragma unroll 8
      for (int r = 0; r < kPR; ++r)
        if (rb + r < rows) m = fmaxf(m, kc[r * kKS]);
      pmax[part * kHidden + col] = m;
      __syncthreads();
      m = mrow[col];
#pragma unroll
      for (int p = 0; p < kParts; ++p) m = fmaxf(m, pmax[p * kHidden + col]);
      float sum = 0.f;
#pragma unroll 8
      for (int r = 0; r < kPR; ++r) {
        const float e = rb + r < rows ? exp_sfu(kc[r * kKS] - m) : 0.f;
        kc[r * kKS] = e;
        sum += e;
      }
      psum[part * kHidden + col] = sum;
      __syncthreads();
      if (tid < kJ) {
        const float m_old = mrow[tid];
        scl[tid] = exp_sfu(m_old - m);  // 0 on the first tile (m_old = -inf)
        mrow[tid] = m;
        float l = psum[tid];
#pragma unroll
        for (int p = 1; p < kParts; ++p) l += psum[p * kHidden + tid];
        lrow[tid] = lrow[tid] * scl[tid] + l;
      }
      __syncthreads();
    }
    LA_STAMP(stamp + 4);
    // context[d][e] = context[d][e] * rescale[d] + sum_t p[t][d] v[t][e]
    // (rows past the chunk have p = 0 and v = 0)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float sc = scl[ch * kDimHead + 16 * mt + gq + 8 * (e >> 1)];
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) cacc[mt][nt][e] *= sc;
      }
    la_tc::mma_smem(Kt + ch * kDimHead, 1, kKS, V + ch * kDimHead, kKS, 1, kRows, 0, ce, cacc);
    __syncthreads();  // the next tile rewrites R and the statistics
    LA_STAMP(stamp + 5);
  }
  float* o = part + ((static_cast<size_t>(b) * S + s) * kHidden + h0 * kDimHead) * kPartStride;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int d = 16 * mt + gq + 8 * h, e = ce + 8 * nt + 2 * tq;
        *reinterpret_cast<float2*>(o + (ch * kDimHead + d) * kPartStride + e) =
            make_float2(cacc[mt][nt][2 * h], cacc[mt][nt][2 * h + 1]);
      }
  if (tid < kJ)
    *reinterpret_cast<float2*>(o + tid * kPartStride + kDimHead) =
        make_float2(mrow[tid], lrow[tid]);
  release_bars(bars, KB);
}

// ---------------------------------------------------------------------------
// K5b: the output over flattened tokens
// ---------------------------------------------------------------------------

// K5b's ring: 64-k stages of the q columns (KB of them), then of the
// out-projection (2 per 128-column block): all of them where kRingBytes
// and the block's shared memory allow (C <= 256), so that they stay
// resident for all of a CTA's tiles.
__host__ __device__ constexpr int output_rest_bytes(int C) {
  // the A tile (then the attention output), the context tiles, 8 mbarriers
  // and the out-ChanLN's row partials (2 x 2 x 64 floats), 1024 to align
  return imax(a_bytes(C), 2 * kBlock) + kCtxBytes + 64 + 1024 + 1024;
}
__host__ __device__ constexpr int output_ring_depth(int C) {
  return imin(ceil_div(C, 64) + 2 * ceil_div(C, 128),
              imin(kRingBytes, kMaxSmem - output_rest_bytes(C)) / kStage);
}
// kStaged (the several-tiles variant at C <= 128): two fp32 x tiles, the
// next one copied while this one is finished
__host__ __device__ constexpr int x_tile_bytes(int C) { return kRows * (C + 4) * 4; }
__host__ __device__ constexpr int output_smem_bytes(int C, bool staged) {
  return output_ring_depth(C) * kStage + output_rest_bytes(C) + (staged ? 2 * x_tile_bytes(C) : 0);
}

struct OutMaps {
  CUtensorMap wqkv, wo;
};

// A pair of x for K5b's residual: from the staged tile in shared memory, or
// from device memory through L2 only.
template <bool kStaged>
__device__ __forceinline__ float2 x_pair(const float* p) {
  if constexpr (!kStaged) return __ldcg(reinterpret_cast<const float2*>(p));
  return *reinterpret_cast<const float2*>(p);
}

// K5b: tiles [tile_begin, tile_end) of tr tokens (64, or 32 where 64-token
// tiles would leave most SMs idle: the rows past tr are zero) of the
// flattened (T = B n, C) input, one after another (the last may be ragged); NB = ceil(C / 128)
// out-projection blocks, J as ln_to_a's. The weight stages stay resident
// where the ring holds them all, and a sample's context tiles are built
// once for all the CTA's tiles of that sample. kMulti (a CTA of several
// tiles, one CTA an SM; NB = 1): the x tiles are staged in shared memory,
// the next one copied (cp.async) while this one's out-projection and
// out-ChanLN run, and the residual reads the staged tile.
template <int NB, int J, bool kMulti>
__device__ __forceinline__ void output_body(const float* __restrict__ x,
                                            const float* __restrict__ g, const OutMaps& maps,
                                            const float* __restrict__ ctx,
                                            const float* __restrict__ bo,
                                            const float* __restrict__ og,
                                            float* __restrict__ out, int n, int T, int C,
                                            int tr, int tile_begin, int tile_end,
                                            unsigned char* smem_raw) {
  static_assert(!kMulti || NB == 1, "several tiles a CTA at C <= 128 only");
  constexpr bool kStaged = kMulti;
  const int KB = ceil_div(C, 64);
  const int D = output_ring_depth(C), total = KB + 2 * NB;
  const int tiles = tile_end - tile_begin;
  const bool resident = D >= total;
  const int stages_all = resident ? total : tiles * total;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sbase = smem_raw + (base - raw);
  unsigned char* A = sbase + D * kStage;  // the A tile, then the attention output (bf16)
  const int region = imax(a_bytes(C), 2 * kBlock);
  unsigned char* Cs = A + region;  // the context of one sample, as ctx_tiles lays it out
  const uint32_t bars = base + D * kStage + region + kCtxBytes;
  float* red = reinterpret_cast<float*>(sbase + D * kStage + region + kCtxBytes + 64);
  float* xs = red + 4 * kRows;  // kStaged: two x tiles

  const int tid = threadIdx.x, wg = tid >> 7;

  // ring stage st (st % total: q columns 0..127 of wqkv rows 64 s .., or
  // the out-projection's block (s - KB) / 2, rows 64 ((s - KB) % 2) ..)
  // into slot st % D
  auto issue = [&](int st) {
    const uint32_t bar = bars + 8 * (st % D), dst = base + (st % D) * kStage;
    const int sl = st % total;
    mbar_expect_tx(bar, kStage);
    if (sl < KB) {
      tma_2d(dst, &maps.wqkv, bar, 0, 64 * sl);
      tma_2d(dst + kAtom, &maps.wqkv, bar, 64, 64 * sl);
    } else {
      const int cb = (sl - KB) >> 1, kr = 64 * ((sl - KB) & 1);
      tma_2d(dst, &maps.wo, bar, 128 * cb, kr);
      tma_2d(dst + kAtom, &maps.wo, bar, 128 * cb + 64, kr);
    }
  };
  if (tid == 0) {
    for (int i = 0; i < D; ++i) mbar_init(bars + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int st = 0; st < imin(D, stages_all); ++st) issue(st);
  }
  // stage `st` of the CTA's sequence: wait for it, the warpgroup's
  // products, and when a later stage takes its slot, free it for thread 0
  auto consume = [&](auto& acc, int st, uint32_t a_blk) {
    const int si = resident ? st % total : st;
    mbar_wait(bars + 8 * (si % D), (si / D) & 1);
    igemm_tc::wgmma_fence();
    igemm_tc::fence_acc(acc);
    mma_block<64>(acc, a_blk, base + (si % D) * kStage + wg * kAtom);
    igemm_tc::wgmma_commit();
    wgmma_wait<0>();
    igemm_tc::fence_acc(acc);
    if (si + D < stages_all) {
      __syncthreads();
      if (tid == 0) {
        fence_async_smem();
        issue(si + D);
      }
    }
  };

  if constexpr (kStaged)
    x_copy(x + static_cast<size_t>(tile_begin) * tr * C, min(tr, T - tile_begin * tr), C, xs, tid);
  int cached = -1;  // the sample whose context tiles Cs holds
#pragma unroll 1
  for (int it = 0; it < tiles; ++it) {
    // the thread's index made opaque each tile, so that the compiler
    // recomputes the addresses it derives instead of holding them in
    // registers across the whole loop
    int tx = threadIdx.x;
    asm volatile("" : "+r"(tx));
    const int lane = tx & 31, wi = (tx >> 5) & 3, gq = lane >> 2, tq = lane & 3;
    const int rl0 = 16 * wi + gq;
    const int tile0 = (tile_begin + it) * tr;
    const int rows = min(tr, T - tile0);
    const int b_lo = tile0 / n, b_hi = (tile0 + rows - 1) / n;
    const float* xt = x + static_cast<size_t>(tile0) * C;
    [[maybe_unused]] const int stamp = 8 * min(it, 5);  // LA_STAMP slots
    LA_STAMP(stamp);
    float* X = xs + (it & 1) * (x_tile_bytes(C) / 4);  // kStaged: this tile's x
    if constexpr (kStaged) {
      la_tc::cp_async_wait<0>();  // this tile's x (the only group in flight)
      __syncthreads();
    }
    if (b_lo != cached)  // in flight across the ChanLN and q
      ctx_copy(ctx + static_cast<size_t>(b_lo) * kHidden * kDimHead, Cs, tx);
    if constexpr (kStaged)
      ln_staged_to_a<J>(X, rows, C, g, A, tx);
    else
      ln_to_a<J>(xt, rows, C, g, A, tx);
    fence_async_smem();
    __syncthreads();
    LA_STAMP(stamp + 1);

    // q of heads 2 wg, 2 wg + 1
    float qa[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) qa[i] = 0.f;
#pragma unroll 1
    for (int kb = 0; kb < KB; ++kb)
      consume(qa, it * total + kb, base + D * kStage + kb * kBlock);
    __syncthreads();  // both warpgroups are done with the A tile
    LA_STAMP(stamp + 2);

    // softmax over each head's 32 channels, then the 32^-0.5 scale: a row's
    // 32 values of head hl lie in its four lanes tq, 8 each
#pragma unroll
    for (int hl = 0; hl < 2; ++hl)
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        float m = -INFINITY;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          m = fmaxf(m, fmaxf(qa[4 * (4 * hl + kk) + 2 * rh], qa[4 * (4 * hl + kk) + 2 * rh + 1]));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        float sum = 0.f;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int e = 0; e < 2; ++e) {  // expf: each q feeds its row's o directly
            float& v = qa[4 * (4 * hl + kk) + 2 * rh + e];
            v = expf(v - m);
            sum += v;
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const float inv = 1.f / sum;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& v = qa[4 * (4 * hl + kk) + 2 * rh + e];
            v = v * inv * kScale;
          }
      }
    LA_STAMP(stamp + 3);

    // o = q context of the row's sample, per head, in 3xTF32 on wgmma
    // m64n32k8 (q from registers: for channels 8kk .. 8kk + 7 the A
    // fragment's k slot tq holds channel 8kk + 2tq, accumulator elements 0
    // and 2 of block 4hl + kk, slot tq + 4 channel 8kk + 2tq + 1; ctx_tiles
    // lays the context's rows out in that order). The tile's samples one
    // after another; each row keeps its own sample's products, rounded to
    // bf16 into the A tile's room (its last readers finished before the q
    // pass's closing barrier).
    const int bs0 = (tile0 + rl0) / n, bs1 = (tile0 + rl0 + 8) / n;
#pragma unroll 1
    for (int sb = b_lo; sb <= b_hi; ++sb) {
      if (sb != cached) {
        if (sb != b_lo) {
          __syncthreads();  // both warpgroups are done with the tiles Cs holds
          ctx_copy(ctx + static_cast<size_t>(sb) * kHidden * kDimHead, Cs, tx);
        }
        ctx_tiles(Cs, tx);
        fence_async_smem();
        __syncthreads();
        cached = sb;
      }
      LA_STAMP(stamp + 4);
#pragma unroll
      for (int hl = 0; hl < 2; ++hl) {
        const uint32_t hi = base + D * kStage + region + (2 * wg + hl) * 2 * kCtxTile;
        float t16[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) t16[i] = 0.f;
        uint32_t ahi[4][4], alo[4][4];  // kept alive until the products are done
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float* qj = qa + 4 * (4 * hl + kk);
          la_tc::tf32_split(qj[0], ahi[kk][0], alo[kk][0]);
          la_tc::tf32_split(qj[2], ahi[kk][1], alo[kk][1]);
          la_tc::tf32_split(qj[1], ahi[kk][2], alo[kk][2]);
          la_tc::tf32_split(qj[3], ahi[kk][3], alo[kk][3]);
        }
        igemm_tc::fence_frags(ahi);
        igemm_tc::fence_frags(alo);
        igemm_tc::wgmma_fence();
        igemm_tc::fence_acc(t16);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {  // small terms first: lo hi', hi lo', hi hi'
          MmaTf32RS32::run(t16, alo[kk], desc_sw128(hi + 32 * kk));
          MmaTf32RS32::run(t16, ahi[kk], desc_sw128(hi + kCtxTile + 32 * kk));
          MmaTf32RS32::run(t16, ahi[kk], desc_sw128(hi + 32 * kk));
        }
        igemm_tc::wgmma_commit();
        wgmma_wait<0>();
        igemm_tc::fence_acc(t16);
        igemm_tc::fence_frags(ahi);
        igemm_tc::fence_frags(alo);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int k = (2 * wg + hl) * kDimHead + 8 * nt + 2 * tq;
          if (bs0 == sb) store_a2(A, rl0, k, t16[4 * nt], t16[4 * nt + 1]);
          if (bs1 == sb) store_a2(A, rl0 + 8, k, t16[4 * nt + 2], t16[4 * nt + 3]);
        }
      }
    }
    fence_async_smem();
    __syncthreads();
    LA_STAMP(stamp + 5);
    if constexpr (kStaged) {  // the next tile's x, in flight across what follows
      if (it + 1 < tiles)
        x_copy(xt + static_cast<size_t>(tr) * C, min(tr, T - tile0 - tr), C,
               xs + ((it + 1) & 1) * (x_tile_bytes(C) / 4), tx);
    }

    // the out-projection: block cb's columns 128 cb + 64 wg .. + 63
    float ya[NB][32];
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) {
#pragma unroll
      for (int i = 0; i < 32; ++i) ya[cb][i] = 0.f;
#pragma unroll
      for (int kr = 0; kr < 2; ++kr)
        consume(ya[cb], it * total + KB + 2 * cb + kr, base + D * kStage + kr * kBlock);
    }
    LA_STAMP(stamp + 6);

    // + bias, then the out-ChanLN over all C columns of a row (each
    // warpgroup's half summed by shuffles over tq, the halves joined in
    // `red`) and the residual; each block's loads issued together
    // (unconditional: past C column 0, past the tile row 0)
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) {
      float2 bv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 128 * cb + 64 * wg + 8 * j + 2 * tq;
        bv[j] = __ldg(reinterpret_cast<const float2*>(bo + (c < C ? c : 0)));
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 128 * cb + 64 * wg + 8 * j + 2 * tq;
        float* y = ya[cb] + 4 * j;
        y[0] += bv[j].x;
        y[1] += bv[j].y;
        y[2] += bv[j].x;
        y[3] += bv[j].y;
        if (c < C) {  // C % 8 == 0: c + 1 < C with c
          s0 += y[0] + y[1];
          s1 += y[2] + y[3];
        }
      }
    }
    auto row_sum = [&](float& v0, float& v1, float* dst) {
      v0 += __shfl_xor_sync(0xffffffffu, v0, 1);
      v0 += __shfl_xor_sync(0xffffffffu, v0, 2);
      v1 += __shfl_xor_sync(0xffffffffu, v1, 1);
      v1 += __shfl_xor_sync(0xffffffffu, v1, 2);
      if (tq == 0) {
        dst[wg * kRows + rl0] = v0;
        dst[wg * kRows + rl0 + 8] = v1;
      }
    };
    row_sum(s0, s1, red);
    __syncthreads();
    const float m0 = (red[rl0] + red[kRows + rl0]) / C;
    const float m1 = (red[rl0 + 8] + red[kRows + rl0 + 8]) / C;
    float v0 = 0.f, v1 = 0.f;
#pragma unroll
    for (int cb = 0; cb < NB; ++cb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 128 * cb + 64 * wg + 8 * j + 2 * tq;
        if (c < C) {
          const float* y = ya[cb] + 4 * j;
          const float a0 = y[0] - m0, a1 = y[1] - m0, a2 = y[2] - m1, a3 = y[3] - m1;
          v0 += a0 * a0 + a1 * a1;
          v1 += a2 * a2 + a3 * a3;
        }
      }
    row_sum(v0, v1, red + 2 * kRows);
    __syncthreads();
    const float rs0 = rsqrtf((red[2 * kRows + rl0] + red[3 * kRows + rl0]) / C + kLnEps);
    const float rs1 = rsqrtf((red[2 * kRows + rl0 + 8] + red[3 * kRows + rl0 + 8]) / C + kLnEps);
    const bool ok0 = rl0 < rows, ok1 = rl0 + 8 < rows;
    // the residual: the staged tile, or x through L2
    const float* x0 = kStaged ? X + rl0 * (C + 4) : xt + static_cast<size_t>(ok0 ? rl0 : 0) * C;
    const float* x1 =
        kStaged ? X + (rl0 + 8) * (C + 4) : xt + static_cast<size_t>(ok1 ? rl0 + 8 : 0) * C;
    float* o0 = out + (static_cast<size_t>(tile0) + rl0) * C;
    float* o1 = o0 + 8 * static_cast<size_t>(C);
#pragma unroll
    for (int jb = 0; jb < 2 * NB; ++jb) {  // 4 column pairs of a block at a time
      const int cb = jb >> 1;
      float2 gv[4], xv0[4], xv1[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * (jb & 1) + jj;
        const int c = 128 * cb + 64 * wg + 8 * j + 2 * tq, cc = c < C ? c : 0;
        gv[jj] = __ldg(reinterpret_cast<const float2*>(og + cc));
        xv0[jj] = x_pair<kStaged>(x0 + cc);
        xv1[jj] = x_pair<kStaged>(x1 + cc);
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * (jb & 1) + jj;
        const int c = 128 * cb + 64 * wg + 8 * j + 2 * tq;
        if (c < C) {
          const float* y = ya[cb] + 4 * j;
          if (ok0)
            *reinterpret_cast<float2*>(o0 + c) =
                make_float2(xv0[jj].x + (y[0] - m0) * rs0 * gv[jj].x,
                            xv0[jj].y + (y[1] - m0) * rs0 * gv[jj].y);
          if (ok1)
            *reinterpret_cast<float2*>(o1 + c) =
                make_float2(xv1[jj].x + (y[2] - m1) * rs1 * gv[jj].x,
                            xv1[jj].y + (y[3] - m1) * rs1 * gv[jj].y);
        }
      }
    }
    LA_STAMP(stamp + 7);
    __syncthreads();  // the next tile rewrites A, and perhaps the context tiles
  }
  release_bars(bars, D);
}

// ---------------------------------------------------------------------------
// K6a and K6c: the full block's projections over flattened tokens
// ---------------------------------------------------------------------------

// K6a's ring holds every 64-k stage of its 128 columns where kRingBytes
// allows (C <= 512: always).
__host__ __device__ constexpr int qkv_ring_depth(int C) {
  return imin(ceil_div(C, 64), kRingBytes / kStage);
}
__host__ __device__ constexpr int qkv_smem_bytes(int C) {
  return qkv_ring_depth(C) * kStage + a_bytes(C) + 64 + 1024;
}
constexpr int kOutProjSmem = 2 * kStage + 2 * kBlock + 64 + 1024;

// K6a: tokens tile * 64 .. of the flattened (T, C) input, ChanLN'd and
// projected onto pass `pass` of wqkv (0 q, scaled by 32^-0.5; 1 k; 2 v),
// columns 64 wg .. of the pass per warpgroup. Writes the (T, 384) qkv
// scratch.
template <int J>
__device__ __forceinline__ void qkv_body(const float* __restrict__ x, const float* __restrict__ g,
                                         const CUtensorMap* wmap, float* __restrict__ qkv, int T,
                                         int C, int tile, int pass, unsigned char* smem_raw) {
  const int KB = ceil_div(C, 64), D = qkv_ring_depth(C);
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* A = smem_raw + (base - raw) + D * kStage;
  const uint32_t bars = base + D * kStage + a_bytes(C);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wg = tid >> 7;
  const int tile0 = tile * kRows, rows = min(kRows, T - tile0);
  auto issue = [&](int st) {
    const uint32_t bar = bars + 8 * (st % D), dst = base + (st % D) * kStage;
    mbar_expect_tx(bar, kStage);
    tma_2d(dst, wmap, bar, pass * 128, 64 * st);
    tma_2d(dst + kAtom, wmap, bar, pass * 128 + 64, 64 * st);
  };
  if (tid == 0) {
    for (int i = 0; i < D; ++i) mbar_init(bars + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int st = 0; st < D; ++st) issue(st);
  }
  ln_to_a<J>(x + static_cast<size_t>(tile0) * C, rows, C, g, A, tid);
  fence_async_smem();
  __syncthreads();
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll 1
  for (int kb = 0; kb < KB; ++kb) {
    mbar_wait(bars + 8 * (kb % D), (kb / D) & 1);
    igemm_tc::wgmma_fence();
    igemm_tc::fence_acc(acc);
    mma_block<64>(acc, base + D * kStage + kb * kBlock, base + (kb % D) * kStage + wg * kAtom);
    igemm_tc::wgmma_commit();
    wgmma_wait<0>();
    igemm_tc::fence_acc(acc);
    if (kb + D < KB) {
      __syncthreads();
      if (tid == 0) {
        fence_async_smem();
        issue(kb + D);
      }
    }
  }
  const float scale = pass == 0 ? kScale : 1.f;
  const int gq = lane >> 2, tq = lane & 3, r0 = 16 * (warp & 3) + gq;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= rows) continue;
    float* dst = qkv + static_cast<size_t>(tile0 + r) * kQKV + pass * 128 + 64 * wg;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j + 2 * tq) =
          make_float2(acc[4 * j + 2 * h] * scale, acc[4 * j + 2 * h + 1] * scale);
  }
  release_bars(bars, D);
}

// K6c: tokens tile * 64 .., output channels ct * 128 .. (64 per
// warpgroup): out = x + (bf16(O) wo + bo), O the (T, 128) attention output.
__device__ __forceinline__ void attn_out_body(const float* __restrict__ o,
                                              const CUtensorMap* wmap,
                                              const float* __restrict__ bo,
                                              const float* __restrict__ x,
                                              float* __restrict__ out, int T, int C, int tile,
                                              int ct, unsigned char* smem_raw) {
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* A = smem_raw + (base - raw) + 2 * kStage;
  const uint32_t bars = base + 2 * kStage + 2 * kBlock;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wg = tid >> 7;
  const int tile0 = tile * kRows, rows = min(kRows, T - tile0), n0 = ct * 128;
  if (tid == 0) {
    mbar_init(bars);
    mbar_init(bars + 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      mbar_expect_tx(bars + 8 * st, kStage);
      tma_2d(base + st * kStage, wmap, bars + 8 * st, n0, 64 * st);
      tma_2d(base + st * kStage + kAtom, wmap, bars + 8 * st, n0 + 64, 64 * st);
    }
  }
  // O rounded to bf16: thread (row r, 32 columns) of 4 threads per row,
  // its loads unconditional (past the tile: row 0, then zeroed)
  {
    const int r = tid >> 2, c0 = 32 * (tid & 3);
    const float4* src = reinterpret_cast<const float4*>(
        o + static_cast<size_t>(tile0 + (r < rows ? r : 0)) * kHidden + c0);
    float4 ov[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) ov[i] = ld_act(src + i);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 v = r < rows ? ov[i] : make_float4(0.f, 0.f, 0.f, 0.f);
      const int k = c0 + 4 * i;
      *reinterpret_cast<uint2*>(A + (k >> 6) * kBlock + swz(r, (k & 63) >> 3) + 2 * (k & 7)) =
          make_uint2(bf16x2_rn(v.x, v.y), bf16x2_rn(v.z, v.w));
    }
  }
  fence_async_smem();
  __syncthreads();
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  igemm_tc::wgmma_fence();
#pragma unroll
  for (int st = 0; st < 2; ++st) {
    mbar_wait(bars + 8 * st, 0);
    igemm_tc::fence_acc(acc);
    mma_block<64>(acc, base + 2 * kStage + st * kBlock, base + st * kStage + wg * kAtom);
  }
  igemm_tc::wgmma_commit();
  wgmma_wait<0>();
  igemm_tc::fence_acc(acc);
  // + bias + residual; the loads issued together (unconditional: past C
  // column 0, past the tile row 0)
  const int gq = lane >> 2, tq = lane & 3, r0 = 16 * (warp & 3) + gq;
  float2 bv[8], xv[2][8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = n0 + 64 * wg + 8 * j + 2 * tq, cc = c < C ? c : 0;
    bv[j] = __ldg(reinterpret_cast<const float2*>(bo + cc));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      xv[h][j] = ld_act(reinterpret_cast<const float2*>(
          x + static_cast<size_t>(tile0 + (r < rows ? r : 0)) * C + cc));
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= rows) continue;
    float* dst = out + static_cast<size_t>(tile0 + r) * C;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + 64 * wg + 8 * j + 2 * tq;
      if (c >= C) continue;  // C % 8 == 0: c + 1 < C with c
      *reinterpret_cast<float2*>(dst + c) =
          make_float2(xv[h][j].x + (acc[4 * j + 2 * h] + bv[j].x),
                      xv[h][j].y + (acc[4 * j + 2 * h + 1] + bv[j].y));
    }
  }
  release_bars(bars, 2);
}

}  // namespace attn_bf16
