// K5 and K6 on bf16 activations: the UNet2D attention blocks under flax's
// dtype=bfloat16 (linear_attention_bf16act, attention_bf16act), designed
// for Hopper.
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
// Roundings (to nearest even; no multiply-add fused where the plain version
// rounds between the two). ChanLN (flax ChanLayerNorm on bf16, eps 1e-3):
// mean and variance (around the fp32 mean) in fp32, each rounded to bf16;
// bf16(x - mean), rstd = bf16(1 / sqrt(bf16(var + bf16(1e-3)))), their
// product rounded, times the fp32 gain, rounded as the 1x1 conv takes it.
// Each projection: the fp32 sum of bf16 products, rounded. K5: q's softmax
// over each head's 32 channels (bf16(q - max), bf16(exp), the fp32 sum
// rounded, the quotient rounded) times bf16(32^-0.5), rounded; k's softmax
// over the sample's tokens in flax's exact order, not online: the max, the
// fp32 sum of the rounded exps bf16(exp(bf16(k - max))), rounded, then the
// probabilities bf16(e / sum) before the context product (an online softmax
// would normalise after it and round other values); the context's fp32 sum
// rounded; bf16(context^T q); the out-projection bf16(bf16(. wo) +
// bf16(bo)); the out-ChanLN times the fp32 gain; y = bf16(x + that), flax's
// fp32 block output, which only convs read, rounding it to bf16. K6: q =
// bf16(q * bf16(32^-0.5)); scores bf16(q . k); the softmax in fp32 in
// exact order (max, the sum of the fp32 exps, then bf16(e / sum), as flax's
// softmax(sim.astype(f32)).astype(bf16)); bf16(p v); the out-projection as
// K5's; y = bf16(x + o). So the only gap to the plain versions is the
// order of fp32 sums (chip_smoke.py phase 18 holds it within two bf16
// steps), and no sum uses atomics: two calls are bit-equal.
//
// Bound: bytes at the 2048-token sites (the projections' 2 * 384 flops per
// 2-byte input channel are below the bf16 ridge), operations at the
// 32-token sites; chip_smoke.py prints each call's bound from its shapes.
// The first design (mma.sync products with the weight streamed through
// shared memory one 64-row slice at a time, a q | k | v scratch, the token
// softmax in four launches) stood 53x (K5) and 92x (K6) above it (PERF.md,
// the kernel table's rows 3c and 4c). This one:
//
// K5, three launches:
// - K5a (proj_kernel<true>), per 64-token tile of one sample, CTAs over a
//   contiguous share of the tiles: the x tile arrives by TMA as stored, in
//   the 128-byte swizzle a wgmma descriptor reads (3-D map (C, n, B): rows
//   past the sample and channels past C arrive as zeros), the next tile's
//   copy in flight while this one runs; ChanLN in place, eight threads a
//   token; the k | v columns as one wgmma chain per warpgroup (k on
//   warpgroup 0, v on 1; all four heads, or two where C > 256 or the tiles
//   are few), the weights by TMA, resident for all of the CTA's tiles; k and
//   v rounded into a staging tile and stored by TMA, head-major ((B, 4, n,
//   [k 32 | v 32]): each (sample, head) contiguous); each tile's k maxima
//   per (head, d) to a small fp32 buffer (a max is exact in any order).
// - K5b (context_kernel), one thread-block cluster of cs CTAs per (sample,
//   head) (the host's plan, kernels/attention.py: bf16act_plan):
//   rank r takes tokens [r share, (r + 1) share) and loads their k | v rows
//   by TMA once (runs of kRun tokens in turn where a share is larger); the
//   max from K5a's tile maxima; the exps in place and their per-rank fp32
//   sums, added in rank order over distributed shared memory, so that every
//   CTA holds the same rounded sum; p = bf16(e / sum) in place; the fp32
//   context partial p^T v by mma.sync (ldmatrix.trans from the swizzled
//   rows; bf16 products are exact in fp32); the partials added in rank
//   order over distributed shared memory, rounded, stored (B, 4, 32, 32).
// - K5c (output_kernel<true>), per 64-token tile of one sample: the x tile
//   by TMA, staged once for the ChanLN and the residual; q re-projected by
//   wgmma (not written and read back: 2 C 128 tensor-core flops a token
//   against 512 bytes); the head softmax in registers (a row's 32 values on
//   four lanes); context^T q by wgmma m64n32k16 with q as a register A
//   operand and the sample's context as a K-major bf16 B tile; the result
//   rounded into a swizzled A tile; the out-projection by wgmma; the bias,
//   the out-ChanLN with its row statistics joined across the warpgroups'
//   columns, the residual written over the staged x tile and stored by TMA.
//   Weights by TMA in a ring, resident for all of the CTA's tiles where they
//   fit (C <= 256).
// K6, three launches: K6a (proj_kernel<false>) is K5a's body over the q, k
// and v passes of wqkv, one pass a CTA, stored (B, n, 384); K6b
// (attn_core_kernel), per (sample, head, 64 queries): S = bf16(q k^T) by
// mma.sync over key tiles of 64 (any n: a max pass, a sum pass and a p v
// pass, the scores recomputed on the tensor cores, the key tile kept when
// there is one), p from the score accumulators as the A operand of bf16(p
// v); K6c (output_kernel<false>) is K5c's out-projection and residual, the
// attention output arriving by TMA as the A tile.
// Past the products, the per-token work is flax's rounding after every op,
// and K5c's phases are ALU-bound on it (tools/k5_phase_clocks.py
// --bf16act). So each rounding between two bf16 operands runs as Hopper's
// packed bf16x2 arithmetic and each bf16 quotient as a product with one
// reciprocal, both exact (bsub2, quot2): on an NVIDIA H100 80GB HBM3 at 700
// W that took K5 from 0.625-0.636 to 0.507-0.514 ms of device time per
// UNet2D forward at batch 50, against the first design's 1.472-1.475
// (tools/step_times.py --attention --bf16act).
//
// Contract (the wrapper checks): C a multiple of 8 up to 512, every pointer
// 16-byte aligned, B * n * 384 < 2^31.

// Phase clocks, compiled in only with -DLA_PHASE_CLOCKS (the build that
// tools/k5_phase_clocks.py --bf16act makes of this file alone): LA_STAMP(i)
// has thread 0 of each CTA write clock64() to slot i of the CTA's
// kStampSlots in bfa_stamps.
#ifdef LA_PHASE_CLOCKS
constexpr int kStampSlots = 64;
__device__ long long bfa_stamps[4000000];
#define LA_STAMP(i)                                                                         \
  do {                                                                                      \
    if (threadIdx.x == 0)                                                                   \
      bfa_stamps[((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) *         \
                     kStampSlots +                                                          \
                 (i)] = clock64();                                                          \
  } while (0)
extern "C" int bfa_stamps_read(long long* host, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, bfa_stamps, sizeof(long long) * n));
}
extern "C" int bfa_stamps_clear() {
  void* p = nullptr;
  const cudaError_t e = cudaGetSymbolAddress(&p, bfa_stamps);
  return static_cast<int>(e != cudaSuccess ? e : cudaMemset(p, 0, sizeof(bfa_stamps)));
}
#endif
#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include <algorithm>
#include <mutex>

#include "attention_bf16.cuh"  // wgmma products, mma_block, ring helpers, the TMA pieces
#include "bf16x2.cuh"         // flax's per-op bf16 roundings as packed arithmetic

namespace cg = cooperative_groups;

namespace {

using attn_bf16::a_bytes;
using attn_bf16::ceil_div;
using attn_bf16::fence_async_smem;
using attn_bf16::kAtom;
using attn_bf16::kBlock;
using attn_bf16::kMaxSmem;
using attn_bf16::kStage;
using attn_bf16::mma_block;
using attn_bf16::release_bars;
using attn_bf16::wgmma_wait;
using bf16x2::badd2;
using bf16x2::bf16x2_rn;
using bf16x2::bmul2;
using bf16x2::bpair;
using bf16x2::bsub2;
using bf16x2::hi_f;
using bf16x2::lo_f;
using bf16x2::quot2;
using bf16x2::rb;
using hopper_tma::mbar_expect_tx;
using hopper_tma::mbar_init;
using hopper_tma::mbar_wait;
using hopper_tma::tma_2d;
using igemm_tc::desc_sw128;
using igemm_tc::smem_u32;
using igemm_tc::swz;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // two warpgroups
constexpr int kTile = 64;      // tokens a tile: one wgmma M
constexpr int kHeads = 4, kDh = 32, kHidden = kHeads * kDh, kQkv = 3 * kHidden;
constexpr int kMaxC = 512;
constexpr int kRun = 512;        // K5b: tokens a CTA holds at once, 128 bytes each
constexpr int kMaxCluster = 8;   // K5b: the portable cluster size
constexpr int kCtxTile = kDh * 128;  // K5c: one head's context as a K-major B tile

__device__ __forceinline__ float bf_scale() { return rb(0.17677669529663687f); }  // 32^-0.5
__device__ __forceinline__ float bf_eps() { return rb(1e-3f); }

__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int x,
                                       int y, int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y), "r"(z)
      : "memory");
}
// a box of shared memory (as the map's swizzle lays it out) to device memory;
// what lies past the tensor's bounds is not written
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int x, int y,
                                             int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(x), "r"(y), "r"(z)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// this thread's committed stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 sums; fragments
// (g = lane / 4, t = lane % 4): a0 (g, 2t..), a1 (g + 8, 2t..), a2 (g, 2t +
// 8..), a3 (g + 8, 2t + 8..); b0 (k 2t.., n g), b1 (k 2t + 8.., n g); d0, d1
// (g, 2t, 2t + 1), d2, d3 (g + 8, ..)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d (64 x 32 per warpgroup) += A (64 x 16 bf16, registers, the fragments as
// mma16816's a per warp) * B (16 x 32, shared memory, K-major, 128-byte
// swizzle); d as attn_bf16::MmaSS's
__device__ __forceinline__ void mma_rs32(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The byte offset of channel c (even) of row r in a tile of 64-channel
// blocks [64 rows][128 B], 128-byte swizzle: a bf16 pair (c, c + 1).
__device__ __forceinline__ uint32_t at(int r, int c) {
  return (c >> 6) * kBlock + swz(r, (c & 63) >> 3) + 2 * (c & 7);
}

// ChanLN of the 64 rows of the staged x tile X into the A tile Y (both
// 64-channel blocks as `at` lays them out; Y may be X): eight threads a row
// (chunk q of each block: the eight lanes of a row read eight distinct bank
// groups), rows r and r + 32 a thread, side by side. gs: the gain, C floats
// in shared memory. Rows of zeros (past the sample) give zeros. Channels C
// .. 64 ceil(C / 64) - 1 of Y: zeros (as TMA filled them where Y is X). All
// threads call it; the caller fences and syncs.
__device__ __forceinline__ void chan_ln_tile(const unsigned char* X, unsigned char* Y, int C,
                                             const float* gs, int tid) {
  const int q = tid & 7, KB = ceil_div(C, 64), nch = C / 8;
  const int r0 = tid >> 3;  // and r0 + 32
  const float inv_c = 1.f / static_cast<float>(C);
  auto ld = [&](int kb, int r) {
    return *reinterpret_cast<const uint4*>(X + kb * kBlock + swz(r, q));
  };
  float s[2] = {0.f, 0.f};
#pragma unroll 2
  for (int kb = 0; kb < KB; ++kb) {
    if (8 * kb + q >= nch) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 v = ld(kb, r0 + 32 * h);
      s[h] += (lo_f(v.x) + hi_f(v.x)) + (lo_f(v.y) + hi_f(v.y)) + (lo_f(v.z) + hi_f(v.z)) +
              (lo_f(v.w) + hi_f(v.w));
    }
  }
  float mean[2], v2[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    s[h] += __shfl_xor_sync(0xffffffffu, s[h], 1);
    s[h] += __shfl_xor_sync(0xffffffffu, s[h], 2);
    s[h] += __shfl_xor_sync(0xffffffffu, s[h], 4);
    mean[h] = s[h] * inv_c;
  }
#pragma unroll 2
  for (int kb = 0; kb < KB; ++kb) {
    if (8 * kb + q >= nch) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 v = ld(kb, r0 + 32 * h);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = lo_f(w[i]) - mean[h], b = hi_f(w[i]) - mean[h];
        v2[h] += a * a + b * b;
      }
    }
  }
  uint32_t mb2[2], rs2[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    v2[h] += __shfl_xor_sync(0xffffffffu, v2[h], 1);
    v2[h] += __shfl_xor_sync(0xffffffffu, v2[h], 2);
    v2[h] += __shfl_xor_sync(0xffffffffu, v2[h], 4);
    mb2[h] = bpair(rb(mean[h]));
    rs2[h] = bpair(rb(__frsqrt_rn(rb(rb(v2[h] * inv_c) + bf_eps()))));
  }
#pragma unroll 2
  for (int kb = 0; kb < KB; ++kb) {
    const int c = 8 * (8 * kb + q);
    if (c >= C && X == Y) continue;  // TMA's zeros stay
    float gv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) gv[i] = c < C ? gs[c + i] : 0.f;
    uint4 xv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) xv[h] = c < C ? ld(kb, r0 + 32 * h) : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint4 o = make_uint4(0u, 0u, 0u, 0u);
      if (c < C) {
        const uint4 v = xv[h];
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
        uint32_t out[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // bf16(bf16(x - mean) rstd), then times g
          const uint32_t u = bmul2(bsub2(w[i], mb2[h]), rs2[h]);
          out[i] = bf16x2_rn(__fmul_rn(lo_f(u), gv[2 * i]), __fmul_rn(hi_f(u), gv[2 * i + 1]));
        }
        o = make_uint4(out[0], out[1], out[2], out[3]);
      }
      *reinterpret_cast<uint4*>(Y + kb * kBlock + swz(r0 + 32 * h, q)) = o;
    }
  }
}

// C floats of v to shared memory (dst), rounded to bf16 where `round`; all
// threads call it, the caller syncs.
__device__ __forceinline__ void stage_vec(const float* __restrict__ v, float* dst, int C,
                                          bool round, int tid) {
  for (int c = tid; c < C; c += kThreads) {
    const float x = __ldg(v + c);
    dst[c] = round ? rb(x) : x;
  }
}

// Tiles: each sample's n tokens in tpb = ceil(n / 64) tiles; tile i is
// sample i / tpb, tokens 64 (i % tpb) ..; a CTA takes tiles [begin, end),
// a contiguous, balanced share.
struct Share {
  int begin, end;
  __device__ Share(int tiles) {
    begin = static_cast<int>(static_cast<long long>(blockIdx.x) * tiles / gridDim.x);
    end = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * tiles / gridDim.x);
  }
};

// ---------------------------------------------------------------------------
// K5a and K6a: the projections
// ---------------------------------------------------------------------------

struct ProjMaps {
  CUtensorMap x, w, dst;  // x (C, n, B); wqkv; K5: kv (64, n, 4 B); K6: qkv (384, n, B)
};

__host__ __device__ constexpr int proj_smem(int C, int NA, int nbuf) {
  // 1024 to align, the resident weights (2 NA atoms a 64-k stage), nbuf A
  // tiles, the staging tile, warp maxima (4 x 128 floats), mbarriers, the
  // gain (C floats)
  return 1024 + ceil_div(C, 64) * 2 * NA * kAtom + nbuf * a_bytes(C) + 2 * NA * kBlock +
         4 * kHidden * 4 + 8 * (8 + 2) + 4 * C;
}

// grid (CTAs, y): K5 (LINEAR) y = head group, 2 NA heads of k on warpgroup
// 0 and their v on warpgroup 1 (N = 64 NA columns each); K6 y = pass (q, k,
// v), 64 columns a warpgroup (NA = 1). nbuf: A tiles, 2 where the next
// tile's copy can be in flight. kmax (K5): (B, tpb, 128) fp32.
template <bool LINEAR, int NA>
__global__ void __launch_bounds__(kThreads, 1)
    proj_kernel(const __grid_constant__ ProjMaps maps, const float* __restrict__ g,
                float* __restrict__ kmax, int n, int C, int tpb, int tiles, int nbuf) {
  constexpr int N = 64 * NA;  // columns a warpgroup
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sbase = smem_raw + (base - raw);
  const int KB = ceil_div(C, 64);
  const int w_bytes = KB * 2 * NA * kAtom;
  const uint32_t a0 = base + w_bytes;  // nbuf A tiles
  const uint32_t stg = a0 + nbuf * a_bytes(C);
  float* pmax = reinterpret_cast<float*>(sbase + (stg - base) + 2 * NA * kBlock);
  const uint32_t bars = stg + 2 * NA * kBlock + 4 * kHidden * 4;  // KB weight, 2 x
  float* gs = reinterpret_cast<float*>(sbase + (bars - base) + 8 * (8 + 2));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wg = tid >> 7;
  const int wi = warp & 3, gq = lane >> 2, tq = lane & 3;
  const int y = blockIdx.y;
  const int h0 = LINEAR ? 2 * NA * y : 0;  // K5: the CTA's first head
  const Share sh(tiles);
  const int ntiles = sh.end - sh.begin;

  auto column = [&](int a) {  // wqkv column of atom a (a / NA: the warpgroup)
    if (LINEAR) return kHidden * (1 + a / NA) + kDh * h0 + 64 * (a % NA);
    return kHidden * y + 64 * a;
  };
  auto issue_x = [&](int it) {
    const int tile = sh.begin + it, b = tile / tpb, t0 = (tile % tpb) * kTile;
    const uint32_t bar = bars + 8 * (KB + it % nbuf), dst = a0 + (it % nbuf) * a_bytes(C);
    mbar_expect_tx(bar, KB * kBlock);
    for (int kb = 0; kb < KB; ++kb) tma_3d(dst + kb * kBlock, &maps.x, bar, 64 * kb, t0, b);
  };
  if (tid == 0) {
    for (int i = 0; i < KB + 2; ++i) mbar_init(bars + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int kb = 0; kb < KB; ++kb) {
      mbar_expect_tx(bars + 8 * kb, 2 * NA * kAtom);
      for (int a = 0; a < 2 * NA; ++a)
        tma_2d(base + (kb * 2 * NA + a) * kAtom, &maps.w, bars + 8 * kb, column(a), 64 * kb);
    }
    if (ntiles > 0) issue_x(0);
  }
  stage_vec(g, gs, C, false, tid);
  __syncthreads();

#pragma unroll 1
  for (int it = 0; it < ntiles; ++it) {
    const int tile = sh.begin + it, b = tile / tpb, tt = tile % tpb, t0 = tt * kTile;
    const int rows = min(kTile, n - t0);
    [[maybe_unused]] const int stamp = 10 * min(it, 5);  // LA_STAMP slots
    LA_STAMP(stamp);
    if (tid == 0 && nbuf == 2 && it + 1 < ntiles) issue_x(it + 1);
    const uint32_t A = a0 + (it % nbuf) * a_bytes(C);
    unsigned char* Ap = sbase + (A - base);
    mbar_wait(bars + 8 * (KB + it % nbuf), (it / nbuf) & 1);
    LA_STAMP(stamp + 1);
    chan_ln_tile(Ap, Ap, C, gs, tid);
    fence_async_smem();
    __syncthreads();
    LA_STAMP(stamp + 2);

    float acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    igemm_tc::wgmma_fence();
#pragma unroll 1
    for (int kb = 0; kb < KB; ++kb) {
      mbar_wait(bars + 8 * kb, 0);  // resident: phase 0 completes once
      igemm_tc::fence_acc(acc);
      mma_block<N>(acc, A + kb * kBlock, base + (kb * 2 * NA + wg * NA) * kAtom);
      igemm_tc::wgmma_commit();
    }
    wgmma_wait<0>();
    igemm_tc::fence_acc(acc);
    if (tid == 0) bulk_wait_read();  // the last tile's stores have read the staging tile
    __syncthreads();                 // ... and both warpgroups are done with A
    if (tid == 0 && nbuf == 1 && it + 1 < ntiles) {
      fence_async_smem();
      issue_x(it + 1);
    }
    LA_STAMP(stamp + 3);

    // round; K6's q scaled; into the staging tile (K5: per head [k 32 | v
    // 32], k from warpgroup 0, v from 1; K6: the warpgroup's 64 columns)
    const uint32_t scale2 = bpair(bf_scale());
    unsigned char* S = sbase + (stg - base);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int c = 8 * j + 2 * tq;  // the warpgroup's column
      uint32_t off;
      if (LINEAR)
        off = (c >> 5) * kBlock + 2 * ((c & 7));
      else
        off = wg * kBlock + 2 * (c & 7);
      const int chunk = LINEAR ? 4 * wg + ((c & 31) >> 3) : c >> 3;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * wi + gq + 8 * h;
        uint32_t v = bf16x2_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        if (!LINEAR && y == 0) v = bmul2(v, scale2);
        *reinterpret_cast<uint32_t*>(S + off + swz(r, chunk)) = v;
      }
    }
    if (LINEAR && wg == 0) {  // the tile's k maxima per column, over its rows
      // (of the sums; rounding to bf16 keeps their order, so the rounded
      // max is the max of the rounded k)
      const bool ok0 = 16 * wi + gq < rows, ok1 = 16 * wi + gq + 8 < rows;
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float m = fmaxf(ok0 ? acc[4 * j + e] : -INFINITY, ok1 ? acc[4 * j + 2 + e] : -INFINITY);
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 4));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 8));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 16));
          if (gq == 0) pmax[wi * kHidden + 8 * j + 2 * tq + e] = rb(m);
        }
    }
    fence_async_smem();
    __syncthreads();
    if (tid == 0) {
      if (LINEAR) {
        for (int hl = 0; hl < 2 * NA; ++hl)
          tma_store_3d(&maps.dst, stg + hl * kBlock, 0, t0, kHeads * b + h0 + hl);
      } else {
        for (int w = 0; w < 2; ++w)
          tma_store_3d(&maps.dst, stg + w * kBlock, kHidden * y + 64 * w, t0, b);
      }
      bulk_commit();
    }
    if (LINEAR && tid < N) {
      const float m = fmaxf(fmaxf(pmax[tid], pmax[kHidden + tid]),
                            fmaxf(pmax[2 * kHidden + tid], pmax[3 * kHidden + tid]));
      kmax[(static_cast<size_t>(b) * tpb + tt) * kHidden + kDh * h0 + tid] = m;
    }
    LA_STAMP(stamp + 4);
  }
  if (tid == 0) bulk_wait_all();
  release_bars(bars, KB + 2);
}

// ---------------------------------------------------------------------------
// K5b: k's token softmax and the context, one cluster per (sample, head)
// ---------------------------------------------------------------------------

// Shared memory: a run's rows (cap x 128 B: [k 32 | v 32] bf16, the
// 128-byte swizzle), then the partial context (32 x 32 fp32), the per-warp
// sums (8 x 32), the max, the sum's reciprocal, the rank's sums (32 each),
// an mbarrier.
__host__ __device__ constexpr int ctx_smem(int cap) {
  return 1024 + cap * 128 + kDh * kDh * 4 + 8 * kDh * 4 + 3 * kDh * 4 + 64;
}

// grid (cs, 4, B), clusters of cs along x: rank r takes the sample's tokens
// [r share, min(n, (r + 1) share)), in runs of cap (a multiple of 64, at
// most kRun; runs = ceil(share / cap)). kvmap: (64, n, 4 B), 64-row boxes.
// ctx: (B, 4, 32, 32) bf16.
__global__ void __launch_bounds__(kThreads)
    context_kernel(const __grid_constant__ CUtensorMap kvmap, const float* __restrict__ kmax,
                   bf16* __restrict__ ctx, int n, int tpb, int share, int cap, int runs) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cs = static_cast<int>(cluster.num_blocks());
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* rows_p = smem_raw + (base - raw);
  float* part = reinterpret_cast<float*>(rows_p + cap * 128);  // [d][e]
  float* wsum = part + kDh * kDh;                                // [warp][d]
  float* mx = wsum + 8 * kDh;
  float* sb = mx + kDh;
  float* psum = sb + kDh;  // this rank's sums, read by the cluster
  const uint32_t bar = smem_u32(psum + kDh);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.y, b = blockIdx.z;
  const int r0 = rank * share, len = max(0, min(n, r0 + share) - r0);
  const int plane = kHeads * b + h;
  LA_STAMP(0);

  auto run_len = [&](int run) { return min(cap, len - run * cap); };
  int loads = 0;  // TMA loads issued into the run buffer (its mbarrier's phases)
  auto load = [&](int run) {  // thread 0
    const int rl = run_len(run), boxes = ceil_div(rl, 64);
    mbar_expect_tx(bar, boxes * kBlock);
    for (int i = 0; i < boxes; ++i)
      tma_3d(base + i * kBlock, &kvmap, bar, 0, r0 + run * cap + 64 * i, plane);
  };
  if (tid == 0) {
    mbar_init(bar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (len > 0) load(0);
  }
  LA_STAMP(1);
  // the max per d: of the sample's tile maxima (K5a), in any order (four
  // loads in flight a thread)
  {
    const int d = tid & 31, p = tid >> 5;
    const float* km = kmax + static_cast<size_t>(b) * tpb * kHidden + kDh * h + d;
    float m = -INFINITY;
    int t = p;
    for (; t + 24 < tpb; t += 32) {
      const float m0 = __ldg(km + t * kHidden), m1 = __ldg(km + (t + 8) * kHidden);
      const float m2 = __ldg(km + (t + 16) * kHidden), m3 = __ldg(km + (t + 24) * kHidden);
      m = fmaxf(m, fmaxf(fmaxf(m0, m1), fmaxf(m2, m3)));
    }
    for (; t < tpb; t += 8) m = fmaxf(m, __ldg(km + t * kHidden));
    LA_STAMP(2);
    wsum[p * kDh + d] = m;
    __syncthreads();
    if (tid < kDh) {
      float mm = wsum[tid];
      for (int i = 1; i < 8; ++i) mm = fmaxf(mm, wsum[i * kDh + tid]);
      mx[tid] = mm;
    }
    __syncthreads();
  }
  LA_STAMP(3);

  // a thread's rows of a run and its chunk: 4 threads a row (k chunk q, d
  // 8q .. 8q + 7); within a warp, lanes 4i .. 4i + 3 take row 8 w + (i / 2
  // + 4 (i % 2)), so that the eight lanes of a quarter-warp (rows r, r + 4)
  // read eight distinct bank groups
  const int q = lane & 3;
  const int rlo = ((lane >> 2) & 1) * 4 + (lane >> 3);
  uint32_t mq2[4];  // the max of d 8q + 2i, 8q + 2i + 1 as a bf16 pair
#pragma unroll
  for (int i = 0; i < 4; ++i) mq2[i] = bf16x2_rn(mx[8 * q + 2 * i], mx[8 * q + 2 * i + 1]);
  // e = bf16(exp(bf16(k - max))) in place of k (0 past the rank's tokens),
  // summed into s; then (second) p = bf16(e / sum) in place
  auto exps = [&](int rl, float (&s)[8]) {
    const int rows64 = ceil_div(rl, 64) * 64;
    for (int r = 8 * warp + rlo; r < rows64; r += 64) {
      uint4* pk = reinterpret_cast<uint4*>(rows_p + swz(r, q));
      const uint4 v = *pk;
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
      uint32_t o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t d = bsub2(w[i], mq2[i]);
        o[i] = r < rl ? bf16x2_rn(expf(lo_f(d)), expf(hi_f(d))) : 0u;
        s[2 * i] += lo_f(o[i]);
        s[2 * i + 1] += hi_f(o[i]);
      }
      *pk = make_uint4(o[0], o[1], o[2], o[3]);
    }
  };
  auto probs = [&](int rl, const float (&rq)[8]) {
    const int rows64 = ceil_div(rl, 64) * 64;
    for (int r = 8 * warp + rlo; r < rows64; r += 64) {
      uint4* pk = reinterpret_cast<uint4*>(rows_p + swz(r, q));
      const uint4 v = *pk;
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
      uint32_t o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        o[i] = quot2(w[i], rq[2 * i], rq[2 * i + 1]);
      *pk = make_uint4(o[0], o[1], o[2], o[3]);
    }
  };

  // 1. the exps and this rank's sums
  float s[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = 0.f;
  const int nruns = len > 0 ? runs : 0;
  for (int run = 0; run < nruns; ++run) {
    if (run > 0) {
      __syncthreads();  // the last run's readers are done
      if (tid == 0) load(run);
    }
    mbar_wait(bar, loads & 1);
    ++loads;
    LA_STAMP(4);
    exps(run_len(run), s);
    fence_async_smem();  // the next run's TMA overwrites what the exps wrote
  }
  // join the thread sums: lanes of the same q over the warp, then the warps
  // in order
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    s[i] += __shfl_xor_sync(0xffffffffu, s[i], 4);
    s[i] += __shfl_xor_sync(0xffffffffu, s[i], 8);
    s[i] += __shfl_xor_sync(0xffffffffu, s[i], 16);
  }
  if (lane < 4)
#pragma unroll
    for (int i = 0; i < 8; ++i) wsum[warp * kDh + 8 * lane + i] = s[i];
  __syncthreads();
  if (tid < kDh) {
    float t = wsum[tid];
    for (int w = 1; w < 8; ++w) t += wsum[w * kDh + tid];
    psum[tid] = t;
  }
  LA_STAMP(5);
  // 2. the sum over the cluster's ranks in rank order: the same in every CTA
  cluster.sync();
  if (tid < kDh) {
    float t = 0.f;
    for (int rr = 0; rr < cs; ++rr) t += cluster.map_shared_rank(psum, rr)[tid];
    sb[tid] = __frcp_rn(rb(t));  // p = bf16(e / bf16(sum)): quot2
  }
  __syncthreads();
  LA_STAMP(6);
  float rq[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) rq[i] = sb[8 * q + i];

  // 3. p in place and the partial context p^T v: warp (mt, nt) = (warp % 2,
  // warp / 2) on d 16 mt .., e 8 nt .., over all of the rank's tokens
  const int mt = warp & 1, nt = warp >> 1;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int run = 0; run < nruns; ++run) {
    const int rl = run_len(run);
    if (nruns > 1) {  // reload the run and take its exps again
      __syncthreads();
      if (tid == 0) load(run);
      mbar_wait(bar, loads & 1);
      ++loads;
      float unused[8] = {};
      exps(rl, unused);
    }
    probs(rl, rq);
    __syncthreads();
    LA_STAMP(7);
    // A = p^T (d x tokens) from [token][d] rows: ldmatrix.trans of (tokens
    // k0 + 8 (l / 16) + l % 8, d chunk 2 mt + (l / 8) % 2); B = v: (tokens k0 +
    // 8 ((l / 8) % 2) + l % 8, v chunk 4 + nt)
    const int ra = (lane & 7) + 8 * (lane >> 4), ca = 2 * mt + ((lane >> 3) & 1);
    const int rbv = (lane & 7) + 8 * ((lane >> 3) & 1);
    for (int k0 = 0; k0 < rl; k0 += 16) {
      uint32_t a[4], b0, b1;
      ldsm_x4_t(base + swz(k0 + ra, ca), a);
      ldsm_x2_t(base + swz(k0 + rbv, 4 + nt), b0, b1);
      mma16816(acc, a, b0, b1);
    }
    fence_async_smem();
  }
  LA_STAMP(8);
  {
    const int d = 16 * mt + (lane >> 2), e = 8 * nt + 2 * q;
    part[d * kDh + e] = acc[0];
    part[d * kDh + e + 1] = acc[1];
    part[(d + 8) * kDh + e] = acc[2];
    part[(d + 8) * kDh + e + 1] = acc[3];
  }
  // 4. the partials added in rank order, rounded; rank r stores entries r
  // 256 .. (each once)
  cluster.sync();
  bf16* out = ctx + static_cast<size_t>(plane) * kDh * kDh;
  for (int i = tid + kThreads * rank; i < kDh * kDh; i += kThreads * cs) {
    float t = 0.f;
    for (int rr = 0; rr < cs; ++rr) t += cluster.map_shared_rank(part, rr)[i];
    out[i] = __float2bfloat16_rn(t);
  }
  LA_STAMP(9);
  cluster.sync();  // no CTA leaves while another may still read its shared memory
  if (tid == 0) hopper_tma::mbar_inval(bar);
}

// ---------------------------------------------------------------------------
// K6b: the softmax core
// ---------------------------------------------------------------------------

constexpr int kAttnQ = 64;      // queries a CTA, 16 a warp
constexpr int kRowS = kDh + 8;  // a staged row of 32 bf16 (80 bytes: conflict-free fragments)

// grid (ceil(n / 64), 4, B), 128 threads. qkv: (B, n, 384) bf16 (q scaled);
// ao: (B, n, 128) bf16.
__global__ void __launch_bounds__(128)
    attn_core_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ ao, int n) {
  __shared__ __align__(16) bf16 Qs[kAttnQ * kRowS], Ks[64 * kRowS], Vs[64 * kRowS];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kAttnQ;
  const bf16* base = qkv + static_cast<size_t>(b) * n * kQkv + h * kDh;
  auto stage = [&](bf16* dst, int r0, int col) {  // 64 rows x 32 columns, zeros past n
    for (int i = tid; i < 64 * 4; i += 128) {
      const int r = i >> 2, c = 8 * (i & 3);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < n)
        v = __ldg(reinterpret_cast<const uint4*>(base + static_cast<size_t>(r0 + r) * kQkv +
                                                 col + c));
      *reinterpret_cast<uint4*>(dst + r * kRowS + c) = v;
    }
  };
  stage(Qs, q0, 0);
  __syncthreads();
  uint32_t qa[2][4];  // the warp's 16 queries, d 16 ks ..
  {
    const bf16* qr = Qs + (16 * warp + g) * kRowS + 2 * t;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      qa[ks][0] = *reinterpret_cast<const uint32_t*>(qr + 16 * ks);
      qa[ks][1] = *reinterpret_cast<const uint32_t*>(qr + 8 * kRowS + 16 * ks);
      qa[ks][2] = *reinterpret_cast<const uint32_t*>(qr + 16 * ks + 8);
      qa[ks][3] = *reinterpret_cast<const uint32_t*>(qr + 8 * kRowS + 16 * ks + 8);
    }
  }
  const int tiles = ceil_div(n, 64);
  int held = -1;  // the key tile Ks and Vs hold
  auto scores = [&](int kt, float (&sc)[8][4]) {
    if (kt != held) {
      __syncthreads();
      stage(Ks, 64 * kt, kHidden);
      stage(Vs, 64 * kt, 2 * kHidden);
      __syncthreads();
      held = kt;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
      const bf16* kr = Ks + (8 * j + g) * kRowS + 2 * t;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
        mma16816(sc[j], qa[ks], *reinterpret_cast<const uint32_t*>(kr + 16 * ks),
                 *reinterpret_cast<const uint32_t*>(kr + 16 * ks + 8));
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[j][e] = 64 * kt + 8 * j + 2 * t + (e & 1) < n ? rb(sc[j][e]) : -INFINITY;
    }
  };
  float sc[8][4];
  float m0 = -INFINITY, m1 = -INFINITY;  // rows g, g + 8
  for (int kt = 0; kt < tiles; ++kt) {
    scores(kt, sc);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      m0 = fmaxf(m0, fmaxf(sc[j][0], sc[j][1]));
      m1 = fmaxf(m1, fmaxf(sc[j][2], sc[j][3]));
    }
  }
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
  float l0 = 0.f, l1 = 0.f;
  for (int kt = 0; kt < tiles; ++kt) {
    scores(kt, sc);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      l0 += expf(sc[j][0] - m0) + expf(sc[j][1] - m0);
      l1 += expf(sc[j][2] - m1) + expf(sc[j][3] - m1);
    }
  }
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  float o[4][4] = {};
  const int rv = (lane & 7) + 8 * ((lane >> 3) & 1), cv = 8 * (lane >> 4);
  for (int kt = 0; kt < tiles; ++kt) {
    scores(kt, sc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // keys 16 kk .. 16 kk + 15
      uint32_t pa[4];
      pa[0] = bf16x2_rn(__fdiv_rn(expf(sc[2 * kk][0] - m0), l0),
                        __fdiv_rn(expf(sc[2 * kk][1] - m0), l0));
      pa[1] = bf16x2_rn(__fdiv_rn(expf(sc[2 * kk][2] - m1), l1),
                        __fdiv_rn(expf(sc[2 * kk][3] - m1), l1));
      pa[2] = bf16x2_rn(__fdiv_rn(expf(sc[2 * kk + 1][0] - m0), l0),
                        __fdiv_rn(expf(sc[2 * kk + 1][1] - m0), l0));
      pa[3] = bf16x2_rn(__fdiv_rn(expf(sc[2 * kk + 1][2] - m1), l1),
                        __fdiv_rn(expf(sc[2 * kk + 1][3] - m1), l1));
#pragma unroll
      for (int np = 0; np < 2; ++np) {  // e 16 np .. 16 np + 15: two n-tiles
        uint32_t bv[4];
        ldsm_x4_t(smem_u32(Vs + (16 * kk + rv) * kRowS + 16 * np + cv), bv);
        mma16816(o[2 * np], pa, bv[0], bv[1]);
        mma16816(o[2 * np + 1], pa, bv[2], bv[3]);
      }
    }
  }
  const int r0 = q0 + 16 * warp + g;
  bf16* out = ao + (static_cast<size_t>(b) * n) * kHidden + h * kDh;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int e = 8 * j + 2 * t;
    if (r0 < n)
      *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(r0) * kHidden + e) =
          bf16x2_rn(o[j][0], o[j][1]);
    if (r0 + 8 < n)
      *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(r0 + 8) * kHidden + e) =
          bf16x2_rn(o[j][2], o[j][3]);
  }
}

// ---------------------------------------------------------------------------
// K5c and K6c: the output side
// ---------------------------------------------------------------------------

struct OutMaps {
  CUtensorMap x, y, wqkv, wo, ao;  // x, y (C, n, B); K6: ao (128, n, B)
};

// Per-tile input buffer: the x tile (then y); K6 also the attention output
// (2 blocks). K5's A region (the ChanLN'd tile, then the attention output)
// and context tiles.
__host__ __device__ constexpr int out_buf(int C, bool linear) {
  return a_bytes(C) + (linear ? 0 : 2 * kBlock);
}
__host__ __device__ constexpr int out_rest(int C, bool linear, int nbuf) {
  // 1024 to align, the buffers, A, the contexts, the row partials (4 x 64
  // floats), mbarriers (ring and 2 x), norm_g, out_g and bf16(bo) (C floats
  // each)
  return 1024 + nbuf * out_buf(C, linear) +
         (linear ? (a_bytes(C) > 2 * kBlock ? a_bytes(C) : 2 * kBlock) + kHeads * kCtxTile : 0) +
         4 * kTile * 4 + 8 * (16 + 2) + 3 * 4 * C;
}

// grid (CTAs): each CTA a contiguous share of the B tpb tiles. The weight
// ring: D stages of 64 k x 128 columns (K5: the q columns of wqkv, KB
// stages, then per 128-column block cb of the output two stages of wo;
// K6: wo's alone), resident where D holds them all. ctx (K5): (B, 4, 32,
// 32) bf16.
template <bool LINEAR, int NB>
__global__ void __launch_bounds__(kThreads, 1)
    output_kernel(const __grid_constant__ OutMaps maps, const float* __restrict__ g,
                  const bf16* __restrict__ ctx, const float* __restrict__ bo,
                  const float* __restrict__ og, int n, int C, int tpb, int tiles, int D,
                  int nbuf) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sbase = smem_raw + (base - raw);
  const int KB = ceil_div(C, 64);
  const int bufb = out_buf(C, LINEAR);
  const int areg = a_bytes(C) > 2 * kBlock ? a_bytes(C) : 2 * kBlock;
  const uint32_t bufs = base + D * kStage;
  const uint32_t A = bufs + nbuf * bufb;  // K5 only
  const uint32_t Ct = A + areg;           // K5 only
  float* red = reinterpret_cast<float*>(
      sbase + (bufs - base) + nbuf * bufb + (LINEAR ? areg + kHeads * kCtxTile : 0));
  const uint32_t bars = smem_u32(red + 4 * kTile);  // D ring, 2 x
  float* gs = red + 4 * kTile + 2 * (16 + 2);  // norm_g, then out_g, then bf16(bo)
  float* ogs = gs + C;
  float* bos = ogs + C;
  const int tid = threadIdx.x, wg = tid >> 7;
  const Share sh(tiles);
  const int ntiles = sh.end - sh.begin;
  const int total = (LINEAR ? KB : 0) + 2 * NB;  // ring stages a tile
  const bool resident = D >= total;
  const int stages_all = resident ? total : ntiles * total;

  auto issue = [&](int st) {  // ring stage st into slot st % D
    const uint32_t bar = bars + 8 * (st % D), dst = base + (st % D) * kStage;
    const int sl = st % total;
    mbar_expect_tx(bar, kStage);
    if (LINEAR && sl < KB) {
      tma_2d(dst, &maps.wqkv, bar, 0, 64 * sl);
      tma_2d(dst + kAtom, &maps.wqkv, bar, 64, 64 * sl);
    } else {
      const int s2 = sl - (LINEAR ? KB : 0), cb = s2 >> 1, kr = 64 * (s2 & 1);
      tma_2d(dst, &maps.wo, bar, 128 * cb, kr);
      tma_2d(dst + kAtom, &maps.wo, bar, 128 * cb + 64, kr);
    }
  };
  auto issue_x = [&](int it) {
    const int tile = sh.begin + it, b = tile / tpb, t0 = (tile % tpb) * kTile;
    const uint32_t bar = bars + 8 * (D + it % nbuf), dst = bufs + (it % nbuf) * bufb;
    mbar_expect_tx(bar, (KB + (LINEAR ? 0 : 2)) * kBlock);
    for (int kb = 0; kb < KB; ++kb) tma_3d(dst + kb * kBlock, &maps.x, bar, 64 * kb, t0, b);
    if (!LINEAR)
      for (int kb = 0; kb < 2; ++kb)
        tma_3d(dst + (KB + kb) * kBlock, &maps.ao, bar, 64 * kb, t0, b);
  };
  if (tid == 0) {
    for (int i = 0; i < D + 2; ++i) mbar_init(bars + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int st = 0; st < min(D, stages_all); ++st) issue(st);
    if (ntiles > 0) issue_x(0);
  }
  if (LINEAR) {
    stage_vec(g, gs, C, false, tid);
    stage_vec(og, ogs, C, false, tid);
  }
  stage_vec(bo, bos, C, true, tid);
  __syncthreads();
  // stage `st` of the CTA's sequence: wait for it, the warpgroup's
  // products, and when a later stage takes its slot, free it for thread 0
  auto consume = [&](float (&acc)[32], int st, uint32_t a_blk) {
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

  int cached = -1;  // the sample whose context tiles Ct holds
#pragma unroll 1
  for (int it = 0; it < ntiles; ++it) {
    // the thread's index made opaque each tile, so that the compiler
    // recomputes what it derives instead of holding it across the loop
    int tx = threadIdx.x;
    asm volatile("" : "+r"(tx));
    const int lane = tx & 31, wi = (tx >> 5) & 3, gq = lane >> 2, tq = lane & 3;
    const int rl0 = 16 * wi + gq;
    const int tile = sh.begin + it, b = tile / tpb, t0 = (tile % tpb) * kTile;
    [[maybe_unused]] const int stamp = 10 * min(it, 5);  // LA_STAMP slots
    LA_STAMP(stamp);
    // the copies of tile nx: with one buffer this tile's, here; with two
    // the next one's, once this tile's x is in (so that the store of the
    // tile before, which read the other buffer, has had time to finish)
    auto prefetch = [&](int nx) {
      if (tx == 0 && nx > 0 && nx < ntiles) {
        bulk_wait_read();  // the store that read the buffer is done with it
        issue_x(nx);
      }
    };
    if (nbuf == 1) prefetch(it);
    const uint32_t X = bufs + (it % nbuf) * bufb;
    unsigned char* Xp = sbase + (X - base);
    uint32_t a2 = X + KB * kBlock;  // the attention output (K6: as loaded)

    if constexpr (LINEAR) {
      if (b != cached) {  // the sample's context as K-major B tiles: row e, d 0..31
        const bf16* cb = ctx + static_cast<size_t>(b) * kHeads * kDh * kDh;
        unsigned char* T = sbase + (Ct - base);
        for (int i = tx; i < kHeads * kDh * kDh / 8; i += kThreads) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(cb) + i);
          const int hd = i >> 7, d = (i >> 2) & 31, e0 = 8 * (i & 3);
          const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const uint16_t val = static_cast<uint16_t>(k & 1 ? w[k >> 1] >> 16 : w[k >> 1]);
            *reinterpret_cast<uint16_t*>(T + hd * kCtxTile + swz(e0 + k, d >> 3) +
                                         2 * (d & 7)) = val;
          }
        }
        cached = b;
      }
    }
    mbar_wait(bars + 8 * (D + it % nbuf), (it / nbuf) & 1);
    LA_STAMP(stamp + 1);

    if constexpr (LINEAR) {
      chan_ln_tile(Xp, sbase + (A - base), C, gs, tx);
      fence_async_smem();
      __syncthreads();
      LA_STAMP(stamp + 2);
      if (nbuf == 2) prefetch(it + 1);
      LA_STAMP(stamp + 3);
      // q of heads 2 wg, 2 wg + 1
      float qa[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) qa[i] = 0.f;
#pragma unroll 1
      for (int kb = 0; kb < KB; ++kb) consume(qa, it * total + kb, A + kb * kBlock);
      __syncthreads();  // both warpgroups are done with A: it takes the attention output
      LA_STAMP(stamp + 4);
      // q rounded; the softmax over each head's 32 channels (a row's 32
      // values of head hl lie in its four lanes tq, 8 each), times the
      // scale; the results as bf16 pairs qp[hl][block][row half], which are
      // the A fragments of the context product
      const uint32_t scale2 = bpair(bf_scale());
      uint32_t qp[2][4][2];
#pragma unroll
      for (int hl = 0; hl < 2; ++hl)
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          float m = -INFINITY;  // of the sums: rounding keeps their order
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            m = fmaxf(m, fmaxf(qa[4 * (4 * hl + kk) + 2 * rh], qa[4 * (4 * hl + kk) + 2 * rh + 1]));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
          const uint32_t m2 = bpair(rb(m));
          float s = 0.f;
          uint32_t e2[4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {  // bf16(exp(bf16(bf16(q) - max)))
            const float* v = qa + 4 * (4 * hl + kk) + 2 * rh;
            const uint32_t d = bsub2(bf16x2_rn(v[0], v[1]), m2);
            e2[kk] = bf16x2_rn(expf(lo_f(d)), expf(hi_f(d)));
            s += lo_f(e2[kk]) + hi_f(e2[kk]);
          }
          s += __shfl_xor_sync(0xffffffffu, s, 1);
          s += __shfl_xor_sync(0xffffffffu, s, 2);
          const float rq = __frcp_rn(rb(s));
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)  // bf16(bf16(e / sum) scale)
            qp[hl][kk][rh] = bmul2(quot2(e2[kk], rq, rq), scale2);
        }
      LA_STAMP(stamp + 5);
      // out = bf16(context^T q) per head: wgmma m64n32k16, q from registers
      // (for d 16 kk .. the A fragment holds blocks 2 kk and 2 kk + 1 of the
      // head), the context's K-major tile
#pragma unroll
      for (int hl = 0; hl < 2; ++hl) {
        const uint32_t bt = Ct + (2 * wg + hl) * kCtxTile;
        uint32_t af[2][4];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          af[kk][0] = qp[hl][2 * kk][0];
          af[kk][1] = qp[hl][2 * kk][1];
          af[kk][2] = qp[hl][2 * kk + 1][0];
          af[kk][3] = qp[hl][2 * kk + 1][1];
        }
        float o16[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) o16[i] = 0.f;
        igemm_tc::fence_frags(af);
        igemm_tc::wgmma_fence();
        igemm_tc::fence_acc(o16);
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) mma_rs32(o16, af[kk], desc_sw128(bt + 32 * kk));
        igemm_tc::wgmma_commit();
        wgmma_wait<0>();
        igemm_tc::fence_acc(o16);
        igemm_tc::fence_frags(af);
        unsigned char* Ap = sbase + (A - base);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = (2 * wg + hl) * kDh + 8 * j + 2 * tq;
          *reinterpret_cast<uint32_t*>(Ap + at(rl0, c)) = bf16x2_rn(o16[4 * j], o16[4 * j + 1]);
          *reinterpret_cast<uint32_t*>(Ap + at(rl0 + 8, c)) =
              bf16x2_rn(o16[4 * j + 2], o16[4 * j + 3]);
        }
      }
      a2 = A;
      fence_async_smem();
      __syncthreads();
      LA_STAMP(stamp + 6);
    }

    // the out-projection, block cb's columns 128 cb + 64 wg ..: o = bf16(
    // bf16(sum) + bf16(bo)), kept as bf16 pairs; K5: the row sums for the
    // out-ChanLN
    uint32_t ov[NB][16];
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) {
      float ya[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) ya[i] = 0.f;
#pragma unroll
      for (int kr = 0; kr < 2; ++kr)
        consume(ya, it * total + (LINEAR ? KB : 0) + 2 * cb + kr, a2 + kr * kBlock);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 128 * cb + 64 * wg + 8 * j + 2 * tq, cc = c < C ? c : 0;
        const uint32_t b2 = bf16x2_rn(bos[cc], bos[cc + 1]);
        ov[cb][2 * j] = badd2(bf16x2_rn(ya[4 * j], ya[4 * j + 1]), b2);
        ov[cb][2 * j + 1] = badd2(bf16x2_rn(ya[4 * j + 2], ya[4 * j + 3]), b2);
        if (LINEAR && c < C) {
          s0 += lo_f(ov[cb][2 * j]) + hi_f(ov[cb][2 * j]);
          s1 += lo_f(ov[cb][2 * j + 1]) + hi_f(ov[cb][2 * j + 1]);
        }
      }
    }
    if (!LINEAR && nbuf == 2) prefetch(it + 1);
    LA_STAMP(stamp + 7);
    uint32_t mb2[2] = {0u, 0u}, rs2[2] = {0u, 0u};  // the out-ChanLN's bf16 statistics
    if constexpr (LINEAR) {  // the out-ChanLN's statistics: fp32 mean, variance
      auto row_sum = [&](float& v0, float& v1, float* dst) {
        v0 += __shfl_xor_sync(0xffffffffu, v0, 1);
        v0 += __shfl_xor_sync(0xffffffffu, v0, 2);
        v1 += __shfl_xor_sync(0xffffffffu, v1, 1);
        v1 += __shfl_xor_sync(0xffffffffu, v1, 2);
        if (tq == 0) {
          dst[wg * kTile + rl0] = v0;
          dst[wg * kTile + rl0 + 8] = v1;
        }
      };
      row_sum(s0, s1, red);
      __syncthreads();
      const float m0 = (red[rl0] + red[kTile + rl0]) * (1.f / static_cast<float>(C));
      const float m1 = (red[rl0 + 8] + red[kTile + rl0 + 8]) * (1.f / static_cast<float>(C));
      float v0 = 0.f, v1 = 0.f;
#pragma unroll
      for (int cb = 0; cb < NB; ++cb)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = 128 * cb + 64 * wg + 8 * j + 2 * tq;
          if (c < C) {
            const float a0 = lo_f(ov[cb][2 * j]) - m0, a1 = hi_f(ov[cb][2 * j]) - m0;
            const float a2_ = lo_f(ov[cb][2 * j + 1]) - m1, a3 = hi_f(ov[cb][2 * j + 1]) - m1;
            v0 += a0 * a0 + a1 * a1;
            v1 += a2_ * a2_ + a3 * a3;
          }
        }
      row_sum(v0, v1, red + 2 * kTile);
      __syncthreads();
      const float eps = bf_eps(), inv_c = 1.f / static_cast<float>(C);
      mb2[0] = bpair(rb(m0));
      mb2[1] = bpair(rb(m1));
      rs2[0] = bpair(rb(__frsqrt_rn(rb(rb((red[2 * kTile + rl0] + red[3 * kTile + rl0]) * inv_c) +
                                       eps))));
      rs2[1] = bpair(rb(__frsqrt_rn(
          rb(rb((red[2 * kTile + rl0 + 8] + red[3 * kTile + rl0 + 8]) * inv_c) + eps))));
    }
    LA_STAMP(stamp + 8);
    // y = bf16(x + h) over the staged x (each element read and written by
    // one thread; a block's 16 x pairs loaded before any is written, so that
    // the loads are in flight together); h: K5 the out-ChanLN times out_g,
    // K6 o
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) {
      uint32_t xv[16];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int c = 128 * cb + 64 * wg + 8 * j + 2 * tq;
          xv[2 * j + hh] = *reinterpret_cast<const uint32_t*>(Xp + at(rl0 + 8 * hh, c < C ? c : 0));
        }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 128 * cb + 64 * wg + 8 * j + 2 * tq;
        if (c >= C) continue;
        const float2 gv = LINEAR ? make_float2(ogs[c], ogs[c + 1]) : make_float2(1.f, 1.f);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const uint32_t x2 = xv[2 * j + hh], o = ov[cb][2 * j + hh];
          uint32_t y2;
          if (LINEAR) {  // x + bf16(bf16(o - mean) rstd) out_g in fp32, rounded once
            const uint32_t u = bmul2(bsub2(o, mb2[hh]), rs2[hh]);
            y2 = bf16x2_rn(__fadd_rn(lo_f(x2), __fmul_rn(lo_f(u), gv.x)),
                           __fadd_rn(hi_f(x2), __fmul_rn(hi_f(u), gv.y)));
          } else {
            y2 = badd2(x2, o);
          }
          *reinterpret_cast<uint32_t*>(Xp + at(rl0 + 8 * hh, c)) = y2;
        }
      }
    }
    fence_async_smem();
    __syncthreads();
    if (tx == 0) {
      for (int kb = 0; kb < KB; ++kb) tma_store_3d(&maps.y, X + kb * kBlock, 64 * kb, t0, b);
      bulk_commit();
    }
    LA_STAMP(stamp + 9);
  }
  if (tid == 0) bulk_wait_all();
  release_bars(bars, D + 2);
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// CTAs of `kernel` (256 threads, `smem` bytes) that the card holds at once,
// per (kernel, smem), cached; times the SM count.
int resident_ctas(const void* kernel, int smem) {
  struct Entry {
    const void* fn;
    int smem, ctas;
  };
  static std::mutex mu;
  static Entry cache[256];
  static int used = 0, sms = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i)
    if (cache[i].fn == kernel && cache[i].smem == smem) return cache[i].ctas;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return -1;
  }
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem) !=
      cudaSuccess)
    return -1;
  const int ctas = (per_sm > 0 ? per_sm : 1) * sms;
  if (used < 256) cache[used++] = {kernel, smem, ctas};
  return ctas;
}

// The kernel's dynamic shared memory limit set to the most a block may
// take, once per kernel (`set`: the caller's flag for that kernel).
template <class K>
cudaError_t smem_limit(K kernel, bool& set) {
  if (set) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  set = e == cudaSuccess;
  return e;
}

// The 3-D map of a (z, y, x) bf16 tensor read and written in 64 x 64 boxes
// (x innermost, 128-byte swizzle; zeros past its bounds when read, nothing
// written past them).
cudaError_t act_map(CUtensorMap* out, const void* p, int x, int y, int z) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(x), static_cast<cuuint64_t>(y),
                              static_cast<cuuint64_t>(z)};
  const cuuint64_t strides[2] = {2ull * x, 2ull * x * y};
  const cuuint32_t box[3] = {64, 64, 1}, one[3] = {1, 1, 1};
  return hopper_tma::tensor_map(out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, p, dims, strides, box,
                                one);
}

template <bool LINEAR, int NA>
cudaError_t launch_proj(const ProjMaps& maps, const float* g, float* kmax, int B, int n, int C,
                        int y, cudaStream_t st) {
  auto kernel = proj_kernel<LINEAR, NA>;
  static bool set = false;
  cudaError_t e = smem_limit(kernel, set);
  if (e != cudaSuccess) return e;
  const int nbuf = proj_smem(C, NA, 2) <= kMaxSmem ? 2 : 1, smem = proj_smem(C, NA, nbuf);
  const int tpb = ceil_div(n, kTile), tiles = B * tpb;
  const int res = resident_ctas(reinterpret_cast<const void*>(kernel), smem);
  if (res < 1) return cudaErrorInvalidValue;
  const int ctas = std::min(tiles, res / y);
  kernel<<<dim3(ctas, y), kThreads, smem, st>>>(maps, g, kmax, n, C, tpb, tiles, nbuf);
  return cudaGetLastError();
}

template <bool LINEAR, int NB>
cudaError_t launch_out(const OutMaps& maps, const float* g, const bf16* ctx, const float* bo,
                       const float* og, int B, int n, int C, cudaStream_t st) {
  auto kernel = output_kernel<LINEAR, NB>;
  static bool set = false;
  cudaError_t e = smem_limit(kernel, set);
  if (e != cudaSuccess) return e;
  const int total = (LINEAR ? ceil_div(C, 64) : 0) + 2 * NB;
  const int nbuf = out_rest(C, LINEAR, 2) + total * kStage <= kMaxSmem ? 2 : 1;
  const int D = std::min(total, (kMaxSmem - out_rest(C, LINEAR, nbuf)) / kStage);
  if (D < 1) return cudaErrorInvalidValue;
  const int smem = D * kStage + out_rest(C, LINEAR, nbuf);
  const int tpb = ceil_div(n, kTile), tiles = B * tpb;
  const int res = resident_ctas(reinterpret_cast<const void*>(kernel), smem);
  if (res < 1) return cudaErrorInvalidValue;
  kernel<<<std::min(tiles, res), kThreads, smem, st>>>(maps, g, ctx, bo, og, n, C, tpb, tiles, D,
                                                  nbuf);
  return cudaGetLastError();
}

template <bool LINEAR>
cudaError_t launch_out_nb(const OutMaps& maps, const float* g, const bf16* ctx, const float* bo,
                          const float* og, int B, int n, int C, cudaStream_t st) {
  switch (ceil_div(C, 128)) {
    case 1: return launch_out<LINEAR, 1>(maps, g, ctx, bo, og, B, n, C, st);
    case 2: return launch_out<LINEAR, 2>(maps, g, ctx, bo, og, B, n, C, st);
    case 3: return launch_out<LINEAR, 3>(maps, g, ctx, bo, og, B, n, C, st);
    default: return launch_out<LINEAR, 4>(maps, g, ctx, bo, og, B, n, C, st);
  }
}

cudaError_t launch_context(const CUtensorMap& kvmap, const float* kmax, bf16* ctx, int B, int n,
                           int cs, int share, cudaStream_t st) {
  static bool set = false;
  if (!set) {
    const cudaError_t e = cudaFuncSetAttribute(
        context_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ctx_smem(kRun));
    if (e != cudaSuccess) return e;
    set = true;
  }
  const int cap = std::min(kRun, ceil_div(share, 64) * 64);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, kHeads, B);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = ctx_smem(cap);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, context_kernel, kvmap, kmax, ctx, n, ceil_div(n, kTile), share,
                            cap, ceil_div(share, cap));
}

bool bad_dims(int B, int n, int C) {
  return B < 1 || B > 65535 || n < 1 || C < 8 || C > kMaxC || C % 8 ||
         static_cast<long long>(B) * n * kQkv > 0x7fffffffLL;
}

}  // namespace

// K5 on bf16 activations. dims: {B, n, C, head groups (1 or 2; 2 wherever
// C > 256), cluster size cs (1 .. 8), share (tokens a rank, (cs - 1) share
// < n <= cs share): kernels/attention.py: bf16act_plan; stages: a mask of
// K5a (1), K5b (2) and K5c (4), 7 on the main path (one alone reads what
// the stage before it last wrote to the scratch; for timing)}. scratch
// (bf16 elements): k | v head-major, B 4 n 64; the contexts, B 4096; the
// tile maxima, B ceil(n / 64) 128 fp32. Three launches on `stream`.
extern "C" int linear_attention_bf16act(const bf16* x, const float* norm_g, const bf16* wqkv,
                                        const bf16* wo, const float* bo, const float* out_g,
                                        bf16* scratch, bf16* out, const int* dims,
                                        void* stream) {
  const int B = dims[0], n = dims[1], C = dims[2], G = dims[3], cs = dims[4], share = dims[5],
            stages = dims[6];
  if (bad_dims(B, n, C) || (G != 1 && G != 2) || (G == 1 && C > 256) || stages < 1 ||
      stages > 7 || cs < 1 ||
      cs > kMaxCluster || share < 1 || static_cast<long long>(cs) * share < n ||
      static_cast<long long>(cs - 1) * share >= n)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16* kv = scratch;
  bf16* ctx = kv + static_cast<size_t>(B) * kHeads * n * 2 * kDh;
  float* kmax = reinterpret_cast<float*>(ctx + static_cast<size_t>(B) * kHeads * kDh * kDh);
  ProjMaps pm;
  OutMaps om;
  cudaError_t e = act_map(&pm.x, x, C, n, B);
  if (e == cudaSuccess) e = hopper_tma::weight_map(&pm.w, wqkv, C, kQkv, kQkv);
  if (e == cudaSuccess) e = act_map(&pm.dst, kv, 2 * kDh, n, kHeads * B);
  if (e == cudaSuccess) e = act_map(&om.y, out, C, n, B);
  if (e == cudaSuccess) e = hopper_tma::weight_map(&om.wo, wo, kHidden, C, C);
  if (e != cudaSuccess) return static_cast<int>(e);
  om.x = pm.x;
  om.wqkv = pm.w;
  om.ao = pm.x;  // unused
  if (stages & 1)
    e = G == 1 ? launch_proj<true, 2>(pm, norm_g, kmax, B, n, C, 1, s)
               : launch_proj<true, 1>(pm, norm_g, kmax, B, n, C, 2, s);
  if (e == cudaSuccess && (stages & 2))
    e = launch_context(pm.dst, kmax, ctx, B, n, cs, share, s);
  if (e == cudaSuccess && (stages & 4))
    e = launch_out_nb<true>(om, norm_g, ctx, bo, out_g, B, n, C, s);
  return static_cast<int>(e);
}

// K6 on bf16 activations. dims: {B, n, C}. scratch: B n 384 + B n 128 bf16
// (q | k | v rows, then the attention output). Three launches on `stream`.
extern "C" int attention_bf16act(const bf16* x, const float* norm_g, const bf16* wqkv,
                                 const bf16* wo, const float* bo, bf16* out, bf16* scratch,
                                 const int* dims, void* stream) {
  const int B = dims[0], n = dims[1], C = dims[2];
  if (bad_dims(B, n, C)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16* qkv = scratch;
  bf16* ao = scratch + static_cast<size_t>(B) * n * kQkv;
  ProjMaps pm;
  OutMaps om;
  cudaError_t e = act_map(&pm.x, x, C, n, B);
  if (e == cudaSuccess) e = hopper_tma::weight_map(&pm.w, wqkv, C, kQkv, kQkv);
  if (e == cudaSuccess) e = act_map(&pm.dst, qkv, kQkv, n, B);
  if (e == cudaSuccess) e = act_map(&om.y, out, C, n, B);
  if (e == cudaSuccess) e = hopper_tma::weight_map(&om.wo, wo, kHidden, C, C);
  if (e == cudaSuccess) e = act_map(&om.ao, ao, kHidden, n, B);
  if (e != cudaSuccess) return static_cast<int>(e);
  om.x = pm.x;
  om.wqkv = pm.w;  // unused
  e = launch_proj<false, 1>(pm, norm_g, nullptr, B, n, C, 3, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  attn_core_kernel<<<dim3(ceil_div(n, kAttnQ), kHeads, B), 128, 0, s>>>(qkv, ao, n);
  e = cudaGetLastError();
  if (e == cudaSuccess) e = launch_out_nb<false>(om, nullptr, nullptr, bo, nullptr, B, n, C, s);
  return static_cast<int>(e);
}
