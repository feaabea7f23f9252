// The persistent, warp-specialised implicit-GEMM tile of K1c and K2c: K1
// and K2 on bf16 activations (conv2d_nhwc_bf16act, downsample_nhwc_bf16act
// in igemm_bf16act.cu), redesigned for Hopper.
//
// Replaces the convolutions of diffphycon_tpu/research/pallas_unet2d.py
// (_conv_kernel :288, _upsample_kernel :279, _matmul_bias_kernel :294,
// _concat_kernel :304, the convs in _resblock_kernel :160 and
// _downsample_kernel :259) as the JAX net computes them under
// dtype=bfloat16: out[m, n] = bf16(bf16(sum_k A[m, k] W[k, n]) +
// bf16(bias[n])), bf16 x bf16 products summed in fp32. A is the bf16 NHWC
// activation as the conv reads it (im2col, the skip concat, the nearest-2x
// upsample, K2's 2x2 window), W the packed (K, N) bf16 weight.
//
// Bound: max(flops / 989 TFLOP/s, bytes / 3.35 TB/s) with 2-byte
// activations; every main-path signature is bound by its operations (the
// 64-channel 3x3 convs' 1152 flops per 2-byte input value).
//
// What held the weight-only core (igemm_bf16.cuh, which K1b, K2b and the
// persistent kernel's bf16 instance keep running) back on bf16 activations,
// and what this tile does about it:
// 1. One CTA per output tile, each with its own prologue and epilogue.
//    Here the grid is at most one CTA an SM (column groups, N tiles x
//    splits, times CTAs a group: unet2d_blocks.act_ctas), and each CTA walks
//    its group's 128-row tiles (tile += CTAs a group); the rings and their
//    mbarriers carry from tile to tile.
// 2. The weights re-read for every tile. Where the split's (K, BN) slice
//    fits beside the A operand (`hold`), the CTA loads it once, a barrier a
//    stage so that the first tile starts on the first stage; else it
//    streams through the ring.
// 3. A re-read for every tap. For the 3x3 convs whose tile is whole image
//    rows or part of one (bw = 128 x bh = 1, bw = 64 x bh = 2: the 16 x 128
//    and 8 x 64 levels), the producer loads per 64-channel block one halo
//    box of (bh + 2) x (bw + 2) pixels (zeros outside the image), and the
//    nine taps are descriptor views into it, 128 bytes a pixel (desc_k: the
//    card takes the swizzle's phase from the address). A is read from L2
//    (bh + 2)(bw + 2) / (bh bw) times a value instead of 9. A tile's halos
//    are resident together, so the k order stays taps outer, channel
//    blocks inner. Halos go with held weights (and then two or three
//    tiles' halos are resident); where the weights would have to stream
//    beside them but fit beside per-tap boxes, the boxes take them
//    (make_layout). Elsewhere a ring stage is one tap x 64 channels as a TMA
//    box (igemm_bf16.cuh's box rule, the upsample by parity class, K2 at
//    traversal stride 2), or by the cp.async gather (channel counts off
//    64, grids no tile divides).
// 4. A through registers. Here both operands come from shared memory by
//    descriptor: A K-major in the 128-byte swizzle as TMA (or the gather)
//    writes it, W MN-major as in igemm_bf16.cuh.
// 5. No producer / consumer split. Here warpgroup 0 is the producer (one
//    thread issues every TMA; all 128 threads with the gather, which
//    completes on the stage's mbarrier by cp.async.mbarrier.arrive), the
//    other two consume; full / empty mbarrier pairs, no CTA-wide barrier
//    in the loop, setmaxnreg moves registers to the consumers. At BN <= 128
//    with two tiles or more a CTA, the consumers take turns at whole tiles
//    (ping-pong: two accumulator sets a warpgroup, an mbarrier handshake
//    so that one's epilogue runs while the other's products do); else both
//    work on every tile, 64 rows each. With halos and held weights there is
//    no ring: a tile's products are one group, and its epilogue is staged
//    in its own halo set and stored by TMA.
// The epilogue: flax's roundings as a packed conversion and a bf16x2 add
// (bf16x2.cuh), the bias rounded once a CTA into shared memory. Numerics:
// the k order of the old core (stages of 64 k, t = k0 / ci), its split-K
// and its rounding, so the outputs are bit-equal to it wherever the split
// is the same. Split-K partials are fp32 and splitk_reduce_bf16act adds
// them in split order.
//
// Contract (the wrapper checks): N a multiple of 8, every channel count a
// multiple of 8, every pointer 16-byte aligned; BM = 128.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "conv_gathers.cuh"
#include "igemm_bf16.cuh"  // Geom, SourceE, source_map, splitk_reduce_bf16act

namespace igemm_bf16act {

using hopper_tma::desc_mn;
using hopper_tma::mbar_expect_tx;
using hopper_tma::tma_2d;
using hopper_tma::tma_4d;
using igemm_bf16::Geom;
using igemm_tc::bf16x2_rn;
using igemm_tc::cp_async16;
using igemm_tc::smem_u32;
using igemm_tc::swz;

// The tensor maps of a launch (kernel parameter space): the (K, N) weight,
// the two sources (per-tap boxes or halo boxes) and, where the epilogue is
// staged, the (M, N) bf16 output in 64-column x 128-row boxes.
struct Maps {
  CUtensorMap w, xa, xb, out;
};

constexpr int BM = 128;                    // two consumer warpgroups of 64 rows
constexpr int BK = hopper_tma::kAtomK;     // k per stage: 64
constexpr int THREADS = 384;               // producer warpgroup + two consumers
constexpr int A_STAGE = BM * 128;          // one tap x 64 channels of 128 rows
constexpr int SMEM_MAX = 232448;           // an H100's largest dynamic shared memory a block
constexpr int RING_MAX = 8;                // ring slots
constexpr int HALO_MAX = 8;                // halo slots: 2 or 3 tiles of up to 4 or 2 channel blocks
constexpr int HELD_MAX = 32;               // held weight stages (a barrier each)
constexpr int BARS_BYTES = 8 * (2 * RING_MAX + 2 * HALO_MAX + HELD_MAX + 2);  // + 2 turns
constexpr int BIAS_BYTES = 256 * 2;  // the N tile's bias, rounded to bf16
// the bytes a layout may use: the ring, the halos and the held weights
constexpr int AVAIL = SMEM_MAX - 1024 - BARS_BYTES - BIAS_BYTES;
constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;  // 128 x 56 + 256 x 224 = 384 x 168

enum AMode { GATHER = 0, BOXES = 1, HALO = 2 };

// How one launch moves its operands (make_layout; unet2d_blocks.bf16act_layout
// mirrors it): byte offsets from the 1024-aligned base of dynamic shared memory.
struct Layout {
  int mode;        // GATHER, BOXES or HALO
  int hold;        // the split's weight slice held for every tile
  int ring;        // ring slots (0 with halo and held weights: no ring)
  int a_bytes;     // A part of a ring slot: A_STAGE, or 0 with halo
  int slot_bytes;  // a_bytes + the streamed weight stage (BN * 128), or 0 held
  int halo_off, halo_bytes, cblocks, hsets;  // halo slots: hsets tiles of cblocks
  int bw, bh;      // the halo tile: columns and rows of the output
  int pingpong;    // the consumer warpgroups take turns at whole tiles (BN <= 128)
  int held_off, bars_off, smem;
};

#ifdef IGEMM_BF16ACT_CLOCKS
// a diagnostic build: clock64() of CTA 0 (tools/sweep_igemm_tc.py --bf16act
// --clocks): role 0 the first consumer warpgroup's thread 0, both
// warpgroups on a tile: a record a stage (after its waits, products issued,
// the previous stage's retired, slot released); in turns: a record a tile
// (its turn come, its products issued, retired, its epilogue done); record
// 511 the end of its walk; role 1 the producer's thread 0, a record a ring
// load (before the empty wait, after it, copies issued)
__device__ long long clk[2][512][4];
#define ACT_CLK(role, i, p) \
  if (blockIdx.x == 0 && (i) < 511) clk[role][i][p] = clock64();
#define ACT_CLK_END() \
  if (blockIdx.x == 0) clk[0][511][0] = clock64();
#else
#define ACT_CLK(role, i, p)
#define ACT_CLK_END()
#endif

__device__ __forceinline__ void mbar_init_n(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// the mbarrier completes when every cp.async this thread issued before it lands
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
// Wait for the phase of parity `parity`; a wait that never completes traps
// (a launch error) after ~2^26 polls instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls > (1u << 26)) __trap();
  }
}

// Descriptor of 64 rows x 16 k of a K-major bf16 operand in the 128-byte
// swizzle (128-byte rows, 8-row groups 1024 bytes apart) whose first row
// starts at `addr`, at any row of a 1024-aligned buffer that TMA (or the
// gather) swizzled: the card takes the swizzle's phase from the address bits
// themselves, so the base-offset field (bits 49-51) stays 0 (with (addr >>
// 7) & 7 there a view that starts off a 1024-byte boundary reads wrong rows;
// tests/test_torch_port_cuda.py holds the halo views bit-equal to per-tap
// boxes).
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// d (64 x BN per warpgroup) += A (64 x 16, shared memory, K-major: a
// desc_k) * B (16 x BN, shared memory, MN-major: a desc_mn). Accumulator
// layout as igemm_bf16::Mma's.
template <int BN>
struct MmaSS;

template <>
struct MmaSS<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
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
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct MmaSS<256> {
  static __device__ __forceinline__ void run(float (&d)[128], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
        "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
        "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
        "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
        "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
        "%124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
          "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
          "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
          "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
          "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
          "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),
          "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]),
          "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
          "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
          "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
          "+f"(d[127])
        : "l"(a), "l"(b), "r"(1));
  }
};

// The tile origin of row tile m0: parity class (upsample), image, row,
// column of its first grid pixel (igemm_bf16::tile's)
struct Origin {
  int cls, b0, y0, x0;
};
__device__ __forceinline__ Origin origin(const Geom& geo, int m0) {
  const int cls = geo.up ? m0 / geo.mc : 0;
  const int img = geo.gh * geo.gw, mr0 = m0 - cls * geo.mc;
  return {cls, mr0 / img, mr0 % img / geo.gw, mr0 % geo.gw};
}

// The stages of a split in the k order, without a division a stage (boxes
// and halos: every channel block 64 wide): tap (ty, tx), channel offset cc
// of the conv input.
struct Taps {
  int cc, tx, ty;
  __device__ __forceinline__ void start(int k0, const Geom& geo) {
    const int t = k0 / geo.ci;
    cc = k0 - t * geo.ci;
    tx = t % geo.ks;
    ty = t / geo.ks;
  }
  __device__ __forceinline__ void next(const Geom& geo) {
    cc += BK;
    if (cc == geo.ci) {
      cc = 0;
      if (++tx == geo.ks) tx = 0, ++ty;
    }
  }
};

// The epilogue of 64 rows of a tile: thread (g = lane / 4, t = lane % 4)
// of warp w holds rows 16w + g and 16w + g + 8, columns 8j + 2t and + 1
// (the accumulator layout), and stores them as they lie: unsplit as flax
// rounds, bf16(bf16(sum) + bf16(bias)), the sum rounded by one packed
// conversion a pair and the bias added in bf16x2 arithmetic (bias2_s: the N
// tile's bias as bf16 pairs; add.rn.bf16x2 on bf16 operands is the fp32 add
// rounded once, bf16x2.cuh), 4 bytes a row and pair; split, split z's fp32
// partials, 8 bytes. A row past the end (up: its class's pixel past the
// batch) is not stored.
template <int BN>
__device__ __forceinline__ void epilogue(const float (&acc)[BN / 2], const Geom& geo, bool boxed_up,
                                         bool unsplit, const uint32_t* bias2_s,
                                         float* __restrict__ dst, int M, int N, int m0, int n0,
                                         int z, int ar, int at) {
  int m[2] = {m0 + ar, m0 + ar + 8};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (boxed_up) {
      const int img = geo.gh * geo.gw;
      const int c2 = m[h] / geo.mc, r = m[h] - c2 * geo.mc, b = r / img, rem = r - b * img;
      const int y = rem / geo.gw, x = rem - y * geo.gw;
      m[h] = b < geo.batch ? (b * geo.H + 2 * y + (c2 >> 1)) * geo.W + 2 * x + (c2 & 1) : -1;
    } else if (m[h] >= M) {
      m[h] = -1;
    }
  }
  const int nt = n0 + 2 * at;  // the thread's first column
  if (unsplit) {
    __nv_bfloat16* out = reinterpret_cast<__nv_bfloat16*>(dst);
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj) {
      const uint32_t b = bias2_s[4 * jj + at];
      const uint32_t o0 = bf16x2::badd2(bf16x2_rn(acc[4 * jj], acc[4 * jj + 1]), b);
      const uint32_t o1 = bf16x2::badd2(bf16x2_rn(acc[4 * jj + 2], acc[4 * jj + 3]), b);
      if (nt + 8 * jj < N) {  // N % 8 == 0: a pair is wholly in or out
        if (m[0] >= 0)
          *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(m[0]) * N + nt + 8 * jj) = o0;
        if (m[1] >= 0)
          *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(m[1]) * N + nt + 8 * jj) = o1;
      }
    }
  } else {
    float* out = dst + static_cast<size_t>(z) * M * N;
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj) {
      if (nt + 8 * jj >= N) continue;
      if (m[0] >= 0)
        *reinterpret_cast<float2*>(out + static_cast<size_t>(m[0]) * N + nt + 8 * jj) =
            make_float2(acc[4 * jj], acc[4 * jj + 1]);
      if (m[1] >= 0)
        *reinterpret_cast<float2*>(out + static_cast<size_t>(m[1]) * N + nt + 8 * jj) =
            make_float2(acc[4 * jj + 2], acc[4 * jj + 3]);
    }
  }
}

// The unsplit epilogue of a whole 128-row tile through shared memory (the
// ping-pong warpgroup's, its two 64-row halves in acc and acc2): the
// warpgroup writes its bf16 results (flax's rounding, as epilogue()) into
// `stage` as TMA stores read it (per 64-column atom, 128 rows of 128 bytes in
// the 128-byte swizzle: conflict-free), and its first thread stores the tile
// by TMA (rows past M and columns past N clipped) as one bulk group; it waits
// for the group's reads of `stage` later (stage_done), off the path to the
// next tile's products.
template <int BN>
__device__ __forceinline__ void epilogue_staged(const float (&acc)[BN / 2],
                                                const float (&acc2)[BN / 2], unsigned char* stage,
                                                const uint32_t* bias2_s, const CUtensorMap* out,
                                                int m0, int n0, int wg, int ct) {
  const int lane = ct & 31, g = lane >> 2, t = lane & 3, w4 = (ct >> 5) & 3;
  auto chunk = [](int r, int c) {  // byte offset of 16-byte chunk c (of BN / 8) of row r
    return (c >> 3) * (128 * 128) + r * 128 + ((c & 7) ^ (r & 7)) * 16;
  };
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float* a = h ? acc2 : acc;
    const int r0 = 64 * h + 16 * w4 + g;
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj) {
      const uint32_t b = bias2_s[4 * jj + t];
      *reinterpret_cast<uint32_t*>(stage + chunk(r0, jj) + 4 * t) =
          bf16x2::badd2(bf16x2_rn(a[4 * jj], a[4 * jj + 1]), b);
      *reinterpret_cast<uint32_t*>(stage + chunk(r0 + 8, jj) + 4 * t) =
          bf16x2::badd2(bf16x2_rn(a[4 * jj + 2], a[4 * jj + 3]), b);
    }
  }
  // the writes, seen by the TMA store (async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  if ((ct & 127) == 0) {
    const uint32_t src = smem_u32(stage);
#pragma unroll
    for (int a = 0; a < BN / 64; ++a)
      asm volatile(
          "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
              reinterpret_cast<uint64_t>(out)),
          "r"(src + a * (128 * 128)), "r"(n0 + 64 * a), "r"(m0)
          : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
}

// By the thread that stored it: the staged tile's TMA store has read its
// stage (a halo set), which goes back to the producer (`count` arrivals, the
// warpgroup's, on the set's empty barrier `bar`).
__device__ __forceinline__ void stage_done(uint32_t bar, int count) {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

// Grid: column groups (tiles_n x splits) x CTAs per group; CTA (group g =
// blockIdx.x % groups, j = blockIdx.x / groups) walks row tiles j, j + CTAs
// per group, .. of N tile g % tiles_n and split g / tiles_n. dst: the bf16
// output (bias not null) or split z's fp32 partials.
template <class G, int BN>
__global__ void __launch_bounds__(THREADS, 1)
kernel(const G g, const __grid_constant__ Maps maps, const Geom geo, const Layout lay,
       const __nv_bfloat16* __restrict__ w, const float* __restrict__ bias,
       float* __restrict__ dst, int M, int N, int K, int per, int tiles_m, int tiles_n,
       int splits) {
  constexpr int W_STAGE = BN * 128;  // one stage of the weight: BN / 64 atoms of [64 k][128 B]
  // ping-pong (BN <= 128): the two consumer warpgroups take turns at whole
  // tiles, so a slot is one warpgroup's (4 warps); else both work on every
  // tile, 64 rows each (8 warps)
  const int releasers = lay.pingpong ? 4 : 8;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle wants 1024-aligned tiles
  const uint32_t bars = base + lay.bars_off;
  const uint32_t full = bars, empty = full + 8 * RING_MAX, hfull = empty + 8 * RING_MAX,
                 hempty = hfull + 8 * HALO_MAX, wfull = hempty + 8 * HALO_MAX,
                 turn = wfull + 8 * HELD_MAX;
  const bool gather = lay.mode == GATHER, halo = lay.mode == HALO;
  const int hslots = lay.hsets * lay.cblocks;
  if (threadIdx.x == 0) {
    for (int i = 0; i < lay.ring; ++i) {
      mbar_init_n(full + 8 * i, gather ? 129 : 1);  // the gather: 128 cp.async arrivals too
      mbar_init_n(empty + 8 * i, releasers);  // lane 0 of each warp on the slot
    }
    for (int i = 0; i < hslots; ++i) {
      mbar_init_n(hfull + 8 * i, 1);
      mbar_init_n(hempty + 8 * i, releasers);
    }
    for (int i = 0; i < HELD_MAX; ++i) mbar_init_n(wfull + 8 * i, 1);
    for (int i = 0; i < 2; ++i) mbar_init_n(turn + 8 * i, 4);  // one warpgroup's warps
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int groups = tiles_n * splits;
  const int grp = blockIdx.x % groups, first = blockIdx.x / groups;
  const int step = gridDim.x / groups;
  const int n0 = (grp % tiles_n) * BN, z = grp / tiles_n;
  // the N tile's bias as bf16 pairs, rounded once (the epilogues read it here)
  uint32_t* bias_s =
      reinterpret_cast<uint32_t*>(smem_raw + (base - raw) + lay.bars_off + BARS_BYTES);
  if (bias != nullptr && threadIdx.x < BN / 2) {
    const int n = n0 + 2 * threadIdx.x;
    bias_s[threadIdx.x] = n < N ? bf16x2_rn(__ldg(bias + n), __ldg(bias + n + 1)) : 0u;
  }
  __syncthreads();

  const int s_begin = z * per;
  const int s_count = min((K + BK - 1) / BK, s_begin + per) - s_begin;
  const uint32_t ring = base, halos = base + lay.halo_off, held = base + lay.held_off;

  if (__shfl_sync(0xffffffffu, threadIdx.x >> 7, 0) == 0) {
    // ---- producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int pt = threadIdx.x;
    if (!gather && pt != 0) return;
    if (pt == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(&maps.w) : "memory");
      if (!gather) {
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(&maps.xa) : "memory");
        if (geo.ca < geo.ci) asm volatile("prefetch.tensormap [%0];\n" ::"l"(&maps.xb) : "memory");
      }
    }
    if (lay.hold && pt == 0) {
      // the split's weight slice, a barrier a stage; kept for every tile
      for (int s = 0; s < s_count; ++s) {
        mbar_expect_tx(wfull + 8 * s, W_STAGE);
#pragma unroll
        for (int a = 0; a < BN / 64; ++a)
          tma_2d(held + s * W_STAGE + a * (BK * 128), &maps.w, wfull + 8 * s, n0 + 64 * a,
                 (s_begin + s) * BK);
      }
    }
    Taps first_tap;
    if (!gather) first_tap.start(s_begin * BK, geo);
    // the gather: 16-byte chunk c of rows r0 + 16 j
    const int c = pt & 7, r0 = pt >> 3;
    int slot = 0, q = 0;
    uint32_t phase = 0;
    for (int mt = first, j = 0; mt < tiles_m; mt += step, ++j) {
      const int m0 = mt * BM;
      const Origin o = origin(geo, m0);
      if (halo) {
        // hsets tiles' halos: slots (j % hsets) * cblocks + cb, phase (j / hsets) & 1
        const int set = j % lay.hsets;
        const uint32_t hphase = ((j / lay.hsets) & 1) ^ 1;
        for (int cb = 0; cb < lay.cblocks; ++cb) {
          const int hs = set * lay.cblocks + cb;
          mbar_wait(hempty + 8 * hs, hphase);
          // a staged epilogue's generic accesses to the set before this copy
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          const int cc = cb * BK;
          const bool from_a = cc < geo.ca;
          mbar_expect_tx(hfull + 8 * hs, (lay.bw + 2) * (lay.bh + 2) * 128);
          tma_4d(halos + hs * lay.halo_bytes, from_a ? &maps.xa : &maps.xb, hfull + 8 * hs,
                 from_a ? cc : cc - geo.ca, o.x0 - geo.pad, o.y0 - geo.pad, o.b0);
        }
      }
      if (lay.ring == 0) continue;
      Taps tp = first_tap;
      for (int s = 0; s < s_count; ++s, ++q) {
        ACT_CLK(1, pt == 0 ? q : 511, 0)
        mbar_wait(empty + 8 * slot, phase ^ 1);
        ACT_CLK(1, pt == 0 ? q : 511, 1)
        const uint32_t st = ring + slot * lay.slot_bytes;
        const int k0 = (s_begin + s) * BK;
        if (gather) {
          // the consumers' products read this slot through the async proxy
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          const int k = k0 + 8 * c;
          const bool k_in = k < K;  // K a multiple of 8: a chunk is wholly in or out
          const typename G::Tap gt = g.tap(k_in ? k : 0);
          // the row contexts anew each stage: the gather serves only shapes
          // the boxes do not take, and the producer's registers are few
#pragma unroll
          for (int i = 0; i < BM / 16; ++i) {
            const int m = m0 + r0 + 16 * i;
            const __nv_bfloat16* p = k_in ? g.ptr4(g.row(m < M ? m : -1), gt) : nullptr;
            cp_async16(st + swz(r0 + 16 * i, c),
                       p ? static_cast<const void*>(p) : static_cast<const void*>(w),
                       p != nullptr);
          }
          cp_async_arrive(full + 8 * slot);
        }
        if (pt == 0) {
          const uint32_t bar = full + 8 * slot;
          mbar_expect_tx(bar, (lay.mode == BOXES ? A_STAGE : 0) + (lay.hold ? 0 : W_STAGE));
          if (!lay.hold) {
#pragma unroll
            for (int a = 0; a < BN / 64; ++a)
              tma_2d(st + lay.a_bytes + a * (BK * 128), &maps.w, bar, n0 + 64 * a, k0);
          }
          if (lay.mode == BOXES) {
            const bool from_a = tp.cc < geo.ca;
            const int tx = tp.tx - geo.pad, ty = tp.ty - geo.pad;
            // up: floor((p + t) / 2) for p + t in -1 .. 2
            const int x = geo.up ? o.x0 + (((o.cls & 1) + tx + 2) >> 1) - 1 : geo.scale * o.x0 + tx;
            const int y = geo.up ? o.y0 + (((o.cls >> 1) + ty + 2) >> 1) - 1 : geo.scale * o.y0 + ty;
            tma_4d(st, from_a ? &maps.xa : &maps.xb, bar, from_a ? tp.cc : tp.cc - geo.ca, x, y,
                   o.b0);
          }
          if (!gather) tp.next(geo);
        }
        ACT_CLK(1, pt == 0 ? q : 511, 2)
        if (++slot == lay.ring) {
          slot = 0;
          phase ^= 1u;
        }
      }
    }
    if (gather) asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // ---- consumer warpgroups 1 and 2
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  // the warpgroup index through a shuffle: warp-uniform to the compiler, so
  // a loop bounded by it is no divergent path around the products
  const int ct = threadIdx.x - 128, wg = __shfl_sync(0xffffffffu, ct >> 7, 0), lane = ct & 31;
  const bool releaser = lane == 0;  // each consumer warp arrives once on an empty barrier
  const int at = lane & 3;
  const bool boxed_up = !gather && geo.up;
  Taps first_tap;
  if (halo) first_tap.start(s_begin * BK, geo);
  // the second 64 rows of a tile inside its halo: row 64 / bw, column 64 % bw
  const uint32_t half_off = halo ? ((64 / lay.bw) * (lay.bw + 2) + 64 % lay.bw) * 128 : 64 * 128;
  // tap (ty, tx) of channel block cc / 64 inside the halo set at hb
  auto halo_view = [&](uint32_t hb, const Taps& tp) -> uint32_t {
    return hb + (tp.cc >> 6) * lay.halo_bytes + (tp.ty * (lay.bw + 2) + tp.tx) * 128;
  };
  auto halo_wait = [&](int j) -> uint32_t {  // tile j's halos landed; their set's base
    const int set = j % lay.hsets;
    for (int cb = 0; cb < lay.cblocks; ++cb)
      mbar_wait(hfull + 8 * (set * lay.cblocks + cb), (j / lay.hsets) & 1);
    return halos + set * lay.cblocks * lay.halo_bytes;
  };
  auto halo_release = [&](int j) {
    const int set = j % lay.hsets;
    for (int cb = 0; cb < lay.cblocks; ++cb) mbar_arrive(hempty + 8 * (set * lay.cblocks + cb));
  };
  int slot = 0, q = 0;  // the ring position, and the stage count for the clock stamps
  uint32_t phase = 0;
  auto advance = [&](int n) {  // n stages on (with a ring)
    for (slot += n; slot >= lay.ring; slot -= lay.ring) phase ^= 1u;
  };
  float acc[BN / 2];

  if constexpr (BN <= 128) {  // two accumulator sets fit the consumers' registers
    if (lay.pingpong) {
      // Ping-pong: the two consumer warpgroups take turns at the CTA's tiles
      // (warpgroup w the w-th, w + 2-th, .. tile of its walk), each a whole
      // 128-row tile, its two 64-row halves in two accumulator sets. A
      // warpgroup starts a tile once the other has waited for (with a ring)
      // or issued (without) every stage of its own (turn[w]), so its
      // products queue behind the other's and its epilogue runs while they
      // do, and no one waits on a ring slot more than a phase ahead of it.
      float acc2[BN / 2];
      const int ar = ((ct >> 5) & 3) * 16 + (lane >> 2);  // rows ar, ar + 8 of each half
      const uint64_t held_desc = desc_mn(held);
      uint32_t tphase = 0;
      // a staged tile whose halo set goes back once its store has read it:
      // with three sets, at this warpgroup's next tile (the set's next user
      // is the other warpgroup's tile after that), else at once
      const bool staged = lay.ring == 0 && bias != nullptr, defer = lay.hsets >= 3;
      const bool storer = (ct & 127) == 0;
      uint32_t pending = 0;
      if (wg == 1 && lay.ring) advance(s_count);
      for (int j = wg, mt = first + wg * step; mt < tiles_m; j += 2, mt += 2 * step) {
        const int m0 = mt * BM;
        if (pending && storer) stage_done(pending, releasers);
        pending = 0;
        if (j > 0) {
          mbar_wait(turn + 8 * wg, tphase);
          tphase ^= 1u;
        }
        ACT_CLK(0, wg == 0 && ct == 0 ? q : 511, 0)
        const uint32_t hb = halo ? halo_wait(j) : 0;
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = acc2[i] = 0.f;
        igemm_tc::fence_acc(acc);
        igemm_tc::fence_acc(acc2);
        Taps tp = first_tap;
        if (lay.ring == 0) {
          // halos and held weights: no ring, the tile's products one group
          igemm_tc::wgmma_fence();
          for (int s = 0; s < s_count; ++s) {
            if (j < 2) mbar_wait(wfull + 8 * s, 0);  // the first tiles: stages as they land
            const uint64_t d0 = desc_k(halo_view(hb, tp)), d1 = desc_k(halo_view(hb, tp) + half_off);
            const uint64_t b_desc = held_desc + static_cast<uint64_t>(s * (W_STAGE >> 4));
#pragma unroll
            for (int ks = 0; ks < BK / 16; ++ks) {
              MmaSS<BN>::run(acc, d0 + 2 * ks, b_desc + 128 * ks);
              MmaSS<BN>::run(acc2, d1 + 2 * ks, b_desc + 128 * ks);
            }
            tp.next(geo);
          }
          igemm_tc::wgmma_commit();
          igemm_tc::fence_acc(acc);
          igemm_tc::fence_acc(acc2);
          if (releaser) mbar_arrive(turn + 8 * (wg ^ 1));
          ACT_CLK(0, wg == 0 && ct == 0 ? q : 511, 1)
          igemm_bf16::wgmma_wait<0>();
        } else {
          int prev = -1;
          for (int s = 0; s < s_count; ++s) {
            const uint32_t st = ring + slot * lay.slot_bytes;
            mbar_wait(full + 8 * slot, phase);
            // the gather's cp.async writes, seen through the barrier, before
            // the products read them through the async proxy
            if (gather) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            if (lay.hold && j < 2) mbar_wait(wfull + 8 * s, 0);
            const uint32_t a0 = halo ? halo_view(hb, tp) : st;
            const uint64_t d0 = desc_k(a0), d1 = desc_k(a0 + half_off);
            const uint64_t b_desc = desc_mn(lay.hold ? held + s * W_STAGE : st + lay.a_bytes);
            igemm_tc::fence_acc(acc);
            igemm_tc::fence_acc(acc2);
            igemm_tc::wgmma_fence();
#pragma unroll
            for (int ks = 0; ks < BK / 16; ++ks) {
              MmaSS<BN>::run(acc, d0 + 2 * ks, b_desc + 128 * ks);
              MmaSS<BN>::run(acc2, d1 + 2 * ks, b_desc + 128 * ks);
            }
            igemm_tc::wgmma_commit();
            igemm_tc::fence_acc(acc);
            igemm_tc::fence_acc(acc2);
            igemm_bf16::wgmma_wait<1>();  // stage s - 1's products: its slot is free
            igemm_tc::fence_acc(acc);
            igemm_tc::fence_acc(acc2);
            if (prev >= 0 && releaser) mbar_arrive(empty + 8 * prev);
            prev = slot;
            advance(1);
            if (halo) tp.next(geo);
          }
          if (releaser) mbar_arrive(turn + 8 * (wg ^ 1));
          ACT_CLK(0, wg == 0 && ct == 0 ? q : 511, 1)
          igemm_bf16::wgmma_wait<0>();
          if (releaser) mbar_arrive(empty + 8 * prev);
        }
        igemm_tc::fence_acc(acc);
        igemm_tc::fence_acc(acc2);
        ACT_CLK(0, wg == 0 && ct == 0 ? q : 511, 2)
        if (staged) {
          // no ring: the tile's halo (one channel block: Layout) is free and
          // stages its epilogue; the storing thread frees it
          epilogue_staged<BN>(acc, acc2, smem_raw + (hb - raw), bias_s, &maps.out, m0, n0, wg,
                              ct);
          pending = hempty + 8 * ((j % lay.hsets) * lay.cblocks);
          if (!defer) {
            if (storer) stage_done(pending, releasers);
            pending = 0;
          }
        } else {
          if (halo && releaser) halo_release(j);
          epilogue<BN>(acc, geo, boxed_up, bias != nullptr, bias_s, dst, M, N, m0, n0, z, ar, at);
          epilogue<BN>(acc2, geo, boxed_up, bias != nullptr, bias_s, dst, M, N, m0 + 64, n0, z,
                       ar, at);
        }
        ACT_CLK(0, wg == 0 && ct == 0 ? q : 511, 3)
        if (lay.ring) advance(s_count);  // the other warpgroup's tile
        ++q;
      }
      // the last store has read its stage before the CTA's shared memory goes
      if (pending && storer) stage_done(pending, releasers);
      if (wg == 0 && ct == 0) {
        ACT_CLK_END()
      }
      return;
    }
  }

  // Cooperative (BN 256, or one tile a CTA): both consumer warpgroups work on
  // every tile, 64 rows each, through the ring.
  const int ar = wg * 64 + ((ct >> 5) & 3) * 16 + (lane >> 2);
  for (int mt = first, j = 0; mt < tiles_m; mt += step, ++j) {
    const int m0 = mt * BM;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    const uint32_t hb = halo ? halo_wait(j) : 0;
    Taps tp = first_tap;
    int prev = -1;
    for (int s = 0; s < s_count; ++s, ++q) {
      const uint32_t st = ring + slot * lay.slot_bytes;
      mbar_wait(full + 8 * slot, phase);
      if (gather) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      if (lay.hold && j == 0) mbar_wait(wfull + 8 * s, 0);
      ACT_CLK(0, wg == 0 && ct == 0 ? q : 511, 0)
      const uint32_t a_addr = halo ? halo_view(hb, tp) + wg * half_off : st + wg * (64 * 128);
      const uint64_t a_desc = desc_k(a_addr);
      const uint64_t b_desc = desc_mn(lay.hold ? held + s * W_STAGE : st + lay.a_bytes);
      igemm_tc::fence_acc(acc);
      igemm_tc::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks)
        MmaSS<BN>::run(acc, a_desc + 2 * ks, b_desc + 128 * ks);
      igemm_tc::wgmma_commit();
      igemm_tc::fence_acc(acc);
      ACT_CLK(0, wg == 0 && ct == 0 ? q : 511, 1)
      igemm_bf16::wgmma_wait<1>();  // stage s - 1's products: its slot is free
      igemm_tc::fence_acc(acc);
      ACT_CLK(0, wg == 0 && ct == 0 ? q : 511, 2)
      if (prev >= 0 && releaser) mbar_arrive(empty + 8 * prev);
      prev = slot;
      advance(1);
      if (halo) tp.next(geo);
      ACT_CLK(0, wg == 0 && ct == 0 ? q : 511, 3)
    }
    igemm_bf16::wgmma_wait<0>();
    igemm_tc::fence_acc(acc);
    if (releaser) {
      mbar_arrive(empty + 8 * prev);
      if (halo) halo_release(j);
    }
    epilogue<BN>(acc, geo, boxed_up, bias != nullptr, bias_s, dst, M, N, m0, n0, z, ar, at);
  }
  if (wg == 0 && ct == 0) {
    ACT_CLK_END()
  }
}

// ---------------------------------------------------------------------------
// host side: the layout and the launch
// ---------------------------------------------------------------------------

// The layout of a launch (unet2d_blocks.bf16act_layout is this in Python).
// boxes: the A tile is a TMA box (igemm_bf16's rule) of bw x bh x bb pixels.
// Halo where the conv is 3 x 3, not upsampled, the tile is whole rows or part
// of one (bb 1, bw a multiple of 64: each warpgroup's 64 rows are one run of
// pixels), at most 4 channel blocks, and the halos of two tiles fit with the
// held weights (three tiles' where they also fit, at most 2 channel blocks;
// held only at BN <= 128), or with 3 streamed weight stages. Elsewhere the weights are held where the
// split's slice fits with 4 A stages, else streamed; the ring takes what is
// left, up to RING_MAX slots.
static inline Layout make_layout(bool boxes, int bw, int bh, int bb, const Geom& geo, int BN,
                                 int per, bool allow_halo) {
  Layout l;
  memset(&l, 0, sizeof(l));
  const int w_stage = BN * 128;
  const int held = per * w_stage;
  const int cblocks = geo.ci / BK;
  const bool halo_ok = allow_halo && boxes && geo.ks == 3 && !geo.up && geo.scale == 1 &&
                       bb == 1 && bw % 64 == 0 && bw + 2 <= 256 && bh + 2 <= 256 && cblocks <= 4;
  if (halo_ok) {
    const int hb = ((bw + 2) * (bh + 2) * 128 + 1023) / 1024 * 1024;
    // held with halos: BN <= 128 (the ping-pong's two accumulator sets), and
    // a tile's halo (one channel block) holds its staged epilogue (128 rows
    // of BN bf16)
    const bool hold_ok = per <= HELD_MAX && BN <= 128 && cblocks == 1 && 128 * BN * 2 <= hb;
    if (hold_ok && 3 * cblocks <= HALO_MAX && 3 * cblocks * hb + held <= AVAIL) {
      l.mode = HALO, l.hold = 1, l.hsets = 3;
    } else if (hold_ok && 2 * cblocks * hb + held <= AVAIL) {
      l.mode = HALO, l.hold = 1, l.hsets = 2;
    } else if (per <= HELD_MAX && held + 4 * A_STAGE <= AVAIL) {
      // per-tap boxes with the weights held: they re-read the activation
      // from L2, as the halos re-read a weight stage a stage
    } else if (2 * cblocks * hb + 3 * w_stage <= AVAIL) {
      l.mode = HALO, l.hold = 0, l.hsets = 2, l.ring = (AVAIL - 2 * cblocks * hb) / w_stage;
    }
    if (l.mode == HALO) {
      l.halo_bytes = hb, l.cblocks = cblocks, l.bw = bw, l.bh = bh;
      l.a_bytes = 0;
      l.slot_bytes = l.hold ? 0 : w_stage;
    }
  }
  if (l.mode != HALO) {
    l.mode = boxes ? BOXES : GATHER;
    l.a_bytes = A_STAGE;
    if (per <= HELD_MAX && held + 4 * A_STAGE <= AVAIL) {
      l.hold = 1, l.slot_bytes = A_STAGE, l.ring = (AVAIL - held) / A_STAGE;
    } else {
      l.hold = 0, l.slot_bytes = A_STAGE + w_stage, l.ring = AVAIL / (A_STAGE + w_stage);
    }
  }
  if (l.ring > RING_MAX) l.ring = RING_MAX;
  l.halo_off = l.ring * l.slot_bytes;
  l.held_off = l.halo_off + l.hsets * l.cblocks * l.halo_bytes;
  l.bars_off = l.held_off + (l.hold ? held : 0);
  l.smem = l.bars_off + BARS_BYTES + BIAS_BYTES + 1024;
  return l;
}

template <class G, int BN>
static inline cudaError_t launch_bn(const G& g, const Maps& maps, const Geom& geo,
                                    const Layout& lay, const __nv_bfloat16* w, const float* bias,
                                    float* out, float* ws, int M, int N, int K, int tiles_m,
                                    int splits, int per, int ctas, cudaStream_t stream) {
  static bool smem_set = false;  // > 48 KB of dynamic shared memory: once per instantiation
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel<G, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const bool split = splits > 1;
  kernel<G, BN><<<ctas, THREADS, lay.smem, stream>>>(g, maps, geo, lay, w,
                                                     split ? nullptr : bias, split ? ws : out,
                                                     M, N, K, per, tiles_m, (N + BN - 1) / BN,
                                                     splits);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !split) return e;
  const size_t mn4 = static_cast<size_t>(M) * N / 4;
  const int blocks = static_cast<int>(mn4 < 256 * 1056 ? (mn4 + 255) / 256 : 1056);
  igemm_bf16::splitk_reduce_bf16act<<<blocks, 256, 0, stream>>>(
      ws, bias, reinterpret_cast<__nv_bfloat16*>(out), M, N, splits);
  return cudaGetLastError();
}

// M, N, K: GEMM sizes (N a multiple of 8); w: the (K, N) bf16 weight; a:
// the activation's boxes; out: the bf16 output (as float*). Plan: bm = 128,
// bn 64, 128 or 256, `splits` splits of `per` stages (every split
// non-empty; ws holds splits * M * N floats when splits > 1), `ctas` CTAs
// (a multiple of the column groups, tiles_n * splits). halo_ok 0 keeps
// per-tap boxes where a halo would serve (the tests compare the two).
template <class G>
inline cudaError_t launch(const G& g, const igemm_bf16::SourceE<__nv_bfloat16>& a,
                          const __nv_bfloat16* w, const float* bias, float* out, float* ws, int M,
                          int N, int K, int bm, int bn, int splits, int per, int ctas,
                          int halo_ok, cudaStream_t stream) {
  const long stages = (K + BK - 1) / BK;
  const int tiles_n = (N + bn - 1) / bn;
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 || K % 8 || bm != BM || splits < 1 || per < 1 ||
      static_cast<long>(splits - 1) * per >= stages || static_cast<long>(splits) * per < stages ||
      (splits > 1 && ws == nullptr) || ctas < tiles_n * splits || ctas % (tiles_n * splits))
    return cudaErrorInvalidValue;
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  cudaError_t e = hopper_tma::weight_map(&maps.w, w, K, N, N);
  if (e != cudaSuccess) return e;
  // igemm_bf16::launch's box rule at bm = 128
  const int gh = a.up ? a.Hs : a.H, gw = a.up ? a.Ws : a.W;
  int bw = 0, bh = 0, bb = 0;
  if (gw % BM == 0) {
    bw = BM, bh = 1, bb = 1;
  } else if (BM % gw == 0 && gh % (BM / gw) == 0) {
    bw = gw, bh = BM / gw, bb = 1;
  } else if (BM % (gh * gw) == 0) {
    bw = gw, bh = gh, bb = BM / (gh * gw);
  }
  const bool boxes = bw > 0 && a.ca % BK == 0 && a.cb % BK == 0 && bw * a.scale <= 256 &&
                     bh * a.scale <= 256 && (!a.up || (a.H == 2 * a.Hs && a.W == 2 * a.Ws));
  const int mc = (a.batch * gh * gw + BM - 1) / BM * BM;
  const Geom geo = {gh,   gw,      a.ks, a.pad, a.scale, a.ca + a.cb,
                    a.ca, a.batch, a.up, mc,    a.H,     a.W};
  Layout lay = make_layout(boxes, bw, bh, bb, geo, bn, per, halo_ok != 0);
  if (lay.mode == HALO) {
    e = igemm_bf16::source_map(&maps.xa, a.xa, a, a.ca, bw + 2, bh + 2, 1);
    if (e == cudaSuccess && a.cb > 0)
      e = igemm_bf16::source_map(&maps.xb, a.xb, a, a.cb, bw + 2, bh + 2, 1);
  } else if (lay.mode == BOXES) {
    e = igemm_bf16::source_map(&maps.xa, a.xa, a, a.ca, bw, bh, bb);
    if (e == cudaSuccess && a.cb > 0)
      e = igemm_bf16::source_map(&maps.xb, a.xb, a, a.cb, bw, bh, bb);
  }
  if (e == cudaSuccess && lay.mode == HALO && lay.hold && splits == 1) {
    // the staged epilogue's TMA stores: the (M, N) bf16 output
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(M)};
    const cuuint64_t stride[1] = {2ull * N};
    const cuuint32_t box[2] = {64, BM}, one[2] = {1, 1};
    e = hopper_tma::tensor_map(&maps.out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, out, dims, stride,
                               box, one);
  }
  if (e != cudaSuccess) return e;
  const int tiles_m = lay.mode == BOXES && a.up ? 4 * mc / BM : (M + BM - 1) / BM;
  // ping-pong where a CTA walks two tiles or more (and always with halos and
  // held weights, which have no ring for the cooperative walk)
  const int step = ctas / (tiles_n * splits);
  lay.pingpong = bn <= 128 && ((lay.mode == HALO && lay.hold) || (tiles_m + step - 1) / step >= 2);
  if (bn == 64)
    return launch_bn<G, 64>(g, maps, geo, lay, w, bias, out, ws, M, N, K, tiles_m, splits, per,
                            ctas, stream);
  if (bn == 128)
    return launch_bn<G, 128>(g, maps, geo, lay, w, bias, out, ws, M, N, K, tiles_m, splits, per,
                             ctas, stream);
  if (bn == 256)
    return launch_bn<G, 256>(g, maps, geo, lay, w, bias, out, ws, M, N, K, tiles_m, splits, per,
                             ctas, stream);
  return cudaErrorInvalidValue;
}

}  // namespace igemm_bf16act
