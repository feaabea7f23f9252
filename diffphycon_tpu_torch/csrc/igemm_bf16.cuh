// The bf16 implicit-GEMM core of K1 (conv2d_nhwc_bf16) and K2
// (downsample_nhwc_bf16), designed for Hopper's bf16 tensor cores.
//
// Replaces, under weight_dtype=bfloat16 (bf16 weights, the activation cast
// to bf16 at the dot, f32 sums: jnp.dot(x.astype(bf16), w, f32)), the
// convolutions of diffphycon_tpu/research/pallas_unet2d.py: _conv_kernel
// (:288), _upsample_kernel (:279), _matmul_bias_kernel (:294),
// _concat_kernel (:304), the convs in _resblock_kernel (:160) and
// _downsample_kernel (:259), through conv2d_nhwc.cu and downsample_nhwc.cu.
//
// out[m, n] = bias[n] + sum_k bf16(A[m, k]) * W[k, n] in fp32: A is the
// fp32 NHWC activation as the conv reads it (im2col, the skip concat, the
// nearest-2x upsample, K2's 2x2 window; no such tensor is built), rounded
// to bf16 (cvt.rn, to nearest even) at the product; W is the packed (K, N)
// bf16 weight, N contiguous.
//
// Bound: max(flops / 989 TFLOP/s, bytes / 3.35 TB/s). The activations stay
// fp32 in device memory, so at the 64-channel levels (3x3: 2 * 9 * 64 =
// 1152 flops per 4-byte input value read once, ~290 flops per byte against
// the card's ridge of 295) the bytes bound it; above them the operations.
// Inside the kernel the fp32 A tile, read once per N tile and tap, is the
// largest traffic from L2. Clock stamps of each stage (`python3 -m
// diffphycon_tpu_torch.tools.sweep_igemm_tc --bf16 --clocks`) show where a
// gather of 16-byte cp.async copies loses its time: at the 8 x 64 conv's
// GEMM (K = 1152, 128 x 128 tiles) with its channels from two sources as
// 96 + 32, issuing the copies takes 69-74% of a stage, 2745-2759 clocks a
// stage against 1245-1280 for the same GEMM from one 128-channel source by
// TMA boxes, 0.070 against 0.038 ms (NVIDIA H100 80GB HBM3, 700 W). So the
// copies go to the tensor memory accelerator (TMA) wherever a tile of the
// activation is a box of it.
//
// Design (the five points of the redesign; the persistent kernel's bf16
// instance, unet2d_persistent.cuh, runs the same tile for its conv and
// downsample stages):
// 1. Deep stages. BK = 64 k per ring stage: four m64nBNk16 products per
//    warpgroup, against one barrier and one fragment conversion. The A
//    tile is fp32, two [BM][128 B] halves (k 0..31, 32..63) in the
//    128-byte swizzle (16-byte chunk c of row r at c ^ (r & 7)), which
//    also keeps the fragment reads bank-conflict free. Tile::STAGES ring
//    stages (4; 3 at 256 columns) fit in 227 KB.
// 2. Weights read as stored. One thread loads each (64, BN) bf16 weight
//    slice by TMA (a tensor map of the (K, N) weight, 64 x 64 boxes,
//    CU_TENSOR_MAP_SWIZZLE_128B, completion on the stage's mbarrier) into
//    the layout wgmma reads MN-major (imm-trans-b = 1): per 64-column atom,
//    64 k rows of 128 bytes. The descriptor (desc_mn) steps 8-row k groups
//    1024 bytes apart (stride byte offset) and atoms BK * 128 bytes apart
//    (leading byte offset). No transpose pass, no second B buffer. k past K
//    and columns past N arrive as zeros.
//    The A tile too comes by TMA when it is a box of the activation (TMA_A):
//    BM grid pixels that are part of one row, whole rows of one image or
//    whole images, every 64-channel block from one source. Then each half
//    is one 4-D box (32 channels x columns x rows x images) of the NHWC
//    source at the tap's offset; taps outside the image arrive as zeros;
//    K2's 2x2 window is the box at traversal stride 2. Through the
//    nearest-2x upsample the tile rows walk the source grid once for each
//    output parity class (py, px): for output pixel (2y + py, 2x + px) tap
//    t reads source pixel y + floor((py + t - 1) / 2), so a class's tile is
//    a box again, and the epilogue stores each row at its class's pixel.
//    Otherwise (channel counts off 64, grids no tile divides) the threads
//    gather A with 16-byte cp.async copies (conv_gathers.cuh), zero-filled
//    outside.
// 3. Products kept in flight. Stage i's products are issued, then the
//    threads wait for stage i - 1's (wgmma.wait_group 1), not their own:
//    while stage i runs they pass the one barrier of the stage (it frees
//    stage i - 1's slot, which one thread refills with stage i + STAGES -
//    1), wait for stage i + 1's mbarrier and convert its A fragments, fp32
//    pairs to bf16x2 in registers, into the other of two fragment sets.
//    The two sets are indexed at compile time by unrolling two stages per
//    iteration; an odd stage count gets one all-zero stage (zero boxes,
//    zero products), so no branch joins accumulators that are in flight
//    (ptxas serialises every product otherwise).
// 4. Accumulation. bf16 x bf16 products are exact in fp32, so the products
//    accumulate on the tensor cores in one chain over the whole split. At
//    the deepest main-path conv (2 x 16, Ca 512 + Cb 256, 3x3, K = 6912)
//    one chain of all 108 stages stays 5.8e-6 relative from the plain bf16
//    version, and the error falls with the chain (27 splits of 4 stages:
//    3.6e-7; `sweep_igemm_tc --bf16`, plans_rel_err; NVIDIA H100 80GB HBM3,
//    700 W): inside the 1e-5 aimed at, so the longest chain is kept
//    (tests/test_torch_port_cuda.py:
//    test_port_bf16_conv_chain_error_at_the_deepest_k holds it there).
// 5. The host's tile plan (kernels/unet2d_blocks.py: tile_plan(..., bf16=
//    True) over TC_TILES_BF16, fitted to device times by
//    tools/sweep_igemm_tc.py --bf16) picks BM x BN (128 x 256, 128 x 128,
//    128 x 64, 64 x 64) and split-K in BK-deep stages by the modelled time;
//    splits write partials that a second launch adds in split order with
//    the bias (igemm_tc.cuh: splitk_reduce_kernel), so two launches are
//    bit-equal. Wide tiles pay: each warpgroup's products read the whole
//    weight slice from shared memory, so per product a 128 x 256 stage
//    moves 0.7x the shared-memory bytes of a 128 x 128 one.
// Epilogue: bias and 16-byte NHWC stores, as igemm_tc.cuh's.
//
// bf16 activations (the gather's Elem __nv_bfloat16: conv2d_nhwc_bf16act,
// downsample_nhwc_bf16act; flax nn.Conv under dtype=bfloat16, the plain
// versions kernels/unet2d_blocks.py: conv2d_nhwc_plain, downsample_nhwc_plain
// on bf16 input). The same tile, ring, TMA weight slices, products in flight
// and tile plans, with the A operand read as stored:
// - a stage's A tile is one [BM][128 B] block, 64 bf16 channels a row in the
//   128-byte swizzle: by TMA one 4-D box of 64 channels (a bf16 source map;
//   the same box rule, unet2d_blocks.py: tma_boxes), else by the gather's
//   16-byte cp.async chunks of 8 channels;
// - the fragments are the stored bf16 pairs (one 32-bit shared load each),
//   no conversion: the fp32-pair rounding of the weight-only variant goes;
// - epilogue: the fp32 sum rounded to bf16, plus the bias rounded to bf16,
//   rounded again, stored bf16 (8-byte stores of 4 channels); split-K
//   partials stay fp32 and splitk_reduce_bf16act adds them in split order
//   before the same rounding.
// Bound: max(flops / 989 TFLOP/s, bytes / 3.35 TB/s) with 2-byte
// activations: the 64-channel 3x3 convs' 1152 flops per 2-byte input value
// (576 per byte) are above the ridge of 295, so every main-path conv of this
// variant is bound by its operations.
//
// Contract (the wrapper checks): N a multiple of 8, K and every channel
// count multiples of 4 (of 8 with bf16 activations), every pointer 16-byte
// aligned.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (the encoder comes from the runtime)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "hopper_tma.cuh"  // mbarriers, TMA copies, desc_mn, the tensor-map cache
#include "igemm_tc.cuh"  // cp.async, swizzle, bf16x2_rn, wgmma fences, split-K reduce

namespace igemm_bf16 {

using igemm_tc::bf16x2_rn;
using igemm_tc::cp_async16;
using igemm_tc::cp_async_commit;
using igemm_tc::cp_async_wait;
using igemm_tc::smem_u32;
using igemm_tc::swz;
using hopper_tma::desc_mn;
using hopper_tma::mbar_expect_tx;
using hopper_tma::mbar_init;
using hopper_tma::mbar_wait;
using hopper_tma::tensor_map;
using hopper_tma::tma_2d;
using hopper_tma::tma_4d;

constexpr int BK = hopper_tma::kAtomK;  // k per ring stage: one 64-row atom of the weight

#ifdef IGEMM_BF16_CLOCKS
// a diagnostic build: clock64() at the phases of each stage of block (0, 0,
// 0), lane 0 of each warpgroup (conv2d_nhwc.cu: igemm_bf16_clocks_read)
__device__ long long clk[2][256][8];
#define IGEMM_BF16_CLK(i, p)                                                                \
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && (threadIdx.x & 127) == 0 && \
      (i) < 256)                                                                           \
    clk[threadIdx.x >> 7][i][p] = clock64();
#else
#define IGEMM_BF16_CLK(i, p)
#endif

// BA: bf16 activations, one [BM][128 B] A block a stage (k 0..63), where
// fp32 activations take two halves
template <int BM, int BN, bool BA = false>
struct Tile {
  static constexpr int THREADS = 2 * BM;       // one warpgroup per 64 rows
  static constexpr int A_HALF = BM * 128;      // fp32: k 0..31 or 32..63; bf16: k 0..63
  static constexpr int HALVES = BA ? 1 : 2;
  static constexpr int HALF_K = BK / HALVES;   // k per 128-byte row
  static constexpr int CHUNK_K = HALF_K / 8;   // k per 16-byte chunk
  static constexpr int A_BYTES = HALVES * A_HALF;
  static constexpr int W_ATOM = BK * 128;      // one 64-column atom: [BK][128 B]
  static constexpr int W_BYTES = BN / 64 * W_ATOM;
  static constexpr int STAGE_BYTES = A_BYTES + W_BYTES;
  static constexpr int STAGES = BN > 128 ? 3 : 4;
  // the ring, one mbarrier per stage, room to align to 1024
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 64 + 1024;
  static constexpr int ROW_STEP = THREADS / 8;  // gather: 8 threads cover a row's chunk column
  static constexpr int A_ROWS = BM / ROW_STEP;  // gather: rows per thread, a chunk a half each
};

// whether gather G reads bf16 activations
template <class G>
constexpr bool kBf16Act =
    std::is_same<typename std::remove_cv<G>::type::Elem, __nv_bfloat16>::value;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The tensor maps of one launch (kernel parameter space: TMA reads them
// there): the (K, N) weight, and with TMA_A the two sources. The tile takes
// pointers to them, so that the persistent kernel can pass maps from a
// table in device memory.
struct Maps {
  CUtensorMap w, xa, xb;
};

// Where a TMA_A tile's boxes start. Tile row m = ((b * gh) + y) * gw + x
// walks a grid of gh x gw pixels per image: the output, whose pixel it is,
// or with `up` the source, in 4 classes of mc rows each, class (py, px)
// standing for output pixel (2y + py, 2x + px). The box of tap (ty, tx)
// starts at source row scale * y + ty - pad (up: y + floor((py + ty -
// pad) / 2)) and the same in the columns, image b, channel c - (c < ca ? 0
// : ca) of xa or xb.
struct Geom {
  int gh, gw;        // the grid: output size, or with up the source size
  int ks, pad;       // taps per side (3, 1, or K2's 2) and padding
  int scale;         // 1, or K2's 2 (the box's traversal stride)
  int ci, ca;        // channels of the conv input, of xa
  int batch;         // images: a box at b = batch is all zeros (the padded stage)
  int up, mc;        // nearest-2x upsample; its tile rows per class (B gh gw rounded to BM)
  int H, W;          // output size
};

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x BN per warpgroup) = A (64 x 16, registers: a0 (g, 2t .. 2t+1),
// a1 (g + 8, 2t ..), a2 (g, 2t + 8 ..), a3 (g + 8, 2t + 8 ..), each a
// bf16x2) * B (16 x BN, shared memory, MN-major: imm-trans-b = 1) +
// (scale_d ? d : 0). Accumulator: d[4j + {0, 1}] = row g, columns 8j + 2t +
// {0, 1}; d[4j + {2, 3}] = row g + 8 (g = lane / 4, t = lane % 4, rows
// relative to the warp's 16).
template <int BN>
struct Mma;

template <>
struct Mma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Mma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Mma<256> {
  static __device__ __forceinline__ void run(float (&d)[128], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
        "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
        "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
        "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
        "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
        "%124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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
          "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
          "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
          "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
          "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
          "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
          "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

// One BM x BN output tile (bx, by) over the BK-stages [z * per, (z + 1) *
// per) of split z. Writes dst[z][m][n] (+ bias[n] when bias is not null:
// the unsplit case; with bf16 activations that case stores bf16, dst read
// as __nv_bfloat16*, and a split's partials stay fp32). Called by all 2 *
// BM threads of a block with Tile<BM, BN, bf16 activations>::SMEM_BYTES of
// shared memory. mw: the weight's map; TMA_A:
// the A tile by TMA boxes (mxa / mxb, geo); else by the gather g. w: the
// weight, a valid address for the gather's zero-filling copies. bars: the
// shared-memory address of STAGES mbarriers (one arrival each) that the
// caller initialised; bit s of `phase` is the parity of ring slot s's next
// completion (0 after the init), and the tile advances it past the
// completions it consumes, so a persistent caller runs tile after tile on
// the same mbarriers. The tile starts with a barrier: the caller's earlier
// reads of the ring's shared memory, and the mbarriers' init, are done.
template <class G, int BM, int BN, bool TMA_A>
__device__ __forceinline__ void tile(const G& g, const CUtensorMap* mw, const CUtensorMap* mxa,
                                     const CUtensorMap* mxb, const Geom& geo,
                                     const __nv_bfloat16* __restrict__ w,
                                     const float* __restrict__ bias, float* __restrict__ dst,
                                     int M, int N, int K, int per, int bx, int by, int z,
                                     unsigned char* smem_raw, uint32_t bars, uint32_t& phase) {
  constexpr bool BA = kBf16Act<G>;
  using T = Tile<BM, BN, BA>;
  using E = typename G::Elem;
  constexpr int S = T::STAGES;
  // the swizzle, TMA's and the descriptors' alike, assumes 1024-byte aligned tiles
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const unsigned char* sbase = smem_raw + (base - raw);

  const int tid = threadIdx.x;
  const int m0 = bx * BM;
  const int n0 = by * BN;
  const int s_begin = z * per;
  const int s_count = min((K + BK - 1) / BK, s_begin + per) - s_begin;
  // an even number of stages: the last, if padded, is all zeros
  const int s_run = s_count + (s_count & 1);

  // gather roles: 16-byte chunk c of each half (fp32: k 4c .. 4c + 3 and 32
  // + 4c .. 32 + 4c + 3 of a stage; bf16: k 8c .. 8c + 7) of tile rows r0 +
  // ROW_STEP * j
  const int c = tid & 7;
  const int r0 = tid >> 3;
  typename G::Row rows[TMA_A ? 1 : T::A_ROWS];
  if constexpr (!TMA_A) {
#pragma unroll
    for (int j = 0; j < T::A_ROWS; ++j) {
      const int m = m0 + r0 + T::ROW_STEP * j;
      rows[j] = g.row(m < M ? m : -1);
    }
  }
  // the tile's first grid pixel and class (TMA_A)
  const int cls = geo.up ? m0 / geo.mc : 0;
  const int img = geo.gh * geo.gw, mr0 = m0 - cls * geo.mc;
  const int b0 = mr0 / img, y0 = mr0 % img / geo.gw, x0 = mr0 % geo.gw;

  // Stage s (local index; s >= s_count: all zeros) into ring slot `slot`.
  // The gather's copies (all threads; they commit their own group), and by
  // one thread the TMA boxes, completing on the slot's mbarrier: rows k0 ..
  // k0 + 63 of the weight's columns n0 .. n0 + BN - 1 (atom a from column
  // n0 + 64a) and with TMA_A the two A halves.
  auto load_stage = [&](int slot, int s) {
    const uint32_t st = base + slot * T::STAGE_BYTES;
    const bool live = s < s_count;
    const int k0 = (s_begin + s) * BK;
    if constexpr (!TMA_A) {
#pragma unroll
      for (int h = 0; h < T::HALVES; ++h) {
        const int k = k0 + T::HALF_K * h + T::CHUNK_K * c;
        const bool k_in = live && k < K;  // K a multiple of CHUNK_K: a chunk is wholly in or out
        const typename G::Tap tp = g.tap(k_in ? k : 0);
#pragma unroll
        for (int j = 0; j < T::A_ROWS; ++j) {
          const E* p = k_in ? g.ptr4(rows[j], tp) : nullptr;
          cp_async16(st + h * T::A_HALF + swz(r0 + T::ROW_STEP * j, c),
                     p ? static_cast<const void*>(p) : static_cast<const void*>(w),
                     p != nullptr);
        }
      }
    }
    if (tid == 0) {
      const uint32_t bar = bars + 8 * slot;
      // the slot's last readers (fragment loads, products) passed the
      // barrier before this: order their accesses before the async copies
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_expect_tx(bar, TMA_A ? T::STAGE_BYTES : T::W_BYTES);
      const int kw = live ? k0 : K;  // rows past K: a box of zeros
#pragma unroll
      for (int a = 0; a < BN / 64; ++a)
        tma_2d(st + T::A_BYTES + a * T::W_ATOM, mw, bar, n0 + 64 * a, kw);
      if constexpr (TMA_A) {
        const int t = k0 / geo.ci, cc = k0 - t * geo.ci;
        const bool from_a = cc < geo.ca;
        const int tx = t % geo.ks - geo.pad, ty = t / geo.ks - geo.pad;
        // up: floor((p + t) / 2) for p + t in -1 .. 2
        const int x = geo.up ? x0 + ((cls & 1) + tx + 2) / 2 - 1 : geo.scale * x0 + tx;
        const int y = geo.up ? y0 + ((cls >> 1) + ty + 2) / 2 - 1 : geo.scale * y0 + ty;
        const int b = live ? b0 : geo.batch;  // past the batch: zeros
#pragma unroll
        for (int h = 0; h < T::HALVES; ++h)
          tma_4d(st + h * T::A_HALF, from_a ? mxa : mxb, bar,
                 (from_a ? cc : cc - geo.ca) + T::HALF_K * h, x, y, b);
      }
    }
  };

  // fragment rows ar and ar + 8 of this thread's warpgroup, column offset at
  const int lane = tid & 31;
  const int ar = (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int at = lane & 3;

  // slot `slot`'s A fragments, each k16 step's (k, k + 1) pairs rounded
  // into bf16x2 (float2 reads: k 16ks + 2at of a half is chunk 4ks + at / 2,
  // byte 8 (at % 2) of it); bf16 activations: the stored pairs (k 16ks + 2at
  // is chunk 2ks, byte 4at; k + 8 the next chunk)
  auto load_frags = [&](uint32_t (&a)[BK / 16][4], int slot) {
    if constexpr (BA) {
      const unsigned char* As = sbase + slot * T::STAGE_BYTES + 4 * at;
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        a[ks][0] = *reinterpret_cast<const uint32_t*>(As + swz(ar, 2 * ks));
        a[ks][1] = *reinterpret_cast<const uint32_t*>(As + swz(ar + 8, 2 * ks));
        a[ks][2] = *reinterpret_cast<const uint32_t*>(As + swz(ar, 2 * ks + 1));
        a[ks][3] = *reinterpret_cast<const uint32_t*>(As + swz(ar + 8, 2 * ks + 1));
      }
      return;
    }
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const unsigned char* As = sbase + slot * T::STAGE_BYTES + (ks >> 1) * T::A_HALF;
      const int c0 = 4 * (ks & 1) + (at >> 1), off = 8 * (at & 1);
      const float2 v0 = *reinterpret_cast<const float2*>(As + swz(ar, c0) + off);
      const float2 v1 = *reinterpret_cast<const float2*>(As + swz(ar + 8, c0) + off);
      const float2 v2 = *reinterpret_cast<const float2*>(As + swz(ar, c0 + 2) + off);
      const float2 v3 = *reinterpret_cast<const float2*>(As + swz(ar + 8, c0 + 2) + off);
      a[ks][0] = bf16x2_rn(v0.x, v0.y);
      a[ks][1] = bf16x2_rn(v1.x, v1.y);
      a[ks][2] = bf16x2_rn(v2.x, v2.y);
      a[ks][3] = bf16x2_rn(v3.x, v3.y);
    }
  };

  float acc[BN / 2];  // the fp32 sum, one chain on the tensor cores
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  uint32_t frag[2][BK / 16][4];  // two stages' A fragments

  __syncthreads();
  // gather: groups committed before stage i + 1's wait: S - 1 + i (one per
  // stage, empty ones past the end keep the count)
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < s_run) load_stage(i, i);
    if constexpr (!TMA_A) cp_async_commit();
  }
  if constexpr (!TMA_A) {
    cp_async_wait<S - 2>();  // stage 0's A
    __syncthreads();
  }
  mbar_wait(bars, phase & 1u);
  load_frags(frag[0], 0);

  // stage i (its fragments in frag[CUR]): issue its products, wait for
  // stage i - 1's, then ready stage i + 1 while stage i runs
  auto step = [&](auto cur_tag, int i) {
    constexpr int CUR = decltype(cur_tag)::value;
    const uint32_t wst = base + (i % S) * T::STAGE_BYTES + T::A_BYTES;
    IGEMM_BF16_CLK(i, 0)
    igemm_tc::fence_acc(acc);
    igemm_tc::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks)
      Mma<BN>::run(acc, frag[CUR][ks], desc_mn(wst + ks * 2048), 1);
    igemm_tc::wgmma_commit();
    igemm_tc::fence_acc(acc);
    IGEMM_BF16_CLK(i, 1)
    wgmma_wait<1>();  // stage i - 1's products: its slot and fragments are free
    igemm_tc::fence_frags(frag[CUR ^ 1]);
    IGEMM_BF16_CLK(i, 2)
    if (i + 1 < s_run) {
      if constexpr (!TMA_A) cp_async_wait<S - 3>();  // stage i + 1's A, this thread's copies
      IGEMM_BF16_CLK(i, 3)
      __syncthreads();
      IGEMM_BF16_CLK(i, 4)
      const int next = i + S - 1;  // into the slot of stage i - 1
      if (next < s_run) load_stage(next % S, next);
      if constexpr (!TMA_A) cp_async_commit();
      IGEMM_BF16_CLK(i, 5)
      const int slot = (i + 1) % S;
      mbar_wait(bars + 8 * slot, ((phase >> slot) ^ ((i + 1) / S)) & 1u);
      load_frags(frag[CUR ^ 1], slot);
      IGEMM_BF16_CLK(i, 6)
    }
  };
  for (int i = 0; i < s_run; i += 2) {
    step(std::integral_constant<int, 0>{}, i);
    step(std::integral_constant<int, 1>{}, i + 1);
  }
  wgmma_wait<0>();
  igemm_tc::fence_acc(acc);
  igemm_tc::fence_frags(frag[0]);
  igemm_tc::fence_frags(frag[1]);
  if constexpr (!TMA_A) cp_async_wait<0>();  // only empty groups can remain
  // slot j completed once for each of stages j, j + S, .. below s_run
#pragma unroll
  for (int j = 0; j < S; ++j) phase ^= ((s_run > j ? (s_run - 1 - j) / S + 1 : 0) & 1u) << j;

  // lanes t and t ^ 1 swap halves: even t stores row g, columns 8j + 2t ..
  // + 3; odd t stores row g + 8, columns 8j + 2t - 2 .. + 1. The row's
  // output pixel, or -1 past the end (up: the class's pixel)
  const bool odd = at & 1;
  int m = m0 + ar + (odd ? 8 : 0);
  if (TMA_A && geo.up) {
    const int c2 = m / geo.mc, r = m - c2 * geo.mc, b = r / img, rem = r - b * img;
    const int y = rem / geo.gw, x = rem - y * geo.gw;
    m = b < geo.batch ? (b * geo.H + 2 * y + (c2 >> 1)) * geo.W + 2 * x + (c2 & 1) : -1;
  } else if (m >= M) {
    m = -1;
  }
  float* out = dst + static_cast<size_t>(z) * M * N;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const float q0 = __shfl_xor_sync(0xffffffffu, odd ? acc[4 * j] : acc[4 * j + 2], 1);
    const float q1 = __shfl_xor_sync(0xffffffffu, odd ? acc[4 * j + 1] : acc[4 * j + 3], 1);
    float4 v = odd ? make_float4(q0, q1, acc[4 * j + 2], acc[4 * j + 3])
                   : make_float4(acc[4 * j], acc[4 * j + 1], q0, q1);
    const int n = n0 + 8 * j + 2 * at - (odd ? 2 : 0);
    if (BA && bias != nullptr) {  // bf16(bf16(sum) + bf16(bias)), stored bf16
      if (m >= 0 && n < N) {
        const float4 b = __ldg(reinterpret_cast<const float4*>(bias + n));
        const uint2 o = make_uint2(
            bf16x2_rn(round_bf16(v.x) + round_bf16(b.x), round_bf16(v.y) + round_bf16(b.y)),
            bf16x2_rn(round_bf16(v.z) + round_bf16(b.z), round_bf16(v.w) + round_bf16(b.w)));
        *reinterpret_cast<uint2*>(reinterpret_cast<__nv_bfloat16*>(dst) +
                                  static_cast<size_t>(m) * N + n) = o;
      }
      continue;
    }
    if (m >= 0 && n < N) {  // N % 4 == 0: the vector is wholly in or out
      if (bias != nullptr) {
        const float4 b = __ldg(reinterpret_cast<const float4*>(bias + n));
        v.x += b.x;
        v.y += b.y;
        v.z += b.z;
        v.w += b.w;
      }
      *reinterpret_cast<float4*>(out + static_cast<size_t>(m) * N + n) = v;
    }
  }
}

template <class G, int BM, int BN, bool TMA_A>
__global__ void __launch_bounds__(2 * BM, 1)
kernel(const G g, const __grid_constant__ Maps maps, const Geom geo,
       const __nv_bfloat16* __restrict__ w, const float* __restrict__ bias,
       float* __restrict__ dst, int M, int N, int K, int per) {
  extern __shared__ unsigned char smem_raw[];
  using T = Tile<BM, BN, kBf16Act<G>>;
  // one 8-byte mbarrier per ring stage, past the ring
  const uint32_t bars = ((smem_u32(smem_raw) + 1023u) & ~1023u) + T::STAGES * T::STAGE_BYTES;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < T::STAGES; ++i) mbar_init(bars + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  uint32_t phase = 0;
  tile<G, BM, BN, TMA_A>(g, &maps.w, &maps.xa, &maps.xb, geo, w, bias, dst, M, N, K, per,
                         blockIdx.x, blockIdx.y, blockIdx.z, smem_raw, bars, phase);
}

// Split-K with bf16 activations: out[m][n] = bf16(bf16(sum_z ws[z][m][n], in
// split order) + bf16(bias[n])), the unsplit epilogue's rounding.
static __global__ void __launch_bounds__(256)
splitk_reduce_bf16act(const float* __restrict__ ws, const float* __restrict__ bias,
                      __nv_bfloat16* __restrict__ out, int M, int N, int splits) {
  const size_t mn4 = static_cast<size_t>(M) * N / 4;
  const float4* w4 = reinterpret_cast<const float4*>(ws);
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < mn4;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float4 v = __ldg(w4 + i);
    for (int z = 1; z < splits; ++z) {
      const float4 p = __ldg(w4 + z * mn4 + i);
      v.x += p.x;
      v.y += p.y;
      v.z += p.z;
      v.w += p.w;
    }
    const float4 b = __ldg(reinterpret_cast<const float4*>(bias + (4 * i) % N));
    reinterpret_cast<uint2*>(out)[i] = make_uint2(
        bf16x2_rn(round_bf16(v.x) + round_bf16(b.x), round_bf16(v.y) + round_bf16(b.y)),
        bf16x2_rn(round_bf16(v.z) + round_bf16(b.z), round_bf16(v.w) + round_bf16(b.w)));
  }
}

// ---------------------------------------------------------------------------
// host side: tensor maps and the launch
// ---------------------------------------------------------------------------

// The activation as TMA boxes would read it (Source), for a launch whose
// tiles may take it (upsample: never). E: float, or bf16 activations.
template <class E>
struct SourceE {
  const E* xa;
  const E* xb;
  int batch, Hs, Ws;  // source size
  int ca, cb;         // channels of xa and xb (cb 0: one source)
  int H, W;           // output size
  int ks, pad, scale;  // taps per side, padding, source pixels per output pixel (K2: 2)
  bool up;             // the conv reads the nearest-2x upsampled source
};
using Source = SourceE<float>;

// The 4-D map (channels, columns, rows, images) of one NHWC source whose
// boxes are 128 bytes of channels (32 fp32 or 64 bf16) x bw x bh x bb
// pixels, at traversal stride `scale` in the columns and rows.
template <class E>
static inline cudaError_t source_map(CUtensorMap* out, const E* x, const SourceE<E>& a, int c,
                                     int bw, int bh, int bb) {
  constexpr bool bf = std::is_same<E, __nv_bfloat16>::value;
  const cuuint64_t es = sizeof(E);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(c), static_cast<cuuint64_t>(a.Ws),
                              static_cast<cuuint64_t>(a.Hs), static_cast<cuuint64_t>(a.batch)};
  const cuuint64_t strides[3] = {es * c, es * c * a.Ws, es * c * a.Ws * a.Hs};
  const cuuint32_t box[4] = {128 / sizeof(E), static_cast<cuuint32_t>(bw * a.scale),
                             static_cast<cuuint32_t>(bh * a.scale), static_cast<cuuint32_t>(bb)};
  const cuuint32_t estr[4] = {1, static_cast<cuuint32_t>(a.scale),
                              static_cast<cuuint32_t>(a.scale), 1};
  return tensor_map(out, bf ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                    4, x, dims, strides, box, estr);
}

// static: each library built from this header (the diagnostic builds too)
// keeps its own smem_set flags
template <class G, int BM, int BN, bool TMA_A>
static inline cudaError_t launch_tile(const G& g, const Maps& maps, const Geom& geo,
                                      const __nv_bfloat16* w, const float* bias, float* out,
                                      float* ws, int M, int N, int K, int tiles_m, int splits,
                                      int per, cudaStream_t stream) {
  using T = Tile<BM, BN, kBf16Act<G>>;
  static bool smem_set = false;  // > 48 KB of dynamic shared memory: once per instantiation
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel<G, BM, BN, TMA_A>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const dim3 grid(tiles_m, (N + BN - 1) / BN, splits);
  const bool split = splits > 1;
  kernel<G, BM, BN, TMA_A><<<grid, T::THREADS, T::SMEM_BYTES, stream>>>(
      g, maps, geo, w, split ? nullptr : bias, split ? ws : out, M, N, K, per);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !split) return e;
  const size_t mn4 = static_cast<size_t>(M) * N / 4;
  const int blocks = static_cast<int>(mn4 < 256 * 1056 ? (mn4 + 255) / 256 : 1056);
  if constexpr (kBf16Act<G>)
    splitk_reduce_bf16act<<<blocks, 256, 0, stream>>>(
        ws, bias, reinterpret_cast<__nv_bfloat16*>(out), M, N, splits);
  else
    igemm_tc::splitk_reduce_kernel<<<blocks, 256, 0, stream>>>(ws, bias, out, M, N, splits);
  return cudaGetLastError();
}

template <class G, int BM, int BN>
static inline cudaError_t launch_mode(bool boxes, const G& g, const Maps& maps, const Geom& geo,
                                      const __nv_bfloat16* w, const float* bias, float* out,
                                      float* ws, int M, int N, int K, int splits, int per,
                                      cudaStream_t stream) {
  if (!boxes)
    return launch_tile<G, BM, BN, false>(g, maps, geo, w, bias, out, ws, M, N, K,
                                         (M + BM - 1) / BM, splits, per, stream);
  const int tiles_m = geo.up ? 4 * geo.mc / BM : (M + BM - 1) / BM;
  return launch_tile<G, BM, BN, true>(g, maps, geo, w, bias, out, ws, M, N, K, tiles_m, splits,
                                      per, stream);
}

// M, N, K: GEMM sizes (N a multiple of 8, K of 4); w: the (K, N) bf16
// weight; a: the activation's boxes (a.boxes false: the gather g alone).
// With bf16 activations (G::Elem, a's E) `out` is the bf16 output, passed
// as float* (the tile stores through it as bf16).
// Tile plan: (bm, bn) (128, 256), (128, 128), (128, 64) or (64, 64);
// `splits` splits of `per` BK-stages each, every split non-empty; ws holds
// splits * M * N floats when splits > 1.
template <class G>
inline cudaError_t launch(const G& g, const SourceE<typename G::Elem>& a, const __nv_bfloat16* w,
                          const float* bias,
                          float* out, float* ws, int M, int N, int K, int bm, int bn, int splits,
                          int per, cudaStream_t stream) {
  const long stages = (K + BK - 1) / BK;
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 || K % 4 || splits < 1 || per < 1 ||
      static_cast<long>(splits - 1) * per >= stages || static_cast<long>(splits) * per < stages ||
      (splits > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  cudaError_t e = hopper_tma::weight_map(&maps.w, w, K, N, N);
  if (e != cudaSuccess) return e;
  // boxes: bm grid pixels (output pixels, or with up source pixels of one
  // parity class) that are part of one row, whole rows of one image, or
  // whole images; every 64-channel block from one source
  const int gh = a.up ? a.Hs : a.H, gw = a.up ? a.Ws : a.W;
  int bw = 0, bh = 0, bb = 0;
  if (gw % bm == 0) {
    bw = bm, bh = 1, bb = 1;
  } else if (bm % gw == 0 && gh % (bm / gw) == 0) {
    bw = gw, bh = bm / gw, bb = 1;
  } else if (bm % (gh * gw) == 0) {
    bw = gw, bh = gh, bb = bm / (gh * gw);
  }
  const bool boxes = bw > 0 && a.ca % BK == 0 && a.cb % BK == 0 && bw * a.scale <= 256 &&
                     bh * a.scale <= 256 && (!a.up || (a.H == 2 * a.Hs && a.W == 2 * a.Ws));
  const int mc = (a.batch * gh * gw + bm - 1) / bm * bm;
  const Geom geo = {gh,    gw,    a.ks,    a.pad,    a.scale, a.ca + a.cb,
                    a.ca,  a.batch, a.up,  mc,       a.H,     a.W};
  if (boxes) {
    e = source_map(&maps.xa, a.xa, a, a.ca, bw, bh, bb);
    if (e == cudaSuccess && a.cb > 0) e = source_map(&maps.xb, a.xb, a, a.cb, bw, bh, bb);
    if (e != cudaSuccess) return e;
  }
  if (bm == 128 && bn == 256)
    return launch_mode<G, 128, 256>(boxes, g, maps, geo, w, bias, out, ws, M, N, K, splits, per,
                                    stream);
  if (bm == 128 && bn == 128)
    return launch_mode<G, 128, 128>(boxes, g, maps, geo, w, bias, out, ws, M, N, K, splits, per,
                                    stream);
  if (bm == 128 && bn == 64)
    return launch_mode<G, 128, 64>(boxes, g, maps, geo, w, bias, out, ws, M, N, K, splits, per,
                                   stream);
  if (bm == 64 && bn == 64)
    return launch_mode<G, 64, 64>(boxes, g, maps, geo, w, bias, out, ws, M, N, K, splits, per,
                                  stream);
  return cudaErrorInvalidValue;
}

}  // namespace igemm_bf16
