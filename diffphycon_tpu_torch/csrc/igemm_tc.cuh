// Tensor-core implicit-GEMM core of K1 (conv2d_nhwc.cu) and K2
// (downsample_nhwc.cu): fp32-accurate convolutions on Hopper's TF32 tensor
// cores.
//
// Replaces, through those two files, the convolutions of
// diffphycon_tpu/research/pallas_unet2d.py: _downsample_kernel (:259),
// _upsample_kernel (:279), _conv_kernel (:288), _matmul_bias_kernel (:294),
// _concat_kernel (:304) and the convs inside _resblock_kernel (:160).
//
// out[m, n] = bias[n] + sum_k A[m, k] * W[k, n]: m walks the output pixels
// (b, oh, ow) of an NHWC tensor, n the output channels, k the (tap, input
// channel) pairs. A is never materialised: a gather functor of
// conv_gathers.cuh turns (m, k) into an address, so im2col, the skip concat,
// the nearest-2x upsample and K2's 2x2 window all happen at load time.
//
// Bound: operations. Every Burgers conv does >= 64 FMAs per byte it must
// move. Plain fp32 FMAs cap at 67 TFLOP/s; the tensor cores give 495 TFLOP/s
// in TF32. 3xTF32 keeps fp32 accuracy: x = hi + lo, each rounded to TF32
// (cvt.rna, round to nearest, ties away from zero), and a * b ~ hi*hi' +
// hi*lo' + lo*hi' accumulated in fp32 (the dropped lo*lo' is ~2^-22
// relative). So the bound is 3 * flops / 495 TFLOP/s.
//
// Design:
// - wgmma.mma_async m64nBNk8 .f32.tf32.tf32, A from registers (the RS form),
//   B from shared memory. One warpgroup per 64 output rows: BM 64 or 128
//   (128 or 256 threads), BN 64 or 128 (tiles 128 x 128, 128 x 64 and
//   64 x 64; two 64 x 64 CTAs fit on one SM). TF32 wgmma takes both operands
//   K-major. The gathered A is K-major by construction (channels are
//   contiguous) and is split into hi and lo in registers as its fragments
//   are loaded. The weight is stored (K, N), MN-major: each slice lands as
//   stored and the threads transpose it into two K-major TF32 tiles, B hi
//   and B lo, in shared memory (so device memory and L2 carry the weight
//   once, not twice).
// - A ring of STAGES slices of BK = 32 (A and the weight slice) in dynamic
//   shared memory, filled by 16-byte cp.async.cg copies: taps outside the
//   image, rows past M, columns past N and k past K use the zero-fill form
//   (src-size 0, a valid source address). The A tile and the B tiles are
//   128-byte rows in the 128-byte swizzle that the wgmma descriptor reads
//   (16-byte chunk c of row r stored at chunk c ^ (r & 7)); it also makes
//   the A-fragment loads bank-conflict free. While one slice's products run
//   on the tensor cores, the threads wait for the next slice, refill the
//   freed ring slot, split the next weight slice into the other pair of B
//   tiles and then the next A fragments: two barriers per slice.
// - Each 32-deep slice is summed on the tensor cores into a fresh
//   accumulator and added to the running fp32 sum with a rounded add: the
//   tensor cores' fp32 accumulation truncates, so one accumulator over all
//   of K drifts from the fp32 result as K grows.
// - Split-K over blockIdx.z when the output tiles alone do not fill the
//   card. The host picks BM, BN and the split count
//   (kernels/unet2d_blocks.py: tile_plan). Each split writes its partial
//   tile to a workspace that the wrapper allocates; a second pass adds the
//   partials in split order, then the bias. No atomics: two launches on the
//   same inputs are bit-equal. (The persistent kernel, unet2d_persistent.cu,
//   runs the same tile body, igemm_tc_tile, and adds the partials in the
//   same order inside its launch.)
// - Epilogue: bias and 16-byte NHWC stores; one lane-pair shuffle turns the
//   accumulator's 2-column pieces into 4-column vectors.
//
// The bf16 variants (K1's and K2's bf16 entries and the persistent
// kernel's bf16 instance) run igemm_bf16.cuh, a core designed for bf16; it
// takes the helpers below (swz, cp.async, bf16x2_rn, the wgmma fences).
//
// Contract (the wrapper checks): N and K multiples of 4, every channel
// count a multiple of 4, every pointer 16-byte aligned.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16x2.cuh"

namespace igemm_tc {

constexpr int BK = 32;     // K per ring stage: one 128-byte row of fp32
constexpr int STAGES = 4;  // ring depth

template <int BM, int BN>
struct Tile {
  static constexpr int THREADS = 2 * BM;  // one warpgroup (128 threads) per 64 rows
  static constexpr int A_BYTES = BM * BK * 4;  // gathered A, [BM][BK], 128-byte swizzle
  static constexpr int W_BYTES = BK * BN * 4;  // weight slice as stored, [BK][BN]
  static constexpr int RING_BYTES = A_BYTES + W_BYTES;  // one ring stage
  static constexpr int B_BYTES = BN * 128;  // one B tile, [BN][128 bytes], K-major: BK TF32 values
  // the ring, then two buffers of (B hi, B lo), then room to align to 1024
  static constexpr int B_OFFSET = STAGES * RING_BYTES;
  static constexpr int SMEM_BYTES = B_OFFSET + 2 * 2 * B_BYTES + 1024;
  static constexpr int ROW_STEP = THREADS / 8;  // 8 threads cover one 128-byte A row
  static constexpr int A_COPIES = BM / ROW_STEP;
  static constexpr int W_COPIES = BK * BN / 4 / THREADS;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c (0..7) of row r in a [rows][128 B] tile
// with the 128-byte swizzle.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
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

// x rounded to TF32 (10 explicit mantissa bits), nearest, ties away from zero.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));  // x - hi is exact in fp32
}

// (lo, hi) rounded to bf16, nearest even, as one bf16x2 (bf16x2.cuh)
using bf16x2::bf16x2_rn;

// Shared-memory descriptor of a K-major operand tile in the 128-byte swizzle:
// 128-byte rows, 8-row groups 1024 bytes apart (stride byte offset); the
// leading byte offset is unused when a product's K (32 bytes) stays inside
// one swizzled row.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous products, and the A fragments alive until they finish.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// d (64 x BN per warpgroup) = A (64 x 8, registers) * B (8 x BN, shared
// memory, K-major) + (scale_d ? d : 0). Accumulator layout: d[4j + {0, 1}]
// = row g, columns 8j + 2t + {0, 1}; d[4j + {2, 3}] = row g + 8 (g = lane /
// 4, t = lane % 4, rows relative to the warp's 16). A fragment: a0 (g, t),
// a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4).
template <int BN>
struct Mma;

template <>
struct Mma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Mma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

// One BM x BN output tile (bx, by) over the K slices [z * per, (z + 1) *
// per) of split z. w: the (K, N) weight as stored. Writes dst[z][m][n]
// (+ bias[n] when bias is not null: the unsplit case). Called by all
// 2 * BM threads of a block, with Tile<BM, BN>::SMEM_BYTES of shared memory
// at smem_raw; K1/K2's kernel calls it once for its block index, the
// persistent kernel (unet2d_persistent.cu) for each tile of a grid-stride
// loop. It ends with every thread past its last shared-memory read, so the
// caller may start the next tile without a barrier.
template <class G, int BM, int BN>
__device__ __forceinline__ void igemm_tc_tile(const G& g, const float* __restrict__ w,
                                              const float* __restrict__ bias,
                                              float* __restrict__ dst, int M, int N, int K,
                                              int per, int bx, int by, int z,
                                              unsigned char* smem_raw) {
  using T = Tile<BM, BN>;
  // the swizzle and the descriptors assume 1024-byte aligned tiles
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sbase = smem_raw + (base - raw);

  const int tid = threadIdx.x;
  const int m0 = bx * BM;
  const int n0 = by * BN;
  const int s_begin = z * per;
  const int s_count = min((K + BK - 1) / BK, s_begin + per) - s_begin;

  // A copy roles: 16-byte chunk c (k = 4c .. 4c + 3 of a slice) of tile
  // rows r0 + ROW_STEP * j
  const int c = tid & 7;
  const int r0 = tid >> 3;
  typename G::Row rows[T::A_COPIES];
#pragma unroll
  for (int j = 0; j < T::A_COPIES; ++j) {
    const int m = m0 + r0 + T::ROW_STEP * j;
    rows[j] = g.row(m < M ? m : -1);
  }

  // one ring stage: the A tile, and rows k0 .. k0 + 31 of w's columns
  // n0 .. n0 + BN - 1 as stored, chunk q of row kr at chunk q ^ (kr / 4 % 8)
  // (the swizzle that makes split_w's column reads conflict-free)
  auto load_slice = [&](int slot, int s) {
    const uint32_t st = base + slot * T::RING_BYTES;
    const int k = s * BK + 4 * c;
    const bool k_in = k < K;  // K % 4 == 0: a chunk is wholly in or out
    const typename G::Tap tp = g.tap(k_in ? k : 0);
#pragma unroll
    for (int j = 0; j < T::A_COPIES; ++j) {
      const float* p = k_in ? g.ptr4(rows[j], tp) : nullptr;
      cp_async16(st + swz(r0 + T::ROW_STEP * j, c),
                 p ? static_cast<const void*>(p) : static_cast<const void*>(w), p != nullptr);
    }
#pragma unroll
    for (int j = 0; j < T::W_COPIES; ++j) {
      const int idx = tid + j * T::THREADS;
      const int q = idx % (BN / 4), kr = idx / (BN / 4);
      const int kk = s * BK + kr, n = n0 + 4 * q;
      const bool ok = kk < K && n < N;  // N % 4 == 0
      cp_async16(st + T::A_BYTES + kr * BN * 4 + ((q ^ ((kr >> 2) & 7)) << 4),
                 ok ? w + static_cast<size_t>(kk) * N + n : w, ok);
    }
  };

  // The weight slice in `slot`, transposed to K-major and split into the
  // TF32 tiles B hi and B lo of buffer `buf` (128-byte swizzle). Thread
  // block (kb, nb) takes rows 4kb .. 4kb + 3 and columns 4nb .. 4nb + 3;
  // the 8 lanes of a quarter warp share nb and walk kb, so both the reads
  // and the 16-byte writes hit 8 distinct bank groups.
  auto split_w = [&](int slot, int buf) {
    const unsigned char* wr = sbase + slot * T::RING_BYTES + T::A_BYTES;
    unsigned char* hi = sbase + T::B_OFFSET + buf * 2 * T::B_BYTES;
    unsigned char* lo = hi + T::B_BYTES;
    for (int blk = tid; blk < BN / 4 * (BK / 4); blk += T::THREADS) {
      const int kb = blk & 7, nb = blk >> 3;
      float4 v[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        v[r] = *reinterpret_cast<const float4*>(wr + (4 * kb + r) * BN * 4 + ((nb ^ kb) << 4));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint4 h, l;
        tf32_split(j == 0 ? v[0].x : j == 1 ? v[0].y : j == 2 ? v[0].z : v[0].w, h.x, l.x);
        tf32_split(j == 0 ? v[1].x : j == 1 ? v[1].y : j == 2 ? v[1].z : v[1].w, h.y, l.y);
        tf32_split(j == 0 ? v[2].x : j == 1 ? v[2].y : j == 2 ? v[2].z : v[2].w, h.z, l.z);
        tf32_split(j == 0 ? v[3].x : j == 1 ? v[3].y : j == 2 ? v[3].z : v[3].w, h.w, l.w);
        *reinterpret_cast<uint4*>(hi + swz(4 * nb + j, kb)) = h;
        *reinterpret_cast<uint4*>(lo + swz(4 * nb + j, kb)) = l;
      }
    }
  };

  // fragment rows ar and ar + 8 of this thread's warpgroup, column offset at
  const int lane = tid & 31;
  const int ar = (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int at = lane & 3;

  // acc: the fp32 sum over the slices done; part: one slice on the tensor
  // cores. The tensor cores' own fp32 accumulation truncates, so a sum over
  // all of K in `part` would drift with K; adding each 32-deep slice into
  // acc with a rounded fp32 add keeps the error near fp32's.
  float acc[BN / 2], part[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.f;
  uint32_t ahi[BK / 8][4], alo[BK / 8][4];
  // the A fragments of the slice in `slot`, split into hi and lo
  auto load_frags = [&](int slot) {
    const unsigned char* As = sbase + slot * T::RING_BYTES;
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
      const int c0 = 2 * ks;  // columns 8ks + at (chunk c0) and 8ks + at + 4 (chunk c0 + 1)
      tf32_split(*reinterpret_cast<const float*>(As + swz(ar, c0) + 4 * at), ahi[ks][0],
                 alo[ks][0]);
      tf32_split(*reinterpret_cast<const float*>(As + swz(ar + 8, c0) + 4 * at), ahi[ks][1],
                 alo[ks][1]);
      tf32_split(*reinterpret_cast<const float*>(As + swz(ar, c0 + 1) + 4 * at), ahi[ks][2],
                 alo[ks][2]);
      tf32_split(*reinterpret_cast<const float*>(As + swz(ar + 8, c0 + 1) + 4 * at),
                 ahi[ks][3], alo[ks][3]);
    }
  };
  // the B tiles are written through the generic proxy and read by wgmma
  // through the async one: each writer fences before the barrier
  auto b_visible = [&]() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  };

  // groups committed before slice i + 1's wait: STAGES - 1 + i (one per
  // slice, empty ones past the end keep the count)
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < s_count) load_slice(i, s_begin + i);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 2>();  // slice 0
  __syncthreads();
  split_w(0, 0);
  load_frags(0);
  b_visible();
  for (int i = 0; i < s_count; ++i) {
    const uint32_t b_hi = base + T::B_OFFSET + (i & 1) * 2 * T::B_BYTES;
    const uint32_t b_lo = b_hi + T::B_BYTES;
    fence_acc(part);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {  // small terms first
      Mma<BN>::run(part, alo[ks], desc_sw128(b_hi + 32 * ks), ks > 0);
      Mma<BN>::run(part, ahi[ks], desc_sw128(b_lo + 32 * ks), 1);
      Mma<BN>::run(part, ahi[ks], desc_sw128(b_hi + 32 * ks), 1);
    }
    wgmma_commit();
    // while the products run: wait for slice i + 1, refill the ring slot of
    // slice i - 1, split slice i + 1's weights into the other B buffer
    // (its last reader, slice i - 1's products, finished before the barrier)
    if (i + 1 < s_count) {
      cp_async_wait<STAGES - 3>();
      __syncthreads();
      const int next = i + STAGES - 1;
      if (next < s_count) load_slice(next % STAGES, s_begin + next);
      cp_async_commit();
      split_w((i + 1) % STAGES, (i + 1) & 1);
    }
    wgmma_wait_all();
    fence_acc(part);
    fence_frags(ahi);  // the products read the fragments until here
    fence_frags(alo);
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[j] += part[j];
    if (i + 1 < s_count) {
      load_frags((i + 1) % STAGES);
      b_visible();
    }
  }
  cp_async_wait<0>();  // only empty groups can remain

  // lanes t and t ^ 1 swap halves: even t stores row g, columns 8j + 2t ..
  // + 3; odd t stores row g + 8, columns 8j + 2t - 2 .. + 1
  const bool odd = at & 1;
  const int m = m0 + ar + (odd ? 8 : 0);
  float* out = dst + static_cast<size_t>(z) * M * N;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const float q0 = __shfl_xor_sync(0xffffffffu, odd ? acc[4 * j] : acc[4 * j + 2], 1);
    const float q1 = __shfl_xor_sync(0xffffffffu, odd ? acc[4 * j + 1] : acc[4 * j + 3], 1);
    float4 v = odd ? make_float4(q0, q1, acc[4 * j + 2], acc[4 * j + 3])
                   : make_float4(acc[4 * j], acc[4 * j + 1], q0, q1);
    const int n = n0 + 8 * j + 2 * at - (odd ? 2 : 0);
    if (m < M && n < N) {  // N % 4 == 0: the vector is wholly in or out
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

template <class G, int BM, int BN>
__global__ void __launch_bounds__(2 * BM, 1)
igemm_tc_kernel(const G g, const float* __restrict__ w, const float* __restrict__ bias,
                float* __restrict__ dst, int M, int N, int K, int per) {
  extern __shared__ unsigned char smem_raw[];
  igemm_tc_tile<G, BM, BN>(g, w, bias, dst, M, N, K, per, blockIdx.x, blockIdx.y, blockIdx.z,
                           smem_raw);
}

// out = bias + the split partials ws[0] + ws[1] + ..., added in split order.
static __global__ void __launch_bounds__(256)
splitk_reduce_kernel(const float* __restrict__ ws, const float* __restrict__ bias,
                     float* __restrict__ out, int M, int N, int splits) {
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
    reinterpret_cast<float4*>(out)[i] = make_float4(v.x + b.x, v.y + b.y, v.z + b.z, v.w + b.w);
  }
}

template <class G, int BM, int BN>
inline cudaError_t launch_tile(const G& g, const float* w, const float* bias, float* out,
                               float* ws, int M, int N, int K, int splits, int per,
                               cudaStream_t stream) {
  using T = Tile<BM, BN>;
  static bool smem_set = false;  // > 48 KB of dynamic shared memory: once per instantiation
  if (!smem_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(igemm_tc_kernel<G, BM, BN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, splits);
  const bool split = splits > 1;
  igemm_tc_kernel<G, BM, BN><<<grid, T::THREADS, T::SMEM_BYTES, stream>>>(
      g, w, split ? nullptr : bias, split ? ws : out, M, N, K, per);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !split) return e;
  const size_t mn4 = static_cast<size_t>(M) * N / 4;
  const int blocks = static_cast<int>(mn4 < 256 * 1056 ? (mn4 + 255) / 256 : 1056);
  splitk_reduce_kernel<<<blocks, 256, 0, stream>>>(ws, bias, out, M, N, splits);
  return cudaGetLastError();
}

// M, N, K: GEMM sizes (N and K multiples of 4). w: the (K, N) weight. Tile
// plan: (bm, bn) (128, 128), (128, 64) or (64, 64); `splits` splits of
// `per` BK-slices each, every split non-empty; ws holds splits * M * N
// floats when splits > 1.
template <class G>
inline cudaError_t launch(const G& g, const float* w, const float* bias, float* out, float* ws,
                          int M, int N, int K, int bm, int bn, int splits, int per,
                          cudaStream_t stream) {
  const long slices = (K + BK - 1) / BK;
  if (M <= 0 || N <= 0 || K <= 0 || N % 4 || K % 4 || splits < 1 || per < 1 ||
      static_cast<long>(splits - 1) * per >= slices || static_cast<long>(splits) * per < slices ||
      (splits > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  if (bm == 128 && bn == 128)
    return launch_tile<G, 128, 128>(g, w, bias, out, ws, M, N, K, splits, per, stream);
  if (bm == 128 && bn == 64)
    return launch_tile<G, 128, 64>(g, w, bias, out, ws, M, N, K, splits, per, stream);
  if (bm == 64 && bn == 64)
    return launch_tile<G, 64, 64>(g, w, bias, out, ws, M, N, K, splits, per, stream);
  return cudaErrorInvalidValue;
}

}  // namespace igemm_tc
