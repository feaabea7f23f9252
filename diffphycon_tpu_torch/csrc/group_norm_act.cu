// K3: GroupNorm + optional FiLM + SiLU + optional residual on NHWC fp32,
//   out = SiLU(GN(x) * gamma + beta [then * (scale + 1) + shift]) [+ res],
// GN per (sample, group) over (H, W, C / groups), biased variance, eps.
//
// Replaces the two normalisation stages inside _resblock_kernel in
// diffphycon_tpu/research/pallas_unet2d.py (:132-167): SiLU(GN(h) * (scale
// + 1) + shift) after the first conv and SiLU(GN(h)) + res after the second.
//
// Bound: bytes. Per element it reads x (and res) and writes y with ~15
// flops, far below the fp32 ridge of 67 TFLOP/s / 3.35 TB/s = 20 flops per
// byte. So x should cross HBM once and y once, and the call should cost one
// launch. A Pallas grid step held a whole (sample, group) row in VMEM; on
// Hopper a row of the Burgers net is up to 512 KB and one block per row
// would leave most of the 132 SMs idle at batch 50, so:
// - one launch, one thread-block cluster of CS CTAs (1..8, the host's
//   plan: kernels/unet2d_blocks.py: gn_cluster_plan) per row, launched with
//   cudaLaunchKernelEx and a cluster-dimension attribute;
// - each CTA copies its slice of the row into shared memory once (16-byte
//   cp.async), and takes the slice's count, mean and sum of squared
//   deviations from there (two passes over shared memory, as the plain
//   version takes the mean first and then the variance of the deviations);
// - the CTAs merge the CS partials with Chan's formula in rank order
//   0..CS-1 through distributed shared memory (cluster.map_shared_rank):
//   every CTA merges the same numbers in the same order, no atomics, so two
//   launches on the same inputs are bit-equal (the cluster barrier that
//   keeps each partial alive until all have read it waits at the end);
// - gamma, beta and the FiLM row come in with the slice's copies, so the
//   update waits on no load but its residual's;
// - each CTA then normalises its held slice, applies gamma/beta, FiLM, SiLU
//   and the residual, and stores with 16-byte stores.
// A CTA holds at most kHeldFloats (52 KB) of its slice, so that four CTAs
// fit on an SM: at the Burgers net's widest level (batch 50, rows of 512 KB,
// 400 CTAs of 64 KB slices) all 400 are then resident at once, where 64 KB
// each would leave one cluster for a second wave. The rest of a larger
// slice is read from device memory (or L2) in each of the three passes.
//
// Contract (the wrapper checks): C / groups a multiple of 4, x, res and out
// 16-byte aligned, ss rows (B, 2C) with any row stride and unit column
// stride.
//
// The bf16-activation variant (group_norm_act_bf16act; flax GroupNorm,
// FiLM, SiLU and residual under dtype=bfloat16, the plain version
// kernels/unet2d_blocks.py: group_norm_act_bf16_plain): x, res, ss and out
// bf16, gamma and beta fp32. The same cluster, slice and Chan merge, on
// 16-byte vectors of 8 bf16 values; statistics in fp32. The host's
// gn_bf16_plan (kernels/unet2d_blocks.py) picks the cluster size (1..8);
// a CTA holds up to 100 KB of its slice. Each value: (x -
// mean) * (rstd * gamma) + beta in fp32 (flax _normalize's order, no fused
// multiply-add), rounded to bf16; then y * bf16(scale + 1), + shift, the
// SiLU as XLA expands it (exp(-y), 1 + e, 1 / d, y * r) and + res, each
// rounded to bf16 (round to nearest even). Bound: bytes, 2-byte values: x
// (and res) read once, y written once. Rounding each op through fp32 takes
// eight one-value conversions a value (16 a clock an SM on an H100) and
// makes the update ALU-bound at the widest level, so the bf16 ops run as
// packed bf16x2 arithmetic (bf16x2.cuh), three packed conversions a pair,
// and the SiLU's exp and reciprocal on the SFU, each proven to round as the
// exact op on every input the chain gives it (silu8 below).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "bf16x2.cuh"

namespace cg = cooperative_groups;

// Phase clocks, compiled in only with -DGN_PHASE_CLOCKS (the build that
// tools/sweep_gn_cluster.py --bf16act --clocks makes of this file alone):
// GN_STAMP(i) has thread 0 of each CTA write clock64() to slot i of the
// CTA's kStampSlots in gn_stamps.
#ifdef GN_PHASE_CLOCKS
constexpr int kStampSlots = 16;
__device__ long long gn_stamps[1 << 20];
#define GN_STAMP(i)                                                                        \
  do {                                                                                     \
    if (threadIdx.x == 0)                                                                  \
      gn_stamps[(blockIdx.y * gridDim.x + blockIdx.x) * kStampSlots + (i)] = clock64();    \
  } while (0)
extern "C" int gn_stamps_read(long long* host, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, gn_stamps, sizeof(long long) * n));
}
extern "C" int gn_stamps_clear() {
  void* p = nullptr;
  const cudaError_t e = cudaGetSymbolAddress(&p, gn_stamps);
  return static_cast<int>(e != cudaSuccess ? e : cudaMemset(p, 0, sizeof(gn_stamps)));
}
#else
#define GN_STAMP(i) \
  do {              \
  } while (0)
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCluster = 8;      // the portable cluster size
constexpr int kHeldFloats = 13312;  // 52 KB: the most of a slice held in shared memory
constexpr int kMaxGroupChannels = 2048;  // per-channel values: 48 KB at most

struct GnArgs {
  const float* x;
  const float* gamma;
  const float* beta;
  const float* ss;   // (B, 2C) FiLM scale | shift, row stride ss_stride; or null
  const float* res;  // like x, or null
  float* out;
  int hw, C, groups, ss_stride;
  float eps;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the block in a fixed order: lanes by shuffles, then the warps'
// sums by warp 0. red: kThreads / 32 floats. Every thread gets the sum.
// kFresh: no earlier call read this red, so no thread need wait for it.
template <bool kFresh = false>
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = warp_sum(v);
  if (!kFresh) __syncthreads();  // red may still be read by an earlier call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) s += red[w];
  return s;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// Float4 vector v (0 <= v < hw * cg4) of the row of group g: pixel v / cg4,
// channels g * cg4 + v % cg4 (in float4 units).
__device__ __forceinline__ size_t vec_index(int v, int cg4, int c4, int g, size_t base4) {
  const int pix = v / cg4;
  return base4 + static_cast<size_t>(pix) * c4 + g * cg4 + (v - pix * cg4);
}

// A thread's walk over vectors v, v + kThreads, ... of a row: its pixel and
// vector channel advance without a division per step.
struct RowCursor {
  int pix, cv;
  const int dpix, dcv, cg4;
  __device__ RowCursor(int v, int cg4_)
      : pix(v / cg4_), cv(v - (v / cg4_) * cg4_), dpix(kThreads / cg4_),
        dcv(kThreads - (kThreads / cg4_) * cg4_), cg4(cg4_) {}
  __device__ void step() {
    pix += dpix;
    cv += dcv;
    if (cv >= cg4) {
      cv -= cg4;
      ++pix;
    }
  }
};

__global__ void __launch_bounds__(kThreads) group_norm_act_kernel(const GnArgs a) {
  // dynamic shared memory: the held part of the CTA's slice, then per
  // channel of the group its (scale, shift), then its gamma, beta and FiLM
  // scale and shift as loaded
  extern __shared__ __align__(16) float4 held[];
  __shared__ float red[kThreads / 32];
  __shared__ float part[3];  // this CTA's (count, mean, M2), read by the cluster

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cs = static_cast<int>(cluster.num_blocks());
  const int row = blockIdx.y;
  const int b = row / a.groups, g = row - b * a.groups;
  const int cg_ = a.C / a.groups, cg4 = cg_ / 4, c4 = a.C / 4;
  const int nvec = a.hw * cg4;
  const size_t base4 = static_cast<size_t>(b) * a.hw * c4;
  // this CTA's vectors [v0, v1)
  const int v0 = static_cast<int>(static_cast<long long>(nvec) * rank / cs);
  const int v1 = static_cast<int>(static_cast<long long>(nvec) * (rank + 1) / cs);
  const int nv = v1 - v0;
  const int held_max = min((nvec + cs - 1) / cs, kHeldFloats / 4);  // as the host sized it
  const int nheld = min(nv, held_max);
  float* coef = reinterpret_cast<float*>(held + held_max);
  float* raw = coef + 2 * cg_;
  const float4* x4 = reinterpret_cast<const float4*>(a.x);
  const bool film = a.ss != nullptr;

  auto load = [&](int i) -> float4 {  // vector v0 + i of the slice
    return i < nheld ? held[i] : __ldg(x4 + vec_index(v0 + i, cg4, c4, g, base4));
  };

  // one group of copies: the held slice, and the group's per-channel
  // values (which the statistics do not wait on, but the update does)
  {
    RowCursor cur(v0 + threadIdx.x, cg4);
    for (int i = threadIdx.x; i < nheld; i += kThreads, cur.step())
      cp_async16(held + i, x4 + base4 + static_cast<size_t>(cur.pix) * c4 + g * cg4 + cur.cv);
  }
  for (int c = threadIdx.x; c < cg_; c += kThreads) {
    const int ch = g * cg_ + c;
    cp_async4(raw + c, a.gamma + ch);
    cp_async4(raw + cg_ + c, a.beta + ch);
    if (film) {
      const float* ssb = a.ss + static_cast<size_t>(b) * a.ss_stride;
      cp_async4(raw + 2 * cg_ + c, ssb + ch);
      cp_async4(raw + 3 * cg_ + c, ssb + a.C + ch);
    }
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // the slice's partial: count, mean, then the sum of squared deviations
  float s = 0.f;
#pragma unroll 4
  for (int i = threadIdx.x; i < nv; i += kThreads) {
    const float4 v = load(i);
    s += (v.x + v.y) + (v.z + v.w);
  }
  const float n_r = 4.f * nv;
  const float mean_r = nv > 0 ? block_sum(s, red) / n_r : 0.f;  // nv: the same in the CTA
  float q = 0.f;
#pragma unroll 4
  for (int i = threadIdx.x; i < nv; i += kThreads) {
    const float4 v = load(i);
    const float dx = v.x - mean_r, dy = v.y - mean_r, dz = v.z - mean_r, dw = v.w - mean_r;
    q += (dx * dx + dy * dy) + (dz * dz + dw * dw);
  }
  const float m2_r = block_sum(q, red);
  if (threadIdx.x == 0) {
    part[0] = n_r;
    part[1] = mean_r;
    part[2] = m2_r;
  }
  cluster.sync();

  // Chan's merge of the cluster's partials in rank order (every CTA the same)
  float n = 0.f, mean = 0.f, m2 = 0.f;
  for (int r = 0; r < cs; ++r) {
    const float* p = cluster.map_shared_rank(part, r);
    const float nb = p[0];
    if (nb == 0.f) continue;
    const float nab = n + nb;
    const float delta = p[1] - mean;
    mean += delta * (nb / nab);
    m2 += p[2] + delta * delta * (n * nb / nab);
    n = nab;
  }
  const float rstd = rsqrtf(m2 / n + a.eps);

  // per channel of the group: y = (x - mean) * scale + shift, with gamma,
  // beta and FiLM folded in
  for (int c = threadIdx.x; c < cg_; c += kThreads) {
    float scale = rstd * raw[c], shift = raw[cg_ + c];
    if (film) {
      const float f1 = raw[2 * cg_ + c] + 1.f;
      scale *= f1;
      shift = shift * f1 + raw[3 * cg_ + c];
    }
    coef[2 * c] = scale;
    coef[2 * c + 1] = shift;
  }
  __syncthreads();

  const float4* res4 = reinterpret_cast<const float4*>(a.res);
  float4* out4 = reinterpret_cast<float4*>(a.out);
  RowCursor cur(v0 + threadIdx.x, cg4);
#pragma unroll 4
  for (int i = threadIdx.x; i < nv; i += kThreads, cur.step()) {
    const int cv = cur.cv;
    const size_t idx = base4 + static_cast<size_t>(cur.pix) * c4 + g * cg4 + cv;
    const float4 xv = load(i);
    const float4 k0 = *reinterpret_cast<const float4*>(coef + 8 * cv);
    const float4 k1 = *reinterpret_cast<const float4*>(coef + 8 * cv + 4);
    float y0 = (xv.x - mean) * k0.x + k0.y;
    float y1 = (xv.y - mean) * k0.z + k0.w;
    float y2 = (xv.z - mean) * k1.x + k1.y;
    float y3 = (xv.w - mean) * k1.z + k1.w;
    // SiLU: y * sigmoid(y), the reciprocal correctly rounded
    y0 *= __frcp_rn(1.f + expf(-y0));
    y1 *= __frcp_rn(1.f + expf(-y1));
    y2 *= __frcp_rn(1.f + expf(-y2));
    y3 *= __frcp_rn(1.f + expf(-y3));
    if (res4 != nullptr) {
      const float4 r = __ldg(res4 + idx);
      y0 += r.x;
      y1 += r.y;
      y2 += r.z;
      y3 += r.w;
    }
    out4[idx] = make_float4(y0, y1, y2, y3);
  }
  cluster.sync();  // no CTA leaves while another may still read its partial
}


using bf16x2::badd2;
using bf16x2::bf16x2_rn;
using bf16x2::bmul2;
using bf16x2::hi_f;
using bf16x2::lo_f;
using bf16x2::rb;

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = lo_f(w[i]);
    f[2 * i + 1] = hi_f(w[i]);
  }
}

// 16-byte vectors of its slice a CTA holds: 100 KB, so that two CTAs of up
// to 128 registers a thread (the widest level's 4-CTA clusters) hold their
// 64 KB slices whole
constexpr int kHeldVecsBf16 = 6400;
constexpr uint32_t kOne2 = 0x3f803f80u;  // bf16 1.0 in both halves

struct GnArgsBf16 {
  const __nv_bfloat16* x;
  const float* gamma;
  const float* beta;
  const __nv_bfloat16* ss;  // (B, 2C) FiLM scale | shift, row stride ss_stride; or null
  const __nv_bfloat16* res;  // like x, or null
  __nv_bfloat16* out;
  int hw, C, groups, ss_stride;
  float eps;
};

// exp(-y) and 1 / d on the SFU (MUFU.EX2, MUFU.RCP), which, rounded to
// bf16, equal the exact ops (expf, __frcp_rn) rounded to bf16 wherever the
// SiLU chain takes them: silu8 below equals silu_exact on all 65,536 bf16
// inputs (tests/test_torch_port_cuda.py runs both through
// group_norm_bf16act_update_check). ex2.approx of -y log2(e) lies within
// kExpUlps fp32 units in the last place of expf(-y) at every bf16 y whose
// result is normal (group_norm_bf16act_exp_ulps measures it on all 65,536),
// so where its bits lie further from a bf16 rounding midpoint (low half
// 0x8000) both round to the same bf16 value; nearer (127 of the 65,536 low
// halves), where the two may round apart, silu8 takes expf. Its subnormal
// results flush to 0, which rounds 1 + e as expf's do. 1 / d for d = bf16(1
// + e) >= 1: a quotient of bf16 values is never within 2^-17 of a bf16
// rounding boundary (bf16x2.cuh: quot2), far more than rcp.approx's error;
// from d = 2^126 on (y <= -87.5, infinities, NaN), where the flushed
// reciprocal would lose a subnormal 1 / d, silu8 takes __frcp_rn.
constexpr uint32_t kExpUlps = 63;
__device__ __forceinline__ float exp_neg_sfu(float y) {
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(e) : "f"(y * -1.4426950408889634f));
  return e;
}
__device__ __forceinline__ bool near_midpoint(float e) {
  return ((__float_as_uint(e) - (0x8000u - kExpUlps)) & 0xffffu) <= 2 * kExpUlps;
}
__device__ __forceinline__ float rcp_sfu(float d) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(d));
  return r;
}

// flax's SiLU on 8 bf16 values (4 pairs) as XLA expands the logistic,
// every op rounded to bf16: y * bf16(1 / bf16(1 + bf16(exp(-y)))). 1 + e
// and y * r are bf16 operations on bf16 operands (bf16x2.cuh), so three
// conversions a pair replace the exact chain's eight a value. The 8 values'
// SFU chains share one basic block; the rare inputs that take the exact op
// branch off once a vector.
__device__ __forceinline__ uint4 silu8(const uint4& y) {
  const uint32_t w[4] = {y.x, y.y, y.z, y.w};
  float v[8], e[8];
  uint32_t slow = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    v[j] = j & 1 ? hi_f(w[j / 2]) : lo_f(w[j / 2]);
    e[j] = exp_neg_sfu(v[j]);
    slow |= static_cast<uint32_t>(near_midpoint(e[j])) << j;
  }
  if (slow) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (slow >> j & 1) e[j] = expf(-v[j]);
  }
  uint32_t d[4];
  float r[8];
  slow = 0;
#pragma unroll
  for (int p = 0; p < 4; ++p) d[p] = badd2(bf16x2_rn(e[2 * p], e[2 * p + 1]), kOne2);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float dj = j & 1 ? hi_f(d[j / 2]) : lo_f(d[j / 2]);
    r[j] = rcp_sfu(dj);
    slow |= static_cast<uint32_t>(__float_as_uint(dj) >= 0x7e800000u) << j;  // 2^126
  }
  if (slow) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (slow >> j & 1) r[j] = __frcp_rn(j & 1 ? hi_f(d[j / 2]) : lo_f(d[j / 2]));
  }
  return make_uint4(bmul2(w[0], bf16x2_rn(r[0], r[1])), bmul2(w[1], bf16x2_rn(r[2], r[3])),
                    bmul2(w[2], bf16x2_rn(r[4], r[5])), bmul2(w[3], bf16x2_rn(r[6], r[7])));
}

// the same chain as the plain version computes it, one fp32 op at a time
__device__ __forceinline__ float silu_exact(float y) {
  return rb(y * rb(__frcp_rn(rb(1.f + rb(expf(-y))))));
}

// bf16(scale + 1) of a FiLM scale pair
__device__ __forceinline__ uint32_t film_f1(uint32_t scale) { return badd2(scale, kOne2); }

// One 8-channel vector's coefficients, from the group's per-channel values
// in shared memory: rstd * gamma and beta in fp32 (flax _normalize's affine),
// bf16(scale + 1) and shift as bf16 pairs.
struct Coef8 {
  float k[8], b[8];
  uint32_t f1[4], sh[4];
};

__device__ __forceinline__ Coef8 coef8(const float* gam, const float* bet, const uint4* film,
                                       int cg8, int cv, float rstd, bool has_film) {
  Coef8 c = {};
  const float4* g4 = reinterpret_cast<const float4*>(gam) + 2 * cv;
  const float4* b4 = reinterpret_cast<const float4*>(bet) + 2 * cv;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float4 g = g4[h], be = b4[h];
    c.k[4 * h] = __fmul_rn(rstd, g.x);
    c.k[4 * h + 1] = __fmul_rn(rstd, g.y);
    c.k[4 * h + 2] = __fmul_rn(rstd, g.z);
    c.k[4 * h + 3] = __fmul_rn(rstd, g.w);
    c.b[4 * h] = be.x;
    c.b[4 * h + 1] = be.y;
    c.b[4 * h + 2] = be.z;
    c.b[4 * h + 3] = be.w;
  }
  if (has_film) {
    const uint4 sc = film[cv], sh = film[cg8 + cv];
    c.f1[0] = film_f1(sc.x);
    c.f1[1] = film_f1(sc.y);
    c.f1[2] = film_f1(sc.z);
    c.f1[3] = film_f1(sc.w);
    c.sh[0] = sh.x;
    c.sh[1] = sh.y;
    c.sh[2] = sh.z;
    c.sh[3] = sh.w;
  }
  return c;
}

// FiLM, SiLU and the residual of 8 bf16 values in bf16x2 arithmetic
// (film: bf16(scale + 1) and shift pairs)
__device__ __forceinline__ uint4 act8(uint4 y, bool has_film, const uint32_t (&f1)[4],
                                      const uint32_t (&sh)[4], bool has_res, const uint4& r) {
  if (has_film) {
    y.x = badd2(bmul2(y.x, f1[0]), sh[0]);
    y.y = badd2(bmul2(y.y, f1[1]), sh[1]);
    y.z = badd2(bmul2(y.z, f1[2]), sh[2]);
    y.w = badd2(bmul2(y.w, f1[3]), sh[3]);
  }
  y = silu8(y);
  if (has_res) y = make_uint4(badd2(y.x, r.x), badd2(y.y, r.y), badd2(y.z, r.z), badd2(y.w, r.w));
  return y;
}

// One vector: the fp32 affine (no fused multiply-add, as flax), rounded to
// bf16 once; then act8.
__device__ __forceinline__ uint4 update8(const uint4& x, float mean, const Coef8& c,
                                         bool has_film, bool has_res, const uint4& r) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
  uint32_t y[4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
    y[p] = bf16x2_rn(__fadd_rn(__fmul_rn(lo_f(w[p]) - mean, c.k[2 * p]), c.b[2 * p]),
                     __fadd_rn(__fmul_rn(hi_f(w[p]) - mean, c.k[2 * p + 1]), c.b[2 * p + 1]));
  return act8(make_uint4(y[0], y[1], y[2], y[3]), has_film, c.f1, c.sh, has_res, r);
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The bf16-activation K3: the fp32 kernel's slice, statistics and merge on
// vectors of 8 bf16 values (cg8 a row's vectors per pixel), kThreads a
// CTA, up to 128 registers a thread (two CTAs an SM). Nothing after the
// merge waits on device memory: gamma, beta and the FiLM row come in with
// the slice, the merge's divisions are done while it lands, and each
// thread's first kResRegs residual vectors (64 registers) are loaded once
// it has landed, to arrive during the statistics and the merge; a longer
// slice's are loaded kResRegs at a time in the update. Where kThreads is a
// multiple of cg8 (every width of the Burgers net) a thread's vectors all
// have the same 8 channels, and it takes their coefficients into registers
// once; else per vector. The tail barrier is split: each CTA arrives once
// it has read the cluster's partials and waits only before it exits.
template <bool kFilm, bool kRes>
__global__ void __launch_bounds__(kThreads, 2) group_norm_act_bf16_kernel(const GnArgsBf16 a) {
  constexpr int kResRegs = 2048 / kThreads;  // 64 registers
  // dynamic shared memory: the held part of the slice, then the group's
  // gamma and beta (fp32), then its FiLM scale and shift (bf16)
  extern __shared__ __align__(16) uint4 held8[];
  __shared__ float red[2][kThreads / 32];  // one for each block_sum
  __shared__ float part[3];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cs = static_cast<int>(cluster.num_blocks());
  const int row = blockIdx.y;
  const int b = row / a.groups, g = row - b * a.groups;
  const int cg_ = a.C / a.groups, cg8 = cg_ / 8, c8 = a.C / 8;
  const int nvec = a.hw * cg8;
  const size_t base8 = static_cast<size_t>(b) * a.hw * c8 + g * cg8;
  const int v0 = static_cast<int>(static_cast<long long>(nvec) * rank / cs);
  const int v1 = static_cast<int>(static_cast<long long>(nvec) * (rank + 1) / cs);
  const int nv = v1 - v0;
  const int held_max = min((nvec + cs - 1) / cs, kHeldVecsBf16);
  const int nheld = min(nv, held_max);
  float* gam = reinterpret_cast<float*>(held8 + held_max);
  float* bet = gam + cg_;
  __nv_bfloat16* film = reinterpret_cast<__nv_bfloat16*>(bet + cg_);  // scale | shift
  const uint4* x8 = reinterpret_cast<const uint4*>(a.x);
  const uint4* res8 = reinterpret_cast<const uint4*>(a.res);
  uint4* out8 = reinterpret_cast<uint4*>(a.out);
  constexpr bool has_film = kFilm, has_res = kRes;
  auto at = [&](const RowCursor& c) { return base8 + static_cast<size_t>(c.pix) * c8 + c.cv; };
  auto load = [&](int i, const RowCursor& c) -> uint4 {
    return i < nheld ? held8[i] : __ldg(x8 + at(c));
  };

  GN_STAMP(0);
  {
    RowCursor cur(v0 + threadIdx.x, cg8);
    for (int i = threadIdx.x; i < nheld; i += kThreads, cur.step())
      cp_async16(held8 + i, x8 + at(cur));
  }
  for (int c = threadIdx.x; c < cg_; c += kThreads) {
    cp_async4(gam + c, a.gamma + g * cg_ + c);
    cp_async4(bet + c, a.beta + g * cg_ + c);
  }
  if (has_film) {  // ss may be a column slice at any offset: 16-byte copies where aligned
    const __nv_bfloat16* ssb = a.ss + static_cast<size_t>(b) * a.ss_stride + g * cg_;
    if ((reinterpret_cast<uintptr_t>(ssb) & 15) == 0) {
      for (int c = threadIdx.x; c < cg8; c += kThreads) {
        cp_async16(film + 8 * c, ssb + 8 * c);
        cp_async16(film + cg_ + 8 * c, ssb + a.C + 8 * c);
      }
    } else {
      for (int c = threadIdx.x; c < cg_; c += kThreads) {
        film[c] = ssb[c];
        film[cg_ + c] = ssb[a.C + c];
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // While the slice lands: the merge's weights, which depend on the
  // slices' counts alone. Lane r < cs of every warp takes rank r's count and
  // Chan weights (the first kernel's expressions, the counts added in rank
  // order), so that the merge waits on no division.
  const int lane = threadIdx.x & 31;
  float wn = 0.f, w1 = 0.f, w2 = 0.f, n = 0.f;
  {
    const int r = min(lane, cs - 1);
    const int r0 = static_cast<int>(static_cast<long long>(nvec) * r / cs);
    const int r1 = static_cast<int>(static_cast<long long>(nvec) * (r + 1) / cs);
    const float mine = 8.f * (r1 - r0);
    float before = 0.f;  // the merged count before rank lane's
    for (int q = 0; q < cs; ++q) {
      const float nb = __shfl_sync(0xffffffffu, mine, q);
      if (q == lane) before = n;
      n += nb;  // + 0 for an empty slice, which the merge skips
    }
    if (lane < cs && mine != 0.f) {
      const float nab = before + mine;
      wn = mine;
      w1 = mine / nab;
      w2 = before * mine / nab;
    }
  }

  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  GN_STAMP(1);
  // the residual of each thread's first kResRegs vectors, in flight through
  // the statistics and the merge (issued once x has landed, so that the
  // slice's copies do not queue behind it)
  uint4 rr[kResRegs] = {};
  if (has_res) {
    RowCursor cur(v0 + threadIdx.x, cg8);
#pragma unroll
    for (int j = 0; j < kResRegs; ++j, cur.step())
      if (threadIdx.x + j * kThreads < nv) rr[j] = __ldg(res8 + at(cur));
  }

  // the slice's partial: count, mean, then the sum of squared deviations
  // (the first kernel's order: each thread's vectors, then block_sum)
  float f[8];
  float s = 0.f;
  {
    RowCursor cur(v0 + threadIdx.x, cg8);
#pragma unroll 4
    for (int i = threadIdx.x; i < nv; i += kThreads, cur.step()) {
      unpack8(load(i, cur), f);
      s += ((f[0] + f[1]) + (f[2] + f[3])) + ((f[4] + f[5]) + (f[6] + f[7]));
    }
  }
  const float n_r = 8.f * nv;
  const float mean_r = nv > 0 ? block_sum<true>(s, red[0]) / n_r : 0.f;
  float q = 0.f;
  {
    RowCursor cur(v0 + threadIdx.x, cg8);
#pragma unroll 4
    for (int i = threadIdx.x; i < nv; i += kThreads, cur.step()) {
      unpack8(load(i, cur), f);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = f[j] - mean_r;
        q += d * d;
      }
    }
  }
  const float m2_r = block_sum<true>(q, red[1]);
  GN_STAMP(2);
  if (threadIdx.x == 0) {
    part[0] = n_r;
    part[1] = mean_r;
    part[2] = m2_r;
  }
  cluster.sync();
  GN_STAMP(3);

  // Chan's merge of the cluster's partials in rank order (every CTA the
  // same, the first kernel's arithmetic): lane r of each warp reads rank
  // r's mean and sum of squares, one round trip over distributed shared
  // memory, and the merge takes them and the weights by shuffles
  float pm = 0.f, pq = 0.f;
  if (lane < cs) {
    const float* p = cluster.map_shared_rank(part, lane);
    pm = p[1];
    pq = p[2];
  }
#ifdef GN_PHASE_CLOCKS
  if (threadIdx.x == 0) asm volatile("" ::"f"(pm), "f"(pq));  // the stamp after they land
#endif
  GN_STAMP(4);
  float mean = 0.f, m2 = 0.f;
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) {
    if (r >= cs) break;
    const float nb = __shfl_sync(0xffffffffu, wn, r);
    const float c1 = __shfl_sync(0xffffffffu, w1, r), c2 = __shfl_sync(0xffffffffu, w2, r);
    const float mb = __shfl_sync(0xffffffffu, pm, r), qb = __shfl_sync(0xffffffffu, pq, r);
    if (nb == 0.f) continue;
    const float delta = mb - mean;
    mean += delta * c1;
    m2 += qb + delta * delta * c2;
  }
  // The partials are read (the merge has used them): this CTA arrives, and
  // waits for the others only before it exits. Relaxed: the loads it
  // orders have completed.
  cluster_arrive_relaxed();
  GN_STAMP(5);
  const float rstd = rsqrtf(m2 / n + a.eps);
  GN_STAMP(6);

  // where kThreads is a multiple of cg8, a thread's vectors share their
  // channels: coefficients once, in registers; else again for each vector
  const uint4* film8 = reinterpret_cast<const uint4*>(film);
  const bool one_cv = kThreads % cg8 == 0;
  RowCursor cur(v0 + threadIdx.x, cg8);
  Coef8 c = coef8(gam, bet, film8, cg8, cur.cv, rstd, has_film);
  GN_STAMP(7);
  // kResRegs vectors a chunk; past the first, each chunk's residual loads
  // are all issued before its updates
  for (int i0 = threadIdx.x; i0 < nv; i0 += kResRegs * kThreads) {
    if (has_res && i0 != threadIdx.x) {
      RowCursor rc = cur;
#pragma unroll
      for (int j = 0; j < kResRegs; ++j, rc.step())
        if (i0 + j * kThreads < nv) rr[j] = __ldg(res8 + at(rc));
    }
#pragma unroll
    for (int j = 0; j < kResRegs; ++j, cur.step()) {
      const int i = i0 + j * kThreads;
      if (i >= nv) break;
      if (!one_cv) c = coef8(gam, bet, film8, cg8, cur.cv, rstd, has_film);
      out8[at(cur)] = update8(load(i, cur), mean, c, has_film, has_res, rr[j]);
    }
  }
  GN_STAMP(8);
  cluster_wait();  // no CTA leaves while another may still read its partial
  GN_STAMP(9);
}

// The update's arithmetic after the affine on n vectors of 8 bf16 values
// (tests): fast[i] as the kernel computes it (act8, with film_f1 of the
// scale as coef8 takes it), exact[i] per value as the plain version does,
// one fp32 op at a time, each rounded to bf16. flags: 1 FiLM, 2 residual.
__global__ void update_check_kernel(const uint4* y, const uint4* scale, const uint4* shift,
                                    const uint4* res, int flags, int n, uint4* fast,
                                    uint4* exact) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool has_film = flags & 1, has_res = flags & 2;
  const uint4 sc = scale[i], shv = shift[i];
  const uint32_t f1[4] = {film_f1(sc.x), film_f1(sc.y), film_f1(sc.z), film_f1(sc.w)};
  const uint32_t sh[4] = {shv.x, shv.y, shv.z, shv.w};
  fast[i] = act8(y[i], has_film, f1, sh, has_res, res[i]);
  const uint32_t yw[4] = {y[i].x, y[i].y, y[i].z, y[i].w}, rw[4] = {res[i].x, res[i].y,
                                                                      res[i].z, res[i].w};
  const uint32_t sw[4] = {sc.x, sc.y, sc.z, sc.w};
  uint32_t out[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    float e[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int b = 16 * h;
      float t = __uint_as_float((yw[p] >> b) << 16);
      if (has_film) {
        const float f = rb(__uint_as_float((sw[p] >> b) << 16) + 1.f);
        t = rb(rb(t * f) + __uint_as_float((sh[p] >> b) << 16));
      }
      t = silu_exact(t);
      if (has_res) t = rb(t + __uint_as_float((rw[p] >> b) << 16));
      e[h] = t;
    }
    out[p] = bf16x2_rn(e[0], e[1]);
  }
  exact[i] = make_uint4(out[0], out[1], out[2], out[3]);
}

// The largest distance, in fp32 units in the last place, between
// exp_neg_sfu(y) and expf(-y) over the bf16 y whose expf(-y) is normal and
// finite (a bit pattern each thread).
__global__ void exp_ulps_kernel(unsigned* out) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  const float y = __uint_as_float(i << 16);
  const float x = expf(-y), a = exp_neg_sfu(y);
  if (isfinite(x) && x >= 1.17549435e-38f && isfinite(a)) {
    const int d = static_cast<int>(__float_as_uint(a)) - static_cast<int>(__float_as_uint(x));
    atomicMax(out, static_cast<unsigned>(d < 0 ? -d : d));
  }
}

// One cluster launch of `Kernel`: cs CTAs of kThreads a row, smem bytes of
// dynamic shared memory (up to max_smem, the kernel's own cap).
template <class Args, void (*Kernel)(const Args)>
cudaError_t launch(const Args& a, int rows, int cs, int smem, int max_smem,
                   cudaStream_t stream) {
  static bool smem_set = false;  // > 48 KB of dynamic shared memory: once per kernel
  if (!smem_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, rows, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, Kernel, a);
}

// The bf16-activation kernel's instance for the FiLM and residual flags
// (bit 0, bit 1).
cudaError_t launch_bf16(int flags, const GnArgsBf16& a, int rows, int cs, int smem,
                        cudaStream_t stream) {
  constexpr int kMax = kHeldVecsBf16 * 16 + kMaxGroupChannels * 12;
  switch (flags) {
    case 0:
      return launch<GnArgsBf16, group_norm_act_bf16_kernel<false, false>>(a, rows, cs, smem,
                                                                           kMax, stream);
    case 1:
      return launch<GnArgsBf16, group_norm_act_bf16_kernel<true, false>>(a, rows, cs, smem,
                                                                          kMax, stream);
    case 2:
      return launch<GnArgsBf16, group_norm_act_bf16_kernel<false, true>>(a, rows, cs, smem,
                                                                          kMax, stream);
    default:
      return launch<GnArgsBf16, group_norm_act_bf16_kernel<true, true>>(a, rows, cs, smem, kMax,
                                                                         stream);
  }
}

}  // namespace

// x, res, out: (B, H, W, C) fp32 NHWC; gamma, beta: (C,); ss: (B, 2C) rows
// ss_stride floats apart, or null; res may be null. dims: {B, H * W, C,
// groups, ss_stride, cluster size}. One cluster launch on `stream`;
// returns its cudaError_t.
extern "C" int group_norm_act_f32(const float* x, const float* gamma, const float* beta,
                                  const float* ss, const float* res, float* out,
                                  const int* dims, float eps, void* stream) {
  const int B = dims[0], hw = dims[1], C = dims[2], groups = dims[3], ss_stride = dims[4],
            cs = dims[5];
  if (B <= 0 || hw <= 0 || C <= 0 || groups <= 0 || C % groups || (C / groups) % 4 ||
      C / groups > kMaxGroupChannels || cs < 1 || cs > kMaxCluster || B * groups > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const GnArgs a{x, gamma, beta, ss, res, out, hw, C, groups, ss_stride, eps};
  const long long nvec = static_cast<long long>(hw) * (C / groups) / 4;
  if (nvec > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const long long held = (nvec + cs - 1) / cs < kHeldFloats / 4 ? (nvec + cs - 1) / cs
                                                                 : kHeldFloats / 4;
  const int smem = static_cast<int>(held * 16) + 24 * (C / groups);
  return static_cast<int>(launch<GnArgs, group_norm_act_kernel>(
      a, B * groups, cs, smem, kHeldFloats * 4 + kMaxGroupChannels * 24,
      static_cast<cudaStream_t>(stream)));
}

// The bf16-activation variant: x, res, out (B, H, W, C) bf16 NHWC; ss (B,
// 2C) bf16 rows ss_stride values apart, or null; gamma, beta fp32; dims as
// group_norm_act_f32's. C / groups a multiple of 8.
extern "C" int group_norm_act_bf16act(const __nv_bfloat16* x, const float* gamma,
                                      const float* beta, const __nv_bfloat16* ss,
                                      const __nv_bfloat16* res, __nv_bfloat16* out,
                                      const int* dims, float eps, void* stream) {
  const int B = dims[0], hw = dims[1], C = dims[2], groups = dims[3], ss_stride = dims[4],
            cs = dims[5];
  if (B <= 0 || hw <= 0 || C <= 0 || groups <= 0 || C % groups || (C / groups) % 8 ||
      C / groups > kMaxGroupChannels || cs < 1 || cs > kMaxCluster || B * groups > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const GnArgsBf16 a{x, gamma, beta, ss, res, out, hw, C, groups, ss_stride, eps};
  const long long nvec = static_cast<long long>(hw) * (C / groups) / 8;
  if (nvec > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const long long held = (nvec + cs - 1) / cs < kHeldVecsBf16 ? (nvec + cs - 1) / cs
                                                               : kHeldVecsBf16;
  const int smem = static_cast<int>(held * 16) + 12 * (C / groups);
  const int flags = (ss != nullptr) | (res != nullptr) << 1;
  return static_cast<int>(launch_bf16(flags, a, B * groups, cs, smem,
                                      static_cast<cudaStream_t>(stream)));
}

// Tests: update_check_kernel on n vectors of 8 bf16 values (device
// pointers, 16-byte aligned); returns the launch's cudaError_t.
extern "C" int group_norm_bf16act_update_check(const uint4* y, const uint4* scale,
                                               const uint4* shift, const uint4* res, int flags,
                                               int n, uint4* fast, uint4* exact,
                                               void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  update_check_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      y, scale, shift, res, flags, n, fast, exact);
  return static_cast<int>(cudaGetLastError());
}

// Tests: exp_ulps_kernel into *out (a zeroed device word), then kExpUlps,
// the guard silu8 allows for, into *guard (host).
extern "C" int group_norm_bf16act_exp_ulps(unsigned* out, int* guard, void* stream) {
  exp_ulps_kernel<<<256, 256, 0, static_cast<cudaStream_t>(stream)>>>(out);
  *guard = static_cast<int>(kExpUlps);
  return static_cast<int>(cudaGetLastError());
}
