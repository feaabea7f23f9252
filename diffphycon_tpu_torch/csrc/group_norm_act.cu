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
// 16-byte vectors of 8 bf16 values (a row is half the bytes, so the host's
// gn_cluster_plan holds twice the values a CTA: kernels/unet2d_blocks.py);
// statistics in fp32. Each value: (x - mean) * (rstd * gamma) + beta in
// fp32 (flax _normalize's order, no fused multiply-add), rounded to bf16;
// then y * bf16(scale + 1), + shift, the SiLU as XLA expands it (exp(-y),
// 1 + e, 1 / d, y * r) and + res, each rounded to bf16 (round to nearest
// even). Bound: bytes, 2-byte values: x (and res) read once, y written once.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

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
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = warp_sum(v);
  __syncthreads();  // red may still be read by an earlier call
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
// float4 channel advance without a division per step.
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


// bf16 helpers of the bf16-activation variant: the value as fp32, and fp32
// rounded to bf16 (to nearest even) and back
__device__ __forceinline__ float rb(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

constexpr int kCoefStride = 9;  // float4s a vector's coefficients take (8 and a pad)

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

// The bf16-activation K3: the fp32 kernel's slice, statistics and merge on
// vectors of 8 bf16 values (cg8 a row's vectors per pixel), and flax's
// per-op rounding in the update.
__global__ void __launch_bounds__(kThreads) group_norm_act_bf16_kernel(const GnArgsBf16 a) {
  // dynamic shared memory: the held part of the slice, then per channel of
  // the group (rstd * gamma, beta, bf16(scale + 1), shift), a float4 each,
  // each vector's 8 channels kCoefStride float4 apart: the lanes of a warp
  // read 8 vectors' coefficients at once, and an unpadded 128-byte stride
  // put them all on the same banks
  extern __shared__ __align__(16) uint4 held8[];
  __shared__ float red[kThreads / 32];
  __shared__ float part[3];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cs = static_cast<int>(cluster.num_blocks());
  const int row = blockIdx.y;
  const int b = row / a.groups, g = row - b * a.groups;
  const int cg_ = a.C / a.groups, cg8 = cg_ / 8, c8 = a.C / 8;
  const int nvec = a.hw * cg8;
  const size_t base8 = static_cast<size_t>(b) * a.hw * c8;
  const int v0 = static_cast<int>(static_cast<long long>(nvec) * rank / cs);
  const int v1 = static_cast<int>(static_cast<long long>(nvec) * (rank + 1) / cs);
  const int nv = v1 - v0;
  const int held_max = min((nvec + cs - 1) / cs, kHeldFloats / 4);  // 16-byte vectors
  const int nheld = min(nv, held_max);
  float* coef = reinterpret_cast<float*>(held8 + held_max);
  const uint4* x8 = reinterpret_cast<const uint4*>(a.x);

  auto load = [&](int i) -> uint4 {
    return i < nheld ? held8[i] : __ldg(x8 + vec_index(v0 + i, cg8, c8, g, base8));
  };
  {
    RowCursor cur(v0 + threadIdx.x, cg8);
    for (int i = threadIdx.x; i < nheld; i += kThreads, cur.step())
      cp_async16(held8 + i, x8 + base8 + static_cast<size_t>(cur.pix) * c8 + g * cg8 + cur.cv);
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  float f[8];
  float s = 0.f;
#pragma unroll 4
  for (int i = threadIdx.x; i < nv; i += kThreads) {
    unpack8(load(i), f);
    s += ((f[0] + f[1]) + (f[2] + f[3])) + ((f[4] + f[5]) + (f[6] + f[7]));
  }
  const float n_r = 8.f * nv;
  const float mean_r = nv > 0 ? block_sum(s, red) / n_r : 0.f;
  float q = 0.f;
#pragma unroll 4
  for (int i = threadIdx.x; i < nv; i += kThreads) {
    unpack8(load(i), f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float d = f[j] - mean_r;
      q += d * d;
    }
  }
  const float m2_r = block_sum(q, red);
  if (threadIdx.x == 0) {
    part[0] = n_r;
    part[1] = mean_r;
    part[2] = m2_r;
  }
  cluster.sync();

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

  const bool film = a.ss != nullptr;
  for (int c = threadIdx.x; c < cg_; c += kThreads) {
    const int ch = g * cg_ + c;
    float4 k = make_float4(__fmul_rn(rstd, a.gamma[ch]), a.beta[ch], 1.f, 0.f);
    if (film) {
      const __nv_bfloat16* ssb = a.ss + static_cast<size_t>(b) * a.ss_stride;
      k.z = rb(__bfloat162float(ssb[ch]) + 1.f);
      k.w = __bfloat162float(ssb[a.C + ch]);
    }
    reinterpret_cast<float4*>(coef)[(c / 8) * kCoefStride + c % 8] = k;
  }
  __syncthreads();

  const uint4* res8 = reinterpret_cast<const uint4*>(a.res);
  uint4* out8 = reinterpret_cast<uint4*>(a.out);
  RowCursor cur(v0 + threadIdx.x, cg8);
#pragma unroll 2
  for (int i = threadIdx.x; i < nv; i += kThreads, cur.step()) {
    const size_t idx = base8 + static_cast<size_t>(cur.pix) * c8 + g * cg8 + cur.cv;
    unpack8(load(i), f);
    float r[8];
    if (res8 != nullptr) unpack8(__ldg(res8 + idx), r);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 k = reinterpret_cast<const float4*>(coef)[kCoefStride * cur.cv + j];
      float y = rb(__fadd_rn(__fmul_rn(f[j] - mean, k.x), k.y));
      if (film) y = rb(rb(y * k.z) + k.w);
      // SiLU as XLA expands the logistic: y * (1 / (1 + exp(-y))), each op rounded
      y = rb(y * rb(__frcp_rn(rb(1.f + rb(expf(-y))))));
      if (res8 != nullptr) y = rb(y + r[j]);
      f[j] = y;
    }
    out8[idx] = pack8(f);
  }
  cluster.sync();
}

template <class Args>
cudaError_t launch(void (*kernel)(const Args), const Args& a, int rows, int cs, int smem,
                   cudaStream_t stream) {
  static bool smem_set = false;  // > 48 KB of dynamic shared memory: once per kernel
  if (!smem_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kHeldFloats * 4 + kMaxGroupChannels * 24);
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
  return cudaLaunchKernelEx(&cfg, kernel, a);
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
  return static_cast<int>(launch(group_norm_act_kernel, a, B * groups, cs, smem,
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
  const long long held = (nvec + cs - 1) / cs < kHeldFloats / 4 ? (nvec + cs - 1) / cs
                                                                 : kHeldFloats / 4;
  const int smem = static_cast<int>(held * 16) + 16 * kCoefStride * (C / groups / 8);
  return static_cast<int>(launch(group_norm_act_bf16_kernel, a, B * groups, cs, smem,
                                 static_cast<cudaStream_t>(stream)));
}
