// K6's three bodies (attention.cu: K6a, the qkv projection; K6b, the
// online softmax; K6c, the out-projection) as device functions of a block
// index, shared with the persistent kernel (unet2d_persistent.cu). See
// attention.cu for the design. Activations and the qkv / O scratch are read
// through L2 only (cp.async.cg, __ldcg): in the persistent kernel other
// blocks wrote them in the same launch.
#pragma once

#include "linear_attention_tc.cuh"

namespace attn_tc {

using namespace la_tc;

constexpr int kQTile = 64;        // queries per K6b CTA: 4 warps x 16
constexpr int kKTile = 64;        // keys per K6b step
constexpr int kCoreThreads = 128;
constexpr int kQS = kDimHead + 4;  // q and k rows: conflict-free A and B fragments
constexpr int kVS = kDimHead + 8;  // v rows
constexpr int kPS = kKTile + 4;    // a warp's P rows
constexpr int kOS = kHidden + 4;   // K6c's O tile rows
constexpr int kCoreSmemFloats = kQTile * kQS + kKTile * kQS + kKTile * kVS +
                                kCoreThreads / 32 * 16 * kPS;

// Rows 0 .. rows - 1 of src (cols floats each, src_ld apart, cols a
// multiple of 4) into dst (ld apart); rows rows .. TR - 1 zero-filled. The
// `threads` threads of the caller take part, this one as `tid`. Commits one
// cp.async group.
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src, size_t src_ld,
                                          int rows, int TR, int cols, int tid, int threads) {
  const int c4 = cols / 4;
  for (int i = tid; i < TR * c4; i += threads) {
    const int r = i / c4, ch = i - r * c4;
    const bool ok = r < rows;
    cp_async16(dst + r * ld + 4 * ch, ok ? src + r * src_ld + 4 * ch : src, ok);
  }
  cp_async_commit();
}

__host__ __device__ constexpr int qkv_smem_floats(int TR, int C) {
  return TR * (C + 4) + kWFloats + 2 * kRows;
}
__host__ __device__ constexpr int out_smem_floats(int TR) { return TR * kOS + kWFloats; }

// K6a: tokens tile * TR .. of the flattened (T, C) input, projected onto
// pass `pass` of wqkv (0 q, 1 k, 2 v); smem: qkv_smem_floats(TR, C) floats.
template <int TR>
__device__ __forceinline__ void attn_qkv_body(const float* __restrict__ x,
                                              const float* __restrict__ g,
                                              const float* __restrict__ wqkv,
                                              float* __restrict__ qkv, int T, int C, int tile,
                                              int pass, float* smem) {
  const int ldx = C + 4;
  float* X = smem;             // TR x ldx: the tile, normalised in place
  float* wbuf = X + TR * ldx;  // two weight slices
  float* mean = wbuf + kWFloats;
  float* rstd = mean + kRows;
  const int tile0 = tile * TR;
  const int rows = min(TR, T - tile0);
  const WeightPass wp{wqkv, kQKV, pass * kCols, kCols, C, pass * kCols + kCols / 2};
  int slot = 0;
  load_w_slice(wp, 0, wbuf, slot);
  load_rows(X, ldx, x + static_cast<size_t>(tile0) * C, C, rows, TR, C, threadIdx.x, kThreads);
  cp_async_wait<0>();
  __syncthreads();
  norm_x_tile(X, ldx, g, rows, C, mean, rstd);  // gemm_tile's first barrier orders it
  float acc[2][4][4];  // with TR = 32 the warps of rows 32..63 idle
  gemm_tile(X, ldx, 1, rows, wp, nullptr, wbuf, slot, acc);
  const WarpTile<2> wt;
  const float scale = pass == 0 ? kScale : 1.f;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wt.row(mt, 2 * h);
      if (r >= rows) continue;
      float* dst = qkv + static_cast<size_t>(tile0 + r) * kQKV + pass * kCols;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        *reinterpret_cast<float2*>(dst + wt.col(nt, 0)) =
            make_float2(acc[mt][nt][2 * h] * scale, acc[mt][nt][2 * h + 1] * scale);
    }
}

// The kCoreThreads threads of a K6b body meet at named barrier `bar`
// (bar.sync with a thread count), so that the persistent kernel can run two
// bodies side by side in one 256-thread block.
__device__ __forceinline__ void core_sync(int bar) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "n"(kCoreThreads) : "memory");
}

// K6b: queries q0 = qt * 64 .. of head h of sample b; qkv: (B n, 384) with
// q already scaled; o: (B n, 128). Run by kCoreThreads threads (this one
// `tid` among them) that meet at barrier `bar`; smem: kCoreSmemFloats floats.
__device__ __forceinline__ void attn_core_body(const float* __restrict__ qkv,
                                               float* __restrict__ o, int n, int qt, int h,
                                               int b, int tid, int bar, float* smem) {
  float* Qs = smem;                  // kQTile x kQS
  float* Ks = Qs + kQTile * kQS;     // kKTile x kQS
  float* Vs = Ks + kKTile * kQS;     // kKTile x kVS
  float* Ps = Vs + kKTile * kVS;     // per warp 16 x kPS
  const int q0 = qt * kQTile;
  const int rows = min(kQTile, n - q0);
  const float* base = qkv + static_cast<size_t>(b) * n * kQKV + h * kDimHead;
  load_rows(Qs, kQS, base + static_cast<size_t>(q0) * kQKV, kQKV, rows, kQTile, kDimHead, tid,
            kCoreThreads);
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const bool active = 16 * warp < rows;  // warp-uniform
  float* pw = Ps + warp * 16 * kPS;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g and g + 8
  float oacc[1][4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[0][nt][e] = 0.f;

  for (int k0 = 0; k0 < n; k0 += kKTile) {
    const int kr = min(kKTile, n - k0);
    core_sync(bar);  // every warp is done with the last tile's k and v
    load_rows(Ks, kQS, base + static_cast<size_t>(k0) * kQKV + kHidden, kQKV, kr, kKTile,
              kDimHead, tid, kCoreThreads);
    load_rows(Vs, kVS, base + static_cast<size_t>(k0) * kQKV + 2 * kHidden, kQKV, kr, kKTile,
              kDimHead, tid, kCoreThreads);
    cp_async_wait<0>();
    core_sync(bar);
    if (!active) continue;
    float s[1][8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[0][nt][e] = 0.f;
    mma_smem(Qs, kQS, 1, Ks, 1, kQS, kDimHead, 16 * warp, 0, s);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (8 * nt + 2 * t + (e & 1) >= kr) s[0][nt][e] = -INFINITY;  // past the keys
        mx[e >> 1] = fmaxf(mx[e >> 1], s[0][nt][e]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      mx[i] = fmaxf(m[i], mx[i]);  // finite: key k0 is in the tile
      alpha[i] = expf(m[i] - mx[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[0][nt][e] - m[e >> 1]);
        s[0][nt][e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = l[i] * alpha[i] + sum[i];
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[0][nt][e] *= alpha[e >> 1];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<float2*>(pw + (g + 8 * i) * kPS + 8 * nt + 2 * t) =
            make_float2(s[0][nt][2 * i], s[0][nt][2 * i + 1]);
    __syncwarp();
    mma_smem(pw, kPS, 1, Vs, kVS, 1, kKTile, 0, 0, oacc);
    __syncwarp();  // P is read before the next tile overwrites it
  }
  if (!active) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * warp + g + 8 * i;
    if (r >= rows) continue;
    const float inv = 1.f / l[i];
    float* dst = o + (static_cast<size_t>(b) * n + q0 + r) * kHidden + h * kDimHead;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      *reinterpret_cast<float2*>(dst + 8 * nt + 2 * t) =
          make_float2(oacc[0][nt][2 * i] * inv, oacc[0][nt][2 * i + 1] * inv);
  }
}

// K6c: tokens tile * TR .., output channels ct * 128 ..: out = x + (O wo +
// bo); smem: out_smem_floats(TR) floats.
template <int TR>
__device__ __forceinline__ void attn_out_body(const float* __restrict__ o,
                                              const float* __restrict__ wo,
                                              const float* __restrict__ bo,
                                              const float* __restrict__ x,
                                              float* __restrict__ out, int T, int C, int tile,
                                              int ct, float* smem) {
  float* Os = smem;              // TR x kOS
  float* wbuf = Os + TR * kOS;   // two weight slices
  const int tile0 = tile * TR, n0 = ct * kCols;
  const int rows = min(TR, T - tile0), nvalid = min(kCols, C - n0);
  const WeightPass wp{wo, C, n0, nvalid, kHidden, n0 + kCols / 2};
  int slot = 0;
  load_w_slice(wp, 0, wbuf, slot);
  load_rows(Os, kOS, o + static_cast<size_t>(tile0) * kHidden, kHidden, rows, TR, kHidden,
            threadIdx.x, kThreads);
  cp_async_wait<0>();  // gemm_tile's first barrier makes the tile visible

  auto store = [&](const auto& acc, const auto& wt) {
#pragma unroll
    for (int mt = 0; mt < static_cast<int>(sizeof(acc) / sizeof(acc[0])); ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = wt.row(mt, 2 * hh);
        if (r >= rows) continue;
        const size_t idx = static_cast<size_t>(tile0 + r) * C + n0;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int c = wt.col(nt, 0);  // even; c < nvalid means c + 1 < nvalid too
          if (c >= nvalid) continue;
          const float2 xv = __ldcg(reinterpret_cast<const float2*>(x + idx + c));
          const float2 bv = *reinterpret_cast<const float2*>(bo + n0 + c);
          *reinterpret_cast<float2*>(out + idx + c) =
              make_float2(xv.x + (acc[mt][nt][2 * hh] + bv.x),
                          xv.y + (acc[mt][nt][2 * hh + 1] + bv.y));
        }
      }
  };
  if (nvalid > kCols / 2) {
    float acc[2][4][4];
    gemm_tile(Os, kOS, 1, rows, wp, nullptr, wbuf, slot, acc);
    store(acc, WarpTile<2>());
  } else {  // at most 64 channels left: all 8 warps on 16 x 32 blocks
    float acc[1][4][4];
    gemm_tile(Os, kOS, 1, rows, wp, nullptr, wbuf, slot, acc);
    store(acc, WarpTile<1>());
  }
}

}  // namespace attn_tc
