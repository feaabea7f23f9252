// K6: the UNet2D full-attention block on NHWC fp32,
//   out = x + out_proj(softmax(q k^T * 32^-0.5) v) + bo,  q, k, v = ChanLN(x) wqkv,
// over all n tokens of a sample (any n >= 1), 4 heads x 32, the softmax in
// fp32.
//
// Replaces _attention_kernel in diffphycon_tpu/research/pallas_unet2d.py
// (:229-256; wrapper attention_block :459-468). On the Burgers net it runs
// once per forward, at the 2x16 bottleneck (n = 32, C = 512).
//
// Bound: operations. The projections are ~97% of the flops at the
// bottleneck (2 n C 384 + 2 n 128 C against 4 n^2 128 for the core) at
// ~130 flops per byte of activations, so they run on the tensor cores in
// 3xTF32 (la_tc's gemm_tile: mma.sync m16n8k8, a = hi + lo rounded by
// cvt.rna, a b ~ lo hi' + hi lo' + hi hi', each 32-deep slice's sums
// promoted into an fp32 total), fp32-accurate. The Pallas kernel held a
// whole sample in VMEM; a design of one block per sample holds 32 tokens at
// most and leaves 82 of 132 SMs idle at batch 50. One call is three launches
// that split the work over the card:
//   K6a, grid (ceil(B n / TR), 3): a tile of TR tokens of the flattened
//        (B n, C) input (tiles run across samples: ChanLN is per token),
//        copied in, ChanLN'd in place, projected onto one of q, k, v (128
//        columns of wqkv, the weight streamed in 32-deep slices); q scaled
//        by 32^-0.5. Writes the (B n, 384) qkv scratch. TR = 32 where
//        64-token tiles would leave SMs idle (kernels/attention.py:
//        attn_tile_rows): a 32-token CTA takes ~101 KB at C = 512, so two
//        share an SM (4 of its 8 warps idle in the product: giving them
//        16 x 32 blocks of their own timed the same on an H100).
//   K6b, grid (ceil(n / 64), 4, B): 64 queries of one (sample, head), one
//        warp per 16 queries, online softmax over 64-key tiles (FlashAttention's
//        loop): S = q k^T on the tensor cores, the running row max and sum
//        by shuffles among a row's four lanes, O rescaled as the max moves,
//        P through the warp's own shared memory into P v on the tensor
//        cores; no n x n matrix is stored. Writes O / sum to the (B n, 128)
//        scratch.
//   K6c, grid (ceil(B n / TR), ceil(C / 128)): the out-projection of a TR
//        token tile onto 128 output channels (its 32-deep slices are the
//        heads, so the heads' partials are summed in head order), plus the
//        bias and the residual.
// No atomics: every output is written by one thread in a fixed order, so two
// calls on the same inputs are bit-equal. expf, not __expf.
//
// The persistent kernel (unet2d_persistent.cu) keeps its own attention
// stage (linear_attention.cuh, attention_common.cuh's 32-token tiles).
#include "linear_attention_tc.cuh"

namespace {

using namespace la_tc;

constexpr int kQTile = 64;        // queries per K6b CTA: 4 warps x 16
constexpr int kKTile = 64;        // keys per K6b step
constexpr int kCoreThreads = 128;
constexpr int kQS = kDimHead + 4;  // q and k rows: conflict-free A and B fragments
constexpr int kVS = kDimHead + 8;  // v rows
constexpr int kPS = kKTile + 4;    // a warp's P rows
constexpr int kOS = kHidden + 4;   // K6c's O tile rows

// Rows 0 .. rows - 1 of src (cols floats each, src_ld apart, cols a
// multiple of 4) into dst (ld apart); rows rows .. TR - 1 zero-filled.
// Commits one cp.async group.
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src, size_t src_ld,
                                          int rows, int TR, int cols, int threads) {
  const int c4 = cols / 4;
  for (int i = threadIdx.x; i < TR * c4; i += threads) {
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

// K6a: tokens tile0 = blockIdx.x * TR .. of the flattened (T, C) input,
// projected onto pass blockIdx.y of wqkv (0 q, 1 k, 2 v).
template <int TR>
__global__ void __launch_bounds__(kThreads) attn_qkv_kernel(const float* __restrict__ x,
                                                            const float* __restrict__ g,
                                                            const float* __restrict__ wqkv,
                                                            float* __restrict__ qkv, int T,
                                                            int C) {
  extern __shared__ __align__(16) float smem[];
  const int ldx = C + 4;
  float* X = smem;             // TR x ldx: the tile, normalised in place
  float* wbuf = X + TR * ldx;  // two weight slices
  float* mean = wbuf + kWFloats;
  float* rstd = mean + kRows;
  const int tile0 = blockIdx.x * TR, pass = blockIdx.y;
  const int rows = min(TR, T - tile0);
  const WeightPass wp{wqkv, kQKV, pass * kCols, kCols, C, pass * kCols + kCols / 2};
  int slot = 0;
  load_w_slice(wp, 0, wbuf, slot);
  load_rows(X, ldx, x + static_cast<size_t>(tile0) * C, C, rows, TR, C, kThreads);
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

// K6b: queries q0 = blockIdx.x * 64 .. of head blockIdx.y of sample
// blockIdx.z; qkv: (B n, 384) with q already scaled; o: (B n, 128).
__global__ void __launch_bounds__(kCoreThreads) attn_core_kernel(const float* __restrict__ qkv,
                                                                 float* __restrict__ o, int n) {
  __shared__ __align__(16) float Qs[kQTile * kQS];
  __shared__ __align__(16) float Ks[kKTile * kQS];
  __shared__ __align__(16) float Vs[kKTile * kVS];
  __shared__ __align__(16) float Ps[kCoreThreads / 32][16 * kPS];
  const int q0 = blockIdx.x * kQTile, h = blockIdx.y, b = blockIdx.z;
  const int rows = min(kQTile, n - q0);
  const float* base = qkv + static_cast<size_t>(b) * n * kQKV + h * kDimHead;
  load_rows(Qs, kQS, base + static_cast<size_t>(q0) * kQKV, kQKV, rows, kQTile, kDimHead,
            kCoreThreads);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool active = 16 * warp < rows;  // warp-uniform
  float* pw = Ps[warp];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g and g + 8
  float oacc[1][4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[0][nt][e] = 0.f;

  for (int k0 = 0; k0 < n; k0 += kKTile) {
    const int kr = min(kKTile, n - k0);
    __syncthreads();  // every warp is done with the last tile's k and v
    load_rows(Ks, kQS, base + static_cast<size_t>(k0) * kQKV + kHidden, kQKV, kr, kKTile,
              kDimHead, kCoreThreads);
    load_rows(Vs, kVS, base + static_cast<size_t>(k0) * kQKV + 2 * kHidden, kQKV, kr, kKTile,
              kDimHead, kCoreThreads);
    cp_async_wait<0>();
    __syncthreads();
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

// K6c: tokens tile0 = blockIdx.x * TR .., output channels n0 =
// blockIdx.y * 128 ..: out = x + (O wo + bo).
template <int TR>
__global__ void __launch_bounds__(kThreads) attn_out_kernel(const float* __restrict__ o,
                                                            const float* __restrict__ wo,
                                                            const float* __restrict__ bo,
                                                            const float* __restrict__ x,
                                                            float* __restrict__ out, int T,
                                                            int C) {
  extern __shared__ __align__(16) float smem[];
  float* Os = smem;              // TR x kOS
  float* wbuf = Os + TR * kOS;   // two weight slices
  const int tile0 = blockIdx.x * TR, n0 = blockIdx.y * kCols;
  const int rows = min(TR, T - tile0), nvalid = min(kCols, C - n0);
  const WeightPass wp{wo, C, n0, nvalid, kHidden, n0 + kCols / 2};
  int slot = 0;
  load_w_slice(wp, 0, wbuf, slot);
  load_rows(Os, kOS, o + static_cast<size_t>(tile0) * kHidden, kHidden, rows, TR, kHidden,
            kThreads);
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
          const float2 xv = *reinterpret_cast<const float2*>(x + idx + c);
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

template <int TR>
cudaError_t launch_tiles(const float* x, const float* g, const float* wqkv, const float* wo,
                         const float* bo, float* out, float* qkv, float* o, int B, int n, int C,
                         cudaStream_t st) {
  static bool smem_set = false;  // > 48 KB of dynamic shared memory: once, for C up to kMaxC
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(attn_qkv_kernel<TR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         qkv_smem_floats(TR, kMaxC) * 4);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(attn_out_kernel<TR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               out_smem_floats(TR) * 4);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const int T = B * n, tiles = (T + TR - 1) / TR;
  attn_qkv_kernel<TR><<<dim3(tiles, 3), kThreads, qkv_smem_floats(TR, C) * 4, st>>>(x, g, wqkv,
                                                                                     qkv, T, C);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  attn_core_kernel<<<dim3((n + kQTile - 1) / kQTile, kHeads, B), kCoreThreads, 0, st>>>(qkv, o,
                                                                                         n);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  attn_out_kernel<TR><<<dim3(tiles, (C + kCols - 1) / kCols), kThreads, out_smem_floats(TR) * 4,
                        st>>>(o, wo, bo, x, out, T, C);
  return cudaGetLastError();
}

}  // namespace

// x, out: (B, n, C) fp32 (an NHWC tensor with n = H * W); g, bo: (C,); wqkv:
// (C, 384); wo: (128, C); scratch: B n 512 floats (qkv, then O). dims: {B,
// n, C, TR}: B <= 65535, n >= 1, C a multiple of 4 in 4 .. 512, B n 512 <
// 2^31, TR 32 or 64 (the token tile of K6a and K6c), every pointer 16-byte
// aligned (the wrapper checks). Three launches on `stream`; returns the first
// cudaError_t that is not cudaSuccess.
extern "C" int attention_f32(const float* x, const float* g, const float* wqkv, const float* wo,
                             const float* bo, float* out, float* scratch, const int* dims,
                             void* stream) {
  const int B = dims[0], n = dims[1], C = dims[2], TR = dims[3];
  if (B <= 0 || B > 65535 || n <= 0 || C < 4 || C > kMaxC || C % 4 ||
      static_cast<long long>(B) * n * (kQKV + kHidden) > 0x7fffffffLL || (TR != 32 && TR != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  float* qkv = scratch;
  float* o = scratch + static_cast<size_t>(B) * n * kQKV;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(TR == 32 ? launch_tiles<32>(x, g, wqkv, wo, bo, out, qkv, o, B, n, C, st)
                                   : launch_tiles<64>(x, g, wqkv, wo, bo, out, qkv, o, B, n, C, st));
}
