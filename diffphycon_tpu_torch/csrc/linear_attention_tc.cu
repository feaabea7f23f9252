// K5: the UNet2D linear-attention block on NHWC fp32,
//   out = x + ChanLN(out_proj(context^T (softmax_d(q) * 32^-0.5)), out_g),
// with q, k, v = ChanLN(x, norm_g) wqkv (4 heads of 32) and, per (sample,
// head), context = softmax_tokens(k)^T v.
//
// Replaces _linear_attention_kernel in diffphycon_tpu/research/pallas_unet2d.py
// (:194-226; wrapper linear_attention_block :447-457). The Pallas kernel
// holds a whole sample in VMEM; on Hopper a block cannot, and the k softmax
// and the context sum run over all of a sample's tokens, so one call is three
// launches:
//   K5a, grid (S, B, head groups): chunk s of sample b's tokens (the
//        host's plan, kernels/attention.py: la_chunk_plan, cuts each sample
//        into S chunks so that B * S fills the card, and splits the heads
//        over 2 CTAs where even 2 B S CTAs leave SMs idle). Per 64-token
//        tile: copy x in,
//        ChanLN it in place (each token's statistics once for all heads),
//        project the tile onto its heads' k and v columns (256 or 128 of
//        wqkv's 384) on the tensor cores, then per (head, d) the running max
//        over the chunk's tokens, exp(k - max), the running sum (from the k
//        accumulators in registers), and the partial context exp(k)^T v on
//        the tensor cores in 3xTF32 (mma_smem), rescaled as the max moves
//        (the online softmax). Writes (context, max, sum) of the chunk to a
//        (B, S, 4, 32, 34) scratch that the wrapper allocates.
//   merge, grid (B): merges the sample's S partials in the fixed order s =
//        0 .. S-1 with the online-softmax rescale and divides by the sum,
//        into a (B, 4, 32, 32) context (once per sample: in K5b's prologue
//        every one of a sample's n / 64 CTAs repeated it, and it took a
//        fifth of K5b's time on an H100);
//   K5b, grid (ceil(n / 64), B): copies the context, the x tile and the
//        first weight slice in together; ChanLN of the tile; the q
//        projection (tile x C x 128) on the tensor cores; the softmax over
//        each head's 32 channels and the 32^-0.5 scale; the context applied
//        on the tensor cores in 3xTF32 (mma_smem); the out-projection
//        (tile x 128 x C) on the tensor cores with its bias; the out-ChanLN
//        and the residual, stored with 16-byte stores.
//
// Bound: operations. The projections are ~90% of the flops (2 n C 384 +
// 2 n 128 C against 2 n 8192 for the context and its application) at
// ~64-512 flops per byte of activations. So they run on the tensor cores:
// mma.sync m16n8k8 in 3xTF32 (a = hi + lo, each rounded to TF32 by
// cvt.rna; a b ~ lo hi' + hi lo' + hi hi', the lo lo' term dropped is
// ~2^-22 relative), fp32-accurate, with each 32-deep slice's sums promoted
// into an fp32 total as in igemm_tc.cuh. The weights stream through shared
// memory in 32-deep slices by cp.async, so each weight byte is read from L2
// once per 64 tokens, and each pass's first slice is copied while the pass
// before it runs. The row statistics take four threads per row and the
// token softmax works on the k accumulators in registers, so no phase walks
// the tile's 64 rows one after another. No atomics: every output is written
// by one thread in a fixed order, so two calls on the same inputs are
// bit-equal. fp32 in and out, expf (not __expf).
//
// The persistent kernel (unet2d_persistent.cu) keeps its own K5 bodies
// (linear_attention.cuh).
#include "linear_attention_tc.cuh"

// Phase clocks, compiled in only with -DLA_PHASE_CLOCKS (the build that
// tools/k5_phase_clocks.py makes): LA_STAMP(i) has thread 0 of each CTA
// write clock64() to slot i of the CTA's kStampSlots in la_stamps.
#ifdef LA_PHASE_CLOCKS
constexpr int kStampSlots = 48;
__device__ long long la_stamps[4000000];
#define LA_STAMP(i)                                                                         \
  do {                                                                                      \
    if (threadIdx.x == 0)                                                                   \
      la_stamps[((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) *          \
                    kStampSlots +                                                           \
                (i)] = clock64();                                                           \
  } while (0)
extern "C" int la_stamps_read(long long* host, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, la_stamps, sizeof(long long) * n));
}
#else
#define LA_STAMP(i) \
  do {              \
  } while (0)
#endif

namespace {

using namespace la_tc;

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

// K5a: chunk s = blockIdx.x of sample b = blockIdx.y, tokens [s * chunk,
// min(n, (s + 1) * chunk)), heads kHpc * blockIdx.z .. + kHpc - 1. With all
// 4 heads a tile takes two 128-column passes (k, then v); with 2 (the
// host's plan where B * S CTAs would leave SMs idle) one pass holds
// both heads' k (columns 0..63) and v (64..127), and twice as many CTAs
// share the work.
template <int kHpc>
__global__ void __launch_bounds__(kThreads, 2)
    la_context_tc_kernel(const float* __restrict__ x, const float* __restrict__ g,
                         const float* __restrict__ wqkv, float* __restrict__ part, int n, int C,
                         int chunk) {
  static_assert(kHpc == 4 || kHpc == 2, "4 or 2 heads per CTA");
  constexpr int kJ = kHpc * kDimHead;  // this CTA's k columns (and v columns)
  constexpr int kNT = kHpc == 4 ? 2 : 1;  // context columns per warp / 8
  extern __shared__ __align__(16) float smem[];
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
  const int b = blockIdx.y, s = blockIdx.x, h0 = kHpc * blockIdx.z;
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
  float* o = part + ((static_cast<size_t>(b) * gridDim.x + s) * kHidden + h0 * kDimHead) *
                        kPartStride;
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

// The merge, per sample b = blockIdx.x: the S partials in order s = 0 ..
// S-1 with the online-softmax rescale, then / sum, into ctx (B, 4, 32, 32).
__global__ void __launch_bounds__(kThreads)
    la_merge_tc_kernel(const float* __restrict__ part, float* __restrict__ ctx, int S) {
  const int tid = threadIdx.x, b = blockIdx.x;
  const int hd = tid >> 1, e0 = (tid & 1) * 16;
  const size_t step = static_cast<size_t>(kHidden) * kPartStride;
  const float* pb = part + static_cast<size_t>(b) * S * step + hd * kPartStride;
  float m = -INFINITY;
#pragma unroll 8
  for (int s = 0; s < S; ++s) m = fmaxf(m, pb[s * step + kDimHead]);
  float c[16], l = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) c[i] = 0.f;
#pragma unroll 4
  for (int s = 0; s < S; ++s) {
    const float* ps = pb + s * step;
    const float w = expf(ps[kDimHead] - m);
    l += w * ps[kDimHead + 1];
#pragma unroll
    for (int i = 0; i < 16; i += 2) {
      const float2 v = *reinterpret_cast<const float2*>(ps + e0 + i);
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

// K5b: tokens tile0 = blockIdx.x * 64 .. + 63 of sample b = blockIdx.y.
__global__ void __launch_bounds__(kThreads, 2)
    la_output_tc_kernel(const float* __restrict__ x, const float* __restrict__ g,
                        const float* __restrict__ wqkv, const float* __restrict__ ctx,
                        const float* __restrict__ wo, const float* __restrict__ bo,
                        const float* __restrict__ og, float* __restrict__ out, int n, int C) {
  extern __shared__ __align__(16) float smem[];
  const int ldx = C + 4;
  float* X = smem;                        // kRows x ldx: normalised x, then the projected rows
  float* QT = X + kRows * ldx;            // kHidden x kTStride: q, then the attention output
  float* cS = QT + kHidden * kTStride;    // [head][d][e] the context, rows kCtxStride apart
  float* wbuf = cS + kHidden * kCtxStride;
  float* mean = wbuf + kWFloats;          // row statistics of the x tile, then of the rows
  float* rstd = mean + kRows;

  const int tid = threadIdx.x;
  const int b = blockIdx.y, tile0 = blockIdx.x * kRows;
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
    const float4 xv = __ldg(reinterpret_cast<const float4*>(xt + static_cast<size_t>(r) * C + c));
    const float4 gv = __ldg(reinterpret_cast<const float4*>(og + c));
    const float m = mean[r], rs = rstd[r];
    *reinterpret_cast<float4*>(ob + static_cast<size_t>(r) * C + c) =
        make_float4(xv.x + (y.x - m) * rs * gv.x, xv.y + (y.y - m) * rs * gv.y,
                    xv.z + (y.z - m) * rs * gv.z, xv.w + (y.w - m) * rs * gv.w);
  }
  LA_STAMP(7);
}

}  // namespace

// x, out: (B, n, C) fp32 (an NHWC tensor with n = H * W); g, bo, og: (C,);
// wqkv: (C, 384); wo: (128, C); part: scratch of B * S * 128 * 34 floats
// (the chunks' partials) then B * 4096 (the merged contexts). dims: {B, n,
// C, S, chunk, head groups, stages}: S = ceil(n / chunk) chunks of a
// multiple of 64 tokens; K5a CTAs of 4 heads (head groups 1) or 2 (head
// groups 2); stages 3 runs K5a, the merge and K5b (1: K5a alone; 2: the merge
// and K5b, on the partials K5a last wrote; for timing). C a multiple of 4
// in 4 .. 512, every pointer 16-byte aligned (the wrapper checks). Launches
// on `stream`; returns the first cudaError_t that is not cudaSuccess.
extern "C" int linear_attention_tc_f32(const float* x, const float* g, const float* wqkv,
                                       const float* wo, const float* bo, const float* og,
                                       float* part, float* out, const int* dims,
                                       void* stream) {
  const int B = dims[0], n = dims[1], C = dims[2], S = dims[3], chunk = dims[4],
            groups = dims[5], stages = dims[6];
  if (B <= 0 || B > 65535 || n <= 0 || C < 4 || C > kMaxC || C % 4 || chunk <= 0 ||
      chunk % kRows || S != (n + chunk - 1) / chunk || S > 65535 || (groups != 1 && groups != 2) ||
      stages < 1 || stages > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool smem_set = false;  // > 48 KB of dynamic shared memory: once, for C up to kMaxC
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(la_context_tc_kernel<4>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         context_smem_floats(kMaxC) * 4);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaFuncSetAttribute(la_context_tc_kernel<2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             context_smem_floats(kMaxC) * 4);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaFuncSetAttribute(la_output_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             output_smem_floats(kMaxC) * 4);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ctx = part + static_cast<size_t>(B) * S * kHidden * kPartStride;
  if (stages & 1) {
    const dim3 grid(S, B, groups);
    if (groups == 1)
      la_context_tc_kernel<4><<<grid, kThreads, context_smem_floats(C) * 4, st>>>(x, g, wqkv, part,
                                                                                  n, C, chunk);
    else
      la_context_tc_kernel<2><<<grid, kThreads, context_smem_floats(C) * 4, st>>>(x, g, wqkv, part,
                                                                                  n, C, chunk);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (stages & 2) {
    la_merge_tc_kernel<<<B, kThreads, 0, st>>>(part, ctx, S);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    la_output_tc_kernel<<<dim3((n + kRows - 1) / kRows, B), kThreads, output_smem_floats(C) * 4,
                          st>>>(x, g, wqkv, ctx, wo, bo, og, out, n, C);
    return static_cast<int>(cudaGetLastError());
  }
  return 0;
}
