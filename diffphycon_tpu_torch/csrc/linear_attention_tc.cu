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
// The bf16 variant (linear_attention_tc_bf16, the Pallas kernel under
// weight_dtype=bfloat16) runs the bodies of attention_bf16.cuh, designed
// for Hopper's bf16 tensor cores (that header says how and why): K5a on
// resident TMA weight stages and wgmma, the same merge, and K5b over tiles
// of the flattened (B n) tokens, one launch each. Its host plan differs in
// two points (kernels/attention.py): two heads per K5a CTA wherever C > 256
// (la_head_groups(..., bf16=True)), so that the resident k | v columns take
// at most 128 KB; and K5b's tile rows and CTAs (la_output_plan).
//
// The bodies live in linear_attention_tc.cuh as device functions of a block
// index: the kernels below call them for their own blockIdx, the persistent
// kernel (unet2d_persistent.cu) for each work item of its stages.

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
#endif
#include "linear_attention_tc.cuh"
#include "attention_bf16.cuh"

namespace {

using namespace la_tc;

template <int kHpc>
__global__ void __launch_bounds__(kThreads, 2)
    la_context_tc_kernel(const float* __restrict__ x, const float* __restrict__ g,
                         const float* __restrict__ wqkv, float* __restrict__ part, int n, int C,
                         int chunk) {
  extern __shared__ __align__(16) float smem[];
  la_context_body<kHpc>(x, g, wqkv, part, n, C, chunk, blockIdx.x, blockIdx.y, blockIdx.z,
                        gridDim.x, smem);
}

__global__ void __launch_bounds__(kThreads)
    la_merge_tc_kernel(const float* __restrict__ part, float* __restrict__ ctx, int S) {
  la_merge_body(part, ctx, S, blockIdx.x);
}

__global__ void __launch_bounds__(kThreads, 2)
    la_output_tc_kernel(const float* __restrict__ x, const float* __restrict__ g,
                        const float* __restrict__ wqkv, const float* __restrict__ ctx,
                        const float* __restrict__ wo, const float* __restrict__ bo,
                        const float* __restrict__ og, float* __restrict__ out, int n, int C) {
  extern __shared__ __align__(16) float smem[];
  la_output_body(x, g, wqkv, ctx, wo, bo, og, out, n, C, blockIdx.x, blockIdx.y, smem);
}

int linear_attention_tc(const float* x, const float* g, const float* wqkv, const float* wo,
                        const float* bo, const float* og, float* part, float* out,
                        const int* dims, void* stream) {
  const int B = dims[0], n = dims[1], C = dims[2], S = dims[3], chunk = dims[4],
            groups = dims[5], stages = dims[6];
  if (B <= 0 || B > 65535 || n <= 0 || C < 4 || C > kMaxC || C % 4 ||
      chunk <= 0 || chunk % kRows || S != (n + chunk - 1) / chunk || S > 65535 ||
      (groups != 1 && groups != 2) || stages < 1 || stages > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool smem_set = false;  // > 48 KB of dynamic shared memory: once, for C up to kMaxC
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(la_context_tc_kernel<4>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         context_smem_floats(kMaxC) * 4);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaFuncSetAttribute(la_context_tc_kernel<2>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
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
      la_context_tc_kernel<4><<<grid, kThreads, context_smem_floats(C) * 4, st>>>(
          x, g, wqkv, part, n, C, chunk);
    else
      la_context_tc_kernel<2><<<grid, kThreads, context_smem_floats(C) * 4, st>>>(
          x, g, wqkv, part, n, C, chunk);
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

// two blocks an SM where their shared memory allows (J = 4: C <= 128)
template <int kHpc, int J>
__global__ void __launch_bounds__(attn_bf16::kThreads, J == 4 ? 2 : 1)
    la_context_bf16_kernel(const float* __restrict__ x, const float* __restrict__ g,
                           const __grid_constant__ CUtensorMap wmap, float* __restrict__ part,
                           int n, int C, int chunk) {
  extern __shared__ __align__(1024) unsigned char smem_bf16[];
  attn_bf16::context_body<kHpc, J>(x, g, &wmap, part, n, C, chunk, blockIdx.x, blockIdx.y,
                                   blockIdx.z, gridDim.x, smem_bf16);
}

// kMulti: several tiles a CTA (the host's plan: one CTA an SM); else one
// tile a CTA
template <int NB, bool kMulti>
__global__ void __launch_bounds__(attn_bf16::kThreads, 1)
    la_output_bf16_kernel(const float* __restrict__ x, const float* __restrict__ g,
                          const __grid_constant__ attn_bf16::OutMaps maps,
                          const float* __restrict__ ctx, const float* __restrict__ bo,
                          const float* __restrict__ og, float* __restrict__ out, int n, int T,
                          int C, int tr) {
  extern __shared__ __align__(1024) unsigned char smem_bf16[];
  // this CTA's share of the tr-token tiles: contiguous, balanced
  const long long tiles = (T + tr - 1) / tr;
  const int begin = static_cast<int>(blockIdx.x * tiles / gridDim.x);
  const int end = static_cast<int>((blockIdx.x + 1) * tiles / gridDim.x);
  attn_bf16::output_body<NB, 4 * NB, kMulti>(x, g, maps, ctx, bo, og, out, n, T, C, tr, begin,
                                             end, smem_bf16);
}

// Set the kernel's dynamic shared memory limit to the most a block may take,
// once per instantiation (each instantiation asks for its own size at launch).
template <class K>
cudaError_t smem_limit(K kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              attn_bf16::kMaxSmem);
}

template <int kHpc, int NB>
cudaError_t launch_context_bf16(const float* x, const float* g, const CUtensorMap& wmap,
                                float* part, int B, int n, int C, int S, int chunk, int groups,
                                cudaStream_t st) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = smem_limit(la_context_bf16_kernel<kHpc, 4 * NB>);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  la_context_bf16_kernel<kHpc, 4 * NB>
      <<<dim3(S, B, groups), attn_bf16::kThreads, attn_bf16::context_smem_bytes(kHpc, C), st>>>(
          x, g, wmap, part, n, C, chunk);
  return cudaGetLastError();
}

template <int NB, bool kMulti>
cudaError_t launch_output_variant(const float* x, const float* g,
                                  const attn_bf16::OutMaps& maps, const float* ctx,
                                  const float* bo, const float* og, float* out, int B, int n,
                                  int C, int tr, int ctas, cudaStream_t st) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = smem_limit(la_output_bf16_kernel<NB, kMulti>);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  la_output_bf16_kernel<NB, kMulti>
      <<<ctas, attn_bf16::kThreads, attn_bf16::output_smem_bytes(C, kMulti), st>>>(
          x, g, maps, ctx, bo, og, out, n, B * n, C, tr);
  return cudaGetLastError();
}

// ctas below the tile count (C <= 128 only): the kMulti variant
template <int NB>
cudaError_t launch_output_bf16(const float* x, const float* g, const attn_bf16::OutMaps& maps,
                               const float* ctx, const float* bo, const float* og, float* out,
                               int B, int n, int C, int tr, int ctas, cudaStream_t st) {
  const long long tiles = (static_cast<long long>(B) * n + tr - 1) / tr;
  if constexpr (NB == 1) {
    if (ctas < tiles)
      return launch_output_variant<1, true>(x, g, maps, ctx, bo, og, out, B, n, C, tr, ctas, st);
  } else if (ctas != tiles) {
    return cudaErrorInvalidValue;
  }
  return launch_output_variant<NB, false>(x, g, maps, ctx, bo, og, out, B, n, C, tr, ctas, st);
}

int linear_attention_bf16(const float* x, const float* g, const __nv_bfloat16* wqkv,
                          const __nv_bfloat16* wo, const float* bo, const float* og, float* part,
                          float* out, const int* dims, void* stream) {
  const int B = dims[0], n = dims[1], C = dims[2], S = dims[3], chunk = dims[4],
            groups = dims[5], stages = dims[6], ctas = dims[7], tr = dims[8];
  const long long tiles = (static_cast<long long>(B) * n + tr - 1) / tr;
  if (B <= 0 || B > 65535 || n <= 0 || C < 8 || C > kMaxC || C % 8 || chunk <= 0 ||
      chunk % kRows || S != (n + chunk - 1) / chunk || S > 65535 ||
      (groups != 1 && groups != 2) || (groups == 1 && C > 256) || stages < 1 || stages > 3 ||
      (tr != 32 && tr != 64) || ctas < 1 || ctas > tiles || ctas > 65535 * 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  attn_bf16::OutMaps maps;
  cudaError_t e = hopper_tma::weight_map(&maps.wqkv, wqkv, C, kQKV, kQKV);
  if (e == cudaSuccess) e = hopper_tma::weight_map(&maps.wo, wo, kHidden, C, C);
  if (e != cudaSuccess) return static_cast<int>(e);
  float* ctx = part + static_cast<size_t>(B) * S * kHidden * kPartStride;
  const int nb = (C + 127) / 128;
  if (stages & 1) {
    if (groups == 1)
      e = nb == 1 ? launch_context_bf16<4, 1>(x, g, maps.wqkv, part, B, n, C, S, chunk, 1, st)
                  : launch_context_bf16<4, 2>(x, g, maps.wqkv, part, B, n, C, S, chunk, 1, st);
    else
      e = nb == 1   ? launch_context_bf16<2, 1>(x, g, maps.wqkv, part, B, n, C, S, chunk, 2, st)
          : nb == 2 ? launch_context_bf16<2, 2>(x, g, maps.wqkv, part, B, n, C, S, chunk, 2, st)
          : nb == 3 ? launch_context_bf16<2, 3>(x, g, maps.wqkv, part, B, n, C, S, chunk, 2, st)
                    : launch_context_bf16<2, 4>(x, g, maps.wqkv, part, B, n, C, S, chunk, 2, st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (stages & 2) {
    la_merge_tc_kernel<<<B, kThreads, 0, st>>>(part, ctx, S);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    e = nb == 1   ? launch_output_bf16<1>(x, g, maps, ctx, bo, og, out, B, n, C, tr, ctas, st)
        : nb == 2 ? launch_output_bf16<2>(x, g, maps, ctx, bo, og, out, B, n, C, tr, ctas, st)
        : nb == 3 ? launch_output_bf16<3>(x, g, maps, ctx, bo, og, out, B, n, C, tr, ctas, st)
                  : launch_output_bf16<4>(x, g, maps, ctx, bo, og, out, B, n, C, tr, ctas, st);
    return static_cast<int>(e);
  }
  return 0;
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
  return linear_attention_tc(x, g, wqkv, wo, bo, og, part, out, dims, stream);
}

// The bf16 variant: wqkv and wo bf16, C a multiple of 8, head groups 2
// wherever C > 256 (attention_bf16.cuh's bodies); dims[7]: K5b's CTAs, 1 ..
// ceil(B n / tr), each over a contiguous share of the tiles of the
// flattened tokens (fewer CTAs than tiles, C <= 128 only: the several-tiles
// variant);
// dims[8]: tr, K5b's tokens per tile, 64 or 32; the rest as
// linear_attention_tc_f32.
extern "C" int linear_attention_tc_bf16(const float* x, const float* g,
                                        const __nv_bfloat16* wqkv, const __nv_bfloat16* wo,
                                        const float* bo, const float* og, float* part,
                                        float* out, const int* dims, void* stream) {
  return linear_attention_bf16(x, g, wqkv, wo, bo, og, part, out, dims, stream);
}
