// K5: the UNet2D linear-attention block on NHWC fp32,
//   out = x + ChanLN(out_proj(linear_attention(ChanLN(x))), out_g),
// with q softmaxed over each head's 32 channels and then scaled by 32^-0.5,
// k softmaxed over all tokens, context = k v^T per (sample, head) and
// out = context^T q (4 heads x 32).
//
// Replaces _linear_attention_kernel in diffphycon_tpu/research/pallas_unet2d.py
// (:194-226; wrapper linear_attention_block :447-457). The Pallas kernel
// holds a whole sample in VMEM; on Hopper a block cannot hold 2048 tokens x
// 64 channels and the k softmax and the context sum run over all tokens, so
// the block is two launches:
//   K5a, grid (B, head): walks the sample's tokens in tiles of 32, projects
//        each tile onto the head's 32 k and 32 v columns, and keeps the 32x32
//        context with a running max and sum per k row (the online softmax of
//        flash attention), then writes context / sum to a (B, 4, 32, 32)
//        scratch;
//   K5b, grid (B, token tile): projects the tile onto q (all heads), softmaxes
//        and scales it, applies context^T, the out-projection with its bias,
//        the out-ChanLN and the residual.
// Both projections together read wqkv once per token: K5a its k/v columns,
// K5b its q columns. No atomics: every output is written by one thread, so
// the result is the same from run to run.
//
// Bound: operations. ~534 MFLOP per sample over the 8 Burgers sites against
// ~3 MB of activations: ~180 flops per byte, far above the fp32 ridge of
// 67 TFLOP/s / 3.35 TB/s = 20. The design keeps every intermediate (the
// normalised input, q, k, v, the attention output, the projected rows) in
// shared memory or registers and spends its effort on FMAs: each thread owns
// 8 (K5a) or 16 (K5b) tokens of one output column, so one weight load from
// L2 feeds 8-16 FMAs and the activations come as 16-byte broadcasts.
// Plain fp32 FMA on CUDA cores, no tensor cores (a simple kernel first).
#include "linear_attention.cuh"

namespace {

using namespace attn;

__global__ void __launch_bounds__(kLaThreads) la_context_kernel(const float* __restrict__ x,
                                                                const float* __restrict__ g,
                                                                const float* __restrict__ wqkv,
                                                                float* __restrict__ ctx, int n,
                                                                int C) {
  extern __shared__ __align__(16) float smem[];
  la_context_body<false>(x, g, wqkv, ctx, n, C, blockIdx.x, blockIdx.y, smem);
}

__global__ void __launch_bounds__(kLaThreads) la_output_kernel(
    const float* __restrict__ x, const float* __restrict__ g, const float* __restrict__ wqkv,
    const float* __restrict__ ctx, const float* __restrict__ wo, const float* __restrict__ bo,
    const float* __restrict__ og, float* __restrict__ out, int n, int C) {
  extern __shared__ __align__(16) float smem[];
  la_output_body<false>(x, g, wqkv, ctx, wo, bo, og, out, n, C, blockIdx.x, blockIdx.y * kTok,
                        smem);
}

}  // namespace

// x, out: (B, n, C) fp32 (an NHWC tensor with n = H*W); g, bo, og: (C,);
// wqkv: (C, 384); wo: (128, C); ctx: (B, 4, 32, 32) scratch. 1 <= C <= 512
// (the wrapper checks). Launches K5a then K5b on `stream`; returns the first
// cudaError_t that is not cudaSuccess.
extern "C" int linear_attention_f32(const float* x, const float* g, const float* wqkv,
                                    const float* wo, const float* bo, const float* og,
                                    float* ctx, float* out, int B, int n, int C,
                                    void* stream) {
  if (B <= 0 || n <= 0 || C <= 0 || C > kMaxC) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem_a = kLaContextSmem * sizeof(float);
  la_context_kernel<<<dim3(B, kHeads), kLaThreads, smem_a, st>>>(x, g, wqkv, ctx, n, C);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int smem_b = la_output_smem(C) * sizeof(float);
  e = cudaFuncSetAttribute(la_output_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_b);
  if (e != cudaSuccess) return static_cast<int>(e);
  la_output_kernel<<<dim3(B, (n + kTok - 1) / kTok), kLaThreads, smem_b, st>>>(
      x, g, wqkv, ctx, wo, bo, og, out, n, C);
  return static_cast<int>(cudaGetLastError());
}
