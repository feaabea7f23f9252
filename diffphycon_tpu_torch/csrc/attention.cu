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
// The bf16 variant (attention_bf16) runs K6a and K6c on attention_bf16.cuh's
// bodies (the ChanLN'd tile written once as bf16 in the swizzle wgmma
// reads, the weight stages by TMA, wgmma from shared memory; 64-token tiles
// of the flattened tokens, no 32-token tiles with idle warps; that header
// says why) and K6b as above, the same 3xTF32 online softmax on fp32 q, k, v.
//
// The bodies live in attention.cuh: the kernels below call them for their
// own blockIdx, the persistent kernel (unet2d_persistent.cu) for each work
// item of its attention stages.
#include "attention.cuh"
#include "attention_bf16.cuh"

namespace {

using namespace attn_tc;

template <int TR>
__global__ void __launch_bounds__(kThreads) attn_qkv_kernel(const float* __restrict__ x,
                                                            const float* __restrict__ g,
                                                            const float* __restrict__ wqkv,
                                                            float* __restrict__ qkv, int T,
                                                            int C) {
  extern __shared__ __align__(16) float smem[];
  attn_qkv_body<TR>(x, g, wqkv, qkv, T, C, blockIdx.x, blockIdx.y, smem);
}

__global__ void __launch_bounds__(kCoreThreads) attn_core_kernel(const float* __restrict__ qkv,
                                                                 float* __restrict__ o, int n) {
  __shared__ __align__(16) float smem[kCoreSmemFloats];
  attn_core_body(qkv, o, n, blockIdx.x, blockIdx.y, blockIdx.z, threadIdx.x, 0, smem);
}

template <int TR>
__global__ void __launch_bounds__(kThreads) attn_out_kernel(const float* __restrict__ o,
                                                            const float* __restrict__ wo,
                                                            const float* __restrict__ bo,
                                                            const float* __restrict__ x,
                                                            float* __restrict__ out, int T,
                                                            int C) {
  extern __shared__ __align__(16) float smem[];
  attn_out_body<TR>(o, wo, bo, x, out, T, C, blockIdx.x, blockIdx.y, smem);
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
      e = cudaFuncSetAttribute(attn_out_kernel<TR>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               out_smem_floats(TR) * 4);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const int T = B * n, tiles = (T + TR - 1) / TR;
  attn_qkv_kernel<TR><<<dim3(tiles, 3), kThreads, qkv_smem_floats(TR, C) * 4, st>>>(
      x, g, wqkv, qkv, T, C);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  attn_core_kernel<<<dim3((n + kQTile - 1) / kQTile, kHeads, B), kCoreThreads, 0, st>>>(qkv, o,
                                                                                         n);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  attn_out_kernel<TR><<<dim3(tiles, (C + kCols - 1) / kCols), kThreads,
                            out_smem_floats(TR) * 4, st>>>(o, wo, bo, x, out, T, C);
  return cudaGetLastError();
}

int attention(const float* x, const float* g, const float* wqkv, const float* wo, const float* bo,
              float* out, float* scratch, const int* dims, void* stream) {
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

template <int NB>
__global__ void __launch_bounds__(attn_bf16::kThreads, 1)
    attn_qkv_bf16_kernel(const float* __restrict__ x, const float* __restrict__ g,
                         const __grid_constant__ CUtensorMap wmap, float* __restrict__ qkv, int T,
                         int C) {
  extern __shared__ __align__(1024) unsigned char smem_bf16[];
  attn_bf16::qkv_body<4 * NB>(x, g, &wmap, qkv, T, C, blockIdx.x, blockIdx.y, smem_bf16);
}

__global__ void __launch_bounds__(attn_bf16::kThreads, 1)
    attn_out_bf16_kernel(const float* __restrict__ o, const __grid_constant__ CUtensorMap wmap,
                         const float* __restrict__ bo, const float* __restrict__ x,
                         float* __restrict__ out, int T, int C) {
  extern __shared__ __align__(1024) unsigned char smem_bf16[];
  attn_bf16::attn_out_body(o, &wmap, bo, x, out, T, C, blockIdx.x, blockIdx.y, smem_bf16);
}

template <int NB>
cudaError_t launch_qkv_bf16(const float* x, const float* g, const CUtensorMap& wmap, float* qkv,
                            int T, int C, cudaStream_t st) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(attn_qkv_bf16_kernel<NB>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               attn_bf16::kMaxSmem);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  attn_qkv_bf16_kernel<NB><<<dim3((T + attn_bf16::kRows - 1) / attn_bf16::kRows, 3),
                             attn_bf16::kThreads, attn_bf16::qkv_smem_bytes(C), st>>>(x, g, wmap,
                                                                                      qkv, T, C);
  return cudaGetLastError();
}

int attention_bf16_launch(const float* x, const float* g, const __nv_bfloat16* wqkv,
                          const __nv_bfloat16* wo, const float* bo, float* out, float* scratch,
                          const int* dims, void* stream) {
  const int B = dims[0], n = dims[1], C = dims[2], TR = dims[3];
  if (B <= 0 || B > 65535 || n <= 0 || C < 8 || C > kMaxC || C % 8 ||
      static_cast<long long>(B) * n * (kQKV + kHidden) > 0x7fffffffLL || TR != attn_bf16::kRows)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_out_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, attn_bf16::kOutProjSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  CUtensorMap wq, wom;
  cudaError_t e = hopper_tma::weight_map(&wq, wqkv, C, kQKV, kQKV);
  if (e == cudaSuccess) e = hopper_tma::weight_map(&wom, wo, kHidden, C, C);
  if (e != cudaSuccess) return static_cast<int>(e);
  float* qkv = scratch;
  float* o = scratch + static_cast<size_t>(B) * n * kQKV;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int T = B * n, nb = (C + 127) / 128;
  e = nb == 1   ? launch_qkv_bf16<1>(x, g, wq, qkv, T, C, st)
      : nb == 2 ? launch_qkv_bf16<2>(x, g, wq, qkv, T, C, st)
      : nb == 3 ? launch_qkv_bf16<3>(x, g, wq, qkv, T, C, st)
                : launch_qkv_bf16<4>(x, g, wq, qkv, T, C, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  attn_core_kernel<<<dim3((n + kQTile - 1) / kQTile, kHeads, B), kCoreThreads, 0, st>>>(qkv, o, n);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  attn_out_bf16_kernel<<<dim3((T + attn_bf16::kRows - 1) / attn_bf16::kRows, (C + 127) / 128),
                         attn_bf16::kThreads, attn_bf16::kOutProjSmem, st>>>(o, wom, bo, x, out, T,
                                                                             C);
  return static_cast<int>(cudaGetLastError());
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
  return attention(x, g, wqkv, wo, bo, out, scratch, dims, stream);
}

// The bf16 variant: wqkv and wo bf16, C a multiple of 8, TR 64; K6a and K6c
// on attention_bf16.cuh's bodies, K6b unchanged (3xTF32 on fp32 q, k, v);
// the rest as attention_f32.
extern "C" int attention_bf16(const float* x, const float* g, const __nv_bfloat16* wqkv,
                              const __nv_bfloat16* wo, const float* bo, float* out,
                              float* scratch, const int* dims, void* stream) {
  return attention_bf16_launch(x, g, wqkv, wo, bo, out, scratch, dims, stream);
}
