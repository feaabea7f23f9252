// K1 and K2 on bf16 activations (flax nn.Conv under dtype=bfloat16):
// conv2d_nhwc_bf16act and downsample_nhwc_bf16act, the bf16 core
// (igemm_bf16.cuh) instantiated for bf16 sources and outputs. Their own
// translation unit, so that nvcc builds these instantiations in parallel
// with K1's and K2's (kernels/_build.py starts one nvcc per .cu file).
//
// Replace the convolutions of diffphycon_tpu/research/pallas_unet2d.py
// (_conv_kernel :288, _upsample_kernel :279, _matmul_bias_kernel :294,
// _concat_kernel :304, the convs in _resblock_kernel :160 and
// _downsample_kernel :259) as the JAX net computes them under
// dtype=bfloat16: bf16 x bf16 products summed in fp32, rounded to bf16, the
// bias rounded to bf16 added, rounded again. The gathers, the tile plans
// and the weight layouts are K1's and K2's (conv2d_nhwc.cu,
// downsample_nhwc.cu).
#include "conv_gathers.cuh"
#include "igemm_bf16.cuh"

// The bf16-activation variant (flax nn.Conv under dtype=bfloat16): xa, xb
// and out bf16 NHWC (Ca, Cb multiples of 8), w (K, Co) bf16, bias fp32; the
// products of the stored bf16 values summed in fp32, rounded to bf16, plus
// the bias rounded to bf16, rounded again (igemm_bf16.cuh). dims as
// conv2d_nhwc_f32's, the plan from tile_plan(..., bf16=True).
extern "C" int conv2d_nhwc_bf16act(const __nv_bfloat16* xa, const __nv_bfloat16* xb,
                                   const __nv_bfloat16* w, const float* bias, __nv_bfloat16* out,
                                   float* ws, const int* dims, void* stream) {
  const int B = dims[0], H = dims[1], W = dims[2], Ca = dims[3], Cb = dims[4], Co = dims[5];
  const int ks = dims[6];
  const int up = dims[7];
  if (Ca % 8 || Cb % 8) return static_cast<int>(cudaErrorInvalidValue);
  const auto g = igemm::make_conv_gather(xa, xb, H, W, Ca, Cb, ks, up);
  const igemm_bf16::SourceE<__nv_bfloat16> a = {
      xa, xb, B, up ? H / 2 : H, up ? W / 2 : W, Ca, Cb, H, W, ks, (ks - 1) / 2, 1, up != 0};
  return (int)igemm_bf16::launch(g, a, w, bias, reinterpret_cast<float*>(out), ws, B * H * W,
                                 Co, ks * ks * (Ca + Cb), dims[8], dims[9], dims[10], dims[11],
                                 (cudaStream_t)stream);
}

// The bf16-activation variant: x and out bf16 NHWC (C a multiple of 8), w
// (4C, Co) bf16, bias fp32; flax's bf16 rounding of the sum and the bias
// (igemm_bf16.cuh); dims as downsample_nhwc_f32's.
extern "C" int downsample_nhwc_bf16act(const __nv_bfloat16* x, const __nv_bfloat16* w,
                                       const float* bias, __nv_bfloat16* out, float* ws,
                                       const int* dims, void* stream) {
  const int B = dims[0], C = dims[3], Co = dims[4];
  if (C % 8) return static_cast<int>(cudaErrorInvalidValue);
  const auto g = igemm::make_down_gather(x, dims[1], dims[2], C);
  const igemm_bf16::SourceE<__nv_bfloat16> a = {x, nullptr, B, dims[1], dims[2], C, 0, g.Ho,
                                                g.Wo, 2, 0, 2, false};
  return (int)igemm_bf16::launch(g, a, w, bias, reinterpret_cast<float*>(out), ws,
                                 B * g.Ho * g.Wo, Co, 4 * C, dims[5], dims[6], dims[7], dims[8],
                                 (cudaStream_t)stream);
}
