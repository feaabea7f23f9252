// K1 and K2 on bf16 activations (flax nn.Conv under dtype=bfloat16):
// conv2d_nhwc_bf16act (K1c) and downsample_nhwc_bf16act (K2c), on the
// persistent, warp-specialised tile of igemm_bf16act.cuh. Their own
// translation unit, so that nvcc builds them in parallel with K1's and K2's
// (kernels/_build.py starts one nvcc per .cu file).
//
// Replace the convolutions of diffphycon_tpu/research/pallas_unet2d.py
// (_conv_kernel :288, _upsample_kernel :279, _matmul_bias_kernel :294,
// _concat_kernel :304, the convs in _resblock_kernel :160 and
// _downsample_kernel :259) as the JAX net computes them under
// dtype=bfloat16: bf16 x bf16 products summed in fp32, rounded to bf16, the
// bias rounded to bf16 added, rounded again. The gathers and the weight
// layouts are K1's and K2's (conv2d_nhwc.cu, downsample_nhwc.cu); the plan is
// unet2d_blocks.tile_plan(..., bf16=True, act=True).
#include "conv_gathers.cuh"
#include "igemm_bf16act.cuh"

// xa, xb and out bf16 NHWC (Ca, Cb multiples of 8), w (K, Co) bf16, bias
// fp32. dims: B, H, W (the output's), Ca, Cb, Co, ks, upsample, then the
// plan: bm, bn, splits, per, CTAs, and 1 where a halo may serve (0: per-tap
// boxes).
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
  return (int)igemm_bf16act::launch(g, a, w, bias, reinterpret_cast<float*>(out), ws, B * H * W,
                                    Co, ks * ks * (Ca + Cb), dims[8], dims[9], dims[10],
                                    dims[11], dims[12], dims[13], (cudaStream_t)stream);
}

// x and out bf16 NHWC (C a multiple of 8), w (4C, Co) bf16, bias fp32.
// dims: B, H, W (the input's), C, Co, then the plan: bm, bn, splits, per,
// CTAs, and an unused 1 (K2's 2 x 2 windows do not overlap: no halo).
extern "C" int downsample_nhwc_bf16act(const __nv_bfloat16* x, const __nv_bfloat16* w,
                                       const float* bias, __nv_bfloat16* out, float* ws,
                                       const int* dims, void* stream) {
  const int B = dims[0], C = dims[3], Co = dims[4];
  if (C % 8) return static_cast<int>(cudaErrorInvalidValue);
  const auto g = igemm::make_down_gather(x, dims[1], dims[2], C);
  const igemm_bf16::SourceE<__nv_bfloat16> a = {x, nullptr, B, dims[1], dims[2], C, 0, g.Ho,
                                                g.Wo, 2, 0, 2, false};
  return (int)igemm_bf16act::launch(g, a, w, bias, reinterpret_cast<float*>(out), ws,
                                    B * g.Ho * g.Wo, Co, 4 * C, dims[5], dims[6], dims[7],
                                    dims[8], dims[9], 0, (cudaStream_t)stream);
}
