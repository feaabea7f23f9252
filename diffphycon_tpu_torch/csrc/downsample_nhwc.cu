// K2: 2x2 stride-2 convolution on NHWC fp32 with bias, the UNet2D downsample
// (space-to-depth + 1x1 conv).
//
// Replaces _downsample_kernel in diffphycon_tpu/research/pallas_unet2d.py.
// The space-to-depth tensor is never built: each output pixel gathers its
// four input pixels at load time.
//
// Bound: operations. Each output pixel does 2*4*C*Co flops (C=64, Co=64 at the
// first level: 32768) against 4*C*4 + Co*4 bytes of activations, far above
// the fp32 ridge of ~20 flops/byte. Same FMA tiling as the convs
// (igemm_nhwc.cuh).
//
// Weight layout: w[k, co] with k = (p1*2 + p2) * C + c, the (p1 p2 c) row
// order of the packed Pallas weight (_down_p); the reference checkpoint's
// (c p1 p2) order is permuted when weights are packed.
#include "conv_gathers.cuh"

// x: (B, H, W, C) with even H, W; out: (B, H/2, W/2, Co); C and Co
// multiples of 4, pointers 16-byte aligned (the wrapper checks).
// Returns cudaGetLastError() after launch.
extern "C" int downsample_nhwc_f32(const float* x, const float* w, const float* bias,
                                   float* out, int B, int H, int W, int C, int Co,
                                   void* stream) {
  const auto g = igemm::make_down_gather<false>(x, H, W, C);
  const int M = B * g.Ho * g.Wo;
  return (int)igemm::launch(g, w, bias, out, M, Co, 4 * C, (cudaStream_t)stream);
}
