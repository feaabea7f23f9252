// K2: 2x2 stride-2 convolution on NHWC fp32 with bias, the UNet2D downsample
// (space-to-depth + 1x1 conv).
//
// Replaces _downsample_kernel in diffphycon_tpu/research/pallas_unet2d.py.
// The space-to-depth tensor is never built: each output pixel gathers its
// four input pixels at load time.
//
// Bound: operations. Each output pixel does 2*4*C*Co flops (C=64, Co=64 at the
// first level: 32768) against 4*C*4 + Co*4 bytes of activations, far above
// the tensor cores' ridge (~49 flops/byte at the 3xTF32 rate). The same
// 3xTF32 tensor-core core as the convs (igemm_tc.cuh); the bf16 variant
// (downsample_nhwc_bf16) runs the bf16 core (igemm_bf16.cuh), and so does
// the bf16-activation variant (downsample_nhwc_bf16act, flax dtype=bf16;
// in igemm_bf16act.cu).
//
// Weight layout: w[k, co] with k = (p1*2 + p2) * C + c, the (p1 p2 c) row
// order of the packed Pallas weight (_down_p); the reference checkpoint's
// (c p1 p2) order is permuted when weights are packed.
#include "conv_gathers.cuh"
#include "igemm_bf16.cuh"
#include "igemm_tc.cuh"

// dims: {B, H, W, C, Co, bm, bn, splits, per}. x: (B, H, W, C) with even H,
// W; out: (B, H/2, W/2, Co); w: (4C, Co); bm, bn, splits, per, ws: the tile
// plan as in conv2d_nhwc_f32. C and Co multiples of 4, pointers 16-byte
// aligned (the wrapper checks). Returns cudaGetLastError() after launch.
extern "C" int downsample_nhwc_f32(const float* x, const float* w, const float* bias,
                                   float* out, float* ws, const int* dims, void* stream) {
  const int B = dims[0], C = dims[3], Co = dims[4];
  const auto g = igemm::make_down_gather(x, dims[1], dims[2], C);
  return (int)igemm_tc::launch(g, w, bias, out, ws, B * g.Ho * g.Wo, Co, 4 * C, dims[5],
                               dims[6], dims[7], dims[8], (cudaStream_t)stream);
}

// The bf16 variant on the bf16 core (igemm_bf16.cuh): w (4C, Co) bf16 (Co a
// multiple of 8); the rest as downsample_nhwc_f32.
extern "C" int downsample_nhwc_bf16(const float* x, const __nv_bfloat16* w, const float* bias,
                                    float* out, float* ws, const int* dims, void* stream) {
  const int B = dims[0], C = dims[3], Co = dims[4];
  const auto g = igemm::make_down_gather(x, dims[1], dims[2], C);
  // the 2x2 window's tap (p1, p2) is the box at source (2 oh + p1, 2 ow + p2),
  // traversal stride 2
  const igemm_bf16::Source a = {x, nullptr, B, dims[1], dims[2], C, 0, g.Ho, g.Wo, 2, 0, 2,
                                false};
  return (int)igemm_bf16::launch(g, a, w, bias, out, ws, B * g.Ho * g.Wo, Co, 4 * C, dims[5],
                                 dims[6], dims[7], dims[8], (cudaStream_t)stream);
}
