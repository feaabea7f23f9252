// K1: same-padded KxK convolution (K in {1, 3}) on NHWC fp32, bias in the
// epilogue, NHWC output.
//
// Replaces, from diffphycon_tpu/research/pallas_unet2d.py:
//   _conv_kernel      (3x3 conv, the last-level resample convs)
//   _upsample_kernel  (nearest 2x + 3x3 conv): `upsample` reads the source
//                     pixel at half index, the 2x tensor is never built
//   _concat_kernel    (skip concat): a second input pointer `xb`; channel
//                     c < Ca comes from xa, the rest from xb, so the
//                     concatenated tensor is never built
//   and the two 3x3 convs and the 1x1 residual conv inside _resblock_kernel.
//
// Bound: operations. The smallest Burgers case (3x3, Ci=Co=64 at 16x128) does
// 2*9*64 = 1152 flops per output pixel against ~2*64*4 bytes of activations,
// far above the fp32 ridge of 67 TFLOP/s / 3.35 TB/s = 20 flops/byte. The
// design keeps A (im2col) out of device memory and spends its effort on FMA
// issue; see igemm_nhwc.cuh.
//
// Weight layout (chosen once when weights are packed): w[k, co] with
// k = (dy*K + dx) * (Ca + Cb) + c, i.e. the flax kernel (kh, kw, Ci, Co)
// flattened to (kh*kw*Ci, Co).
#include "conv_gathers.cuh"

// B: batch; H, W: output size; Ca, Cb: channels of xa and xb (Cb = 0 and
// xb = NULL for one source); Co: output channels; ks: 1 or 3; upsample: 0/1
// (then xa/xb are (B, H/2, W/2, C)). Ca, Cb, Co multiples of 4 and every
// pointer 16-byte aligned (the wrapper checks). Returns cudaGetLastError().
extern "C" int conv2d_nhwc_f32(const float* xa, const float* xb, const float* w,
                               const float* bias, float* out, int B, int H, int W,
                               int Ca, int Cb, int Co, int ks, int upsample,
                               void* stream) {
  const auto g = igemm::make_conv_gather<false>(xa, xb, H, W, Ca, Cb, ks, upsample);
  const int M = B * H * W;
  const int K = ks * ks * (Ca + Cb);
  return (int)igemm::launch(g, w, bias, out, M, Co, K, (cudaStream_t)stream);
}
