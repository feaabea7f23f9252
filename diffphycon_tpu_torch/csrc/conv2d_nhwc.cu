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
// 2*9*64*64 = 73,728 flops per output pixel against 2*64*4 = 512 bytes of
// activations (144 flops/byte), above the ridge of the tensor cores at the
// 3xTF32 rate (495 / 3 TFLOP/s over 3.35 TB/s = 49 flops/byte). The design
// keeps A (im2col) out of device memory and runs 3xTF32 wgmma products; see
// igemm_tc.cuh. The bf16 variant (conv2d_nhwc_bf16, the Pallas kernels under
// weight_dtype=bfloat16) runs the bf16 core, igemm_bf16.cuh, on the same
// gathers; at the bf16 rate the ridge is 989 / 3.35 = 295 flops per byte, so
// the 64-channel levels are bound by their fp32 activations' bytes. The
// bf16-activation variant (conv2d_nhwc_bf16act, flax dtype=bfloat16) runs
// the same core from its own translation unit, igemm_bf16act.cu.
//
// Weight layout (chosen once when weights are packed): w[k, co] with
// k = (dy*K + dx) * (Ca + Cb) + c, i.e. the flax kernel (kh, kw, Ci, Co)
// flattened to (kh*kw*Ci, Co).
#include "conv_gathers.cuh"
#include "igemm_bf16.cuh"
#include "igemm_tc.cuh"

// dims: {B, H, W, Ca, Cb, Co, ks, upsample, bm, bn, splits, per}, one array
// so that the host passes one argument for twelve. B: batch; H, W: output
// size; Ca, Cb: channels of xa and xb (Cb = 0 and xb = NULL for one source);
// Co: output channels; ks: 1 or 3; upsample: 0/1 (then xa/xb are (B, H/2,
// W/2, C)). bm, bn, splits, per: the tile plan (per in stages of the core's
// BK). w: (K, Co); ws: splits * M * Co floats when splits > 1 (else unused).
// Ca, Cb, Co multiples of 4 and every pointer 16-byte aligned (the wrapper
// checks). Returns cudaGetLastError().
extern "C" int conv2d_nhwc_f32(const float* xa, const float* xb, const float* w,
                               const float* bias, float* out, float* ws, const int* dims,
                               void* stream) {
  const int B = dims[0], H = dims[1], W = dims[2], Ca = dims[3], Cb = dims[4], Co = dims[5];
  const int ks = dims[6];
  const auto g = igemm::make_conv_gather(xa, xb, H, W, Ca, Cb, ks, dims[7]);
  return (int)igemm_tc::launch(g, w, bias, out, ws, B * H * W, Co, ks * ks * (Ca + Cb),
                               dims[8], dims[9], dims[10], dims[11], (cudaStream_t)stream);
}

// The bf16 variant on the bf16 core (igemm_bf16.cuh): w (K, Co) bf16 (Co a
// multiple of 8), the activations rounded to bf16 at the products; the rest
// as conv2d_nhwc_f32.
extern "C" int conv2d_nhwc_bf16(const float* xa, const float* xb, const __nv_bfloat16* w,
                                const float* bias, float* out, float* ws, const int* dims,
                                void* stream) {
  const int B = dims[0], H = dims[1], W = dims[2], Ca = dims[3], Cb = dims[4], Co = dims[5];
  const int ks = dims[6];
  const int up = dims[7];
  const auto g = igemm::make_conv_gather(xa, xb, H, W, Ca, Cb, ks, up);
  const igemm_bf16::Source a = {xa, xb, B, up ? H / 2 : H, up ? W / 2 : W, Ca, Cb, H, W, ks,
                                (ks - 1) / 2, 1, up != 0};
  return (int)igemm_bf16::launch(g, a, w, bias, out, ws, B * H * W, Co, ks * ks * (Ca + Cb),
                                 dims[8], dims[9], dims[10], dims[11], (cudaStream_t)stream);
}

#ifdef IGEMM_BF16_CLOCKS
// the bf16 core's per-stage clock stamps of block (0, 0, 0), both warpgroups
extern "C" int igemm_bf16_clocks_read(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, igemm_bf16::clk, sizeof(igemm_bf16::clk));
}
#endif
