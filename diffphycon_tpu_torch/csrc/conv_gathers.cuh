// The implicit-GEMM gathers of the NHWC convolutions: ConvGather for K1
// (conv2d_nhwc.cu) and DownGather for K2 (downsample_nhwc.cu), read by
// address through igemm_tc.cuh, which K1, K2 and the persistent kernel
// (unet2d_persistent.cu) share.
//
// out[m, n] = bias[n] + sum_k A[m, k] * W[k, n]: m walks the output pixels
// (b, oh, ow) of an NHWC tensor, n the output channels and k the (tap, input
// channel) pairs. A is never materialised: a gather turns (m, k) into an
// address, so im2col, the skip concat and the nearest-2x upsample all
// happen at load time.
//
// Gather contract (k4 is a multiple of 4; the 4 values k4..k4+3 share a tap
// and a source tensor):
//   struct Row;                         per-output-pixel context
//   struct Tap;                         per-k4 context
//   Row row(int m) const;               m < 0 marks a row past the end
//   Tap tap(int k4) const;
//   const float* ptr4(const Row&, const Tap&) const;  the 4 values' address,
//                                       nullptr outside the image
// The tile copies the addresses with cp.async.cg, which reads through L2
// only: in the persistent kernel other blocks wrote the activations earlier
// in the same launch.
#pragma once

#include <cuda_runtime.h>

namespace igemm {

// Same-padded ks x ks conv (ks in {1, 3}) of xa [| xb] (the skip concat:
// channel c < Ca from xa, the rest from xb), optionally of the nearest-2x
// upsampled input (`up`: the source pixel at half index).
struct ConvGather {
  const float* xa;
  const float* xb;
  int Ca, Cb, Ci;
  int H, W;    // output (= conv input, in upsampled coordinates) size
  int Hs, Ws;  // source tensor size: (H/2, W/2) when upsampling, else (H, W)
  int ks, pad, up;

  // 32-bit indices: the wrapper caps every tensor at 2^31 - 1 elements
  struct Row {
    int oh, ow, base;  // base: source pixel index of (b, 0, 0); oh < 0 past the end
  };
  struct Tap {
    int dy, dx, c;
  };

  __device__ Row row(int m) const {
    if (m < 0) return {-H - 8, 0, 0};  // every tap falls outside the image
    const int ow = m % W;
    const int t = m / W;
    return {t % H, ow, (t / H) * Hs * Ws};
  }
  __device__ Tap tap(int k) const {
    const int t = k / Ci;
    return {t / ks - pad, t % ks - pad, k - t * Ci};
  }
  // channels c .. c+3 (c % 4 == 0, Ca % 4 == 0: never split across sources);
  // nullptr outside the image
  __device__ const float* ptr4(const Row& r, const Tap& tp) const {
    int ih = r.oh + tp.dy;
    int iw = r.ow + tp.dx;
    if (ih < 0 || ih >= H || iw < 0 || iw >= W) return nullptr;
    if (up) {
      ih >>= 1;
      iw >>= 1;
    }
    const int pix = r.base + ih * Ws + iw;
    return tp.c < Ca ? xa + pix * Ca + tp.c : xb + pix * Cb + (tp.c - Ca);
  }
};

// B: batch; H, W: output size; Ca, Cb: channels of xa and xb (Cb = 0 and xb
// = nullptr for one source); upsample: xa / xb are (B, H/2, W/2, C).
__device__ __host__ inline ConvGather make_conv_gather(const float* xa, const float* xb, int H,
                                                      int W, int Ca, int Cb, int ks,
                                                      int upsample) {
  ConvGather g;
  g.xa = xa;
  g.xb = xb;
  g.Ca = Ca;
  g.Cb = Cb;
  g.Ci = Ca + Cb;
  g.H = H;
  g.W = W;
  g.Hs = upsample ? H / 2 : H;
  g.Ws = upsample ? W / 2 : W;
  g.ks = ks;
  g.pad = (ks - 1) / 2;
  g.up = upsample;
  return g;
}

// 2x2 stride-2 conv (space-to-depth + 1x1) with rows k = (p1*2 + p2)*C + c.
struct DownGather {
  const float* x;
  int C, H, W;  // input size
  int Ho, Wo;   // output size (H/2, W/2)

  // 32-bit indices: the wrapper caps every tensor at 2^31 - 1 elements
  struct Row {
    int base;  // input pixel index of the 2x2 window's top-left; -1 past the end
  };
  struct Tap {
    int off, c;  // pixel offset of (p1, p2) in the window, channel
  };

  __device__ Row row(int m) const {
    if (m < 0) return {-1};
    const int ow = m % Wo;
    const int t = m / Wo;
    return {((t / Ho) * H + 2 * (t % Ho)) * W + 2 * ow};
  }
  __device__ Tap tap(int k) const {
    const int p = k / C;
    return {(p >> 1) * W + (p & 1), k - p * C};
  }
  // channels c .. c+3 of one window pixel (C % 4 == 0); nullptr past the end
  __device__ const float* ptr4(const Row& r, const Tap& tp) const {
    return r.base < 0 ? nullptr : x + (r.base + tp.off) * C + tp.c;
  }
};

// x: (B, H, W, C) with even H, W.
__device__ __host__ inline DownGather make_down_gather(const float* x, int H, int W, int C) {
  DownGather g;
  g.x = x;
  g.C = C;
  g.H = H;
  g.W = W;
  g.Ho = H / 2;
  g.Wo = W / 2;
  return g;
}

}  // namespace igemm
