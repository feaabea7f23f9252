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
// Gather contract (one 16-byte chunk: k4 is a multiple of its values, 4
// fp32 or 8 bf16, and they share a tap and a source tensor):
//   using Elem;                         the activation's type, float or bf16
//   struct Row;                         per-output-pixel context
//   struct Tap;                         per-k4 context
//   Row row(int m) const;               m < 0 marks a row past the end
//   Tap tap(int k4) const;
//   const Elem* ptr4(const Row&, const Tap&) const;  the chunk's address,
//                                       nullptr outside the image
// Each gather is a template on Elem: float (K1, K2, the persistent kernel)
// or __nv_bfloat16 (the bf16-activation K1 and K2, whose channel counts are
// multiples of 8).
// The tile copies the addresses with cp.async.cg, which reads through L2
// only: in the persistent kernel other blocks wrote the activations earlier
// in the same launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace igemm {

// Same-padded ks x ks conv (ks in {1, 3}) of xa [| xb] (the skip concat:
// channel c < Ca from xa, the rest from xb), optionally of the nearest-2x
// upsampled input (`up`: the source pixel at half index).
template <class E>
struct ConvGatherE {
  using Elem = E;
  const E* xa;
  const E* xb;
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
  // the chunk at channel c (a chunk never straddles the two sources: Ca is
  // a multiple of its values); nullptr outside the image
  __device__ const E* ptr4(const Row& r, const Tap& tp) const {
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

using ConvGather = ConvGatherE<float>;

// B: batch; H, W: output size; Ca, Cb: channels of xa and xb (Cb = 0 and xb
// = nullptr for one source); upsample: xa / xb are (B, H/2, W/2, C).
template <class E>
__device__ __host__ inline ConvGatherE<E> make_conv_gather(const E* xa, const E* xb, int H,
                                                          int W, int Ca, int Cb, int ks,
                                                          int upsample) {
  ConvGatherE<E> g;
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
template <class E>
struct DownGatherE {
  using Elem = E;
  const E* x;
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
  // the chunk at channel c of one window pixel; nullptr past the end
  __device__ const E* ptr4(const Row& r, const Tap& tp) const {
    return r.base < 0 ? nullptr : x + (r.base + tp.off) * C + tp.c;
  }
};

using DownGather = DownGatherE<float>;

// x: (B, H, W, C) with even H, W.
template <class E>
__device__ __host__ inline DownGatherE<E> make_down_gather(const E* x, int H, int W, int C) {
  DownGatherE<E> g;
  g.x = x;
  g.C = C;
  g.H = H;
  g.W = W;
  g.Ho = H / 2;
  g.Wo = W / 2;
  return g;
}

}  // namespace igemm
