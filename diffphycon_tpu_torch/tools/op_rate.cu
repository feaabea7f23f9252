// The issue rate of the ops the bf16-activation K3's update is made of
// (csrc/group_norm_act.cu), for tools/sweep_gn_cluster.py --bf16act
// --clocks, which builds this file alone: one CTA of 1024 threads an SM,
// each thread 8 independent chains of 256 ops; thread 0's clock64() span of
// the loop into clk[blockIdx.x]. mode: 0 fp32 FMA, 1 fp32 -> bf16
// conversion (cvt.rn.bf16.f32, one value), 2 cvt.rn.bf16x2.f32 (two
// values), 3 MUFU ex2, 4 bf16x2 fma.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t cvt_bf16x2(float hi, float lo) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

template <int M>
__device__ __forceinline__ void op_chains(float (&v)[8], uint32_t (&u)[8]) {
  for (int s = 0; s < 256; ++s) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (M == 0) {
        v[j] = fmaf(v[j], 0.999f, 0.001f);
      } else if (M == 1) {
        v[j] = __uint_as_float(
            static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v[j]))) << 16 | 1u);
      } else if (M == 2) {
        v[j] = __uint_as_float(cvt_bf16x2(v[j], v[(j + 1) & 7]) | 1u);
      } else if (M == 3) {
        asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(v[j]) : "f"(v[j] * -1.4426950408889634f));
      } else {
        asm volatile("fma.rn.bf16x2 %0, %0, %1, %2;\n" : "+r"(u[j]) : "r"(0x3f7f3f7fu),
                     "r"(0x3c003c00u));
      }
    }
  }
}

__global__ void op_rate_kernel(int mode, long long* clk, float* sink) {
  float v[8];
  uint32_t u[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    v[j] = 0.5f + j * 0.001f + threadIdx.x * 1e-6f;
    u[j] = __float_as_uint(v[j]);
  }
  __syncthreads();
  const long long t0 = clock64();
  switch (mode) {
    case 0: op_chains<0>(v, u); break;
    case 1: op_chains<1>(v, u); break;
    case 2: op_chains<2>(v, u); break;
    case 3: op_chains<3>(v, u); break;
    default: op_chains<4>(v, u);
  }
  __syncthreads();
  const long long t1 = clock64();
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) acc += v[j] + __uint_as_float(u[j]);
  sink[blockIdx.x * blockDim.x + threadIdx.x] = acc;
  if (threadIdx.x == 0) clk[blockIdx.x] = t1 - t0;
}

}  // namespace

// op_rate_kernel of `mode` over `sms` CTAs; returns the cudaError_t. clk:
// sms int64, sink: sms * 1024 floats (device).
extern "C" int gn_op_rate(int mode, int sms, long long* clk, float* sink) {
  op_rate_kernel<<<sms, 1024>>>(mode, clk, sink);
  return static_cast<int>(cudaDeviceSynchronize());
}
