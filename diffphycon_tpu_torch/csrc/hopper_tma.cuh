// Hopper's tensor memory accelerator (TMA) and the wgmma operand
// descriptor for weights read as stored, shared by the bf16 kernels:
// igemm_bf16.cuh (K1/K2) and attention_bf16.cuh (K5/K6).
//
// Device side: mbarriers (one arrival, the rest by transaction bytes), 2-D
// and 4-D tiled TMA copies into shared memory that complete on an mbarrier,
// and desc_mn, the descriptor of a bf16 weight tile that TMA wrote in the
// 128-byte swizzle and wgmma reads MN-major (imm-trans-b = 1). Host side:
// tensor_map, which encodes a tiled tensor map through the driver's
// cuTensorMapEncodeTiled (found with cudaGetDriverEntryPoint, so the build
// needs no -lcuda) and caches it per address, shape and box.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (the encoder comes from the runtime)
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <mutex>
#include <unordered_map>

namespace hopper_tma {

// k rows of one weight atom: a TMA box of 64 columns x kAtomK rows of bf16,
// each row 128 bytes
constexpr int kAtomK = 64;

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}
// before the mbarrier's shared memory is put to another use (every wait on
// it done)
__device__ __forceinline__ void mbar_inval(uint32_t bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int x,
                                       int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y)
      : "memory");
}
__device__ __forceinline__ void tma_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c,
                                       int x, int y, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(x), "r"(y), "r"(b)
      : "memory");
}

// A tensor map in global memory (not a __grid_constant__ parameter) that
// generic stores wrote, made visible to this thread's TMA copies through it
// (the tensormap proxy); the writer released it (tensormap_release) before
// its kernel ended.
__device__ __forceinline__ void tensormap_acquire(const void* map) {
  asm volatile("fence.proxy.tensormap::generic.acquire.gpu [%0], 128;\n" ::"l"(map) : "memory");
}
__device__ __forceinline__ void tensormap_release() {
  asm volatile("fence.proxy.tensormap::generic.release.gpu;\n" ::: "memory");
}

// Descriptor of a (16 k, N) bf16 slice of a weight tile, MN-major in the
// 128-byte swizzle as TMA writes 64 x kAtomK boxes: 8-row k groups 1024
// bytes apart (stride byte offset), 64-column atoms kAtomK * 128 bytes
// apart (leading byte offset). The next 16 k start 2048 bytes further.
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((kAtomK * 128) >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The key of one tensor map: every field it is encoded from (zero-filled
// past `rank`, so that equal maps compare and hash equal as bytes).
struct MapKey {
  const void* addr;
  int dtype, rank;
  cuuint64_t dims[5], strides[4];
  cuuint32_t box[5], estr[5];
  bool operator==(const MapKey& o) const { return memcmp(this, &o, sizeof(MapKey)) == 0; }
};
static_assert(sizeof(MapKey) % 8 == 0, "MapKey is hashed as 8-byte words");
struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    uint64_t h = 1469598103934665603ull, word;  // FNV-1a over the key's words
    for (size_t i = 0; i < sizeof(MapKey); i += 8) {
      memcpy(&word, reinterpret_cast<const unsigned char*>(&k) + i, 8);
      h = (h ^ word) * 1099511628211ull;
    }
    return static_cast<size_t>(h ^ (h >> 29));
  }
};

// Past this many maps the cache starts over. Each translation unit that
// includes this header keeps its own cache: K1's and K2's bf16 launches of
// one UNet2D forward at batch 50 need ~160 maps (a weight map for each of
// their 55 launches, up to two activation maps each), K5's and K6's 9 two
// weight maps each; the allocator hands weights and activations the same
// addresses call after call, so a full cache means addresses that come and
// go (new nets, casts made anew each step).
constexpr size_t MAX_MAPS = 16384;

// One tiled tensor map of `rank` dims (innermost first), 128-byte swizzle,
// zeros out of bounds; encoded once per (address, shape, box) and cached.
static inline cudaError_t tensor_map(CUtensorMap* out, CUtensorMapDataType dtype, int rank,
                                     const void* addr, const cuuint64_t* dims,
                                     const cuuint64_t* strides, const cuuint32_t* box,
                                     const cuuint32_t* estr) {
  static std::mutex mu;
  static EncodeTiled encode = nullptr;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> cache;
  MapKey key;
  memset(&key, 0, sizeof(key));
  key.addr = addr;
  key.dtype = static_cast<int>(dtype);
  key.rank = rank;
  for (int i = 0; i < rank; ++i) {
    key.dims[i] = dims[i];
    key.box[i] = box[i];
    key.estr[i] = estr[i];
    if (i + 1 < rank) key.strides[i] = strides[i];
  }
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *out = hit->second;
    return cudaSuccess;
  }
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  if (encode(out, dtype, rank, const_cast<void*>(addr), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  if (cache.size() >= MAX_MAPS) cache.clear();
  cache.emplace(key, *out);
  return cudaSuccess;
}

// The 2-D map of a (K, N) row-major bf16 weight (N contiguous, rows ld
// elements apart) read in 64-column x kAtomK-row boxes; rows past K and
// columns past N arrive as zeros.
static inline cudaError_t weight_map(CUtensorMap* out, const void* w, int K, int N, int ld) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(K)};
  const cuuint64_t stride[1] = {2ull * ld};
  const cuuint32_t box[2] = {64, kAtomK}, one[2] = {1, 1};
  return tensor_map(out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, dims, stride, box, one);
}

}  // namespace hopper_tma
