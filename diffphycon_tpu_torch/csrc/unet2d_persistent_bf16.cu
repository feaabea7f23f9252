// K7 and K8, the bf16 instance (bf16 matmul weights): the stage bodies of
// the per-block bf16 kernels, igemm_bf16.cuh's tile and attention_bf16.cuh's
// bodies, and the tensor maps they read. The kernel and its design:
// unet2d_persistent.cuh; the float instance and the grid:
// unet2d_persistent.cu.
#include "unet2d_persistent.cuh"

namespace {

// The bf16 instance's tensor maps, encoded on the host and written into
// device memory by a kernel that takes them as its parameter (so a CUDA
// graph captures them by value): kChunkMaps records a launch, so that a
// plan's maps (130 for the Burgers UNet2D) take one launch or two.
constexpr int kMapCols = 19;  // int64 per map: see unet2d_persistent_maps
constexpr int kChunkMaps = 255;  // 255 x 128 bytes: within 32764 bytes of parameters (CUDA 12.1+)
struct MapChunk {
  CUtensorMap m[kChunkMaps];
};

__global__ void __launch_bounds__(256)
    write_maps_kernel(const __grid_constant__ MapChunk chunk, CUtensorMap* dst, int n) {
  const uint4* src = reinterpret_cast<const uint4*>(chunk.m);
  uint4* out = reinterpret_cast<uint4*>(dst);
  for (int i = threadIdx.x; i < n * 8; i += blockDim.x) out[i] = src[i];
  hopper_tma::tensormap_release();
}

}  // namespace

// The bf16 instance's blocks an SM (for unet2d_persistent_grid).
extern "C" int unet2d_persistent_bf16_occupancy(int* per_sm) {
  return static_cast<int>(occupancy<__nv_bfloat16>(per_sm));
}

// One launch of the bf16 instance, as unet2d_persistent_f32; stages:
// StageBf16 records (43 int64); maps: the stages' tensor maps in device
// memory (unet2d_persistent_maps), 64-byte aligned, written for these bases.
extern "C" int unet2d_persistent_bf16(const void* stages, int n_stages, const long long* bases,
                                      int n_counters, int* grid_out, void* stream,
                                      const void* maps) {
  return launch<__nv_bfloat16>(stages, n_stages, bases, n_counters, grid_out, stream, maps);
}

// Encodes n_maps tensor maps and writes them to `maps` (device memory,
// n_maps x 128 bytes, 64-byte aligned) on `stream`. specs: n_maps rows of
// kMapCols int64: element type (0 bf16, 1 fp32), rank (2 or 4), base id and
// byte offset of the global address (bases[base] + offset, as a stage's
// pointer; 16-byte aligned), dims[4], strides[3] (bytes, dims 1..), box[4],
// element strides[4], innermost first; unused entries 0. Returns the first
// cudaError_t that is not cudaSuccess.
extern "C" int unet2d_persistent_maps(const long long* specs, int n_maps, const long long* bases,
                                      void* maps, void* stream) {
  if (n_maps < 0 || specs == nullptr || bases == nullptr || maps == nullptr ||
      reinterpret_cast<uintptr_t>(maps) % 64)
    return static_cast<int>(cudaErrorInvalidValue);
  MapChunk chunk;
  for (int c0 = 0; c0 < n_maps; c0 += kChunkMaps) {
    const int n = n_maps - c0 < kChunkMaps ? n_maps - c0 : kChunkMaps;
    memset(&chunk, 0, sizeof(chunk));
    for (int i = 0; i < n; ++i) {
      const long long* sp = specs + static_cast<size_t>(c0 + i) * kMapCols;
      const int rank = static_cast<int>(sp[1]);
      if ((sp[0] != 0 && sp[0] != 1) || (rank != 2 && rank != 4) || sp[2] < 0 ||
          sp[2] >= kBases)
        return static_cast<int>(cudaErrorInvalidValue);
      const long long addr = bases[sp[2]] + sp[3];
      if (addr == 0 || addr % 16) return static_cast<int>(cudaErrorInvalidValue);
      cuuint64_t dims[4], strides[3];
      cuuint32_t box[4], estr[4];
      for (int k = 0; k < 4; ++k) {
        dims[k] = static_cast<cuuint64_t>(sp[4 + k]);
        box[k] = static_cast<cuuint32_t>(sp[11 + k]);
        estr[k] = static_cast<cuuint32_t>(sp[15 + k]);
        if (k < 3) strides[k] = static_cast<cuuint64_t>(sp[8 + k]);
      }
      const cudaError_t e = hopper_tma::tensor_map(
          &chunk.m[i],
          sp[0] == 0 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank,
          reinterpret_cast<const void*>(addr), dims, strides, box, estr);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    write_maps_kernel<<<1, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        chunk, static_cast<CUtensorMap*>(maps) + c0, n);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

#ifdef MEGA_PHASE_CLOCKS
// Copies the first n stamps of the bf16 instance, as mega_stamps_read.
extern "C" int mega_stamps_read_bf16(long long* host, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, mega_stamps, sizeof(long long) * n));
}
#endif
