// K7 and K8, the float instance (3xTF32 tensor cores), and the cooperative
// grid of both instances. The kernel and its design: unet2d_persistent.cuh;
// the bf16 instance: unet2d_persistent_bf16.cu.
#include "unet2d_persistent.cuh"

// unet2d_persistent_bf16.cu: the bf16 instance's blocks an SM
extern "C" int unet2d_persistent_bf16_occupancy(int* per_sm);

namespace {

// The cooperative grid on the current device: one block per SM as the
// occupancy calculator finds it at each instantiation's shared memory,
// worked out once per device for both together (the host plans one grid,
// whichever the plan's weight type).
cudaError_t grid_size(int* blocks) {
  static int grid_dev = -1, grid_blocks = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev != grid_dev) {
    int sms = 0, f32 = 0, bf16 = 0;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return e;
    if ((e = occupancy<float>(&f32)) != cudaSuccess) return e;
    if ((e = static_cast<cudaError_t>(unet2d_persistent_bf16_occupancy(&bf16))) != cudaSuccess)
      return e;
    const int per_sm = f32 < bf16 ? f32 : bf16;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    grid_dev = dev;
    grid_blocks = per_sm * sms;
  }
  *blocks = grid_blocks;
  return cudaSuccess;
}

}  // namespace

extern "C" int unet2d_persistent_grid(int* blocks) { return static_cast<int>(grid_size(blocks)); }

// stages: n_stages Stage records (38 int64) in device memory; bases: kBases
// host int64 (bases[0] = 0, bases[1] the workspace, whose first n_counters
// ints are the arrival counters); grid_out (may be null): the number of
// blocks launched. One cooperative launch on `stream` of as many 256-thread
// blocks as fit on the card at once (one per SM). Returns the first
// cudaError_t that is not cudaSuccess (cudaErrorCooperativeLaunchTooLarge is
// returned, not retried smaller).
extern "C" int unet2d_persistent_f32(const void* stages, int n_stages, const long long* bases,
                                     int n_counters, int* grid_out, void* stream) {
  return launch<float>(stages, n_stages, bases, n_counters, grid_out, stream, nullptr);
}

#ifdef MEGA_PHASE_CLOCKS
// Copies the first n stamps of the float instance ((stage * 256 + block) *
// 3 + {start, work end, barrier end}) to host.
extern "C" int mega_stamps_read(long long* host, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, mega_stamps, sizeof(long long) * n));
}
#endif
