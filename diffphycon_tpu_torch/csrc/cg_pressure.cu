// K4: the whole conjugate-gradient pressure solve A p = div in one launch,
// A the masked 5-point Laplacian of a fluid domain with obstacles.
//
// Replaces _cg_kernel in diffphycon_tpu/physics/fluids/pallas_cg.py (one
// pallas_call program per batch element, every field resident in VMEM for
// the whole loop). Same CG variant as the reference: a = <p,r>/<p,Ap>,
// x += a p, r -= a Ap, b = -<r,Ap>/<p,Ap>, p = r + b p; the loop test
// max|r| >= accuracy && i < max_iterations comes before each body and is per
// batch element.
//
// Bound: neither bytes nor FLOPs. After its first load a CTA touches device
// memory only to write x. One iteration does ~19 flops per cell, but the
// ~430 iterations of a 127x127 smoke solve at accuracy 1e-6 form one
// dependent chain with two reductions over the whole element in each. The
// time is that chain's latency: per iteration two cluster-wide reductions,
// two CTA barriers inside them and one before the stencil, and the sweeps
// between them.
//
// Design: one thread-block cluster of S CTAs (4, 8 or 16: the host's plan,
// kernels/cg_pressure.py: cg_cluster_plan) per batch element, launched with
// cudaLaunchKernelEx and a cluster-dimension attribute (16 is a
// non-portable size). CTA `rank` owns the band of rows [rank H / S,
// (rank + 1) H / S); thread t owns the band's cells t, t + 256, ... (K of
// them, K * 256 >= the band), so x, r, p, A p and the packed stencil codes
// (one byte per cell: bits 0-3 neighbour y+1, y-1, x+1, x-1 present, bits
// 4-6 the negated centre) stay in registers. Only p goes through shared
// memory, since only p is read by neighbours. No CTA reads another's
// shared memory and no cluster barrier runs inside the loop: every
// transfer between ranks is a one-way st.async into the receiver's shared
// memory that completes bytes on the receiver's mbarrier.
// - Each reduction is of a fused pair: (<r,Ap>, max|r|) after the x/r
//   update, (<p,Ap>, <p,r>) after the stencil. Each warp reduces its pair by
//   xor shuffles, the CTA sums its 8 warps in order, and lanes 0..S-1 of
//   warp 0 push the CTA's pair into slot `rank` of every rank; each rank
//   waits on its mbarrier for the S slots (one phase per reduction), then
//   every thread sums them in rank order. So every thread of the cluster
//   holds bit-identical a, b, max|r| and leaves the loop in the same
//   iteration. Slots and mbarriers alternate by reduction parity: a rank
//   pushes into a slot again only after it has received the receiver's next
//   partial, which the receiver computes from what it read out of that slot.
// - The halo: in the first reduction of an iteration each rank also pushes
//   (r, p) of its first and last rows, before the p update, to the ranks
//   below and above, counted on the same mbarrier phase. Once b is known a
//   rank takes the new p beyond each end of its band as r + b p of those
//   rows, the same fma the neighbour uses, so the two copies are bit-equal.
//   A CTA barrier orders the band's own new p before the stencil reads it.
// One 1024-thread block per element would fill 8 of 132 SMs at batch 8 with
// 5 block barriers per iteration; a cluster barrier per reduction cost
// ~1,300 SM clocks per reduction on an H100 where the st.async pushes wait
// ~180-440. What is left is the
// chain of the shuffles, CTA barriers, the one-way pushes and the stencil
// (tools/sweep_cg_cluster.py: iterations timed under each S, a bare cluster
// barrier, and SM clocks per phase).
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

// Phase clocks, compiled in only with -DCG_PHASE_CLOCKS (the build that
// tools/sweep_cg_cluster.py --phase-clocks makes): thread 0 of each CTA adds
// the clock64() ticks since its last mark to slot i of its kStampSlots in
// cg_stamps, over the iterations (slot 9: the iteration count).
#ifdef CG_PHASE_CLOCKS
constexpr int kStampSlots = 16;
__device__ long long cg_stamps[2048 * kStampSlots];
#define CG_STAMP(i)                                               \
  do {                                                            \
    if (threadIdx.x == 0) {                                       \
      const long long now_ = clock64();                           \
      cg_stamps[blockIdx.x * kStampSlots + (i)] += now_ - stamp_; \
      stamp_ = now_;                                              \
    }                                                             \
  } while (0)
extern "C" int cg_stamps_read(long long* host, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, cg_stamps, sizeof(long long) * n));
}
#else
#define CG_STAMP(i) \
  do {              \
  } while (0)
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCellsPerThread = 32;
constexpr int kBandCells = kThreads * kMaxCellsPerThread;  // 8192: a band's cells at most
constexpr int kMaxCluster = 16;
// Dynamic shared memory, floats: a band's p (ceil(H / S) rows, rounded up
// to 16 bytes), then the two halo rows of (r, p).
__host__ __device__ constexpr int halo_offset(int band_cells) { return (band_cells + 3) & ~3; }
__host__ __device__ constexpr int smem_floats(int band_cells, int W) {
  return halo_offset(band_cells) + 4 * W;
}
constexpr int kMaxSmem = smem_floats(kBandCells, kBandCells) * static_cast<int>(sizeof(float));
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Shared-memory addresses, the cluster's address of another rank's copy,
// st.async and the mbarrier (PTX for sm_90).
__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ uint32_t at_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// v into another rank's shared memory at `addr`; its arrival counts 8 bytes
// on that rank's mbarrier at `mbar`.
__device__ __forceinline__ void push(uint32_t addr, float2 v, uint32_t mbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];" ::"r"(
          addr),
      "f"(v.x), "f"(v.y), "r"(mbar)
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* mbar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(mbar)) : "memory");
}

// This rank's one arrival on its own mbarrier, with the bytes the phase
// waits for (pushes that land first are counted against them).
__device__ __forceinline__ void mbar_expect(uint64_t* mbar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(mbar)),
               "r"(bytes)
               : "memory");
}

// Wait for the phase of `parity` to complete. A phase that never completes
// (a push lost to a fault) traps after ~2^26 polls instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* mbar, uint32_t parity) {
  const uint32_t addr = smem_addr(mbar);
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

// What one rank keeps for the cluster reductions: per parity, the 8 warps'
// partials, the S ranks' partials (pushed by each rank into every rank) and
// an mbarrier.
struct Reduction {
  float2 warps[2][kWarps];
  float2 ranks[2][kMaxCluster];
  uint64_t mbar[2];
};

// The cluster-wide (sum of a, sum (kMax false) or max (kMax true) of b) in
// the slots of parity `par`; every thread of every rank gets the same bits.
// Each warp's pair by xor butterflies (every lane the same value: IEEE
// addition commutes exactly), the CTA's as its 8 warps' in order, pushed by
// lanes 0..S-1 of warp 0 into slot `rank` of every rank; then every thread
// sums the S slots in rank order. `bytes`: what this rank's mbarrier waits
// for in this phase (8 per rank, and the halo rows in the first reduction
// of an iteration). kPhase: the first of its three phase-clock slots.
template <bool kMax, int kPhase>
__device__ __forceinline__ float2 cluster_reduce(float a, float b, int par, int bytes,
                                                 Reduction& red, uint32_t& phase, int S,
                                                 int rank, long long& stamp_) {
  a = warp_sum(a);
  b = kMax ? warp_max(b) : warp_sum(b);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red.warps[par][warp] = make_float2(a, b);
  __syncthreads();
  if (warp == 0) {
    float2 c = red.warps[par][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const float2 v = red.warps[par][w];
      c.x += v.x;
      c.y = kMax ? fmaxf(c.y, v.y) : c.y + v.y;
    }
    if (lane == 0) mbar_expect(&red.mbar[par], bytes);
    if (lane < S)
      push(at_rank(smem_addr(&red.ranks[par][rank]), lane), c,
           at_rank(smem_addr(&red.mbar[par]), lane));
  }
  CG_STAMP(kPhase);
  mbar_wait(&red.mbar[par], (phase >> par) & 1u);
  phase ^= 1u << par;
  CG_STAMP(kPhase + 1);
  float2 tot = red.ranks[par][0];
#pragma unroll
  for (int q = 1; q < kMaxCluster; ++q) {  // the ranks in order (unrolled: the loads overlap)
    if (q < S) {
      const float2 v = red.ranks[par][q];
      tot.x += v.x;
      tot.y = kMax ? fmaxf(tot.y, v.y) : tot.y + v.y;
    }
  }
  CG_STAMP(kPhase + 2);
  return tot;
}

__device__ __forceinline__ uint32_t code_of(const uint32_t* cw, int k) {
  return (cw[k >> 2] >> (8 * (k & 3))) & 0xffu;
}

// (A p)[cell] in the order of masked_laplacian: centre, y+1, y-1, x+1, x-1.
// up, dn, lf, rt: the neighbours' p (read only where the code has them).
__device__ __forceinline__ float stencil(float centre, uint32_t code, float up, float dn,
                                         float rt, float lf) {
  float s = -static_cast<float>((code >> 4) & 7u) * centre;
  if (code & 1u) s += up;
  if (code & 2u) s += dn;
  if (code & 4u) s += rt;
  if (code & 8u) s += lf;
  return s;
}

// K: cells per thread (K * kThreads >= the largest band).
template <int K>
__global__ void __launch_bounds__(kThreads)
    cg_cluster_kernel(const float* __restrict__ div, const uint8_t* __restrict__ packed,
                      float* __restrict__ out, int* __restrict__ iters, int H, int W,
                      float accuracy, int max_iterations) {
  extern __shared__ __align__(16) float smem[];
  __shared__ Reduction red;
  const cg::cluster_group cl = cg::this_cluster();
  const int S = static_cast<int>(cl.num_blocks()), rank = static_cast<int>(cl.block_rank());
  const int b = blockIdx.x / S;
  const int row0 = rank * H / S, row1 = (rank + 1) * H / S;
  const int nb = (row1 - row0) * W;  // the band's cells
  const int last0 = nb - W;          // the band's last row starts here
  float* pbuf = smem;                // the band's p
  // (r, p before its update) of the row below the band (the rank below's
  // last row) and of the row above it (the rank above's first row), pushed
  // by those ranks in each iteration's first reduction
  float2* halo_dn = reinterpret_cast<float2*>(smem + halo_offset((H + S - 1) / S * W));
  float2* halo_up = halo_dn + W;
  const int tid = threadIdx.x;
  const float* d = div + (static_cast<size_t>(b) * H + row0) * W;
  if (tid == 0) {
    mbar_init(&red.mbar[0]);
    mbar_init(&red.mbar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // where this band's first and last rows go, if it has a neighbour there
  const bool has_dn = rank > 0, has_up = rank + 1 < S;
  const uint32_t to_dn = has_dn ? at_rank(smem_addr(halo_up), rank - 1) : 0u;
  const uint32_t to_dn_mbar = has_dn ? at_rank(smem_addr(&red.mbar[0]), rank - 1) : 0u;
  const uint32_t to_up = has_up ? at_rank(smem_addr(halo_dn), rank + 1) : 0u;
  const uint32_t to_up_mbar = has_up ? at_rank(smem_addr(&red.mbar[0]), rank + 1) : 0u;
  const int halo_bytes = 8 * W * (has_dn + has_up);

  float x[K], r[K], p[K], ap[K];
  uint32_t cw[(K + 3) / 4];
#pragma unroll
  for (int k = 0; k < (K + 3) / 4; ++k) cw[k] = 0u;
  // cells past the band hold zeros and code 0: they add nothing
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int l = tid + k * kThreads;
    const float v = l < nb ? d[l] : 0.f;
    x[k] = 0.f;
    r[k] = v;
    p[k] = v;
    if (l < nb) cw[k >> 2] |= static_cast<uint32_t>(packed[row0 * W + l]) << (8 * (k & 3));
  }
  // A p on p = div: every neighbour from device memory
  float pap = 0.f, pr = 0.f, rmax = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int l = tid + k * kThreads;
    const uint32_t c = code_of(cw, k);
    ap[k] = stencil(p[k], c, (c & 1u) ? d[l + W] : 0.f, (c & 2u) ? d[l - W] : 0.f,
                    (c & 4u) ? d[l + 1] : 0.f, (c & 8u) ? d[l - 1] : 0.f);
    pap += p[k] * ap[k];
    pr += p[k] * r[k];
    rmax = fmaxf(rmax, fabsf(r[k]));
  }
  cl.sync();  // every rank has started and initialised its mbarriers
  uint32_t phase = 0u;   // bit i: the parity of mbarrier i's current phase
  long long stamp_ = 0;  // read only by the phase clocks
  float2 t = cluster_reduce<false, 0>(pap, pr, 0, 8 * S, red, phase, S, rank, stamp_);
  pap = t.x;
  pr = t.y;
  rmax = cluster_reduce<true, 0>(0.f, rmax, 1, 8 * S, red, phase, S, rank, stamp_).y;
#ifdef CG_PHASE_CLOCKS
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStampSlots; ++i) cg_stamps[blockIdx.x * kStampSlots + i] = 0;
    stamp_ = clock64();
  }
#endif

  int it = 0;
  // rmax, pap and pr are the same bits in every thread of the cluster
  while (rmax >= accuracy && it < max_iterations) {
    const float a = pr / pap;
    float rap = 0.f;
    rmax = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int l = tid + k * kThreads;
      x[k] += a * p[k];
      r[k] -= a * ap[k];
      rap += r[k] * ap[k];
      rmax = fmaxf(rmax, fabsf(r[k]));
      if (l < W && has_dn) push(to_dn + 8 * l, make_float2(r[k], p[k]), to_dn_mbar);
      if (l >= last0 && l < nb && has_up)
        push(to_up + 8 * (l - last0), make_float2(r[k], p[k]), to_up_mbar);
    }
    CG_STAMP(0);
    t = cluster_reduce<true, 1>(rap, rmax, 0, 8 * S + halo_bytes, red, phase, S, rank, stamp_);
    rmax = t.y;
    const float bb = -t.x / pap;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int l = tid + k * kThreads;
      p[k] = __fmaf_rn(bb, p[k], r[k]);
      if (l < nb) pbuf[l] = p[k];
    }
    __syncthreads();  // the band's new p, before the stencil reads it
    CG_STAMP(4);
    pap = 0.f;
    pr = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int l = tid + k * kThreads;
      const uint32_t c = code_of(cw, k);
      float up = 0.f, dn = 0.f, rt = 0.f, lf = 0.f;
      // past the band's ends the new p is r + b p of the pushed rows, the
      // same fma the neighbour rank computes
      if (c & 1u) {
        const int j = l - last0;
        up = j >= 0 ? __fmaf_rn(bb, halo_up[j].y, halo_up[j].x) : pbuf[l + W];
      }
      if (c & 2u) dn = l < W ? __fmaf_rn(bb, halo_dn[l].y, halo_dn[l].x) : pbuf[l - W];
      if (c & 4u) rt = pbuf[l + 1];
      if (c & 8u) lf = pbuf[l - 1];
      ap[k] = stencil(p[k], c, up, dn, rt, lf);
      pap += p[k] * ap[k];
      pr += p[k] * r[k];
    }
    CG_STAMP(5);
    t = cluster_reduce<false, 6>(pap, pr, 1, 8 * S, red, phase, S, rank, stamp_);
    pap = t.x;
    pr = t.y;
    ++it;
  }
#ifdef CG_PHASE_CLOCKS
  if (threadIdx.x == 0) cg_stamps[blockIdx.x * kStampSlots + 9] = it;
#endif
  cl.sync();  // every push into this rank has landed and no rank waits on it

  float* o = out + (static_cast<size_t>(b) * H + row0) * W;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int l = tid + k * kThreads;
    if (l < nb) o[l] = x[k];
  }
  if (rank == 0 && tid == 0) iters[b] = it;
}

// A bare cluster barrier, `rounds` times, for the barrier's round trip at S
// (tools/sweep_cg_cluster.py): ns[0] = the global timer's nanoseconds over
// the rounds, on rank 0.
__global__ void __launch_bounds__(kThreads) cluster_barrier_probe(int rounds,
                                                                  unsigned long long* ns) {
  const cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  unsigned long long t0, t1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  for (int i = 0; i < rounds; ++i) cl.sync();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1));
  if (cl.block_rank() == 0 && threadIdx.x == 0) ns[0] = t1 - t0;
}

// Both kernels run clusters of up to 16 CTAs (a non-portable size) and the
// solve up to kMaxSmem of dynamic shared memory: set once per kernel.
template <typename Kern>
cudaError_t set_attributes(Kern kern, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  done = e == cudaSuccess;
  return e;
}

cudaLaunchConfig_t cluster_config(int ctas, int S, int smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Shape of one solve at S: false if the kernel cannot take it; else the
// cells per thread and the dynamic shared memory.
bool solve_shape(int H, int W, int S, int& K, int& smem) {
  if (H <= 0 || W <= 0 || (S != 4 && S != 8 && S != kMaxCluster) || S > H) return false;
  const long long pstride = static_cast<long long>((H + S - 1) / S) * W;
  if (pstride > kBandCells) return false;
  K = 1;
  while (K * kThreads < pstride) K *= 2;
  smem = static_cast<int>(sizeof(float)) * smem_floats(static_cast<int>(pstride), W);
  return true;
}

template <int K>
cudaError_t solve(bool occupancy, int* clusters, const float* div, const uint8_t* packed,
                  float* out, int* iters, int B, int H, int W, float accuracy, int max_iterations,
                  int S, int smem, cudaStream_t stream) {
  static bool attrs = false;
  const cudaError_t e = set_attributes(cg_cluster_kernel<K>, attrs);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(occupancy ? S : B * S, S, smem, stream, attr);
  if (occupancy) return cudaOccupancyMaxActiveClusters(clusters, cg_cluster_kernel<K>, &cfg);
  return cudaLaunchKernelEx(&cfg, cg_cluster_kernel<K>, div, packed, out, iters, H, W, accuracy,
                            max_iterations);
}

cudaError_t dispatch(bool occupancy, int* clusters, const float* div, const uint8_t* packed,
                     float* out, int* iters, int B, int H, int W, float accuracy,
                     int max_iterations, int S, cudaStream_t stream) {
  int K, smem;
  if (!solve_shape(H, W, S, K, smem)) return cudaErrorInvalidValue;
#define CG_SOLVE(k)                                                                             \
  case k:                                                                                       \
    return solve<k>(occupancy, clusters, div, packed, out, iters, B, H, W, accuracy,           \
                    max_iterations, S, smem, stream)
  switch (K) {
    CG_SOLVE(1);
    CG_SOLVE(2);
    CG_SOLVE(4);
    CG_SOLVE(8);
    CG_SOLVE(16);
    CG_SOLVE(32);
  }
#undef CG_SOLVE
  return cudaErrorInvalidValue;
}

}  // namespace

// div, out: (B, H, W) float32; packed: (H, W) uint8 stencil codes; iters:
// (B,) int32. One launch of B clusters of S CTAs (S in {4, 8, 16}, S <= H,
// ceil(H / S) * W <= 8192: the wrapper checks) on `stream`. Returns its
// cudaError_t.
extern "C" int cg_pressure_f32(const float* div, const uint8_t* packed, float* out, int* iters,
                               int B, int H, int W, float accuracy, int max_iterations, int S,
                               void* stream) {
  if (B <= 0 || static_cast<long long>(B) * S > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch(false, nullptr, div, packed, out, iters, B, H, W, accuracy,
                                   max_iterations, S, static_cast<cudaStream_t>(stream)));
}

// *clusters = how many clusters of S CTAs of an (H, W) solve the device
// holds at once (cudaOccupancyMaxActiveClusters). Returns its cudaError_t.
extern "C" int cg_cluster_occupancy(int H, int W, int S, int* clusters) {
  *clusters = 0;
  return static_cast<int>(
      dispatch(true, clusters, nullptr, nullptr, nullptr, nullptr, 1, H, W, 0.f, 0, S, nullptr));
}

// One cluster of S CTAs (1..16) of 256 threads crosses `rounds` cluster
// barriers; ns (device, one uint64) gets the global timer's nanoseconds over
// them. Returns the launch's cudaError_t.
extern "C" int cg_barrier_probe(int S, int rounds, unsigned long long* ns, void* stream) {
  if (S < 1 || S > kMaxCluster || rounds < 0) return static_cast<int>(cudaErrorInvalidValue);
  static bool attrs = false;
  cudaError_t e = set_attributes(cluster_barrier_probe, attrs);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(S, S, 0, static_cast<cudaStream_t>(stream), attr);
  return static_cast<int>(cudaLaunchKernelEx(&cfg, cluster_barrier_probe, rounds, ns));
}
