// Post-sort voxel scan (kernel K1) for Hopper, sm_90a.
//
// Replaces: objectdetection_3d_tpu/ops/voxel_scan.py::postsort_scan (the
// Pallas TPU kernel `_kernel`, one sequential grid over 4096-lane blocks
// with a 3-scalar carry in SMEM).
//
// Computes, for each row of nondecreasing cell ids (B, P):
//   first[i] = (i == 0 || cell[i] != cell[i-1]) && cell[i] < sentinel
//   vox[i]   = (number of first[j], j <= i) - 1     the 0-based run index
//   rank[i]  = i - (largest j <= i with first[j], or 0)   position in run
// Every row restarts its runs, so vox of a row starts at 0 (the TPU
// kernel's per-row rebase is built in).  Values at sentinel points are
// defined by the same formulas; callers mask them.
//
// Bound on this card: bytes.  At the flagship size (B=1, P=131,072) it
// reads 0.5 MB and writes 1 MB, about 0.5 us at 3.35 TB/s, so launch
// latency and the serial tile loop set its time, not bandwidth.
//
// Design: GPU blocks share no carry, so the TPU's cross-block SMEM carry
// becomes a loop inside one block per row.  The block walks the row in
// tiles of kThreads*kItems ids; each thread scans kItems consecutive ids
// in registers, a warp-shuffle + shared-memory block scan combines the
// per-thread run counts (sum) and latest run starts (max), and the carry
// from earlier tiles stays in registers.  A multi-block look-back scan
// that fills more than one SM at B=1 is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ int warp_incl_sum(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += o;
  }
  return v;
}

__device__ __forceinline__ int warp_incl_max(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v = max(v, o);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
postsort_scan_kernel(const int* __restrict__ cell, int* __restrict__ vox,
                     int* __restrict__ rank, int p, int sentinel) {
  __shared__ int warp_sum[kWarps];
  __shared__ int warp_max[kWarps];
  const size_t row = blockIdx.x;
  const int* c = cell + row * p;
  int* vo = vox + row * p;
  int* ro = rank + row * p;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  int carry_sum = 0;    // runs started in earlier tiles of this row
  int carry_start = 0;  // latest run start in earlier tiles (0 if none)

  for (int base = 0; base < p; base += kTile) {
    const int i0 = base + threadIdx.x * kItems;
    int prev = (i0 > 0 && i0 <= p) ? c[i0 - 1] : 0;
    unsigned flags = 0;
    int tsum = 0;
    int tmax = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = i0 + k;
      if (i < p) {
        const int x = c[i];
        const bool first = (i == 0 || x != prev) && x < sentinel;
        prev = x;
        if (first) {
          flags |= 1u << k;
          ++tsum;
          tmax = i;
        }
      }
    }

    // block-wide inclusive scans of the per-thread sums and maxima
    const int isum = warp_incl_sum(tsum, lane);
    const int imax = warp_incl_max(tmax, lane);
    if (lane == 31) {
      warp_sum[warp] = isum;
      warp_max[warp] = imax;
    }
    __syncthreads();
    if (warp == 0) {
      int ws = lane < kWarps ? warp_sum[lane] : 0;
      int wm = lane < kWarps ? warp_max[lane] : 0;
      ws = warp_incl_sum(ws, lane);
      wm = warp_incl_max(wm, lane);
      if (lane < kWarps) {
        warp_sum[lane] = ws;
        warp_max[lane] = wm;
      }
    }
    __syncthreads();

    // exclusive prefix of this thread = carry + earlier warps + earlier lanes
    int lane_max = __shfl_up_sync(0xffffffffu, imax, 1);
    if (lane == 0) lane_max = 0;
    int s = carry_sum + (warp > 0 ? warp_sum[warp - 1] : 0) + isum - tsum;
    int r = max(max(carry_start, warp > 0 ? warp_max[warp - 1] : 0),
                lane_max);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = i0 + k;
      if (i < p) {
        if (flags & (1u << k)) {
          ++s;
          r = i;
        }
        vo[i] = s - 1;
        ro[i] = i - r;
      }
    }
    carry_sum += warp_sum[kWarps - 1];
    carry_start = max(carry_start, warp_max[kWarps - 1]);
    __syncthreads();  // warp_sum / warp_max are rewritten by the next tile
  }
}

}  // namespace

// cell, vox, rank: (b, p) int32 device arrays; stream: cudaStream_t.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int postsort_scan(const void* cell, void* vox, void* rank, int b,
                             int p, int sentinel, void* stream) {
  if (b > 0 && p > 0) {
    postsort_scan_kernel<<<b, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(cell), static_cast<int*>(vox),
        static_cast<int*>(rank), p, sentinel);
  }
  return static_cast<int>(cudaGetLastError());
}
