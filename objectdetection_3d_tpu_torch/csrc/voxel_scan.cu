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
// reads 0.5 MB and writes 1 MB, about 0.5 us at 3.35 TB/s, so the time is
// launch latency and the latency of a few dependent memory round trips.
//
// The function is a scan over the monoid (run starts, latest run start)
// under (sum, max), whose identity is (0, 0): the start indices are
// absolute within the row.  Design: tiles of kTile ids, a grid of (tiles
// per row) x B blocks, so that B = 1 spreads over 64 SMs at the flagship
// size, in two launches (reduce, then scan):
// - reduce: each block folds its tile into one (count, latest start) pair
//   and writes it to a (B, tiles) scratch array;
// - scan: each block folds the pairs of the earlier tiles of its row into
//   its carry, scans its tile, and writes both outputs.
// Reduce-then-scan rather than a single-pass decoupled look-back: no block
// waits on another (no forward-progress assumption, nothing to spin on),
// and there are no status words to zero or tag per call, so the scratch is
// an uninitialised wrapper allocation and the launches replay from a CUDA
// graph unchanged.  It costs a second launch and a second read of the ids
// (from L2), and each scan block reads up to (tiles - 1) pairs: 63 at the
// flagship, 511 at P = 2^20.
// Inside a tile, each thread holds kItems consecutive ids, read and written
// as two 16-byte vectors where the row is 16-byte aligned (P % 4 == 0);
// the id before a thread's first comes from the previous lane by a shuffle
// (lane 0 reads it, from the same row only: a row's first id starts a run
// whatever the row before ends with).  The block combines the threads'
// pairs by warp-shuffle scans and one shared-memory step across warps.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
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

// This thread's kItems ids from index i0 of row c (p ids): the run-start
// flags (bit k for id i0 + k), their count and the latest start (0 if
// none).  Every thread of the block calls it (the shuffle).
struct Items {
  unsigned flags;
  int count;
  int latest;
};

__device__ __forceinline__ Items scan_items(const int* c, int i0, int p,
                                            int sentinel, bool vec,
                                            int lane) {
  int x[kItems];
  if (vec && i0 + kItems <= p) {
    const int4 a = *reinterpret_cast<const int4*>(c + i0);
    const int4 b = *reinterpret_cast<const int4*>(c + i0 + 4);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) x[k] = i0 + k < p ? c[i0 + k] : 0;
  }
  // the id before i0: the previous lane's last, or (lane 0) a load
  int prev = __shfl_up_sync(0xffffffffu, x[kItems - 1], 1);
  if (lane == 0) prev = (i0 > 0 && i0 <= p) ? c[i0 - 1] : 0;
  Items it = {0u, 0, 0};
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = i0 + k;
    if (i < p && (i == 0 || x[k] != prev) && x[k] < sentinel) {
      it.flags |= 1u << k;
      ++it.count;
      it.latest = i;
    }
    prev = x[k];
  }
  return it;
}

// 16-byte vectors for every row: the row length keeps each row's start
// aligned, and so do the three base pointers
bool vectors_fit(const void* cell, const void* vox, const void* rank, int p) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(cell) |
                         reinterpret_cast<uintptr_t>(vox) |
                         reinterpret_cast<uintptr_t>(rank);
  return p % 4 == 0 && (bits & 15) == 0;
}

// (sum, max) over the block of every thread's (s, m), to every thread;
// ws and wm may be written again after the caller's next barrier
__device__ __forceinline__ int2 block_fold(int s, int m, int* ws, int* wm) {
  s = __reduce_add_sync(0xffffffffu, s);
  m = __reduce_max_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0) {
    ws[threadIdx.x >> 5] = s;
    wm[threadIdx.x >> 5] = m;
  }
  __syncthreads();
  int2 r = make_int2(0, 0);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    r.x += ws[w];
    r.y = max(r.y, wm[w]);
  }
  return r;
}

// agg: (B, tiles) pairs (run starts, latest start) of each tile
__global__ void __launch_bounds__(kThreads)
tile_reduce_kernel(const int* __restrict__ cell, int2* __restrict__ agg,
                   int p, int sentinel, bool vec) {
  __shared__ int warp_sum[kWarps];
  __shared__ int warp_max[kWarps];
  const size_t row = blockIdx.y;
  const int i0 = blockIdx.x * kTile + threadIdx.x * kItems;
  const Items it = scan_items(cell + row * p, i0, p, sentinel, vec,
                              threadIdx.x & 31);
  const int2 a = block_fold(it.count, it.latest, warp_sum, warp_max);
  if (threadIdx.x == 0) agg[row * gridDim.x + blockIdx.x] = a;
}

// carry of the earlier tiles of the row, then the tile's scan and outputs
__global__ void __launch_bounds__(kThreads)
tile_scan_kernel(const int* __restrict__ cell, const int2* __restrict__ agg,
                 int* __restrict__ vox, int* __restrict__ rank, int p,
                 int sentinel, bool vec) {
  __shared__ int warp_sum[kWarps];
  __shared__ int warp_max[kWarps];
  const size_t row = blockIdx.y;
  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // this thread's ids first, so that their loads overlap the carry's
  const int i0 = tile * kTile + threadIdx.x * kItems;
  const Items it = scan_items(cell + row * p, i0, p, sentinel, vec, lane);

  // (sum, max) of the pairs of tiles 0 .. tile-1 of this row
  int cs = 0, cm = 0;
  for (int j = threadIdx.x; j < tile; j += kThreads) {
    const int2 a = agg[row * gridDim.x + j];
    cs += a.x;
    cm = max(cm, a.y);
  }
  const int2 carry = block_fold(cs, cm, warp_sum, warp_max);
  __syncthreads();  // warp_sum / warp_max are written again below

  // block-wide inclusive scans of the per-thread sums and maxima
  const int isum = warp_incl_sum(it.count, lane);
  const int imax = warp_incl_max(it.latest, lane);
  if (lane == 31) {
    warp_sum[warp] = isum;
    warp_max[warp] = imax;
  }
  __syncthreads();
  int wsum = 0, wmax = 0;  // the earlier warps of this block
  for (int w = 0; w < warp; ++w) {
    wsum += warp_sum[w];
    wmax = max(wmax, warp_max[w]);
  }
  // exclusive prefix of this thread = carry + earlier warps + earlier lanes
  int lane_max = __shfl_up_sync(0xffffffffu, imax, 1);
  if (lane == 0) lane_max = 0;
  int s = carry.x + wsum + isum - it.count;
  int r = max(max(carry.y, wmax), lane_max);
  int vo[kItems], ro[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (it.flags & (1u << k)) {
      ++s;
      r = i0 + k;
    }
    vo[k] = s - 1;
    ro[k] = i0 + k - r;
  }
  int* vrow = vox + row * p;
  int* rrow = rank + row * p;
  if (vec && i0 + kItems <= p) {
    *reinterpret_cast<int4*>(vrow + i0) = make_int4(vo[0], vo[1], vo[2],
                                                    vo[3]);
    *reinterpret_cast<int4*>(vrow + i0 + 4) = make_int4(vo[4], vo[5], vo[6],
                                                        vo[7]);
    *reinterpret_cast<int4*>(rrow + i0) = make_int4(ro[0], ro[1], ro[2],
                                                    ro[3]);
    *reinterpret_cast<int4*>(rrow + i0 + 4) = make_int4(ro[4], ro[5], ro[6],
                                                        ro[7]);
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (i0 + k < p) {
        vrow[i0 + k] = vo[k];
        rrow[i0 + k] = ro[k];
      }
    }
  }
}

}  // namespace

// Ids per tile: the scratch of postsort_scan holds 2 ints per tile.
extern "C" int postsort_scan_tile() { return kTile; }

// cell, vox, rank: (b, p) int32 device arrays; agg: (b, ceil(p / tile), 2)
// int32 scratch, written before it is read; stream: cudaStream_t.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int postsort_scan(const void* cell, void* vox, void* rank,
                             void* agg, int b, int p, int sentinel,
                             void* stream) {
  if (b > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (b > 0 && p > 0) {
    const dim3 grid((p + kTile - 1) / kTile, b);
    const bool vec = vectors_fit(cell, vox, rank, p);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (grid.x > 1) {
      tile_reduce_kernel<<<grid, kThreads, 0, s>>>(
          static_cast<const int*>(cell), static_cast<int2*>(agg), p,
          sentinel, vec);
    }
    tile_scan_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const int*>(cell), static_cast<const int2*>(agg),
        static_cast<int*>(vox), static_cast<int*>(rank), p, sentinel, vec);
  }
  return static_cast<int>(cudaGetLastError());
}
