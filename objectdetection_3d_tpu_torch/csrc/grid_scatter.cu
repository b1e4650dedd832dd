// Single-write pseudo-image grid build (kernel K2) for Hopper, sm_90a.
//
// Replaces: objectdetection_3d_tpu/ops/grid_scatter.py::scatter_to_grid
// (the Pallas TPU kernel `_kernel`: one program per (z-slice, row chunk)
// zero-fills its VMEM window and inserts that range's voxel rows).
//
// Computes, per batch row b, the dense grid out[b] of (ncells, C): the
// feature row feats[b, j] at cell ids[b, j] for every voxel j whose id is
// below ncells, and zero at every other cell.  ids are SORTED ascending
// per row, unique below ncells; padding voxels carry an id >= ncells.
//
// Bound on this card: bytes written.  The flagship grid (100x400x400 cells
// x 20 channels, bf16) is 640 MB written against about 4 MB read, about
// 0.19 ms at 3.35 TB/s.
//
// Design: keep what makes the TPU kernel worth having, a grid written
// exactly once -- no zero-fill pass followed by a scatter pass.  Each block
// owns kCells consecutive cells of one row: two threads binary-search the
// sorted ids for the block's [first, last) voxel range, the block stages
// the (cell -> voxel row) map of its range in shared memory, and then
// writes its whole range front to back in 16-byte stores, taking a
// feature element where a voxel lands and zero elsewhere.  The kernel
// copies element bits, so one instantiation per element size serves bf16
// (2 bytes) and float32 (4 bytes).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kCells = 1024;

template <typename U>
__device__ __forceinline__ U element(const U* __restrict__ f,
                                     const int* row_of, int e, int c) {
  const int cell = e / c;
  const int r = row_of[cell];
  return r >= 0 ? f[static_cast<long long>(r) * c + (e - cell * c)] : U(0);
}

template <typename U>
__global__ void __launch_bounds__(kThreads)
scatter_to_grid_kernel(const U* __restrict__ feats,
                       const int* __restrict__ ids, U* __restrict__ out,
                       int v, int c, long long ncells) {
  __shared__ int row_of[kCells];
  __shared__ int bounds[2];
  const long long b = blockIdx.y;
  const long long cell0 = static_cast<long long>(blockIdx.x) * kCells;
  const long long cell1 = min(cell0 + kCells, ncells);
  const int* id = ids + b * v;
  const U* f = feats + b * v * c;
  U* o = out + (b * ncells + cell0) * c;

  for (int t = threadIdx.x; t < kCells; t += kThreads) row_of[t] = -1;
  if (threadIdx.x < 2) {
    const long long target = threadIdx.x == 0 ? cell0 : cell1;
    int lo = 0;
    int hi = v;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (static_cast<long long>(id[mid]) < target) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    bounds[threadIdx.x] = lo;
  }
  __syncthreads();
  for (int j = bounds[0] + threadIdx.x; j < bounds[1]; j += kThreads) {
    row_of[id[j] - cell0] = j;
  }
  __syncthreads();

  const int ne = static_cast<int>(cell1 - cell0) * c;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(o) & 15) == 0) {
    constexpr int kVec = 16 / sizeof(U);
    const int nvec = ne / kVec;
    uint4* o4 = reinterpret_cast<uint4*>(o);
    for (int q = threadIdx.x; q < nvec; q += kThreads) {
      union {
        uint4 u;
        U e[kVec];
      } pack;
      // one division per vector; walk (cell, channel) from there
      int cell = (q * kVec) / c;
      int ch = q * kVec - cell * c;
      int r = row_of[cell];
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        pack.e[k] = r >= 0 ? f[static_cast<long long>(r) * c + ch] : U(0);
        if (++ch == c) {
          ch = 0;
          ++cell;
          r = row_of[min(cell, kCells - 1)];
        }
      }
      o4[q] = pack.u;
    }
    done = nvec * kVec;
  }
  for (int e = done + threadIdx.x; e < ne; e += kThreads) {
    o[e] = element(f, row_of, e, c);
  }
}

}  // namespace

// feats: (b, v, c) elements of elem_size bytes (2 or 4); ids: (b, v) int32;
// out: (b, ncells, c) of the same element size; stream: cudaStream_t.
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for an unsupported element size or grid.
extern "C" int scatter_to_grid(const void* feats, const void* ids, void* out,
                               int b, int v, int c, long long ncells,
                               int elem_size, void* stream) {
  if (b <= 0 || c <= 0 || ncells <= 0) return 0;
  const long long blocks = (ncells + kCells - 1) / kCells;
  if (b > 65535 || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(b));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* id = static_cast<const int*>(ids);
  if (elem_size == 2) {
    scatter_to_grid_kernel<uint16_t><<<grid, kThreads, 0, s>>>(
        static_cast<const uint16_t*>(feats), id, static_cast<uint16_t*>(out),
        v, c, ncells);
  } else if (elem_size == 4) {
    scatter_to_grid_kernel<uint32_t><<<grid, kThreads, 0, s>>>(
        static_cast<const uint32_t*>(feats), id, static_cast<uint32_t*>(out),
        v, c, ncells);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
