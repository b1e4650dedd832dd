// Dense pseudo-image grid build (kernel K2) for Hopper, sm_90a.
//
// Replaces: objectdetection_3d_tpu/ops/grid_scatter.py::scatter_to_grid
// (the Pallas TPU kernel `_kernel`: one program per (z-slice, row chunk)
// zero-fills its VMEM window and inserts that range's voxel rows).
//
// Computes, per batch row b, the dense grid out[b] of (ncells, C): the
// feature row feats[b, j] at cell ids[b, j] for every voxel j whose id is
// below ncells, and zero at every other cell.  ids are unique below
// ncells; padding voxels carry an id >= ncells.  (The callers pass them
// sorted; this kernel does not need it.)
//
// Bound on this card: bytes written.  The flagship grid (100x400x400 cells
// x 20 channels, bf16) is 640 MB written against about 4 MB read, about
// 0.19 ms at 3.35 TB/s, and 99.5% of its cells are empty.
//
// Design: a streaming zero fill, then the voxel rows over it, as two
// launches on the caller's stream.
// - The fill is one-shot blocks of 512 threads that each store 4 x 16
//   bytes of zeros, with no index work at all: it runs at cudaMemset's
//   rate.
// - The copy has one thread per 16-, 8-, 4- or 2-byte piece of a voxel
//   row (the widest that divides the row: 8 bytes for 20 bf16 channels).
//   It is launched with programmatic stream serialization, so its blocks
//   start while the fill's last blocks run, load their rows, and wait
//   (griddepcontrol.wait) only before they store.
// So an occupied cell is written twice, and the TPU kernel's "each cell
// written once" no longer holds: the flagship cloud's 76,202 rows are 3 MB
// of the 640 MB.  Designs that wrote each cell once, or zeroed and copied
// inside one block, spent their time finding each block's voxels and lost
// to zeros + index_put_ on the flagship cloud (NVIDIA H100 80GB HBM3,
// 700 W: 0.2455 ms for blocks that found their range through a pre-pass,
// against 0.2132 ms for this design and 0.2249 ms for zeros +
// index_put_).  The kernels copy bits, so one instantiation per element
// size serves bf16 (2 bytes) and float32 (4 bytes).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kFillThreads = 512;
constexpr int kFillVecs = 4;               // 16-byte stores per thread
constexpr int kCopyThreads = 256;

// Zeros over the n elements of o: 16-byte stores over the n16 vectors
// from element `head` on; block 0 also zeroes the elements before head
// and after the vectors.  Lets the copy launch as its blocks finish.
template <typename U>
__global__ void __launch_bounds__(kFillThreads)
fill_zero_kernel(U* __restrict__ o, int head, long long n16, long long n) {
  const uint4 zero = make_uint4(0, 0, 0, 0);
  uint4* o4 = reinterpret_cast<uint4*>(o + head);
  const long long base =
      static_cast<long long>(blockIdx.x) * kFillThreads * kFillVecs +
      threadIdx.x;
#pragma unroll
  for (int k = 0; k < kFillVecs; ++k) {
    const long long i = base + static_cast<long long>(k) * kFillThreads;
    if (i < n16) o4[i] = zero;
  }
  if (blockIdx.x == 0) {
    const long long tail = head + n16 * static_cast<long long>(16 / sizeof(U));
    if (threadIdx.x < head) o[threadIdx.x] = U(0);
    for (long long e = tail + threadIdx.x; e < n; e += kFillThreads) {
      o[e] = U(0);
    }
  }
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// out[b, ids[b, j]] = feats[b, j], row by row in V-sized pieces, row_vecs
// pieces a row: one thread per (j, piece) of row b = blockIdx.y.
template <typename V>
__global__ void __launch_bounds__(kCopyThreads)
copy_rows_kernel(const V* __restrict__ feats, const int* __restrict__ ids,
                 V* __restrict__ out, int v, int row_vecs, long long ncells) {
  const int e = blockIdx.x * kCopyThreads + threadIdx.x;
  const long long b = blockIdx.y;
  bool live = e < v * row_vecs;
  int q = 0;
  int id = -1;
  V val;
  if (live) {
    const int j = e / row_vecs;
    q = e - j * row_vecs;
    id = ids[b * v + j];
    live = id >= 0 && id < ncells;
    if (live) val = feats[(b * v + j) * row_vecs + q];
  }
  // the fill's zeros land first
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (live) out[(b * ncells + id) * row_vecs + q] = val;
}

template <typename V>
int launch_copy(const void* feats, const int* ids, void* out, int b, int v,
                int row_bytes, long long ncells, cudaStream_t s) {
  const int row_vecs = row_bytes / static_cast<int>(sizeof(V));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(
      static_cast<unsigned>((static_cast<long long>(v) * row_vecs +
                             kCopyThreads - 1) / kCopyThreads),
      static_cast<unsigned>(b));
  cfg.blockDim = dim3(kCopyThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, copy_rows_kernel<V>, static_cast<const V*>(feats), ids,
      static_cast<V*>(out), v, row_vecs, ncells));
}

template <typename U>
int launch(const U* feats, const int* ids, U* out, int b, int v, int c,
           long long ncells, cudaStream_t s) {
  const long long n = static_cast<long long>(b) * ncells * c;
  // elements before the first 16-byte boundary, then whole vectors
  const long long align = static_cast<long long>(
      ((16 - (reinterpret_cast<uintptr_t>(out) & 15)) & 15) / sizeof(U));
  const int head = static_cast<int>(align < n ? align : n);
  const long long n16 = (n - head) * static_cast<long long>(sizeof(U)) / 16;
  const long long per_block = static_cast<long long>(kFillThreads) * kFillVecs;
  const long long fill_blocks = n16 > 0 ? (n16 + per_block - 1) / per_block
                                        : 1;
  const int row_bytes = c * static_cast<int>(sizeof(U));
  if (fill_blocks > 0x7fffffffLL || b > 65535 ||
      static_cast<long long>(v) * row_bytes > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  fill_zero_kernel<U><<<static_cast<unsigned>(fill_blocks), kFillThreads, 0,
                        s>>>(out, head, n16, n);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || v <= 0) return err;
  // the widest piece that divides a row and both tensors' alignment
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(feats) |
                         reinterpret_cast<uintptr_t>(out);
  auto fits = [&](int bytes) {
    return row_bytes % bytes == 0 && ptrs % bytes == 0;
  };
  if (fits(16)) {
    err = launch_copy<uint4>(feats, ids, out, b, v, row_bytes, ncells, s);
  } else if (fits(8)) {
    err = launch_copy<uint2>(feats, ids, out, b, v, row_bytes, ncells, s);
  } else if (fits(4)) {
    err = launch_copy<uint32_t>(feats, ids, out, b, v, row_bytes, ncells, s);
  } else {
    err = launch_copy<uint16_t>(feats, ids, out, b, v, row_bytes, ncells, s);
  }
  return err != 0 ? err : static_cast<int>(cudaGetLastError());
}

}  // namespace

// feats: (b, v, c) elements of elem_size bytes (2 or 4); ids: (b, v) int32;
// out: (b, ncells, c) of the same element size; stream: cudaStream_t.
// Returns cudaGetLastError() after the launches (0 on success), or
// cudaErrorInvalidValue for an unsupported element size or grid.
extern "C" int scatter_to_grid(const void* feats, const void* ids, void* out,
                               int b, int v, int c, long long ncells,
                               int elem_size, void* stream) {
  if (b <= 0 || c <= 0 || ncells <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* id = static_cast<const int*>(ids);
  if (elem_size == 2) {
    return launch(static_cast<const uint16_t*>(feats), id,
                  static_cast<uint16_t*>(out), b, v, c, ncells, s);
  }
  if (elem_size == 4) {
    return launch(static_cast<const uint32_t*>(feats), id,
                  static_cast<uint32_t*>(out), b, v, c, ncells, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
