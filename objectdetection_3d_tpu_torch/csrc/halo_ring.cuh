// The plane ring shared by the bf16 bodies of K8 (fused_stage.cu) and K10
// (subm_conv3d.cu) for Hopper, sm_90a: a block owns an 8 x 16 pixel tile
// of a channels-last (D, H, W, C) grid and walks z, staging each input
// plane's 10 x 18 halo window once in a ring of shared-memory slots while
// mma.sync m16n8k16 runs the 3x3x3 taps from there.
//
// Staged rows are 32 bytes (16 bf16 channels): a plane slot is
// [ceil(C/16) chunks][halo pixel][16 channels], and the resident weights
// are the (ceil(C/16), 27, np, 16) packing of ops/pallas_conv.py::
// kernel_weights, row for row.  The two 16-byte halves of a row swap where
// bit 2 of the row index (the pixel, or the weight row) is set, so that
// the 8 rows of one ldmatrix phase hit 8 distinct bank groups without
// padding.  TMA cannot stride C = 20's 40-byte pixels, so the halo arrives
// by cp.async in 16-byte pieces (C % 8 == 0), 8-byte pieces (C % 4 == 0),
// or 2-byte loads.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "conv_tile.cuh"

namespace halo_ring {

using conv_tile::bf16;
using conv_tile::kThreads;

constexpr int kTH = 8;                    // tile rows: one per warp
constexpr int kTW = 16;                   // tile columns: one m16 operand
constexpr int kWinW = kTW + 2;
constexpr int kWin = (kTH + 2) * kWinW;   // halo pixels of a plane

// cp.async of a PB-byte piece (PB = 16 or 8); zero-fills when !valid.
template <int PB>
__device__ __forceinline__ void cp_piece(void* dst, const void* src,
                                         bool valid) {
  const unsigned d = conv_tile::smem_addr(dst);
  const int n = valid ? PB : 0;
  if constexpr (PB == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  }
}

__device__ __forceinline__ void ldsm_x4(unsigned (&a)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(unsigned& b0, unsigned& b1,
                                        unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x1(unsigned& b0, unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x1.shared.b16 {%0}, [%1];\n"
               : "=r"(b0)
               : "r"(addr));
}

// d += a (m16 x k8) @ b (k8 x n8), bf16 in, float32 sums
__device__ __forceinline__ void mma_bf16_k8(float (&d)[4],
                                            const unsigned (&a)[2],
                                            unsigned b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
}

// The packed subm weights (chunks, 27, np, 16) into shared memory at `dst`
// by cp.async: rows of 32 bytes, halves swapped on rows with bit 2 set.
__device__ __forceinline__ void load_weights(unsigned char* dst,
                                             const bf16* __restrict__ w,
                                             int chunks, int np) {
  for (int i = threadIdx.x; i < chunks * 27 * np * 2; i += kThreads) {
    const int r = i >> 1;
    cp_piece<16>(dst + r * 32 + ((((i & 1) ^ (r >> 2)) & 1) << 4),
                 w + static_cast<long long>(i) * 8, true);
  }
}

// Plane z of the (D, H, W, C) grid xb (zeros outside 0..D-1, outside the
// grid and beyond C) into `slot`: the halo window of the tile at (h0, w0)
// as [chunk][pixel][16 channels], the 16-byte half h of pixel p at
// h ^ (bit 2 of p).  PB: cp.async piece in bytes (16: C % 8 == 0, 8:
// C % 4 == 0), or 0 for synchronous 2-byte loads.
template <int PB>
__device__ __forceinline__ void load_plane(unsigned char* slot,
                                           const bf16* __restrict__ xb,
                                           int z, int D, int H, int W, int C,
                                           int chunks, int h0, int w0) {
  const int tid = threadIdx.x;
  const long long hw = static_cast<long long>(H) * W;
  const bool zin = z >= 0 && z < D;
  const bf16* xp = xb + static_cast<long long>(zin ? z : 0) * hw * C;
  if constexpr (PB > 0) {
    constexpr int kPE = PB / 2;           // channels per piece
    const int per_px = chunks * 16 / kPE;
    for (int i = tid; i < kWin * per_px; i += kThreads) {
      const int px = i / per_px;
      const int c = (i - px * per_px) * kPE;
      const int hy = px / kWinW;
      const int h = h0 + hy - 1;
      const int w = w0 + px - hy * kWinW - 1;
      const bool ok = zin && h >= 0 && h < H && w >= 0 && w < W && c < C;
      const bf16* src =
          ok ? xp + (static_cast<long long>(h) * W + w) * C + c : xp;
      const int k = c & 15;
      cp_piece<PB>(slot + ((c >> 4) * kWin + px) * 32 +
                       ((((k >> 3) ^ (px >> 2)) & 1) << 4) + (k & 7) * 2,
                   src, ok);
    }
  } else {
    const unsigned short* xs = reinterpret_cast<const unsigned short*>(xp);
    const int per_px = chunks * 16;
    for (int i = tid; i < kWin * per_px; i += kThreads) {
      const int px = i / per_px;
      const int c = i - px * per_px;
      const int hy = px / kWinW;
      const int h = h0 + hy - 1;
      const int w = w0 + px - hy * kWinW - 1;
      const bool ok = zin && h >= 0 && h < H && w >= 0 && w < W && c < C;
      const int k = c & 15;
      *reinterpret_cast<unsigned short*>(
          slot + ((c >> 4) * kWin + px) * 32 +
          ((((k >> 3) ^ (px >> 2)) & 1) << 4) + (k & 7) * 2) =
          ok ? xs[(static_cast<long long>(h) * W + w) * C + c] : 0;
    }
  }
}

// A staged output pixel's stride in bf16: padded by 16 bytes where the
// 16-byte pieces allow it (no bank conflicts), else packed flat.
__host__ __device__ inline int staged_stride(int co) {
  return co % 8 == 0 ? co + 8 : co;
}

// One warp writes its npx staged pixels `sg` (stride staged_stride(Co))
// to the contiguous output pixels at `g`, in 16-byte pieces where the
// layout allows.
__device__ __forceinline__ void store_row(bf16* __restrict__ g,
                                          const bf16* sg, int npx, int Co,
                                          int stride, int lane) {
  if (Co % 8 == 0) {
    const int q = Co / 8;
    for (int i = lane; i < npx * q; i += 32) {
      const int p = i / q;
      const int k = i - p * q;
      *reinterpret_cast<uint4*>(g + p * Co + 8 * k) =
          *reinterpret_cast<const uint4*>(sg + p * stride + 8 * k);
    }
  } else {
    // staged flat: the warp's npx pixels are one contiguous span
    const int n = npx * Co;
    if ((reinterpret_cast<uintptr_t>(g) & 15) == 0 && n % 8 == 0) {
      for (int i = lane; i < n / 8; i += 32) {
        reinterpret_cast<uint4*>(g)[i] = reinterpret_cast<const uint4*>(sg)[i];
      }
    } else {
      for (int i = lane; i < n; i += 32) g[i] = sg[i];
    }
  }
}

}  // namespace halo_ring
