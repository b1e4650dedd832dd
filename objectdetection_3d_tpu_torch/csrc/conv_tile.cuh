// Shared body of the direct 3x3(x3) convolution kernels for Hopper,
// sm_90a: K8 (fused_stage.cu) and K10 (subm_conv3d.cu), and K9's float32
// body (zfold_conv.cu; its bf16 body is its own, over wgmma.cuh).
//
// Layout: channels last.  An input plane is (H, W, C), an output plane
// (H, W, Co), in float32 or bf16; weights are (taps, C, Co) with the taps
// in (dz, dy, dx) order, in the input's type.  Two bodies compute the
// conv, both with float32 sums, rounding only the stored output to the
// input's type: float32 runs on the CUDA cores (FFMA, below), bf16 on the
// tensor cores (mma.sync, further down).
//
// CUDA-core tiling: a block of kThreads threads owns a kTH x kTW tile of output
// pixels of one output plane and all of its (padded) output channels.
// Thread t is pixel thread t % kPT (one row, kPX consecutive columns) and
// channel thread t / kPT (kCPT output channels), so it keeps a kPX x kCPT
// accumulator in registers.  The input channels are walked in chunks of
// kCK: per chunk the block stages, in shared memory as float, the
// (kTH+2) x (kTW+2) halo window of each of the KZ input planes and the
// chunk's weights, then every thread runs its taps from there.  Per
// (dy, channel) a thread reads kPX+2 inputs once for the three dx taps and
// its weights as 16-byte broadcasts, against 3*kPX*kCPT FFMAs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace conv_tile {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T, as float
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_float<T>(from_float<T>(v));
}

template <int KZ, int CT, int CPT, int PX, int CK>
struct Tile {
  static constexpr int kKZ = KZ;                // input planes per output
  static constexpr int kCT = CT;                // channel threads
  static constexpr int kCPT = CPT;              // out channels per thread
  static constexpr int kCPTP = (CPT + 3) / 4 * 4;  // ... padded to float4
  static constexpr int kPX = PX;                // pixels per thread
  static constexpr int kCK = CK;                // input channels per chunk
  static constexpr int kPT = kThreads / CT;     // pixel threads
  static constexpr int kTW = 16;
  static constexpr int kCG = kTW / PX;          // column groups of a row
  static constexpr int kTH = kPT / kCG;
  static constexpr int kPix = kTH * kTW;
  static constexpr int kCoP = CT * CPT;         // output channels covered
  static constexpr int kS = kTW + 3;            // odd halo row stride
  static constexpr int kPlane = (kTH + 2) * kS;
  static constexpr int kHalo = KZ * CK * kPlane;            // floats
  static constexpr int kTaps = KZ * 9;
  static constexpr int kWRow = CT * kCPTP;
  static constexpr int kW = kTaps * CK * kWRow;             // floats
  static_assert(kThreads % CT == 0 && kTW % PX == 0 && kPT % kCG == 0,
                "tile does not divide");
};

// Stage input channels [c0, c0+CK) of the halo window at rows h0-1..,
// columns w0-1.. of each plane planes[kz] (nullptr: a zero plane) as float
// [kz][c][row][col]; zero outside the plane and beyond C.
template <typename G, typename T>
__device__ __forceinline__ void load_halo(float* __restrict__ hs,
                                          const T* const (&planes)[G::kKZ],
                                          int H, int W, int C, int h0,
                                          int w0, int c0) {
  constexpr int kWinW = G::kTW + 2;
  constexpr int kWin = (G::kTH + 2) * kWinW;
#pragma unroll
  for (int kz = 0; kz < G::kKZ; ++kz) {
    const T* p = planes[kz];
    for (int i = threadIdx.x; i < kWin * G::kCK; i += kThreads) {
      const int c = i % G::kCK;
      const int px = i / G::kCK;
      const int hy = px / kWinW;
      const int hx = px - hy * kWinW;
      const int h = h0 + hy - 1;
      const int w = w0 + hx - 1;
      const int cc = c0 + c;
      float v = 0.f;
      if (p != nullptr && h >= 0 && h < H && w >= 0 && w < W && cc < C) {
        v = to_float<T>(p[(static_cast<long long>(h) * W + w) * C + cc]);
      }
      hs[(kz * G::kCK + c) * G::kPlane + hy * G::kS + hx] = v;
    }
  }
}

// Stage input channels [c0, c0+CK) of the (taps, C, Co) weights as float
// [tap][c][channel thread][kCPTP]; zero beyond C, Co and kCPT.
template <typename G, typename T>
__device__ __forceinline__ void load_weights(float* __restrict__ ws,
                                             const T* __restrict__ w, int C,
                                             int Co, int c0) {
  for (int i = threadIdx.x; i < G::kW; i += kThreads) {
    const int j = i % G::kCPTP;
    const int r = i / G::kCPTP;
    const int ct = r % G::kCT;
    const int r2 = r / G::kCT;
    const int c = r2 % G::kCK;
    const int tap = r2 / G::kCK;
    const int co = ct * G::kCPT + j;
    float v = 0.f;
    if (j < G::kCPT && co < Co && c0 + c < C) {
      v = to_float<T>(w[(static_cast<long long>(tap) * C + c0 + c) * Co + co]);
    }
    ws[i] = v;
  }
}

// acc[p][j] += sum over the staged taps and channels of
// input(row + dy, col + p + dx) * weight(tap, c, ct*kCPT + j)
template <typename G>
__device__ __forceinline__ void accumulate(const float* __restrict__ hs,
                                           const float* __restrict__ ws,
                                           int row, int col, int ct,
                                           float (&acc)[G::kPX][G::kCPT]) {
#pragma unroll 1
  for (int kz = 0; kz < G::kKZ; ++kz) {
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll 2
      for (int c = 0; c < G::kCK; ++c) {
        const float* src =
            hs + (kz * G::kCK + c) * G::kPlane + (row + dy) * G::kS + col;
        float a[G::kPX + 2];
#pragma unroll
        for (int i = 0; i < G::kPX + 2; ++i) a[i] = src[i];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int tap = (kz * 3 + dy) * 3 + dx;
          const float4* wp = reinterpret_cast<const float4*>(
              ws + (tap * G::kCK + c) * G::kWRow + ct * G::kCPTP);
          float wv[G::kCPTP];
#pragma unroll
          for (int q = 0; q < G::kCPTP / 4; ++q) {
            const float4 v = wp[q];
            wv[4 * q] = v.x;
            wv[4 * q + 1] = v.y;
            wv[4 * q + 2] = v.z;
            wv[4 * q + 3] = v.w;
          }
#pragma unroll
          for (int p = 0; p < G::kPX; ++p) {
#pragma unroll
            for (int j = 0; j < G::kCPT; ++j) {
              acc[p][j] = fmaf(a[p + dx], wv[j], acc[p][j]);
            }
          }
        }
      }
    }
  }
}

// This thread's pixel row and first column in the tile, and channel thread.
template <typename G>
__device__ __forceinline__ void thread_place(int& row, int& col, int& ct) {
  const int pt = threadIdx.x % G::kPT;
  ct = threadIdx.x / G::kPT;
  row = pt / G::kCG;
  col = (pt % G::kCG) * G::kPX;
}

// The float32 accumulator of one output tile at (h0, w0): the 3x3 (KZ=1)
// or 3x3x3 (KZ=3) conv of planes[0..KZ) with the (taps, C, Co) weights.
// hs / ws: shared memory of kHalo / kW floats.  It starts each channel
// chunk with a barrier and ends without one.
template <typename G, typename T>
__device__ __forceinline__ void conv_tile(float* hs, float* ws,
                                          const T* const (&planes)[G::kKZ],
                                          const T* __restrict__ w, int H,
                                          int W, int C, int Co, int h0,
                                          int w0,
                                          float (&acc)[G::kPX][G::kCPT]) {
  int row, col, ct;
  thread_place<G>(row, col, ct);
#pragma unroll
  for (int p = 0; p < G::kPX; ++p) {
#pragma unroll
    for (int j = 0; j < G::kCPT; ++j) acc[p][j] = 0.f;
  }
#pragma unroll 1
  for (int c0 = 0; c0 < C; c0 += G::kCK) {
    __syncthreads();
    load_halo<G>(hs, planes, H, W, C, h0, w0, c0);
    load_weights<G>(ws, w, C, Co, c0);
    __syncthreads();
    accumulate<G>(hs, ws, row, col, ct, acc);
  }
}

// Store the accumulator of the tile at (h0, w0) into the (H, W, Co)
// output plane, rounded to T; pixels and channels outside are skipped.
template <typename G, typename T>
__device__ __forceinline__ void store_tile(T* __restrict__ out,
                                           const float (&acc)[G::kPX][G::kCPT],
                                           int H, int W, int Co, int h0,
                                           int w0) {
  int row, col, ct;
  thread_place<G>(row, col, ct);
  const int h = h0 + row;
  if (h >= H) return;
#pragma unroll
  for (int p = 0; p < G::kPX; ++p) {
    const int w = w0 + col + p;
    if (w >= W) continue;
    T* o = out + (static_cast<long long>(h) * W + w) * Co;
#pragma unroll
    for (int j = 0; j < G::kCPT; ++j) {
      const int co = ct * G::kCPT + j;
      if (co < Co) o[co] = from_float<T>(acc[p][j]);
    }
  }
}

// ---------------------------------------------------------------------
// bf16 tensor-core body: the same conv as an implicit GEMM on mma.sync
// m16n8k16 (bf16 in, float32 sums).  Warp w owns the kMT tile rows
// [w*kMT, (w+1)*kMT); each row's 16 pixels are one m16 fragment, and the
// warp keeps all kNT n8 fragments of the output channels.  The input
// channels are walked in chunks of 16 (the k of one mma): per chunk the
// block stages the bf16 halo windows as [kz][row][col][channel] and the
// chunk's weights as [tap][out channel][channel], both with a 48-byte row
// stride so that ldmatrix reads hit 8 distinct bank groups, and every
// (tap, row) is one ldmatrix.x4 of A plus, per n8 fragment, one
// ldmatrix.x2 of B and one mma.  The weights come packed by the caller as
// (ceil(C/16), taps, NT*8, 16) bf16, zero-padded.

template <int KZ, int TH, int NT>
struct MmaTile {
  static constexpr int kKZ = KZ;
  static constexpr int kTH = TH;
  static constexpr int kTW = 16;
  static constexpr int kNT = NT;
  static constexpr int kMT = TH / 8;            // tile rows per warp
  static constexpr int kNP = NT * 8;            // padded out channels
  static constexpr int kPS = 24;                // bf16 per staged row
  static constexpr int kWinW = kTW + 2;
  static constexpr int kWin = (TH + 2) * kWinW;
  static constexpr int kHalo = KZ * kWin * kPS;  // bf16
  static constexpr int kTaps = KZ * 9;
  static constexpr int kW = kTaps * kNP * kPS;   // bf16
  static constexpr size_t kBytes = (kHalo + kW) * 2;
  static_assert(TH % 8 == 0 && kThreads == 256, "8 warps, 8k rows");
};

using bf16 = __nv_bfloat16;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Stage input channels [c0, c0+16) of each plane's halo window as bf16
// [kz][row][col][channel]; zero outside the plane and beyond C.
template <typename M>
__device__ __forceinline__ void load_halo_mma(bf16* __restrict__ hs,
                                              const bf16* const (&planes)[M::kKZ],
                                              int H, int W, int C, int h0,
                                              int w0, int c0) {
  const bf16 zero = __float2bfloat16_rn(0.f);
#pragma unroll
  for (int kz = 0; kz < M::kKZ; ++kz) {
    const bf16* p = planes[kz];
    for (int i = threadIdx.x; i < M::kWin * 8; i += kThreads) {
      const int q = i & 7;
      const int px = i >> 3;
      const int hy = px / M::kWinW;
      const int hx = px - hy * M::kWinW;
      const int h = h0 + hy - 1;
      const int w = w0 + hx - 1;
      const int cc = c0 + 2 * q;
      __nv_bfloat162 v = __halves2bfloat162(zero, zero);
      if (p != nullptr && h >= 0 && h < H && w >= 0 && w < W && cc < C) {
        const bf16* src = p + (static_cast<long long>(h) * W + w) * C + cc;
        if ((C & 1) == 0 && cc + 1 < C) {
          v = *reinterpret_cast<const __nv_bfloat162*>(src);
        } else {
          v = __halves2bfloat162(src[0], cc + 1 < C ? src[1] : zero);
        }
      }
      *reinterpret_cast<__nv_bfloat162*>(hs + (kz * M::kWin + px) * M::kPS +
                                         2 * q) = v;
    }
  }
}

// Stage chunk `ch` of the packed weights: kTaps*kNP rows of 16 bf16.
template <typename M>
__device__ __forceinline__ void load_weights_mma(bf16* __restrict__ ws,
                                                 const bf16* __restrict__ wpk,
                                                 int ch) {
  const uint4* src = reinterpret_cast<const uint4*>(
      wpk + static_cast<long long>(ch) * M::kTaps * M::kNP * 16);
  for (int i = threadIdx.x; i < M::kTaps * M::kNP * 2; i += kThreads) {
    *reinterpret_cast<uint4*>(ws + (i >> 1) * M::kPS + (i & 1) * 8) = src[i];
  }
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[mt][nt] += the staged chunk's products for this warp's rows
template <typename M>
__device__ __forceinline__ void accumulate_mma(
    const bf16* hs, const bf16* ws, float (&acc)[M::kMT][M::kNT][4]) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // ldmatrix.x4 of A: lane l gives row l%8 of matrix l/8 (pixels 0-7 /
  // 8-15, channels 0-7 / 8-15); ldmatrix.x2 of B: lanes 0-15 give rows
  // (out channels) 0-7 of channels 0-7, then 8-15
  const int am = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int ak = (lane >> 4) * 8;
  const int bn = lane & 7;
  const int bk = ((lane >> 3) & 1) * 8;
  const unsigned hs0 = smem_addr(hs);
  const unsigned ws0 = smem_addr(ws);
#pragma unroll 1
  for (int kz = 0; kz < M::kKZ; ++kz) {
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int tap = (kz * 3 + dy) * 3 + dx;
#pragma unroll
        for (int mt = 0; mt < M::kMT; ++mt) {
          const int row = warp * M::kMT + mt;
          const unsigned aaddr =
              hs0 + ((kz * M::kWin + (row + dy) * M::kWinW + am + dx) *
                         M::kPS + ak) * 2;
          unsigned a[4];
          asm volatile(
              "ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
              "{%0, %1, %2, %3}, [%4];\n"
              : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
              : "r"(aaddr));
#pragma unroll
          for (int nt = 0; nt < M::kNT; ++nt) {
            const unsigned baddr =
                ws0 + ((tap * M::kNP + nt * 8 + bn) * M::kPS + bk) * 2;
            unsigned b0, b1;
            asm volatile(
                "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                : "=r"(b0), "=r"(b1)
                : "r"(baddr));
            mma_bf16(acc[mt][nt], a, b0, b1);
          }
        }
      }
    }
  }
}

// The float32 accumulator fragments of one output tile at (h0, w0), on
// the tensor cores; as conv_tile, with the packed weights `wpk`.
template <typename M>
__device__ __forceinline__ void conv_tile_mma(
    bf16* hs, bf16* ws, const bf16* const (&planes)[M::kKZ],
    const bf16* __restrict__ wpk, int H, int W, int C, int h0, int w0,
    float (&acc)[M::kMT][M::kNT][4]) {
#pragma unroll
  for (int mt = 0; mt < M::kMT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < M::kNT; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.f;
    }
  }
  const int chunks = (C + 15) / 16;
#pragma unroll 1
  for (int ch = 0; ch < chunks; ++ch) {
    __syncthreads();
    load_halo_mma<M>(hs, planes, H, W, C, h0, w0, ch * 16);
    load_weights_mma<M>(ws, wpk, ch);
    __syncthreads();
    accumulate_mma<M>(hs, ws, acc);
  }
}

// Calls f(row, col, channel, value) for every accumulator element of this
// thread: fragment element j of (mt, nt) is pixel (warp*kMT + mt,
// lane/4 + 8*(j/2)) and channel nt*8 + 2*(lane%4) + j%2.
template <typename M, typename F>
__device__ __forceinline__ void for_each_mma(
    const float (&acc)[M::kMT][M::kNT][4], F&& f) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int mt = 0; mt < M::kMT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < M::kNT; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        f(warp * M::kMT + mt, (lane >> 2) + 8 * (j >> 1),
          nt * 8 + 2 * (lane & 3) + (j & 1), acc[mt][nt][j]);
      }
    }
  }
}

// Store the fragments of the tile at (h0, w0) into the (H, W, Co) bf16
// output plane; pixels and channels outside are skipped.
template <typename M>
__device__ __forceinline__ void store_tile_mma(
    bf16* __restrict__ out, const float (&acc)[M::kMT][M::kNT][4], int H,
    int W, int Co, int h0, int w0) {
  for_each_mma<M>(acc, [&](int row, int col, int n, float v) {
    const int h = h0 + row;
    const int w = w0 + col;
    if (h < H && w < W && n < Co) {
      out[(static_cast<long long>(h) * W + w) * Co + n] = __float2bfloat16_rn(v);
    }
  });
}

// Calls f(n8 fragments) as an integral constant for a packed width of
// np = 8 * NT output channels, NT in {3, 4, 8, 10, 16} up to kMaxNT;
// returns cudaErrorInvalidValue for any other np.
template <int kMaxNT, typename F>
int by_packed_width(int np, F&& f) {
  using std::integral_constant;
  switch (np) {
    case 24:
      return f(integral_constant<int, 3>{});
    case 32:
      return f(integral_constant<int, 4>{});
    case 64:
      if constexpr (kMaxNT >= 8) return f(integral_constant<int, 8>{});
      break;
    case 80:
      if constexpr (kMaxNT >= 10) return f(integral_constant<int, 10>{});
      break;
    case 128:
      if constexpr (kMaxNT >= 16) return f(integral_constant<int, 16>{});
      break;
    default:
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Calls f(channel threads, channels per thread) as integral constants for
// the split that covers Co output channels, up to kMaxCo; returns
// cudaErrorInvalidValue for a Co outside 1..kMaxCo.
template <int kMaxCo, typename F>
int by_out_channels(int co, F&& f) {
  using std::integral_constant;
  if (co <= 0 || co > kMaxCo) return static_cast<int>(cudaErrorInvalidValue);
  if (co <= 20) {
    return f(integral_constant<int, 4>{}, integral_constant<int, 5>{});
  }
  if (co <= 32) {
    return f(integral_constant<int, 4>{}, integral_constant<int, 8>{});
  }
  if constexpr (kMaxCo > 32) {
    if (co <= 64) {
      return f(integral_constant<int, 8>{}, integral_constant<int, 8>{});
    }
  }
  if constexpr (kMaxCo > 64) {
    if (co <= 80) {
      return f(integral_constant<int, 16>{}, integral_constant<int, 5>{});
    }
    return f(integral_constant<int, 16>{}, integral_constant<int, 8>{});
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Launch `kern` on `grid` with `smem` bytes of dynamic shared memory.
template <typename K, typename... Args>
int launch(K kern, dim3 grid, size_t smem, void* stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace conv_tile
