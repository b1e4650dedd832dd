// 3x3x3 SAME convolution for narrow channels (kernel K10) for Hopper,
// sm_90a.
//
// Replaces: objectdetection_3d_tpu/ops/pallas_conv.py::subm_conv3d_pallas
// (the Pallas TPU kernel `_kernel`: per (z, 8-row band) program, 27 rolled
// taps written into a 24-row-per-tap im2col scratch and one
// (Co, 27*24) @ (27*24, TH*Wp) MXU product).
//
// Computes out[b, z, h, w, o] = sum over (dz, dy, dx, c) of
// x[b, z+dz-1, h+dy-1, w+dx-1, c] * k[dz, dy, dx, c, o], zero outside the
// grid: the vertical encoder's submanifold conv before its mask, for
// C <= 24 input channels, bias-free, channels last, float32 sums.
//
// Bound on this card: at the flagship's stage 0 (100x400x400, 20 -> 20
// channels, bf16) the 0.35 TFLOP of products over the bf16 tensor-core
// rate (0.35 ms) and the 1.28 GB read and written once (0.38 ms) are
// close: a balanced kernel.
//
// Design: the TPU kernel's im2col scratch exists to give the MXU one wide
// contraction; here the 27 taps run straight from shared memory
// (conv_tile.cuh) as an implicit GEMM.  bf16 (the flagship): a block owns
// a 16x16-pixel tile of one z slice; per 16-channel chunk it stages the 3
// input slices' halo windows and the packed weights, and each warp runs
// two tile rows as m16 fragments through mma.sync m16n8k16 with float32
// sums, one ldmatrix per fragment.  float32: the same tiling idea on the
// CUDA cores (a 32x16 tile, 4 channels per chunk, 8 pixels x 5 or 8
// channels per thread).  Still well above the bound: no TMA, no
// double-buffered staging and mma.sync instead of wgmma (later work).

#include "conv_tile.cuh"

namespace {

using conv_tile::kThreads;

template <typename T, int CT, int CPT>
__global__ void __launch_bounds__(kThreads, 2)
subm_conv3d_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   T* __restrict__ out, int D, int H, int W, int C, int Co) {
  using G = conv_tile::Tile<3, CT, CPT, 8, 4>;
  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);
  float* ws = hs + G::kHalo;
  const int plane = blockIdx.z;
  const int b = plane / D;
  const int z = plane - b * D;
  const long long psz = static_cast<long long>(H) * W * C;
  const T* planes[3];
#pragma unroll
  for (int kz = 0; kz < 3; ++kz) {
    const int zz = z + kz - 1;
    planes[kz] = (zz >= 0 && zz < D)
                     ? x + (static_cast<long long>(b) * D + zz) * psz
                     : nullptr;
  }
  const int h0 = blockIdx.y * G::kTH;
  const int w0 = blockIdx.x * G::kTW;
  float acc[G::kPX][G::kCPT];
  conv_tile::conv_tile<G>(hs, ws, planes, w, H, W, C, Co, h0, w0, acc);
  conv_tile::store_tile<G>(
      out + static_cast<long long>(plane) * H * W * Co, acc, H, W, Co, h0,
      w0);
}

template <int NT>
__global__ void __launch_bounds__(kThreads, 2)
subm_conv3d_mma_kernel(const conv_tile::bf16* __restrict__ x,
                       const conv_tile::bf16* __restrict__ wpk,
                       conv_tile::bf16* __restrict__ out, int D, int H, int W,
                       int C, int Co) {
  using M = conv_tile::MmaTile<3, 16, NT>;
  extern __shared__ float4 smem4[];
  conv_tile::bf16* hs = reinterpret_cast<conv_tile::bf16*>(smem4);
  conv_tile::bf16* ws = hs + M::kHalo;
  const int plane = blockIdx.z;
  const int b = plane / D;
  const int z = plane - b * D;
  const long long psz = static_cast<long long>(H) * W * C;
  const conv_tile::bf16* planes[3];
#pragma unroll
  for (int kz = 0; kz < 3; ++kz) {
    const int zz = z + kz - 1;
    planes[kz] = (zz >= 0 && zz < D)
                     ? x + (static_cast<long long>(b) * D + zz) * psz
                     : nullptr;
  }
  const int h0 = blockIdx.y * M::kTH;
  const int w0 = blockIdx.x * M::kTW;
  float acc[M::kMT][M::kNT][4];
  conv_tile::conv_tile_mma<M>(hs, ws, planes, wpk, H, W, C, h0, w0, acc);
  conv_tile::store_tile_mma<M>(
      out + static_cast<long long>(plane) * H * W * Co, acc, H, W, Co, h0,
      w0);
}

int launch_mma(const void* x, const void* wpk, void* out, int B, int D,
               int H, int W, int C, int Co, int np, void* stream) {
  if (Co > np) return static_cast<int>(cudaErrorInvalidValue);
  return conv_tile::by_packed_width<8>(np, [&](auto nt) {
    constexpr int kNT = decltype(nt)::value;
    using M = conv_tile::MmaTile<3, 16, kNT>;
    const dim3 grid((W + M::kTW - 1) / M::kTW, (H + M::kTH - 1) / M::kTH,
                    B * D);
    return conv_tile::launch(
        subm_conv3d_mma_kernel<kNT>, grid, M::kBytes, stream,
        static_cast<const conv_tile::bf16*>(x),
        static_cast<const conv_tile::bf16*>(wpk),
        static_cast<conv_tile::bf16*>(out), D, H, W, C, Co);
  });
}

template <typename T>
int launch(const void* x, const void* w, void* out, int B, int D, int H,
           int W, int C, int Co, void* stream) {
  return conv_tile::by_out_channels<64>(Co, [&](auto ct, auto cpt) {
    constexpr int kCT = decltype(ct)::value;
    constexpr int kCPT = decltype(cpt)::value;
    using G = conv_tile::Tile<3, kCT, kCPT, 8, 4>;
    const dim3 grid((W + G::kTW - 1) / G::kTW, (H + G::kTH - 1) / G::kTH,
                    B * D);
    return conv_tile::launch(subm_conv3d_kernel<T, kCT, kCPT>, grid,
                             (G::kHalo + G::kW) * sizeof(float), stream,
                             static_cast<const T*>(x),
                             static_cast<const T*>(w), static_cast<T*>(out),
                             D, H, W, C, Co);
  });
}

}  // namespace

// K10.  x: (B, D, H, W, C); out: (B, D, H, W, Co), both contiguous, of
// one type.  float32 (dtype 0): w is the (3, 3, 3, C, Co) float32
// weight and the CUDA-core body runs.  bf16 (dtype 1): w is the bf16
// weight packed as (ceil(C/16), 27, np, 16) (conv_tile.cuh), np in
// {24, 32, 64} and >= Co, and the tensor-core body runs.  1 <= Co <= 64;
// B * D <= 65535.  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int subm_conv3d(const void* x, const void* w, void* out, int B,
                           int D, int H, int W, int C, int Co, int np,
                           int dtype, void* stream) {
  if (B <= 0 || D <= 0 || H <= 0 || W <= 0 || C <= 0 || B * D > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) return launch<float>(x, w, out, B, D, H, W, C, Co, stream);
  if (dtype == 1) {
    return launch_mma(x, w, out, B, D, H, W, C, Co, np, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
