// 3x3 SAME 2D convolution over the z-folded encoder layout (kernel K9) for
// Hopper, sm_90a.
//
// Replaces: objectdetection_3d_tpu/ops/zfold_conv.py::_conv2d_3x3_raw
// (the Pallas TPU kernel `_kernel`: per (image, 8-row band) program, 9
// accumulated (TH*Wb, 128) @ (128, 128) MXU products over a double-buffered
// halo band), which `conv2d_3x3_pallas` runs forward and, with the taps
// flipped and the channels swapped, for the input gradient.
//
// Computes out[n, h, w, o] = sum over (dy, dx, c) of
// x[n, h+dy-1, w+dx-1, c] * k[dy, dx, c, o], zero outside the image, for
// C, Co <= 128, channels last, float32 sums.
//
// Bound on this card: operations.  The fold widens the encoder's narrow
// convs to C, Co ~ 128 at (zb+2)/3 the products: 0.69 TFLOP at the
// flagship's stage 0 (25 folded images of 400x400, 120 -> 80 channels),
// 0.70 ms at the bf16 tensor-core rate, against 0.86 GB moved (0.26 ms).
//
// Design: the TPU kernel's 128-lane padding and roll-based taps exist for
// the MXU; here the taps run straight from shared memory (conv_tile.cuh)
// as an implicit GEMM.  bf16 (the flagship): a block owns an 8x16-pixel
// tile of one image and all (up to 128) output channels; per 16-channel
// chunk it stages the halo window and the packed weights, and each warp
// runs one tile row as an m16 fragment against every n8 fragment of the
// output channels through mma.sync m16n8k16 with float32 sums.  float32:
// the same tile on the CUDA cores, 8 channels per chunk, 8 pixels x 8 (or
// 5) channels per thread.  Each warp reloads B for every mma, so shared
// memory, not the tensor cores, limits the bf16 body; no TMA and no
// double buffering yet (later work).  The backward's dx is this kernel
// on the cotangent; its dw (9 contractions over the N*H*W rows) is left
// to torch.matmul, as the JAX package leaves it to XLA.

#include "conv_tile.cuh"

namespace {

using conv_tile::kThreads;

template <typename T, int CT, int CPT>
__global__ void __launch_bounds__(kThreads, 2)
conv2d_3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  T* __restrict__ out, int H, int W, int C, int Co) {
  using G = conv_tile::Tile<1, CT, CPT, 8, 8>;
  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);
  float* ws = hs + G::kHalo;
  const long long n = blockIdx.z;
  const T* planes[1] = {x + n * H * W * C};
  const int h0 = blockIdx.y * G::kTH;
  const int w0 = blockIdx.x * G::kTW;
  float acc[G::kPX][G::kCPT];
  conv_tile::conv_tile<G>(hs, ws, planes, w, H, W, C, Co, h0, w0, acc);
  conv_tile::store_tile<G>(out + n * H * W * Co, acc, H, W, Co, h0, w0);
}

template <int NT>
__global__ void __launch_bounds__(kThreads, 2)
conv2d_3x3_mma_kernel(const conv_tile::bf16* __restrict__ x,
                      const conv_tile::bf16* __restrict__ wpk,
                      conv_tile::bf16* __restrict__ out, int H, int W, int C,
                      int Co) {
  using M = conv_tile::MmaTile<1, 8, NT>;
  extern __shared__ float4 smem4[];
  conv_tile::bf16* hs = reinterpret_cast<conv_tile::bf16*>(smem4);
  conv_tile::bf16* ws = hs + M::kHalo;
  const long long n = blockIdx.z;
  const conv_tile::bf16* planes[1] = {x + n * H * W * C};
  const int h0 = blockIdx.y * M::kTH;
  const int w0 = blockIdx.x * M::kTW;
  float acc[M::kMT][M::kNT][4];
  conv_tile::conv_tile_mma<M>(hs, ws, planes, wpk, H, W, C, h0, w0, acc);
  conv_tile::store_tile_mma<M>(out + n * H * W * Co, acc, H, W, Co, h0, w0);
}

int launch_mma(const void* x, const void* wpk, void* out, int N, int H,
               int W, int C, int Co, int np, void* stream) {
  if (Co > np) return static_cast<int>(cudaErrorInvalidValue);
  return conv_tile::by_packed_width<16>(np, [&](auto nt) {
    constexpr int kNT = decltype(nt)::value;
    using M = conv_tile::MmaTile<1, 8, kNT>;
    const dim3 grid((W + M::kTW - 1) / M::kTW, (H + M::kTH - 1) / M::kTH, N);
    return conv_tile::launch(conv2d_3x3_mma_kernel<kNT>, grid, M::kBytes,
                             stream, static_cast<const conv_tile::bf16*>(x),
                             static_cast<const conv_tile::bf16*>(wpk),
                             static_cast<conv_tile::bf16*>(out), H, W, C, Co);
  });
}

template <typename T>
int launch(const void* x, const void* w, void* out, int N, int H, int W,
           int C, int Co, void* stream) {
  return conv_tile::by_out_channels<128>(Co, [&](auto ct, auto cpt) {
    constexpr int kCT = decltype(ct)::value;
    constexpr int kCPT = decltype(cpt)::value;
    using G = conv_tile::Tile<1, kCT, kCPT, 8, 8>;
    const dim3 grid((W + G::kTW - 1) / G::kTW, (H + G::kTH - 1) / G::kTH, N);
    return conv_tile::launch(conv2d_3x3_kernel<T, kCT, kCPT>, grid,
                             (G::kHalo + G::kW) * sizeof(float), stream,
                             static_cast<const T*>(x),
                             static_cast<const T*>(w), static_cast<T*>(out),
                             H, W, C, Co);
  });
}

}  // namespace

// K9.  x: (N, H, W, C); out: (N, H, W, Co), both contiguous, of one
// type.  float32 (dtype 0): w is the (3, 3, C, Co) float32 weight and the
// CUDA-core body runs.  bf16 (dtype 1): w is the bf16 weight packed as
// (ceil(C/16), 9, np, 16) (conv_tile.cuh), np in {24, 32, 64, 80, 128}
// and >= Co, and the tensor-core body runs.  1 <= C, Co <= 128;
// N <= 65535.  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int conv2d_3x3(const void* x, const void* w, void* out, int N,
                          int H, int W, int C, int Co, int np, int dtype,
                          void* stream) {
  if (N <= 0 || N > 65535 || H <= 0 || W <= 0 || C <= 0 || C > 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) return launch<float>(x, w, out, N, H, W, C, Co, stream);
  if (dtype == 1) return launch_mma(x, w, out, N, H, W, C, Co, np, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
