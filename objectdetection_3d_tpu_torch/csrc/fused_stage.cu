// One eval-mode vertical-encoder stage in one pass (kernel K8) for Hopper,
// sm_90a.
//
// Replaces: objectdetection_3d_tpu/ops/fused_stage.py::fused_stage_call
// (the Pallas TPU kernel `_kernel`: per (z block, 8-row band) program, the
// z-folded subm conv as 9 banded MXU products on its block and the next,
// the mask/BN/ReLU epilogue through selector products, and the down conv
// as two more products, writing only the stage output).
//
// Computes, for every output slice z' of the stage (D' = (D-3)/2 + 1):
//   y[z]  = round_T(relu(acc[z] * a_s + b_s) * mask[z]),
//           acc = the 3x3x3 SAME subm conv of x in float32;
//   out[z'] = round_T(relu(dd * a_d + b_d) * max(mask[2z'..2z'+2])),
//           dd = sum over t < 3 of y[2z'+t] @ wd[t] in float32;
// that is subm conv, mask, batch norm (eval affine), ReLU, the
// (3,1,1)/(2,1,1) VALID down conv, batch norm and ReLU under the pooled
// mask.  Channels last; x, mask and the weights in one type T (float32 or
// bf16), the affines float32.
//
// Bound on this card: operations.  At the flagship's stage 0
// (100x400x400, 20 -> 20 channels, bf16) the subm conv's 0.35 TFLOP and
// the down conv's 0.02 TFLOP take 0.37 ms at the bf16 tensor-core rate;
// the input, mask and output, each moved once, take 0.29 ms.  What the
// fusion saves is the unfused stage's passes over the 100-slice
// intermediate: conv output, mask and BN multiplies, ReLU, each a read
// and a write of 0.64 GB.
//
// Design: the TPU kernel folds z blocks into its 128 lanes; here the
// layout stays unfolded.  A block owns a 16x16 (or 8x16) pixel tile of one
// output slice z' and all its output channels.  For t = 0, 1, 2 it runs
// the subm conv of slice 2z'+t over the tile (conv_tile.cuh: in bf16 on
// the tensor cores, mma.sync m16n8k16 over 16-channel chunks; in float32
// on the CUDA cores), applies the mask, affine and ReLU to the float32
// sums, rounds to T, and parks the slice in shared memory; every thread
// then adds that slice's down-conv products (CUDA-core FFMA) to a second
// register accumulator.  Only the stage output is written.  The subm
// slice 2z'+2 is computed again by the block of z'+1 (1.5x the subm
// products), which keeps blocks independent.  The down conv on the CUDA
// cores and one block per SM at 64 channels (141 KB of shared memory)
// keep it far above the bound; later work.

#include "conv_tile.cuh"

namespace {

using conv_tile::kThreads;
using conv_tile::round_to;
using conv_tile::to_float;

// NT = 0: the CUDA-core subm body (float32); NT > 0: the tensor-core
// body with NT n8 fragments (bf16, weights packed as conv_tile.cuh says)
template <typename T, int CT, int CPT, int NT>
__global__ void __launch_bounds__(kThreads, 2)
fused_stage_kernel(const T* __restrict__ x, const T* __restrict__ mask,
                   const T* __restrict__ ws_g, const float* __restrict__ wd,
                   const float* __restrict__ vec, T* __restrict__ out, int D,
                   int Dout, int H, int W, int C, int Co) {
  using G = conv_tile::Tile<3, CT, CPT, 4, 4>;
  using M = conv_tile::MmaTile<3, G::kTH, NT == 0 ? 1 : NT>;
  constexpr bool kMma = NT > 0;
  extern __shared__ float4 smem4[];
  // subm staging, then one subm slice of the tile as float [c][pixel]
  float* ys = reinterpret_cast<float*>(
      reinterpret_cast<char*>(smem4) +
      (kMma ? M::kBytes : (G::kHalo + G::kW) * sizeof(float)));
  const int plane = blockIdx.z;
  const int b = plane / Dout;
  const int zo = plane - b * Dout;
  const int h0 = blockIdx.y * G::kTH;
  const int w0 = blockIdx.x * G::kTW;
  int row, col, ct;
  conv_tile::thread_place<G>(row, col, ct);
  const long long hw = static_cast<long long>(H) * W;
  const long long psz = hw * C;
  const T* mplane = mask + static_cast<long long>(b) * D * hw;
  // mask, affine, ReLU and rounding of subm output (pixel, channel) of
  // slice z, into ys
  auto park = [&](int z, int r, int c, int n, float v) {
    const int h = h0 + r;
    const int w = w0 + c;
    if (n >= Co) return;
    const float m = (h < H && w < W)
                        ? to_float<T>(mplane[z * hw + static_cast<long long>(h)
                                             * W + w])
                        : 0.f;
    ys[n * G::kPix + r * G::kTW + c] = round_to<T>(
        fmaxf(v * __ldg(vec + n) + __ldg(vec + Co + n), 0.f) * m);
  };

  float dd[G::kPX][CPT];
#pragma unroll
  for (int p = 0; p < G::kPX; ++p) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) dd[p][j] = 0.f;
  }

#pragma unroll 1
  for (int t = 0; t < 3; ++t) {
    const int z = 2 * zo + t;
    const T* planes[3];
#pragma unroll
    for (int kz = 0; kz < 3; ++kz) {
      const int zz = z + kz - 1;
      planes[kz] = (zz >= 0 && zz < D)
                       ? x + (static_cast<long long>(b) * D + zz) * psz
                       : nullptr;
    }
    // the barriers inside the conv separate these ys writes from the
    // previous slice's reads
    if constexpr (kMma) {
      auto* hs = reinterpret_cast<conv_tile::bf16*>(smem4);
      float acc[M::kMT][M::kNT][4];
      conv_tile::conv_tile_mma<M>(hs, hs + M::kHalo, planes, ws_g, H, W, C,
                                  h0, w0, acc);
      conv_tile::for_each_mma<M>(acc, [&](int r, int c, int n, float v) {
        park(z, r, c, n, v);
      });
    } else {
      float* hs = reinterpret_cast<float*>(smem4);
      float acc[G::kPX][CPT];
      conv_tile::conv_tile<G>(hs, hs + G::kHalo, planes, ws_g, H, W, C, Co,
                              h0, w0, acc);
#pragma unroll
      for (int p = 0; p < G::kPX; ++p) {
#pragma unroll
        for (int j = 0; j < CPT; ++j) park(z, row, col + p, ct * CPT + j,
                                           acc[p][j]);
      }
    }
    __syncthreads();
    // down-conv tap t: dd += y[2z'+t] @ wd[t]
    const float* wt = wd + static_cast<long long>(t) * Co * Co;
#pragma unroll 2
    for (int c = 0; c < Co; ++c) {
      const float4 yv =
          *reinterpret_cast<const float4*>(ys + c * G::kPix + row * G::kTW +
                                           col);
      const float y4[4] = {yv.x, yv.y, yv.z, yv.w};
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int co = ct * CPT + j;
        const float wv = co < Co ? __ldg(wt + c * Co + co) : 0.f;
#pragma unroll
        for (int p = 0; p < G::kPX; ++p) {
          dd[p][j] = fmaf(y4[p], wv, dd[p][j]);
        }
      }
    }
  }

  const int h = h0 + row;
  if (h >= H) return;
  T* o = out + (static_cast<long long>(b) * Dout + zo) * hw * Co;
#pragma unroll
  for (int p = 0; p < G::kPX; ++p) {
    const int w = w0 + col + p;
    if (w >= W) continue;
    const T* mp = mplane + static_cast<long long>(h) * W + w;
    const float md = fmaxf(to_float<T>(mp[2 * zo * hw]),
                           fmaxf(to_float<T>(mp[(2 * zo + 1) * hw]),
                                 to_float<T>(mp[(2 * zo + 2) * hw])));
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int co = ct * CPT + j;
      if (co < Co) {
        const float v = fmaxf(dd[p][j] * __ldg(vec + 2 * Co + co) +
                                  __ldg(vec + 3 * Co + co),
                              0.f) *
                        md;
        o[(static_cast<long long>(h) * W + w) * Co + co] =
            conv_tile::from_float<T>(v);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* mask, const void* ws, const void* wd,
           const void* vec, void* out, int B, int D, int H, int W, int C,
           int Co, int np, void* stream) {
  const int dout = (D - 3) / 2 + 1;
  return conv_tile::by_out_channels<64>(Co, [&](auto ct, auto cpt) {
    constexpr int kCT = decltype(ct)::value;
    constexpr int kCPT = decltype(cpt)::value;
    using G = conv_tile::Tile<3, kCT, kCPT, 4, 4>;
    const dim3 grid((W + G::kTW - 1) / G::kTW, (H + G::kTH - 1) / G::kTH,
                    B * dout);
    const size_t ys_bytes = static_cast<size_t>(Co) * G::kPix * sizeof(float);
    auto go = [&](auto kern, size_t staging) {
      return conv_tile::launch(
          kern, grid, staging + ys_bytes, stream, static_cast<const T*>(x),
          static_cast<const T*>(mask), static_cast<const T*>(ws),
          static_cast<const float*>(wd), static_cast<const float*>(vec),
          static_cast<T*>(out), D, dout, H, W, C, Co);
    };
    if constexpr (std::is_same<T, float>::value) {
      return go(fused_stage_kernel<T, kCT, kCPT, 0>,
                (G::kHalo + G::kW) * sizeof(float));
    } else {
      if (Co > np) return static_cast<int>(cudaErrorInvalidValue);
      return conv_tile::by_packed_width<8>(np, [&](auto nt) {
        constexpr int kNT = decltype(nt)::value;
        return go(fused_stage_kernel<T, kCT, kCPT, kNT>,
                  conv_tile::MmaTile<3, G::kTH, kNT>::kBytes);
      });
    }
  });
}

}  // namespace

// K8.  x: (B, D, H, W, C) and mask: (B, D, H, W) of one type; wd:
// (3, Co, Co) down weights and vec: (4, Co) rows a_s, b_s, a_d, b_d,
// float32; out: (B, (D-3)/2+1, H, W, Co) of the input type.  float32
// (dtype 0): ws is the (3, 3, 3, C, Co) float32 subm weight and the
// CUDA-core subm body runs.  bf16 (dtype 1): ws is the bf16 subm weight
// packed as (ceil(C/16), 27, np, 16) (conv_tile.cuh), np in {24, 32, 64}
// and >= Co, and the tensor-core subm body runs.  All contiguous; D >= 3,
// 1 <= Co <= 64, B * ((D-3)/2+1) <= 65535.  Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int fused_stage(const void* x, const void* mask, const void* ws,
                           const void* wd, const void* vec, void* out, int B,
                           int D, int H, int W, int C, int Co, int np,
                           int dtype, void* stream) {
  if (B <= 0 || D < 3 || H <= 0 || W <= 0 || C <= 0 ||
      B * ((D - 3) / 2 + 1) > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    return launch<float>(x, mask, ws, wd, vec, out, B, D, H, W, C, Co, np,
                         stream);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x, mask, ws, wd, vec, out, B, D, H, W, C,
                                 Co, np, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
