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
// Design (bf16, the flagship): a block owns an 8 x 16 pixel tile and a run
// of consecutive output slices [z0', z1'), and walks the subm slices
// s = 2z0' .. 2z1' in order; each is computed once (slice 2z'+2 is tap 2
// of z' and tap 0 of z'+1), so only the first slice of a run repeats the
// neighbouring run's last.
// - Weights resident: the block copies the packed subm weights (all taps
//   and input channels, at most 111 KB at 32 -> 64 channels) and the bf16
//   down weights into shared memory once, for its whole life.
// - Input planes: a ring of 4 halo windows (10 x 18 pixels, all input
//   channels as 16-channel chunks); slice s reads planes s-1, s, s+1 while
//   plane s+2 arrives by cp.async (16- or 8-byte pieces; TMA cannot take
//   C = 20, whose 40-byte pixels break its 16-byte strides).  A 16-byte
//   half of a pixel's chunk sits at position half ^ bit 2 of the pixel
//   index (the weights' rows likewise), so ldmatrix is free of bank
//   conflicts without padding.  The ring's loads, the resident subm
//   weights and the 16-byte row stores are shared with K10's bf16 body
//   (halo_ring.cuh).
// - Subm conv on the tensor cores: warp w owns tile row w, one m16 operand;
//   per (chunk, tap) one ldmatrix.x4 of A and, per n8 fragment of the
//   output channels, one ldmatrix.x2 of B and one mma.sync m16n8k16.
// - Down conv on the tensor cores: the warp applies mask, affine and ReLU
//   to its float32 sums, rounds them to bf16 and packs them straight into
//   A fragments (an m16n8 accumulator pair is an m16k16 operand), then adds
//   y[s] @ wd[t] to one float32 output accumulator in registers: tap 2 of
//   z' = s/2 - 1 (finishing it) and tap 0 of z' = s/2 for even s, tap 1
//   for odd s.  The products of bf16 values are exact, so the result
//   differs from the plain version only in the order of the float32 sums.
// - Mask: read once per pixel and slice, a slice ahead, into registers,
//   where the pooled mask is kept as a running max.
// - Epilogue: each finished output slice is rounded to bf16, staged per
//   warp (in the ring slot just freed, or beside the ring when it does not
//   fit) and written in 16-byte pieces: a warp's 16 pixels are contiguous.
// Blocks are not persistent: a block's one copy of its weights is small
// beside its walk over D'.  The z runs are cut only where that evens
// out the last wave of blocks.
// float32 keeps the CUDA-core body of conv_tile.cuh (one output slice per
// block, the subm slice 2z'+2 computed again by the block of z'+1, the
// down conv in FFMA).

#include <climits>
#include <cstdint>

#include "conv_tile.cuh"
#include "halo_ring.cuh"
#include "wgmma.cuh"

namespace {

using conv_tile::bf16;
using conv_tile::kThreads;
using halo_ring::cp_piece;
using halo_ring::kTH;
using halo_ring::kTW;
using halo_ring::kWin;
using halo_ring::kWinW;
using halo_ring::ldsm_x2;
using halo_ring::ldsm_x4;

// ---- float32: CUDA cores ------------------------------------------------

template <int CT, int CPT>
__global__ void __launch_bounds__(kThreads, 2)
fused_stage_f32_kernel(const float* __restrict__ x,
                       const float* __restrict__ mask,
                       const float* __restrict__ ws_g,
                       const float* __restrict__ wd,
                       const float* __restrict__ vec, float* __restrict__ out,
                       int D, int Dout, int H, int W, int C, int Co) {
  using G = conv_tile::Tile<3, CT, CPT, 4, 4>;
  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);
  // one subm slice of the tile as float [c][pixel], after the staging
  float* ys = hs + G::kHalo + G::kW;
  const int plane = blockIdx.z;
  const int b = plane / Dout;
  const int zo = plane - b * Dout;
  const int h0 = blockIdx.y * G::kTH;
  const int w0 = blockIdx.x * G::kTW;
  int row, col, ct;
  conv_tile::thread_place<G>(row, col, ct);
  const long long hw = static_cast<long long>(H) * W;
  const long long psz = hw * C;
  const float* mplane = mask + static_cast<long long>(b) * D * hw;

  float dd[G::kPX][CPT];
#pragma unroll
  for (int p = 0; p < G::kPX; ++p) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) dd[p][j] = 0.f;
  }

#pragma unroll 1
  for (int t = 0; t < 3; ++t) {
    const int z = 2 * zo + t;
    const float* planes[3];
#pragma unroll
    for (int kz = 0; kz < 3; ++kz) {
      const int zz = z + kz - 1;
      planes[kz] = (zz >= 0 && zz < D)
                       ? x + (static_cast<long long>(b) * D + zz) * psz
                       : nullptr;
    }
    // the barriers inside the conv separate these ys writes from the
    // previous slice's reads
    float acc[G::kPX][CPT];
    conv_tile::conv_tile<G>(hs, hs + G::kHalo, planes, ws_g, H, W, C, Co, h0,
                            w0, acc);
    const int h = h0 + row;
#pragma unroll
    for (int p = 0; p < G::kPX; ++p) {
      const int w = w0 + col + p;
      const float m = (h < H && w < W)
                          ? mplane[z * hw + static_cast<long long>(h) * W + w]
                          : 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int n = ct * CPT + j;
        if (n < Co) {
          ys[n * G::kPix + row * G::kTW + col + p] =
              fmaxf(acc[p][j] * __ldg(vec + n) + __ldg(vec + Co + n), 0.f) *
              m;
        }
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
  float* o = out + (static_cast<long long>(b) * Dout + zo) * hw * Co;
#pragma unroll
  for (int p = 0; p < G::kPX; ++p) {
    const int w = w0 + col + p;
    if (w >= W) continue;
    const float* mp = mplane + static_cast<long long>(h) * W + w;
    const float md = fmaxf(mp[2 * zo * hw],
                           fmaxf(mp[(2 * zo + 1) * hw], mp[(2 * zo + 2) * hw]));
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int co = ct * CPT + j;
      if (co < Co) {
        o[(static_cast<long long>(h) * W + w) * Co + co] =
            fmaxf(dd[p][j] * __ldg(vec + 2 * Co + co) +
                      __ldg(vec + 3 * Co + co),
                  0.f) *
            md;
      }
    }
  }
}

int launch_f32(const void* x, const void* mask, const void* ws,
               const void* wd, const void* vec, void* out, int B, int D,
               int H, int W, int C, int Co, void* stream) {
  const int dout = (D - 3) / 2 + 1;
  if (static_cast<long long>(B) * dout > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return conv_tile::by_out_channels<64>(Co, [&](auto ct, auto cpt) {
    constexpr int kCT = decltype(ct)::value;
    constexpr int kCPT = decltype(cpt)::value;
    using G = conv_tile::Tile<3, kCT, kCPT, 4, 4>;
    const dim3 grid((W + G::kTW - 1) / G::kTW, (H + G::kTH - 1) / G::kTH,
                    B * dout);
    const size_t smem =
        (G::kHalo + G::kW) * sizeof(float) + Co * G::kPix * sizeof(float);
    return conv_tile::launch(
        fused_stage_f32_kernel<kCT, kCPT>, grid, smem, stream,
        static_cast<const float*>(x), static_cast<const float*>(mask),
        static_cast<const float*>(ws), static_cast<const float*>(wd),
        static_cast<const float*>(vec), static_cast<float*>(out), D, dout, H,
        W, C, Co);
  });
}

// ---- bf16: tensor cores, z walked inside the block ------------------------

constexpr int kRing = 4;                  // staged input planes
constexpr int kVec = 4 * 64;              // staged affines, float
constexpr int kMaxSmem = 232448;          // a block's shared memory, bytes

// Byte offsets of a block's shared memory: the subm weights at 0, then
// the down weights, the affines, the ring of kRing plane slots and, when
// it does not fit in a slot, the output staging.
struct Layout {
  int wd, vec, ring, slot, stride, stg, total;
};

__host__ __device__ inline Layout layout(int chunks, int np, int co) {
  Layout l;
  const int kd = (np + 15) / 16 * 16;
  l.wd = chunks * 27 * np * 32;
  l.vec = l.wd + 3 * np * (kd + 8) * 2;
  l.ring = l.vec + kVec * 4;
  l.slot = chunks * kWin * 32;
  l.stride = halo_ring::staged_stride(co);
  l.total = l.ring + kRing * l.slot;
  const int stg = kTH * kTW * l.stride * 2;
  l.stg = -1;                             // staged in the freed ring slot
  if (stg > l.slot) {
    l.stg = l.total;
    l.total += stg;
  }
  return l;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// NT: n8 fragments of the padded output channels (np = 8 * NT); PB: the
// halo's cp.async piece in bytes (16: C % 8 == 0, 8: C % 4 == 0), or 0 for
// synchronous 2-byte loads.  Subm weights (ceil(C/16), 27, np, 16), down
// weights (3, np, kd) as ops/fused_stage.py::down_weights packs them.
template <int NT, int PB>
__global__ void __launch_bounds__(kThreads, NT <= 4 ? 2 : 1)
fused_stage_mma_kernel(const bf16* __restrict__ x,
                       const bf16* __restrict__ mask,
                       const bf16* __restrict__ wsub,
                       const bf16* __restrict__ wdn,
                       const float* __restrict__ vec, bf16* __restrict__ out,
                       int D, int Dout, int H, int W, int C, int Co, int zpc,
                       int nzc, Layout L) {
  constexpr int kNP = NT * 8;
  constexpr int kKD = (NT + 1) / 2;       // k16 steps of the down conv
  constexpr int kKRow = kKD * 16 + 8;     // staged down-weight row, bf16
  extern __shared__ uint4 smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_raw);
  unsigned char* ring = smem + L.ring;
  float* vs = reinterpret_cast<float*>(smem + L.vec);
  const int chunks = (C + 15) / 16;
  const int b = blockIdx.z / nzc;
  const int zo0 = (blockIdx.z - b * nzc) * zpc;
  const int zo1 = min(Dout, zo0 + zpc);
  if (zo0 >= zo1) return;
  const int s0 = 2 * zo0;                 // subm slices s0 .. s1
  const int s1 = 2 * zo1;
  const int h0 = blockIdx.y * kTH;
  const int w0 = blockIdx.x * kTW;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long hw = static_cast<long long>(H) * W;
  const bf16* xb = x + static_cast<long long>(b) * D * hw * C;

  // resident weights: subm rows of 32 bytes (halo_ring.cuh); down rows
  // padded to kKRow
  halo_ring::load_weights(smem, wsub, chunks, kNP);
  for (int i = tid; i < 3 * kNP * kKD * 2; i += kThreads) {
    const int r = i / (kKD * 2);
    const int q = i - r * kKD * 2;
    cp_piece<16>(smem + L.wd + (r * kKRow + q * 8) * 2,
                 wdn + static_cast<long long>(i) * 8, true);
  }
  for (int i = tid; i < kVec; i += kThreads) {
    const int n = i & 63;
    vs[i] = n < Co ? vec[(i >> 6) * Co + n] : 0.f;
  }

  // plane z into its ring slot
  auto load_plane = [&](int z) {
    halo_ring::load_plane<PB>(ring + ((z + 4) & 3) * L.slot, xb, z, D, H, W,
                              C, chunks, h0, w0);
  };
  load_plane(s0 - 1);
  load_plane(s0);
  load_plane(s0 + 1);
  wgmma::cp_async_commit();

  // this thread's tile row, pixel columns pc and pc + 8, and mask there
  const int row = h0 + warp;
  const int pc = lane >> 2;
  const bf16* mrow = mask + static_cast<long long>(b) * D * hw +
                     static_cast<long long>(min(row, H - 1)) * W + w0;
  auto mask_at = [&](int z, int c) {
    return (row < H && w0 + c < W) ? __bfloat162float(mrow[z * hw + c])
                                   : 0.f;
  };
  // ldmatrix lanes: A pixel am, channel half ah; B row bn, half bh
  const int am = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int ah = lane >> 4;
  const int bn = lane & 7;
  const int bh = (lane >> 3) & 1;
  const unsigned ws0 = conv_tile::smem_addr(smem);
  const unsigned wd0 = conv_tile::smem_addr(smem + L.wd);
  const unsigned ring0 = conv_tile::smem_addr(ring);

  float o[NT][4];                         // the output slice's sums
  unsigned yp[NT][2];                     // y[s] as bf16 pairs
  float md[2] = {0.f, 0.f};               // pooled mask
  float mnext[2] = {mask_at(s0, pc), mask_at(s0, pc + 8)};

  // o += y[s] @ wd[t]: the k16 step kc of A is y's fragments 2kc, 2kc+1
  auto down = [&](int t) {
#pragma unroll
    for (int kc = 0; kc < kKD; ++kc) {
      const int hi = min(2 * kc + 1, NT - 1);
      const bool has_hi = 2 * kc + 1 < NT;
      const unsigned a[4] = {yp[2 * kc][0], yp[2 * kc][1],
                             has_hi ? yp[hi][0] : 0u,
                             has_hi ? yp[hi][1] : 0u};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        unsigned b0, b1;
        ldsm_x2(b0, b1,
                wd0 + ((t * kNP + nt * 8 + bn) * kKRow + kc * 16 + bh * 8) *
                          2);
        conv_tile::mma_bf16(o[nt], a, b0, b1);
      }
    }
  };

#pragma unroll 1
  for (int s = s0; s <= s1; ++s) {
    __syncthreads();                      // the slot of plane s-2 is free
    if (s + 2 <= s1 + 1) load_plane(s + 2);
    wgmma::cp_async_commit();
    wgmma::cp_async_wait<1>();            // planes up to s+1 have landed
    __syncthreads();
    const float m[2] = {mnext[0], mnext[1]};
    if (s < s1) {
      mnext[0] = mask_at(s + 1, pc);
      mnext[1] = mask_at(s + 1, pc + 8);
    }

    // subm slice s of this warp's row
    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[nt][j] = 0.f;
    }
#pragma unroll 1
    for (int ch = 0; ch < chunks; ++ch) {
#pragma unroll 1
      for (int kz = 0; kz < 3; ++kz) {
        const unsigned plane =
            ring0 + ((s + 3 + kz) & 3) * L.slot + ch * kWin * 32;
        const unsigned wt = ws0 + (ch * 27 + kz * 9) * kNP * 32;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const int px = (warp + dy) * kWinW + am + dx;
            unsigned a[4];
            ldsm_x4(a, plane + px * 32 + (((ah ^ (px >> 2)) & 1) << 4));
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              // row (tap, nt*8 + bn); its bit 2 is bn's
              const int r = (dy * 3 + dx) * kNP + nt * 8 + bn;
              unsigned b0, b1;
              ldsm_x2(b0, b1, wt + r * 32 + (((bh ^ (bn >> 2)) & 1) << 4));
              conv_tile::mma_bf16(acc[nt], a, b0, b1);
            }
          }
        }
      }
    }

    // y = round(relu(acc * a_s + b_s) * mask), packed as A fragments
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = nt * 8 + 2 * (lane & 3);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        yp[nt][hh] = pack_bf16(
            fmaxf(acc[nt][2 * hh] * vs[n] + vs[64 + n], 0.f) * m[hh],
            fmaxf(acc[nt][2 * hh + 1] * vs[n + 1] + vs[65 + n], 0.f) * m[hh]);
      }
    }

    if (s & 1) {
      down(1);
      md[0] = fmaxf(md[0], m[0]);
      md[1] = fmaxf(md[1], m[1]);
      continue;
    }
    if (s > s0) {
      // tap 2 finishes output slice s/2 - 1
      down(2);
      md[0] = fmaxf(md[0], m[0]);
      md[1] = fmaxf(md[1], m[1]);
      __syncthreads();                    // every warp is done with the ring
      bf16* sg = reinterpret_cast<bf16*>(
          (L.stg < 0 ? ring + ((s + 3) & 3) * L.slot : smem + L.stg) +
          warp * kTW * L.stride * 2);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = nt * 8 + 2 * (lane & 3);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          bf16* d = sg + (pc + 8 * hh) * L.stride + n;
          if (n < Co) {
            d[0] = __float2bfloat16_rn(
                fmaxf(o[nt][2 * hh] * vs[128 + n] + vs[192 + n], 0.f) *
                md[hh]);
          }
          if (n + 1 < Co) {
            d[1] = __float2bfloat16_rn(
                fmaxf(o[nt][2 * hh + 1] * vs[129 + n] + vs[193 + n], 0.f) *
                md[hh]);
          }
        }
      }
      __syncwarp();
      if (row < H) {
        const int npx = min(kTW, W - w0);
        bf16* g = out + ((static_cast<long long>(b) * Dout + s / 2 - 1) * hw +
                         static_cast<long long>(row) * W + w0) *
                            Co;
        halo_ring::store_row(g, sg, npx, Co, L.stride, lane);
      }
    }
    if (s < s1) {
      // tap 0 starts output slice s/2
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int j = 0; j < 4; ++j) o[nt][j] = 0.f;
      }
      down(0);
      md[0] = m[0];
      md[1] = m[1];
    }
  }
  wgmma::cp_async_wait<0>();
}

int launch_mma(const void* x, const void* mask, const void* ws,
               const void* wd, const void* vec, void* out, int B, int D,
               int H, int W, int C, int Co, int np, void* stream) {
  const int dout = (D - 3) / 2 + 1;
  const Layout L = layout((C + 15) / 16, np, Co);
  const long long tiles_h = (H + kTH - 1) / kTH;
  const long long tiles_w = (W + kTW - 1) / kTW;
  if (Co > np || L.total > kMaxSmem || tiles_h > 65535 ||
      tiles_w > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const int pb = (C % 8 == 0 && xa % 16 == 0)  ? 16
                 : (C % 4 == 0 && xa % 8 == 0) ? 8
                                               : 0;
  return conv_tile::by_packed_width<8>(np, [&](auto nt) {
    constexpr int kNT = decltype(nt)::value;
    auto go = [&](auto kern) {
      cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
      int dev = 0;
      int sms = 0;
      int per_sm = 0;
      if (err == cudaSuccess) err = cudaGetDevice(&dev);
      if (err == cudaSuccess) {
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
      }
      if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                            kThreads, L.total);
      }
      if (err != cudaSuccess) return static_cast<int>(err);
      if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
      // z runs of zpc output slices: the fewest waves of blocks times the
      // subm slices a run computes (2 zpc + 1)
      const long long tiles = tiles_h * tiles_w * B;
      const long long slots = static_cast<long long>(sms) * per_sm;
      long long best = LLONG_MAX;
      int zpc = dout;
      for (int nz = 1; nz <= dout && nz <= 16; ++nz) {
        const int run = (dout + nz - 1) / nz;
        const long long used = (dout + run - 1) / run;
        if (B * used > 65535) break;
        const long long cost = (tiles * used + slots - 1) / slots *
                               (2 * run + 1);
        if (cost < best) {
          best = cost;
          zpc = run;
        }
      }
      if (best == LLONG_MAX) return static_cast<int>(cudaErrorInvalidValue);
      const int nzc = (dout + zpc - 1) / zpc;
      const dim3 grid(static_cast<unsigned>(tiles_w),
                      static_cast<unsigned>(tiles_h), B * nzc);
      kern<<<grid, kThreads, L.total, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const bf16*>(x), static_cast<const bf16*>(mask),
          static_cast<const bf16*>(ws), static_cast<const bf16*>(wd),
          static_cast<const float*>(vec), static_cast<bf16*>(out), D, dout,
          H, W, C, Co, zpc, nzc, L);
      return static_cast<int>(cudaGetLastError());
    };
    if (pb == 16) return go(fused_stage_mma_kernel<kNT, 16>);
    if (pb == 8) return go(fused_stage_mma_kernel<kNT, 8>);
    return go(fused_stage_mma_kernel<kNT, 0>);
  });
}

}  // namespace

// K8.  x: (B, D, H, W, C) and mask: (B, D, H, W) of one type; vec: (4, Co)
// rows a_s, b_s, a_d, b_d, float32; out: (B, (D-3)/2+1, H, W, Co) of the
// input type.  float32 (dtype 0): ws is the (3, 3, 3, C, Co) subm weight
// and wd the (3, Co, Co) down weight, both float32, the CUDA-core body
// runs, and B * ((D-3)/2+1) <= 65535.  bf16 (dtype 1): ws is the subm
// weight packed as (ceil(C/16), 27, np, 16) (conv_tile.cuh) and wd the down
// weight packed as (3, np, 16 * ceil(np/16)) by
// ops/fused_stage.py::down_weights, np in {24, 32, 64} and >= Co; the
// tensor-core body runs, its weights must fit in shared memory (C <= 32 at
// np 64), B <= 65535 and ceil(H/8) <= 65535.  All contiguous; D >= 3,
// 1 <= Co <= 64.  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int fused_stage(const void* x, const void* mask, const void* ws,
                           const void* wd, const void* vec, void* out, int B,
                           int D, int H, int W, int C, int Co, int np,
                           int dtype, void* stream) {
  if (B <= 0 || D < 3 || H <= 0 || W <= 0 || C <= 0 || Co <= 0 || Co > 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    return launch_f32(x, mask, ws, wd, vec, out, B, D, H, W, C, Co, stream);
  }
  if (dtype == 1) {
    return launch_mma(x, mask, ws, wd, vec, out, B, D, H, W, C, Co, np,
                      stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
