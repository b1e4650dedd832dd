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
// close: a balanced kernel.  Stage 1 (49 slices, 20 -> 32) is bound by its
// operations.
//
// Design, bf16 (the flagship): the 27 taps run straight from shared memory
// as an implicit GEMM on mma.sync m16n8k16 with float32 sums (the TPU
// kernel's im2col scratch exists only to give the MXU one wide
// contraction).  A block owns an 8 x 16 pixel tile (warp w: tile row w,
// one m16 operand) and a run of consecutive output slices [z0, z1), and
// walks the input planes p = z0-1 .. z1 once each:
// - Plane ring (halo_ring.cuh, shared with K8's bf16 body): plane p is
//   read from a ring of 3 halo slots while planes p+1 and p+2 arrive by
//   cp.async (16-byte pieces where C % 8 == 0, 8-byte at C = 20: TMA
//   cannot stride its 40-byte pixels), with one barrier per plane.  The
//   pieces' offsets are the same for every plane, so a table of them is
//   built once per block; the pieces of a k8 chunk's unread half and the
//   planes outside the grid are not loaded.  32-byte rows with the
//   half-swap on bit 2 of the row keep ldmatrix free of bank conflicts
//   without padding.
// - Each A fragment feeds three output slices: plane p is tap kz = 0 of
//   slice p+1, kz = 1 of p and kz = 2 of p-1, so a warp keeps three float32
//   accumulators in registers (rotating with p mod 3) and loads each
//   (plane, chunk, dy, dx) operand once instead of three times.  Slice p-1
//   is finished after plane p.  A plane that feeds three slices of the run
//   takes a path with no branch between its kz products, so the compiler
//   can overlap their operand loads and products.
// - Weights resident: the packed weights (all taps and input channels,
//   41 KB at 20 -> 20 channels, 55 KB at 20 -> 32) are copied into shared
//   memory once per block.
// - Epilogue: a finished slice is rounded to bf16, staged per warp (its 16
//   pixels are contiguous in the output) and stored in 16-byte pieces.
// - Less padding: where the last 16-channel chunk holds at most 8
//   channels (C = 20), its products are mma.sync m16n8k8 on the first
//   16-byte half of its rows, so C = 20 runs 24 channels, not 32; the
//   output channels are padded to np (Co = 20 runs 24).
// Blocks are not persistent: the z runs are cut only where that evens out
// the last wave of blocks (each run reads run + 2 planes).
// float32: the CUDA-core body of conv_tile.cuh (a block per 32 x 16 tile
// of one z slice, 4 channels per chunk, 8 pixels x 5 or 8 channels per
// thread).

#include <climits>
#include <cstdint>

#include "conv_tile.cuh"
#include "halo_ring.cuh"
#include "wgmma.cuh"

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

using conv_tile::bf16;
using halo_ring::kTH;
using halo_ring::kTW;
using halo_ring::kWin;
using halo_ring::kWinW;

constexpr int kRing = 3;                  // staged input planes
constexpr int kMaxSmem = 232448;          // a block's shared memory, bytes

// Byte offsets of a block's shared memory: the weights at 0, then the ring
// of kRing plane slots, the output staging (8 warps x 16 pixels) and the
// halo's cp.async pieces (pb bytes each; none for pb = 0).
struct Layout {
  int ring, slot, stride, stg, desc, total;
};

inline Layout layout(int chunks, int np, int co, int pb) {
  Layout l;
  l.ring = chunks * 27 * np * 32;
  l.slot = chunks * kWin * 32;
  l.stride = halo_ring::staged_stride(co);
  l.stg = l.ring + kRing * l.slot;
  l.desc = l.stg + kTH * kTW * l.stride * 2;
  l.total = l.desc + (pb > 0 ? kWin * chunks * 32 / pb * 8 : 0);
  return l;
}

// NT: n8 fragments of the padded output channels (np = 8 * NT); PB: the
// halo's cp.async piece in bytes, or 0 (halo_ring::load_plane).  Weights
// (ceil(C/16), 27, np, 16) as ops/pallas_conv.py::kernel_weights packs
// them.
template <int NT, int PB>
__global__ void __launch_bounds__(kThreads, NT <= 4 ? 2 : 1)
subm_conv3d_mma_kernel(const bf16* __restrict__ x,
                       const bf16* __restrict__ wpk, bf16* __restrict__ out,
                       int D, int H, int W, int C, int Co, int zpc, int nzc,
                       Layout L) {
  constexpr int kNP = NT * 8;
  extern __shared__ uint4 smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_raw);
  unsigned char* ring = smem + L.ring;
  const int chunks = (C + 15) / 16;
  const int b = blockIdx.z / nzc;
  const int z0 = (blockIdx.z - b * nzc) * zpc;
  const int z1 = min(D, z0 + zpc);
  if (z0 >= z1) return;
  const int h0 = blockIdx.y * kTH;
  const int w0 = blockIdx.x * kTW;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tid = threadIdx.x;
  const long long hw = static_cast<long long>(H) * W;
  const bf16* xb = x + static_cast<long long>(b) * D * hw * C;
  // the last chunk holds at most 8 channels: k8 products on its first
  // half (16-byte halves of the rows) instead of k16 on zeros
  const bool k8_last = C - (chunks - 1) * 16 <= 8;

  halo_ring::load_weights(smem, wpk, chunks, kNP);
  // the halo's cp.async pieces, the same for every plane: (offset in the
  // ring slot, offset in the plane or -1 to zero-fill), for the channels
  // the products read (the first half of a k8 chunk)
  int2* desc = reinterpret_cast<int2*>(smem + L.desc);
  constexpr int kPE = PB > 0 ? PB / 2 : 1;   // channels per piece
  const int keep = (k8_last ? (chunks - 1) * 16 + 8 : chunks * 16) / kPE;
  const int npieces = kWin * keep;
  if constexpr (PB > 0) {
    for (int i = tid; i < npieces; i += kThreads) {
      const int px = i / keep;
      const int c = (i - px * keep) * kPE;
      const int hy = px / kWinW;
      const int h = h0 + hy - 1;
      const int w = w0 + px - hy * kWinW - 1;
      const bool ok = h >= 0 && h < H && w >= 0 && w < W && c < C;
      const int k = c & 15;
      desc[i] = make_int2(((c >> 4) * kWin + px) * 32 +
                              ((((k >> 3) ^ (px >> 2)) & 1) << 4) +
                              (k & 7) * 2,
                          ok ? (h * W + w) * C + c : -1);
    }
    __syncthreads();
  }
  // plane p (z0-1 <= p <= z1) into ring slot (p + 1) % 3; planes outside
  // the grid are zero and never read
  auto load_plane = [&](int p) {
    if (p < 0 || p >= D) return;
    unsigned char* slot = ring + (p + 1) % kRing * L.slot;
    if constexpr (PB > 0) {
      const bf16* xp = xb + static_cast<long long>(p) * hw * C;
      for (int i = tid; i < npieces; i += kThreads) {
        const int2 d = desc[i];
        halo_ring::cp_piece<PB>(slot + d.x, d.y >= 0 ? xp + d.y : xp,
                                d.y >= 0);
      }
    } else {
      halo_ring::load_plane<0>(slot, xb, p, D, H, W, C, chunks, h0, w0);
    }
  };
  load_plane(z0 - 1);
  wgmma::cp_async_commit();
  load_plane(z0);
  wgmma::cp_async_commit();

  const int row = h0 + warp;
  const int pc = lane >> 2;
  // ldmatrix lanes: A pixel am, channel half ah; B row bn, half bh
  const int am = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int ah = lane >> 4;
  const int bn = lane & 7;
  const int bh = (lane >> 3) & 1;
  const unsigned ws0 = conv_tile::smem_addr(smem);
  const unsigned ring0 = conv_tile::smem_addr(ring);
  bf16* sg = reinterpret_cast<bf16*>(smem + L.stg) + warp * kTW * L.stride;

  // acc[(z - z0 + 1) % 3]: the sums of output slice z
  float acc[3][NT][4];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[a][nt][j] = 0.f;
    }
  }

  // the 9 (dy, dx) taps of chunk ch of the staged plane at `plane` into
  // the sums of the output slices `use` marks (kz = 0, 1, 2); R as in
  // step() below; k8: k8 products on the chunk's first 8 channels; all:
  // every slice is used (no branch between the kz products)
  auto taps = [&](auto rc, auto k8, auto all, const bool (&use)[3],
                  unsigned plane, int ch) {
    constexpr int R = decltype(rc)::value;
    constexpr bool kK8 = decltype(k8)::value;
    constexpr bool kAll = decltype(all)::value;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int px = (warp + dy) * kWinW + am + dx;
        unsigned a[4];
        if constexpr (kK8) {
          unsigned a2[2];
          halo_ring::ldsm_x2(a2[0], a2[1],
                             plane + px * 32 + (((px >> 2) & 1) << 4));
          a[0] = a2[0];
          a[1] = a2[1];
        } else {
          halo_ring::ldsm_x4(a,
                             plane + px * 32 + (((ah ^ (px >> 2)) & 1) << 4));
        }
#pragma unroll
        for (int kz = 0; kz < 3; ++kz) {
          if (!kAll && !use[kz]) continue;
          const unsigned wt =
              ws0 + (ch * 27 + kz * 9 + dy * 3 + dx) * kNP * 32;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            // row nt*8 + bn of the tap; its bit 2 is bn's
            if constexpr (kK8) {
              unsigned b0;
              halo_ring::ldsm_x1(
                  b0, wt + (nt * 8 + bn) * 32 + (((bn >> 2) & 1) << 4));
              const unsigned a2[2] = {a[0], a[1]};
              halo_ring::mma_bf16_k8(acc[(R + 4 - kz) % 3][nt], a2, b0);
            } else {
              unsigned b0, b1;
              halo_ring::ldsm_x2(b0, b1,
                                 wt + (nt * 8 + bn) * 32 +
                                     (((bh ^ (bn >> 2)) & 1) << 4));
              conv_tile::mma_bf16(acc[(R + 4 - kz) % 3][nt], a, b0, b1);
            }
          }
        }
      }
    }
  };

  // plane p, with R = (p - z0 + 1) % 3 as a constant: output slice
  // p + 1 - kz sits in acc[(R + 1 - kz) % 3]
  auto step = [&](auto rc, int p) {
    constexpr int R = decltype(rc)::value;
    wgmma::cp_async_wait<1>();            // this thread's plane p landed
    // every thread's plane p has landed, and plane p-1 is done with: its
    // slot takes plane p+2
    __syncthreads();
    if (p + 2 <= z1) load_plane(p + 2);
    wgmma::cp_async_commit();
    if (p >= 0 && p < D) {                // a zero plane adds nothing
      // which of the three output slices fed by plane p are this run's
      const bool use[3] = {p + 1 < z1, p >= z0 && p < z1, p > z0};
      const unsigned slot = ring0 + (p + 1) % kRing * L.slot;
      auto chunk_loop = [&](auto all) {
#pragma unroll 1
        for (int ch = 0; ch < chunks; ++ch) {
          const unsigned plane = slot + ch * kWin * 32;
          if (ch == chunks - 1 && k8_last) {
            taps(rc, std::true_type{}, all, use, plane, ch);
          } else {
            taps(rc, std::false_type{}, all, use, plane, ch);
          }
        }
      };
      if (use[0] && use[1] && use[2]) {
        chunk_loop(std::true_type{});
      } else {
        chunk_loop(std::false_type{});
      }
    }
    if (p > z0) {
      // output slice p - 1 is finished: stage, store, and clear its sums
      // for slice p + 2
      float (&o)[NT][4] = acc[(R + 2) % 3];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = nt * 8 + 2 * (lane & 3);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          bf16* d = sg + (pc + 8 * hh) * L.stride + n;
          if (n < Co) d[0] = __float2bfloat16_rn(o[nt][2 * hh]);
          if (n + 1 < Co) d[1] = __float2bfloat16_rn(o[nt][2 * hh + 1]);
          o[nt][2 * hh] = 0.f;
          o[nt][2 * hh + 1] = 0.f;
        }
      }
      __syncwarp();
      if (row < H) {
        bf16* g = out + ((static_cast<long long>(b) * D + p - 1) * hw +
                         static_cast<long long>(row) * W + w0) *
                            Co;
        halo_ring::store_row(g, sg, min(kTW, W - w0), Co, L.stride, lane);
      }
      __syncwarp();
    }
  };

  using I0 = std::integral_constant<int, 0>;
  using I1 = std::integral_constant<int, 1>;
  using I2 = std::integral_constant<int, 2>;
#pragma unroll 1
  for (int p = z0 - 1;; p += 3) {
    step(I0{}, p);
    if (p + 1 > z1) break;
    step(I1{}, p + 1);
    if (p + 2 > z1) break;
    step(I2{}, p + 2);
    if (p + 3 > z1) break;
  }
  wgmma::cp_async_wait<0>();
}

int launch_mma(const void* x, const void* wpk, void* out, int B, int D,
               int H, int W, int C, int Co, int np, void* stream) {
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const int pb = (C % 8 == 0 && xa % 16 == 0)  ? 16
                 : (C % 4 == 0 && xa % 8 == 0) ? 8
                                               : 0;
  const Layout L = layout((C + 15) / 16, np, Co, pb);
  const long long tiles_h = (H + kTH - 1) / kTH;
  const long long tiles_w = (W + kTW - 1) / kTW;
  if (Co > np || L.total > kMaxSmem || B > 65535 || tiles_h > 65535 ||
      tiles_w > INT_MAX || static_cast<long long>(H) * W * C > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
      // planes a run reads (zpc + 2)
      const long long tiles = tiles_h * tiles_w * B;
      const long long slots = static_cast<long long>(sms) * per_sm;
      long long best = LLONG_MAX;
      int zpc = D;
      for (int nz = 1; nz <= D && nz <= 16; ++nz) {
        const int run = (D + nz - 1) / nz;
        const long long used = (D + run - 1) / run;
        if (B * used > 65535) break;
        const long long cost =
            (tiles * used + slots - 1) / slots * (run + 2);
        if (cost < best) {
          best = cost;
          zpc = run;
        }
      }
      if (best == LLONG_MAX) return static_cast<int>(cudaErrorInvalidValue);
      const int nzc = (D + zpc - 1) / zpc;
      const dim3 grid(static_cast<unsigned>(tiles_w),
                      static_cast<unsigned>(tiles_h), B * nzc);
      kern<<<grid, kThreads, L.total, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const bf16*>(x), static_cast<const bf16*>(wpk),
          static_cast<bf16*>(out), D, H, W, C, Co, zpc, nzc, L);
      return static_cast<int>(cudaGetLastError());
    };
    if (pb == 16) return go(subm_conv3d_mma_kernel<kNT, 16>);
    if (pb == 8) return go(subm_conv3d_mma_kernel<kNT, 8>);
    return go(subm_conv3d_mma_kernel<kNT, 0>);
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
// weight, the CUDA-core body runs, and B * D <= 65535.  bf16 (dtype 1): w
// is the bf16 weight packed as (ceil(C/16), 27, np, 16) (halo_ring.cuh),
// np in {24, 32, 64} and >= Co, the tensor-core body runs, its weights
// must fit in shared memory, B <= 65535 and ceil(H/8) <= 65535.
// 1 <= Co <= 64.  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int subm_conv3d(const void* x, const void* w, void* out, int B,
                           int D, int H, int W, int C, int Co, int np,
                           int dtype, void* stream) {
  if (B <= 0 || D <= 0 || H <= 0 || W <= 0 || C <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    if (static_cast<long long>(B) * D > 65535) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch<float>(x, w, out, B, D, H, W, C, Co, stream);
  }
  if (dtype == 1) {
    return launch_mma(x, w, out, B, D, H, W, C, Co, np, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
