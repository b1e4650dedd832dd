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
// Design (bf16, the flagship): an implicit GEMM on wgmma (wgmma.cuh) in
// persistent, weight-stationary blocks, one per SM.
// - Weights: the output channels are cut into nsl slices of ns <= 80
//   (Co 128 -> 2 x 64; 80 stays whole).  Block b keeps slice b % nsl of
//   the packed weights, all 9 taps and all input channels (at most
//   184 KB), resident in shared memory for its whole life, so weights
//   cross from L2 once per block, not once per tile (restaging them per
//   tile moved about 30 GB per train step).  The blocks of one group (one
//   per slice) walk the same tiles in the same order, so a tile's input
//   is mostly read from device memory once.
// - Tiles: NWG warpgroups (up to 4, as many as shared memory allows) each
//   own 4 rows x 16 columns of output, one m64 operand.  Per tap and
//   16-channel step a warp ldmatrix's its row, shifted by (dy, dx), out
//   of the staged halo into A registers, and the warpgroup issues one
//   wgmma m64n<ns>k16 against the resident slice (B, K-major, 128-byte
//   swizzle).  A tap's A registers load while the previous tap's wgmmas
//   run.
// - Halo: TMA loads each 64-channel chunk of a tile's halo window as one
//   (64, 18, rows + 2, 1) box, zero-filled outside the image and beyond C,
//   into a ring of two stages signalled by mbarriers; the 128-byte swizzle
//   it lands in keeps ldmatrix free of bank conflicts.  (C not a multiple
//   of 8, whose rows TMA cannot address, is staged by the threads in the
//   same layout.)  The next chunk is in flight while one computes.
// - Epilogue: the sums, rounded to bf16, are staged over the consumed
//   halo stage and written in 16-byte stores.
// On this card the body is power-bound as much as anything: at the
// flagship shapes it runs at the 700 W limit with the SM clock near
// 1.7 GHz, and more warps per SM (2 -> 4 warpgroups) gained 10%.
// float32 keeps the CUDA-core body of conv_tile.cuh (8 channels per
// chunk, 8 pixels x 8 (or 5) channels per thread).  The backward's dx is
// this kernel on the cotangent; its dw (9 contractions over the N*H*W
// rows) is left to torch.matmul, as the JAX package leaves it to XLA.

#include <cuda.h>

#include <climits>

#include "conv_tile.cuh"
#include "wgmma.cuh"

namespace {

using conv_tile::bf16;
using conv_tile::kThreads;

// ---- float32: CUDA cores ----------------------------------------------

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

template <typename T>
int launch(const void* x, const void* w, void* out, int N, int H, int W,
           int C, int Co, void* stream) {
  if (N > 65535) return static_cast<int>(cudaErrorInvalidValue);
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

// ---- bf16: wgmma ----------------------------------------------------------

constexpr int kTW = 16;                    // tile columns: one m16 row
constexpr int kWinW = kTW + 2;
constexpr int kCK = 64;                    // channels per halo chunk
constexpr int kRowB = kCK * 2;             // 128 bytes: a pixel's chunk, a
                                           // weight row; one swizzle row
constexpr int kStages = 2;
constexpr int kMaxSmem = 232448;           // a block's shared memory, bytes

// A block of NWG warpgroups (4 tile rows each) and output slice width NS.
template <int NS, int NWG>
struct Tile {
  static constexpr int kThreads = NWG * 128;
  static constexpr int kTH = NWG * 4;      // tile rows
  static constexpr int kWinH = kTH + 2;
  static constexpr int kWin = kWinH * kWinW;  // halo pixels
  static constexpr int kBoxB = kWin * kRowB;  // one halo box, bytes
  static constexpr int kStageB = (kBoxB + 1023) / 1024 * 1024;  // aligned
  static constexpr int kOS = NS + 8;       // staged output pixel, bf16
  // the output tile is staged over a halo stage
  static constexpr bool kOutFits = kTH * kTW * kOS * 2 <= kStageB;
  // the weights, the halo stages (the last chunk's also stages the output
  // tile) and one mbarrier per stage
  static int used(int C) {
    return 9 * ((C + kCK - 1) / kCK) * NS * kRowB + kStages * kStageB +
           kStages * 8;
  }
  // plus up to 1024 bytes of slack to align to the swizzle atom
  static int slack(int C) {
    return kMaxSmem - used(C) < 1024 ? kMaxSmem - used(C) : 1024;
  }
};

// Without TMA (C not a multiple of 8, so rows are not 16-byte aligned):
// stage channels [c0, c0 + kCK) of the halo window at rows h0-1..,
// columns w0-1.. of image `xn` as the TMA box lands, [pixel][128 bytes]
// with the 128-byte swizzle; zero outside the image and beyond C.
template <typename G>
__device__ __forceinline__ void load_halo(unsigned char* stage,
                                          const bf16* __restrict__ xn, int H,
                                          int W, int C, int h0, int w0,
                                          int c0) {
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(xn);
  for (int i = threadIdx.x; i < G::kWin * 8; i += G::kThreads) {
    const int px = i >> 3;
    const int q = i & 7;
    const int hy = px / kWinW;
    const int h = h0 + hy - 1;
    const int w = w0 + px - hy * kWinW - 1;
    const int c = c0 + q * 8;
    union {
      uint4 u;
      unsigned short e[8];
    } v;
    v.u = make_uint4(0, 0, 0, 0);
    if (h >= 0 && h < H && w >= 0 && w < W) {
      const unsigned short* src =
          xs + (static_cast<long long>(h) * W + w) * C + c;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (c + e < C) v.e[e] = src[e];
      }
    }
    *reinterpret_cast<uint4*>(stage + px * kRowB + ((q ^ (px & 7)) << 4)) =
        v.u;
  }
}

// The A operand of one tap, KS k16 steps: lane's pixel p of the staged
// halo (this warp's row shifted by the tap), channel half `half`.
template <int KS>
__device__ __forceinline__ void load_a(unsigned (&a)[KS][4], unsigned stage,
                                       int p, int half) {
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const unsigned addr =
        stage + p * kRowB + (((2 * s + half) ^ (p & 7)) << 4);
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(a[s][0]), "=r"(a[s][1]), "=r"(a[s][2]), "=r"(a[s][3])
        : "r"(addr));
  }
}

// acc += one staged chunk's products (9 taps x KS steps).  `p0` is the
// lane's halo pixel at tap (0, 0); `wchunk` the shared address of the
// chunk's tap-0 weights, taps wtap bytes apart.  A tap's A registers are
// loaded while the previous tap's wgmmas run.
template <int NS, int KS>
__device__ __forceinline__ void mma_chunk(float (&acc)[NS / 2],
                                          unsigned stage, int p0, int half,
                                          unsigned wchunk, int wtap) {
  unsigned a[2][KS][4];
  load_a<KS>(a[0], stage, p0, half);
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    wgmma::fence();
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      wgmma::Wgmma<NS>::mma(acc, a[t & 1][s],
                            wgmma::desc_sw128(wchunk + t * wtap + s * 32));
    }
    wgmma::commit();
    if (t < 8) {
      wgmma::wait<1>();                    // tap t-1's registers are free
      const int dy = (t + 1) / 3;
      const int dx = (t + 1) % 3;
      load_a<KS>(a[(t + 1) & 1], stage, p0 + dy * kWinW + dx, half);
    }
  }
  wgmma::wait<0>();
#pragma unroll
  for (int i = 0; i < NS / 2; ++i) wgmma::fence_operand(acc[i]);
}

// x: (N, H, W, C) bf16, also described by `tmap` when use_tma; wpk: nsl
// slices packed by the wrapper (ops/zfold_conv.py::wgmma_weights) as
// (nsl, 9, ceil(C/64), NS, 64) bf16 with the 128-byte swizzle; out:
// (N, H, W, Co).  gridDim.x = groups * nsl.
template <int NS, int NWG>
__global__ void __launch_bounds__(NWG * 128, 1)
conv2d_3x3_wgmma_kernel(const __grid_constant__ CUtensorMap tmap,
                        const bf16* __restrict__ x,
                        const bf16* __restrict__ wpk, bf16* __restrict__ out,
                        int H, int W, int C, int Co, int nsl, int tiles,
                        int use_tma, int slack) {
  using G = Tile<NS, NWG>;
  static_assert(G::kOutFits, "output tile > halo stage");
  extern __shared__ uint4 smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_raw);
  const int pad = (1024 - (wgmma::smem_u32(smem) & 1023)) & 1023;
  // a block without static shared memory gets its dynamic shared memory
  // 1024-byte aligned on this card (measured), which 4 warpgroups at
  // 64 x 128 channels need, as they leave less than 1024 bytes of slack
  if (pad > slack) __trap();
  smem += pad;
  const int nch = (C + kCK - 1) / kCK;
  const int wtap = nch * NS * kRowB;       // bytes per tap of the slice
  const int wbytes = 9 * wtap;
  unsigned char* ws = smem;
  unsigned char* hs = ws + wbytes;
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(hs + kStages * G::kStageB);

  const int slice = blockIdx.x % nsl;
  const int group = blockIdx.x / nsl;
  const int groups = gridDim.x / nsl;
  const int tiles_w = (W + kTW - 1) / kTW;
  const int tiles_img = ((H + G::kTH - 1) / G::kTH) * tiles_w;
  const int my_tiles = group < tiles ? (tiles - 1 - group) / groups + 1 : 0;
  const int steps = my_tiles * nch;        // (tile, chunk) stages

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) wgmma::mbar_init(full + i, 1);
    wgmma::mbar_init_fence();
  }
  // this block's weight slice, once
  {
    const unsigned char* src = reinterpret_cast<const unsigned char*>(wpk) +
                               static_cast<long long>(slice) * wbytes;
    for (int i = threadIdx.x * 16; i < wbytes; i += G::kThreads * 16) {
      wgmma::cp_async16(ws + i, src + i, 16);
    }
    wgmma::cp_async_commit();
  }
  __syncthreads();
  auto tile_origin = [&](int k, int& n, int& h0, int& w0) {
    const int t = group + (k / nch) * groups;
    n = t / tiles_img;
    const int r = t - n * tiles_img;
    h0 = (r / tiles_w) * G::kTH;
    w0 = (r % tiles_w) * kTW;
  };
  // stage k: one TMA box issued by thread 0, or every thread's share
  auto load_stage = [&](int k) {
    if (k >= steps) return;
    int n, h0, w0;
    tile_origin(k, n, h0, w0);
    unsigned char* dst = hs + (k % kStages) * G::kStageB;
    if (use_tma) {
      if (threadIdx.x == 0) {
        wgmma::mbar_expect_tx(full + k % kStages, G::kBoxB);
        wgmma::tma_load_4d(dst, &tmap, full + k % kStages, (k % nch) * kCK,
                           w0 - 1, h0 - 1, n);
      }
    } else {
      load_halo<G>(dst, x + static_cast<long long>(n) * H * W * C, H, W, C,
                   h0, w0, (k % nch) * kCK);
    }
  };
  load_stage(0);

  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  // ldmatrix.x4: lane l gives pixel (l%8) + 8*((l/8)%2), channels
  // 8*(l/16)..+8 of the k16 step
  const int p0 = (wg * 4 + warp) * kWinW + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int half = lane >> 4;
  const unsigned ws0 = wgmma::smem_u32(ws);
  float acc[NS / 2];

#pragma unroll 1
  for (int k = 0; k < steps; ++k) {
    load_stage(k + 1);
    if (k == 0) {
      wgmma::cp_async_wait<0>();           // the weights
      wgmma::fence_proxy_async();
    }
    if (use_tma) wgmma::mbar_wait(full + k % kStages, (k / kStages) & 1);
    __syncthreads();
    const int ch = k % nch;
    if (ch == 0) {
#pragma unroll
      for (int i = 0; i < NS / 2; ++i) {
        acc[i] = 0.f;
        wgmma::fence_operand(acc[i]);
      }
    }
    const unsigned stage =
        wgmma::smem_u32(hs + (k % kStages) * G::kStageB);
    const unsigned wchunk = ws0 + ch * NS * kRowB;
    const int left = C - ch * kCK;
    if (left > 48) {
      mma_chunk<NS, 4>(acc, stage, p0, half, wchunk, wtap);
    } else if (left > 32) {
      mma_chunk<NS, 3>(acc, stage, p0, half, wchunk, wtap);
    } else if (left > 16) {
      mma_chunk<NS, 2>(acc, stage, p0, half, wchunk, wtap);
    } else {
      mma_chunk<NS, 1>(acc, stage, p0, half, wchunk, wtap);
    }

    if (ch == nch - 1) {
      // round to bf16 into this warpgroup's 64 rows of the output tile,
      // staged over the halo stage once every warp is done with it
      __syncthreads();
      bf16* os = reinterpret_cast<bf16*>(hs + (k % kStages) * G::kStageB);
      const int p = wg * 64 + warp * 16 + (lane >> 2);
#pragma unroll
      for (int j = 0; j < NS / 8; ++j) {
        const int c = 8 * j + 2 * (lane & 3);
        *reinterpret_cast<__nv_bfloat162*>(os + p * G::kOS + c) =
            __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<__nv_bfloat162*>(os + (p + 8) * G::kOS + c) =
            __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      int n, h0, w0;
      tile_origin(k, n, h0, w0);
      bf16* on = out + static_cast<long long>(n) * H * W * Co;
      constexpr int kQ = NS / 8;           // 16-byte pieces per pixel
      for (int i = threadIdx.x & 127; i < 64 * kQ; i += 128) {
        const int pl = wg * 64 + i / kQ;
        const int q = i % kQ;
        const int h = h0 + pl / kTW;
        const int w = w0 + pl % kTW;
        const int co = slice * NS + 8 * q;
        if (h >= H || w >= W || co >= Co) continue;
        const bf16* s = os + pl * G::kOS + 8 * q;
        bf16* d = on + (static_cast<long long>(h) * W + w) * Co + co;
        if ((Co & 7) == 0) {
          *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
        } else {
          for (int e = 0; e < 8 && co + e < Co; ++e) d[e] = s[e];
        }
      }
      // the stage's next writer may be TMA (the async proxy)
      wgmma::fence_proxy_async();
    }
    __syncthreads();                       // stage k may be refilled
  }
  wgmma::cp_async_wait<0>();
}

// cuTensorMapEncodeTiled, from the driver through the runtime, so nothing
// new is linked.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The tensor map of (N, H, W, C) bf16 `x` whose boxes are the halo
// windows (win_h rows) in 64-channel chunks, landing with the 128-byte
// swizzle.
int halo_tensor_map(CUtensorMap* tmap, const void* x, int N, int H, int W,
                    int C, int win_h) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode),
        cudaEnableDefault, &found);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || encode == nullptr) {
      encode = nullptr;
      return static_cast<int>(cudaErrorNotSupported);
    }
  }
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C),
                              static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(C) * 2,
                                 static_cast<cuuint64_t>(W) * C * 2,
                                 static_cast<cuuint64_t>(H) * W * C * 2};
  const cuuint32_t box[4] = {kCK, kWinW, static_cast<cuuint32_t>(win_h), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      tmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Calls f(ns) as an integral constant for a slice width ns in 8..80, a
// multiple of 8; returns cudaErrorInvalidValue for any other ns.
template <typename F>
int by_slice_width(int ns, F&& f) {
  using std::integral_constant;
  switch (ns) {
    case 8: return f(integral_constant<int, 8>{});
    case 16: return f(integral_constant<int, 16>{});
    case 24: return f(integral_constant<int, 24>{});
    case 32: return f(integral_constant<int, 32>{});
    case 40: return f(integral_constant<int, 40>{});
    case 48: return f(integral_constant<int, 48>{});
    case 56: return f(integral_constant<int, 56>{});
    case 64: return f(integral_constant<int, 64>{});
    case 72: return f(integral_constant<int, 72>{});
    case 80: return f(integral_constant<int, 80>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int NS, int NWG>
int launch_tile(const void* x, const void* wpk, void* out, int N, int H,
                int W, int C, int Co, int nsl, void* stream) {
  using G = Tile<NS, NWG>;
  const long long tiles = static_cast<long long>(N) *
                          ((H + G::kTH - 1) / G::kTH) * ((W + kTW - 1) / kTW);
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  // TMA needs 16-byte aligned rows
  const int use_tma = (C & 7) == 0;
  CUtensorMap tmap = {};
  if (use_tma) {
    const int err = halo_tensor_map(&tmap, x, N, H, W, C, G::kWinH);
    if (err != 0) return err;
  }
  auto kern = conv2d_3x3_wgmma_kernel<NS, NWG>;
  const int slack = G::slack(C);
  const size_t smem = G::used(C) + slack;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  int dev = 0;
  int sms = 0;
  int per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        G::kThreads, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  long long groups = static_cast<long long>(sms) * per_sm / nsl;
  groups = groups < 1 ? 1 : (groups > tiles ? tiles : groups);
  kern<<<static_cast<unsigned>(groups * nsl), G::kThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(
      tmap, static_cast<const bf16*>(x), static_cast<const bf16*>(wpk),
      static_cast<bf16*>(out), H, W, C, Co, nsl, static_cast<int>(tiles),
      use_tma, slack);
  return static_cast<int>(cudaGetLastError());
}

int launch_wgmma(const void* x, const void* wpk, void* out, int N, int H,
                 int W, int C, int Co, int ns, void* stream) {
  const int nsl = (Co + ns - 1) / ns;
  return by_slice_width(ns, [&](auto nsc) {
    constexpr int kNS = decltype(nsc)::value;
    // the most warpgroups whose halo stages fit beside the weights
    if constexpr (Tile<kNS, 4>::kOutFits) {
      if (Tile<kNS, 4>::used(C) <= kMaxSmem) {
        return launch_tile<kNS, 4>(x, wpk, out, N, H, W, C, Co, nsl, stream);
      }
    }
    if constexpr (Tile<kNS, 3>::kOutFits) {
      if (Tile<kNS, 3>::used(C) <= kMaxSmem) {
        return launch_tile<kNS, 3>(x, wpk, out, N, H, W, C, Co, nsl, stream);
      }
    }
    return launch_tile<kNS, 2>(x, wpk, out, N, H, W, C, Co, nsl, stream);
  });
}

}  // namespace

// K9.  x: (N, H, W, C); out: (N, H, W, Co), both contiguous, of one
// type; 1 <= C, Co <= 128.  float32 (dtype 0): w is the (3, 3, C, Co)
// float32 weight, the CUDA-core body runs, N <= 65535, and ns is unused.
// bf16 (dtype 1): w is the bf16 weight packed in ceil(Co/ns) slices of
// width ns (8..64, a multiple of 8) by ops/zfold_conv.py::wgmma_weights,
// the wgmma body runs, and N * ceil(H/8) * ceil(W/16) < 2^31.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int conv2d_3x3(const void* x, const void* w, void* out, int N,
                          int H, int W, int C, int Co, int ns, int dtype,
                          void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || C > 128 || Co <= 0 ||
      Co > 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) return launch<float>(x, w, out, N, H, W, C, Co, stream);
  if (dtype == 1) return launch_wgmma(x, w, out, N, H, W, C, Co, ns, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
