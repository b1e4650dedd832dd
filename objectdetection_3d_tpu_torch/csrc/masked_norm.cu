// The vertical encoder's eval-mode stage norm in one pass (kernel K11) for
// Hopper, sm_90a.
//
// Replaces no Pallas kernel.  On the TPU, XLA fuses the chain that follows
// each conv of a stage (mask multiply, masked batch norm, ReLU) into one
// loop; the port ran it eagerly as ~13 ATen passes a stage over the dense
// grid, each reading and writing the whole activation.
//
// Computes, over a channels-last tensor x of P pixels by C channels
// (the NDHWC view of the stage's channels_last_3d activation) with the
// per-pixel 0/1 mask m in x's type and the batch norm's eval affine a, b
// (float32, C each):
//     y[p, c] = round(relu(x[p, c] * a[c] + b[c]) * m[p])
// in float32, rounded once to x's type.  Since m is 0 or 1 this is the
// eval chain relu(((x * m) - mean) * rsqrt(var + eps) * w + bias) * m.
// It is built without fused multiply-add contraction (cuda_lib's
// SOURCE_FLAGS), so it rounds as its plain PyTorch version does, product
// then sum.
//
// Bound on this card: bytes.  x is read once, m once and y written once:
// at stage 0's subm norm of the flagship (100 x 400 x 400 pixels x 20
// bf16 channels, 320 M elements) 1.31 GB, about 0.39 ms at 3.35 TB/s.
// Design:
// - 16-byte loads of x and stores of y (8 bf16 or 4 float32 elements a
//   vector); x through the streaming cache path, since nothing reads it
//   again.
// - A persistent, grid-stride launch: as many 256-thread blocks as fit on
//   the card's SMs at once (the occupancy query), each thread keeping
//   kUnroll vectors in flight before it computes any of them.
// - a and b in shared memory, loaded once per block (C <= 256: every
//   encoder width of the port lies in 8..196).
// - No integer division per element: a thread finds the (pixel, channel)
//   of its first vector once, and steps both by the grid's fixed stride
//   with a compare and a subtract.  C is a multiple of 4 (every encoder
//   width of the port is; others are refused), so a vector's elements
//   fall in runs of 4 that never cross a pixel (a vector starts on a
//   multiple of 4 elements): each run takes one 16-byte read of a and of
//   b and one mask value, and a 20-channel pixel split across vectors
//   costs nothing extra.
// - Out of place: y is a fresh tensor of x's shape.  Writing over x would
//   move the same bytes and would make the custom operator a mutating one,
//   which torch.export rewrites with a copy.
// A ragged tail (P * C not a multiple of the vector) is finished
// element by element by block 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;                 // 16-byte vectors in flight
constexpr int kMaxChannels = 256;          // a and b in shared memory

// 16 bytes of T as float32 values, and back (round to nearest even)
template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int kN = 4;
  __device__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
  __device__ static float load(const float* p) { return __ldg(p); }
  __device__ static void store(float* p, float v) { *p = v; }
};

__device__ __forceinline__ unsigned bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void unpack(const uint4& u, float* f) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      f[2 * j] = __uint_as_float(w[j] << 16);
      f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
  __device__ static uint4 pack(const float* f) {
    unsigned w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      w[j] = bf16_bits(f[2 * j]) | (bf16_bits(f[2 * j + 1]) << 16);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ static float load(const __nv_bfloat16* p) {
    const unsigned short bits =
        __ldg(reinterpret_cast<const unsigned short*>(p));
    return __uint_as_float(static_cast<unsigned>(bits) << 16);
  }
  __device__ static void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

__device__ __forceinline__ float affine_relu(float x, float a, float b,
                                             float m) {
  return fmaxf(x * a + b, 0.0f) * m;
}

// C % 4 == 0, so each aligned run of 4 elements lies in one pixel
template <typename T>
__global__ void __launch_bounds__(kThreads)
masked_affine_relu_kernel(const T* __restrict__ x, const T* __restrict__ m,
                          const float* __restrict__ a,
                          const float* __restrict__ b, T* __restrict__ y,
                          long long n, int c_dim) {
  constexpr int kN = Pack<T>::kN;
  constexpr int kRuns = kN / 4;
  extern __shared__ float4 smem[];
  float* sa = reinterpret_cast<float*>(smem);
  float* sb = sa + c_dim;
  for (int i = threadIdx.x; i < c_dim; i += kThreads) {
    sa[i] = a[i];
    sb[i] = b[i];
  }
  __syncthreads();

  const long long n_vec = n / kN;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long v = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  // (pixel, channel) of vector v's first element, and of one grid stride
  long long p = v * kN / c_dim;
  int c = static_cast<int>(v * kN - p * c_dim);
  const long long step_p = stride * kN / c_dim;
  const int step_c = static_cast<int>(stride * kN - step_p * c_dim);
  const uint4* x4 = reinterpret_cast<const uint4*>(x);
  uint4* y4 = reinterpret_cast<uint4*>(y);

  for (; v < n_vec; v += kUnroll * stride) {
    uint4 xv[kUnroll];
    int cv[kUnroll];
    float mq[kUnroll][kRuns];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      cv[j] = c;
      if (v + j * stride < n_vec) {
        xv[j] = __ldcs(x4 + v + j * stride);
        long long q = p;
        int k = c;
#pragma unroll
        for (int r = 0; r < kRuns; ++r) {
          mq[j][r] = Pack<T>::load(m + q);
          k += 4;
          if (k == c_dim) {
            k = 0;
            ++q;
          }
        }
      }
      p += step_p;
      c += step_c;
      if (c >= c_dim) {
        c -= c_dim;
        ++p;
      }
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      if (v + j * stride >= n_vec) break;
      float f[kN];
      Pack<T>::unpack(xv[j], f);
      int k = cv[j];
#pragma unroll
      for (int r = 0; r < kRuns; ++r) {
        const float4 av = *reinterpret_cast<const float4*>(sa + k);
        const float4 bv = *reinterpret_cast<const float4*>(sb + k);
        const float mv = mq[j][r];
        f[4 * r] = affine_relu(f[4 * r], av.x, bv.x, mv);
        f[4 * r + 1] = affine_relu(f[4 * r + 1], av.y, bv.y, mv);
        f[4 * r + 2] = affine_relu(f[4 * r + 2], av.z, bv.z, mv);
        f[4 * r + 3] = affine_relu(f[4 * r + 3], av.w, bv.w, mv);
        k += 4;
        if (k == c_dim) k = 0;
      }
      y4[v + j * stride] = Pack<T>::pack(f);
    }
  }

  // the ragged tail, fewer than kN elements
  const long long head = n_vec * kN;
  if (blockIdx.x == 0 && threadIdx.x < n - head) {
    const long long e = head + threadIdx.x;
    const long long q = e / c_dim;
    const int k = static_cast<int>(e - q * c_dim);
    Pack<T>::store(y + e, affine_relu(Pack<T>::load(x + e), sa[k], sb[k],
                                      Pack<T>::load(m + q)));
  }
}

template <typename T>
int launch(const void* x, const void* m, const float* a, const float* b,
           void* y, long long n, int c, cudaStream_t stream) {
  auto kernel = masked_affine_relu_kernel<T>;
  const size_t smem = 2 * sizeof(float) * static_cast<size_t>(c);
  // blocks resident at once over the card (per device, per instantiation)
  static int resident[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    // the query at the largest a and b: one answer for every C
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kThreads, 2 * sizeof(float) * kMaxChannels);
    if (err != cudaSuccess) return static_cast<int>(err);
    resident[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  constexpr int kN = Pack<T>::kN;
  const long long vec_blocks = (n / kN + kThreads - 1) / kThreads;
  const long long blocks =
      vec_blocks < 1 ? 1 : (vec_blocks < resident[dev] ? vec_blocks
                                                       : resident[dev]);
  kernel<<<static_cast<int>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(m), a, b,
      static_cast<T*>(y), n, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y = round(relu(x * a + b) * m) over n = P * c elements of channels-last
// x (dtype 0: float32, 1: bf16; x and y 16-byte aligned), m of P elements
// in x's type, a and b float32 (c,), c a multiple of 4 in 4..256.
// Returns the CUDA error of the launch (0 on success).
extern "C" int masked_affine_relu(const void* x, const void* m,
                                  const void* a, const void* b, void* y,
                                  long long n, int c, int dtype,
                                  void* stream) {
  if (n <= 0) return 0;
  if (c <= 0 || c > kMaxChannels || c % 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  if (dtype == 0) return launch<float>(x, m, af, bf, y, n, c, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, m, af, bf, y, n, c, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
