// Exact rotated-3D intersection of box pairs (kernels K5, K6 and K7) for
// Hopper, sm_90a.
//
// Replaces: objectdetection_3d_tpu/ops/pallas_iou3d.py
//   * intersection_volume_aligned_pallas (`_kernel`: intersection volumes
//     of aligned pairs (boxes1[p], boxes2[p]), no gather),
//   * iou_gathered_pallas      (`_gathered_kernel`: IoU of (table[ids[p]],
//     boxes2[p]) with the table row gathered in the kernel), and
//   * iou_gathered_pair_pallas (`_gathered_pair_kernel`: the same for two
//     id streams against one box stream, in one pass).
// All run `_clip_volumes_blocks`: every one of the 12 faces of a pair (6 of
// box 1 clipped by box 2's half-spaces, 6 of box 2 clipped by box 1's) is
// clipped by Sutherland-Hodgman, and the intersection volume follows from
// the divergence theorem over the clipped polygons.
//
// Bound on this card: operations.  A pair costs some 10^5 float operations
// (12 polygons x 6 planes x the ring compaction below) against 40 bytes of
// traffic, far above the card's 20 flops per byte for float32.
//
// Design: one thread per pair (K7: one thread per anchor, clipping both of
// its GTs in turn).  The (G, 10) table -- 9 box fields and a validity flag
// per row -- sits in shared memory, and the gather is a plain load from it
// (the TPU kernel's one-hot matrix product exists only because the TPU has
// no cheap gather).  Each polygon's ring lives in registers: every loop is
// unrolled, so ring slots have compile-time indices.  The ring schedule is
// the TPU body's: kSlots[p] slots enter plane p and kCaps[p] leave it; each
// slot's kept vertex, then its edge's crossing point, is placed at its
// running position, and the count is min(run, cap).  The arithmetic is the
// body's operation for operation (the build passes -fmad=false), so the
// kernel agrees with its plain PyTorch version (ops/iou3d.py) up to the
// last bits of sinf/cosf.
//
// The clipper is the one __device__ function `pair_volume`; K5 is its
// entry without a gather or an IoU.

#include <cuda_runtime.h>

namespace {

constexpr float kEps = 1e-6f;
constexpr float kShrink = 1e-5f;
constexpr float kUnionEps = 1e-6f;
constexpr int kThreads = 128;

struct Frame {
  float f[9];     // x, y, z (bottom center), dx, dy, dz, rx, ry, rz
  float r[3][3];  // Rz @ Ry @ Rx
};

__device__ __forceinline__ void load_frame(const float* b, Frame& fr) {
#pragma unroll
  for (int k = 0; k < 9; ++k) fr.f[k] = b[k];
  const float cx = cosf(fr.f[6]), sx = sinf(fr.f[6]);
  const float cy = cosf(fr.f[7]), sy = sinf(fr.f[7]);
  const float cz = cosf(fr.f[8]), sz = sinf(fr.f[8]);
  fr.r[0][0] = cz * cy;
  fr.r[0][1] = cz * sy * sx - sz * cx;
  fr.r[0][2] = cz * sy * cx + sz * sx;
  fr.r[1][0] = sz * cy;
  fr.r[1][1] = sz * sy * sx + cz * cx;
  fr.r[1][2] = sz * sy * cx - cz * sx;
  fr.r[2][0] = -sy;
  fr.r[2][1] = cy * sx;
  fr.r[2][2] = cy * cx;
}

// corner k of the bottom-anchored box: p0..p3 at the bottom
// (-,-) (+,-) (+,+) (-,+), p4..p7 the same xy at the top
__device__ __forceinline__ void corner(const Frame& b, int k, float& x,
                                       float& y, float& z) {
  const float sgx = (k == 1 || k == 2 || k == 5 || k == 6) ? 1.f : -1.f;
  const float sgy = (k == 2 || k == 3 || k == 6 || k == 7) ? 1.f : -1.f;
  const float sgz = k >= 4 ? 1.f : 0.f;
  const float lx = sgx * b.f[3] / 2.f;
  const float ly = sgy * b.f[4] / 2.f;
  const float lz = sgz * b.f[5];
  x = b.f[0] + b.r[0][0] * lx + b.r[0][1] * ly + b.r[0][2] * lz;
  y = b.f[1] + b.r[1][0] * lx + b.r[1][1] * ly + b.r[1][2] * lz;
  z = b.f[2] + b.r[2][0] * lx + b.r[2][1] * ly + b.r[2][2] * lz;
}

// corner index i (0..3) of face f, outward winding
// (0,3,2,1) (4,5,6,7) (0,1,5,4) (2,3,7,6) (0,4,7,3) (1,2,6,5), packed 4
// bits per corner, the face's first corner in the low bits
__device__ __forceinline__ int face_corner(int f, int i) {
  const unsigned pack = f == 0   ? 0x1230u
                        : f == 1 ? 0x7654u
                        : f == 2 ? 0x4510u
                        : f == 3 ? 0x6732u
                        : f == 4 ? 0x3740u
                                 : 0x5621u;
  return static_cast<int>((pack >> (4 * i)) & 0xFu);
}

// the 6 outward half-spaces n . p <= off (+x, -x, +y, -y, +z, -z), each
// offset moved by `shift`
__device__ __forceinline__ void planes(const Frame& b, float shift,
                                       float (&n)[6][4]) {
  const float cxm = b.f[0] + b.r[0][2] * b.f[5] / 2.f;
  const float cym = b.f[1] + b.r[1][2] * b.f[5] / 2.f;
  const float czm = b.f[2] + b.r[2][2] * b.f[5] / 2.f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float half = b.f[3 + a] / 2.f;
    const float nx = b.r[0][a], ny = b.r[1][a], nz = b.r[2][a];
    const float base = nx * cxm + ny * cym + nz * czm;
    n[2 * a][0] = nx;
    n[2 * a][1] = ny;
    n[2 * a][2] = nz;
    n[2 * a][3] = (base + half) + shift;
    n[2 * a + 1][0] = -nx;
    n[2 * a + 1][1] = -ny;
    n[2 * a + 1][2] = -nz;
    n[2 * a + 1][3] = -(base - half) + shift;
  }
}

// place candidate (x, y, z) at ring slot `run` when `ok`
template <int kCap>
__device__ __forceinline__ void place(float (&ox)[12], float (&oy)[12],
                                      float (&oz)[12], bool ok, int run,
                                      float x, float y, float z) {
#pragma unroll
  for (int j = 0; j < kCap; ++j) {
    if (ok && run == j) {
      ox[j] = x;
      oy[j] = y;
      oz[j] = z;
    }
  }
}

// one Sutherland-Hodgman pass of plane P over the ring
template <int P>
__device__ __forceinline__ void clip_plane(float (&vx)[12], float (&vy)[12],
                                           float (&vz)[12], int& cnt,
                                           const float (&pl)[4]) {
  constexpr int kSlots = P == 0 ? 4 : 6 + P;  // 4, 7, 8, 9, 10, 11
  constexpr int kCap = 7 + P;                 // 7, 8, 9, 10, 11, 12
  float s[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    s[i] = pl[0] * vx[i] + pl[1] * vy[i] + pl[2] * vz[i] - pl[3];
  }
  float ox[12], oy[12], oz[12];
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    ox[j] = 0.f;
    oy[j] = 0.f;
    oz[j] = 0.f;
  }
  int run = 0;
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    constexpr int kLast = kSlots - 1;
    const int nxt = i == kLast ? 0 : i + 1;
    const bool wrap = cnt == i + 1;
    const float sn = wrap ? s[0] : s[nxt];
    const float xn = wrap ? vx[0] : vx[nxt];
    const float yn = wrap ? vy[0] : vy[nxt];
    const float zn = wrap ? vz[0] : vz[nxt];
    float denom = s[i] - sn;
    denom = fabsf(denom) > kEps ? denom : kEps;
    const float tt = fminf(fmaxf(s[i] / denom, 0.f), 1.f);
    const bool edge_valid = i < cnt;
    const bool inside = s[i] <= kEps;
    const bool keep = edge_valid && inside;
    place<kCap>(ox, oy, oz, keep, run, vx[i], vy[i], vz[i]);
    run += keep ? 1 : 0;
    const bool cross = edge_valid && (inside != (sn <= kEps));
    place<kCap>(ox, oy, oz, cross, run, vx[i] + tt * (xn - vx[i]),
                vy[i] + tt * (yn - vy[i]), vz[i] + tt * (zn - vz[i]));
    run += cross ? 1 : 0;
  }
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    vx[j] = ox[j];
    vy[j] = oy[j];
    vz[j] = oz[j];
  }
  cnt = min(run, kCap);
}

// adds, in order, the fan volumes of box a's 6 faces clipped by `pl`
__device__ void add_face_volumes(const Frame& a, const float (&pl)[6][4],
                                 float& vol) {
  float cx[8], cy[8], cz[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) corner(a, k, cx[k], cy[k], cz[k]);
#pragma unroll 1
  for (int f = 0; f < 6; ++f) {
    // f is a loop variable: select the face's corners by predicated
    // copies, so that every ring index stays a compile-time constant and
    // the ring stays in registers
    float vx[12], vy[12], vz[12];
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      vx[j] = 0.f;
      vy[j] = 0.f;
      vz[j] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = face_corner(f, i);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (c == k) {
          vx[i] = cx[k];
          vy[i] = cy[k];
          vz[i] = cz[k];
        }
      }
    }
    int cnt = 4;
    clip_plane<0>(vx, vy, vz, cnt, pl[0]);
    clip_plane<1>(vx, vy, vz, cnt, pl[1]);
    clip_plane<2>(vx, vy, vz, cnt, pl[2]);
    clip_plane<3>(vx, vy, vz, cnt, pl[3]);
    clip_plane<4>(vx, vy, vz, cnt, pl[4]);
    clip_plane<5>(vx, vy, vz, cnt, pl[5]);
    float total = 0.f;
#pragma unroll
    for (int i = 1; i < 11; ++i) {
      const float crx = vy[i] * vz[i + 1] - vz[i] * vy[i + 1];
      const float cry = vz[i] * vx[i + 1] - vx[i] * vz[i + 1];
      const float crz = vx[i] * vy[i + 1] - vy[i] * vx[i + 1];
      const float contrib = vx[0] * crx + vy[0] * cry + vz[0] * crz;
      total = total + (i + 1 < cnt ? contrib : 0.f) / 6.f;
    }
    vol = vol + total;
  }
}

// intersection volume of boxes b1 and b2: the 12 polygons' volumes summed
// in the order of the TPU body's rows (box 1's faces, then box 2's)
__device__ float pair_volume(const Frame& b1, const Frame& b2) {
  float pl[6][4];
  float vol = 0.f;
  planes(b2, -kShrink, pl);
  add_face_volumes(b1, pl, vol);
  planes(b1, kShrink, pl);
  add_face_volumes(b2, pl, vol);
  return vol;
}

__device__ __forceinline__ float gathered_iou(const float* row,
                                              const Frame& b2,
                                              float vol2) {
  Frame b1;
  load_frame(row, b1);
  float inter = fmaxf(pair_volume(b1, b2), 0.f);
  const float vol1 = b1.f[3] * b1.f[4] * b1.f[5];
  const float uni = vol1 + vol2 - inter;
  const float iou = uni > kUnionEps ? inter / fmaxf(uni, kUnionEps) : 0.f;
  return iou * row[9];
}

__device__ __forceinline__ void load_table(const float* table, int g,
                                           float* tab) {
  for (int k = threadIdx.x; k < g * 10; k += blockDim.x) tab[k] = table[k];
  __syncthreads();
}

// table: (g, 10) rows of 9 box fields + validity; ids: (p,) and, for the
// pair kernel, a second (p,) stream; boxes2: (p, 9); out: (nstreams, p)
template <int kStreams>
__global__ void __launch_bounds__(kThreads)
iou_gathered_kernel(const float* __restrict__ table, int g,
                    const int* __restrict__ ids_a,
                    const int* __restrict__ ids_b,
                    const float* __restrict__ boxes2,
                    float* __restrict__ out, long long p) {
  extern __shared__ float tab[];
  load_table(table, g, tab);
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (t >= p) return;
  Frame b2;
  load_frame(boxes2 + t * 9, b2);
  const float vol2 = b2.f[3] * b2.f[4] * b2.f[5];
#pragma unroll 1
  for (int st = 0; st < kStreams; ++st) {
    const int id = st == 0 ? ids_a[t] : ids_b[t];
    out[st * p + t] = (id >= 0 && id < g)
                          ? gathered_iou(tab + id * 10, b2, vol2)
                          : 0.f;
  }
}

// boxes1, boxes2: (p, 9); out: (p,) raw intersection volumes
__global__ void __launch_bounds__(kThreads)
aligned_volume_kernel(const float* __restrict__ boxes1,
                      const float* __restrict__ boxes2,
                      float* __restrict__ out, long long p) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (t >= p) return;
  Frame b1, b2;
  load_frame(boxes1 + t * 9, b1);
  load_frame(boxes2 + t * 9, b2);
  out[t] = pair_volume(b1, b2);
}

int launch(int streams, const void* table, int g, const void* ids_a,
           const void* ids_b, const void* boxes2, void* out, long long p,
           void* stream) {
  if (p <= 0) return 0;
  const long long blocks = (p + kThreads - 1) / kThreads;
  const size_t smem = static_cast<size_t>(g) * 10 * sizeof(float);
  if (g <= 0 || smem > 48 * 1024 || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* tb = static_cast<const float*>(table);
  const int* ia = static_cast<const int*>(ids_a);
  const int* ib = static_cast<const int*>(ids_b);
  const float* b2 = static_cast<const float*>(boxes2);
  float* o = static_cast<float*>(out);
  if (streams == 1) {
    iou_gathered_kernel<1><<<static_cast<unsigned>(blocks), kThreads, smem,
                             s>>>(tb, g, ia, ia, b2, o, p);
  } else {
    iou_gathered_kernel<2><<<static_cast<unsigned>(blocks), kThreads, smem,
                             s>>>(tb, g, ia, ib, b2, o, p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K6.  table: (g, 10) float32; ids: (p,) int32; boxes2: (p, 9) float32;
// out: (p,) float32; stream: cudaStream_t.  Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int iou_gathered(const void* table, int g, const void* ids,
                            const void* boxes2, void* out, long long p,
                            void* stream) {
  return launch(1, table, g, ids, ids, boxes2, out, p, stream);
}

// K7.  As K6 with two id streams; out: (2, p) float32.
extern "C" int iou_gathered_pair(const void* table, int g, const void* ids_a,
                                 const void* ids_b, const void* boxes2,
                                 void* out, long long p, void* stream) {
  return launch(2, table, g, ids_a, ids_b, boxes2, out, p, stream);
}

// K5.  boxes1, boxes2: (p, 9) float32; out: (p,) float32 intersection
// volumes (not clamped at 0); stream: cudaStream_t.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int intersection_volume_aligned(const void* boxes1,
                                           const void* boxes2, void* out,
                                           long long p, void* stream) {
  if (p <= 0) return 0;
  const long long blocks = (p + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  aligned_volume_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes1), static_cast<const float*>(boxes2),
      static_cast<float*>(out), p);
  return static_cast<int>(cudaGetLastError());
}
