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
// Design.  The clipper is one thread per pair with the ring in registers:
// every loop is unrolled, so ring slots have compile-time indices.  The
// ring schedule is the TPU body's: kSlots[p] slots enter plane p and
// kCaps[p] leave it; each slot's kept vertex, then its edge's crossing
// point, is placed at its running position, and the count is min(run,
// cap).  The arithmetic is the body's operation for operation (the build
// passes -fmad=false), so the kernels agree with their plain PyTorch
// versions (ops/iou3d.py) up to the last bits of sinf/cosf.
// K6 and K7 (the gather of a (G, 10) table row -- 9 box fields and a
// validity flag -- against an aligned box) skip the clips that provably
// add nothing: at the flagship most anchors lie metres from both of their
// top-2 trees.  Three launches: (1) one thread per table row computes its
// frame, corners and pushed-out planes once (a pair no longer pays the
// row's sinf/cosf); (2) one thread per pair runs a separating-plane test
// per direction (below) and writes 0 for every pair it clears, appending
// the rest to a list through one atomic per warp; (3) a grid of resident
// blocks clips the listed (pair, stream) items densely, so warps do not
// idle on cleared lanes.  Outputs are indexed by pair, so the list's order
// does not matter.
// K5 is the clipper's entry without a gather, test or IoU (`pair_volume`).

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

// ---- K6, K7: the separating-plane test, then the clip of what it leaves --
//
// A face ring of box 1 entering plane P of box 2 (pulled in by kShrink)
// holds box 1's corners and clamped convex combinations of them.  If all 8
// corners lie beyond P by more than kEps + kMargin, every ring vertex does
// too -- the crossing points' rounding, at coordinates of tens of metres,
// moves them by ~1e-5, and the plain version's sinf/cosf move the corners
// and planes by less -- so P keeps no vertex and crosses no edge, the ring
// leaves empty, and the 6 faces add exactly 0.0f, here and in the plain
// version alike.  The same holds for box 2's faces against box 1's planes
// pushed out.  A pair cleared both ways has inter = 0 and IoU exactly 0; a
// pair cleared one way clips only the other (adding +0.0f changes no sum).
constexpr float kMargin = 1e-3f;
// a table row's record: frame f[9], r[9], validity, pad, corners x[8],
// y[8], z[8], the 6 planes pushed out by kShrink, pad
constexpr int kRec = 72;
constexpr int kRecValid = 18;
constexpr int kRecCorners = 20;
constexpr int kRecPlanes = 44;

// the per-row work of every pair, once per row; thread 0 zeroes the count
__global__ void __launch_bounds__(kThreads)
row_records_kernel(const float* __restrict__ table, int g,
                   float* __restrict__ rec, int* __restrict__ count) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i == 0) *count = 0;
  if (i >= g) return;
  Frame b;
  load_frame(table + i * 10, b);
  float* o = rec + static_cast<long long>(i) * kRec;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    o[k] = b.f[k];
    o[9 + k] = b.r[k / 3][k % 3];
  }
  o[kRecValid] = table[i * 10 + 9];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    corner(b, k, o[kRecCorners + k], o[kRecCorners + 8 + k],
           o[kRecCorners + 16 + k]);
  }
  float pl[6][4];
  planes(b, kShrink, pl);
#pragma unroll
  for (int k = 0; k < 24; ++k) o[kRecPlanes + k] = pl[k / 4][k % 4];
}

// some plane of pl has all 8 corners beyond it by more than kEps + kMargin
__device__ __forceinline__ bool separated(const float (&pl)[6][4],
                                          const float* cx, const float* cy,
                                          const float* cz) {
  bool any = false;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    bool all = true;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      all = all && pl[k][0] * cx[c] + pl[k][1] * cy[c] + pl[k][2] * cz[c] -
                           pl[k][3] >
                       kEps + kMargin;
    }
    any = any || all;
  }
  return any;
}

// One thread per pair p: for each stream, IoU 0 where the id is out of
// range, the row invalid or the test clears both directions; every other
// (pair, stream) is appended to `list` as p << 3 | stream << 2 | (box 2's
// faces cleared) << 1 | (box 1's faces cleared), through one atomic per
// warp.
template <int kStreams>
__global__ void __launch_bounds__(kThreads)
separation_kernel(const float* __restrict__ rec, int g,
                  const int* __restrict__ ids_a, const int* __restrict__ ids_b,
                  const float* __restrict__ boxes2, float* __restrict__ out,
                  long long p, int* __restrict__ count,
                  unsigned* __restrict__ list) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const bool live = t < p;
  const int lane = threadIdx.x & 31;
  Frame b2;
  load_frame(boxes2 + (live ? t : 0) * 9, b2);
  float cx[8], cy[8], cz[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) corner(b2, k, cx[k], cy[k], cz[k]);
  float pl2[6][4];
  planes(b2, -kShrink, pl2);
#pragma unroll 1
  for (int st = 0; st < kStreams; ++st) {
    bool need = false;
    unsigned item = 0;
    if (live) {
      const int id = st == 0 ? ids_a[t] : ids_b[t];
      if (id >= 0 && id < g && __ldg(rec + id * kRec + kRecValid) != 0.f) {
        const float* r = rec + id * kRec;
        float pl1[6][4];
#pragma unroll
        for (int k = 0; k < 24; ++k) {
          pl1[k / 4][k % 4] = __ldg(r + kRecPlanes + k);
        }
        float rx[8], ry[8], rz[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          rx[k] = __ldg(r + kRecCorners + k);
          ry[k] = __ldg(r + kRecCorners + 8 + k);
          rz[k] = __ldg(r + kRecCorners + 16 + k);
        }
        const bool c1 = separated(pl2, rx, ry, rz);
        const bool c2 = separated(pl1, cx, cy, cz);
        need = !(c1 && c2);
        item = static_cast<unsigned>(t) << 3 | st << 2 | (c2 ? 2u : 0u) |
               (c1 ? 1u : 0u);
      }
      if (!need) out[st * p + t] = 0.f;
    }
    const unsigned want = __ballot_sync(0xffffffffu, need);
    if (want != 0) {
      const int leader = __ffs(want) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd(count, __popc(want));
      base = __shfl_sync(0xffffffffu, base, leader);
      if (need) list[base + __popc(want & ((1u << lane) - 1u))] = item;
    }
  }
}

// The clips the test left, densely: list items i, i + stride, ... of the
// count the test wrote.
__global__ void __launch_bounds__(kThreads)
clip_kernel(const float* __restrict__ rec, const int* __restrict__ ids_a,
            const int* __restrict__ ids_b, const float* __restrict__ boxes2,
            float* __restrict__ out, long long p,
            const int* __restrict__ count,
            const unsigned* __restrict__ list) {
  const int n = *count;
#pragma unroll 1
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    const unsigned item = list[i];
    const long long t = item >> 3;
    const int st = (item >> 2) & 1;
    const float* r = rec + (st == 0 ? ids_a[t] : ids_b[t]) * kRec;
    Frame b1, b2;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      b1.f[k] = r[k];
      b1.r[k / 3][k % 3] = r[9 + k];
    }
    load_frame(boxes2 + t * 9, b2);
    // pair_volume, without the directions the test cleared
    float pl[6][4];
    float vol = 0.f;
    if (!(item & 1u)) {
      planes(b2, -kShrink, pl);
      add_face_volumes(b1, pl, vol);
    }
    if (!(item & 2u)) {
      planes(b1, kShrink, pl);
      add_face_volumes(b2, pl, vol);
    }
    const float inter = fmaxf(vol, 0.f);
    const float vol1 = b1.f[3] * b1.f[4] * b1.f[5];
    const float vol2 = b2.f[3] * b2.f[4] * b2.f[5];
    const float uni = vol1 + vol2 - inter;
    const float iou = uni > kUnionEps ? inter / fmaxf(uni, kUnionEps) : 0.f;
    out[st * p + t] = iou * r[kRecValid];
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

// K6 (streams 1) and K7 (streams 2): the row records, the test, then the
// clips on a grid of as many blocks as fit on the card at once.
int launch(int streams, const void* table, int g, const void* ids_a,
           const void* ids_b, const void* boxes2, void* out, long long p,
           void* rec, void* work, void* stream) {
  if (p <= 0) return 0;
  // list items hold p << 3
  if (g <= 0 || p >= (1LL << 29)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* tb = static_cast<const float*>(table);
  const int* ia = static_cast<const int*>(ids_a);
  const int* ib = static_cast<const int*>(ids_b);
  const float* b2 = static_cast<const float*>(boxes2);
  float* o = static_cast<float*>(out);
  float* rc = static_cast<float*>(rec);
  int* count = static_cast<int*>(work);
  unsigned* list = reinterpret_cast<unsigned*>(count + 1);
  row_records_kernel<<<(g + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      tb, g, rc, count);
  const unsigned blocks = static_cast<unsigned>((p + kThreads - 1) / kThreads);
  if (streams == 1) {
    separation_kernel<1><<<blocks, kThreads, 0, s>>>(rc, g, ia, ia, b2, o, p,
                                                     count, list);
  } else {
    separation_kernel<2><<<blocks, kThreads, 0, s>>>(rc, g, ia, ib, b2, o, p,
                                                     count, list);
  }
  int dev = 0;
  int sms = 0;
  int per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, clip_kernel,
                                                        kThreads, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long most = (streams * p + kThreads - 1) / kThreads;
  long long grid = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  grid = grid < most ? grid : most;
  clip_kernel<<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
      rc, ia, streams == 1 ? ia : ib, b2, o, p, count, list);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K6.  table: (g, 10) float32, 9 box fields and validity per row; ids:
// (p,) int32; boxes2: (p, 9) float32; out: (p,) float32; rec: (g, 72)
// float32 and work: (1 + p) int32 scratch; stream: cudaStream_t.  p <
// 2^29.  Returns cudaGetLastError() after the launches (0 on success).
extern "C" int iou_gathered(const void* table, int g, const void* ids,
                            const void* boxes2, void* out, long long p,
                            void* rec, void* work, void* stream) {
  return launch(1, table, g, ids, ids, boxes2, out, p, rec, work, stream);
}

// K7.  As K6 with two id streams; out: (2, p) float32; work: (1 + 2p)
// int32.
extern "C" int iou_gathered_pair(const void* table, int g, const void* ids_a,
                                 const void* ids_b, const void* boxes2,
                                 void* out, long long p, void* rec,
                                 void* work, void* stream) {
  return launch(2, table, g, ids_a, ids_b, boxes2, out, p, rec, work,
                stream);
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
