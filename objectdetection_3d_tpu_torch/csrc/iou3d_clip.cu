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
// Bound on this card: operations.  A clipped pair costs some 10^4 float
// operations (12 polygons x 6 planes) against 76 bytes of traffic, far
// above the card's 20 flops per byte for float32; a pair the test below
// clears costs ~10^3.
//
// Design.  Two steps, each shared by the three kernels.
// (1) A separating-plane test, one thread per pair: if all 8 corners of a
// box lie beyond one plane of the other by more than a margin, that box's
// 6 faces add exactly 0 (below).  A pair cleared both ways is written 0
// (IoU or volume); every other pair joins a list, with its two "cleared"
// bits, through one atomic per warp.  Most pairs of the flagship's callers
// lie metres apart, so the list is short.  K5 first tries each box's
// extent along the other's axes, which clears a far pair in ~300
// operations instead of the 16 corners' and 96 corner-plane tests'
// ~1,000, and clears nothing that the corner test would not.
// (2) The clip of the listed pairs, on a grid of resident blocks: each
// pair gets 12 lanes, one per face, so a pair's latency is one polygon's
// and not twelve.  The lanes compute the pair's six sines and cosines
// once between them (through shared memory).  A lane's ring lives in shared
// memory, two buffers of up to 12 vertices in a column of its own (no
// bank conflicts whatever slot a lane touches), so each candidate vertex is
// stored once at its running position -- no select network over the
// ring's slots -- and a plane walks only the ring's live slots.  The
// per-face totals are summed in face order by the pair's first lane.
// The arithmetic is the TPU body's operation for operation (the build
// passes -fmad=false): the ring schedule (at most 7 + p vertices leave
// plane p), each slot's kept vertex then its edge's crossing point at its
// running position, count = min(run, cap), the fan from vertex 0, the
// faces in order.  Slots past the count, which the body multiplies by 0,
// are not read; a cleared direction's faces, exactly +0.0 in the body,
// are skipped: adding +0.0 to a sum that starts at +0.0 changes no bit.
// So the kernels agree with their plain PyTorch versions (ops/iou3d.py)
// up to the last bits of the sines and cosines.
// K6 and K7 gather a (G, 10) table row -- 9 box fields and a validity flag
// -- against an aligned box: a first launch computes each row's frame,
// corners and pushed-out planes once, so their test does not pay the
// row's sines and cosines per pair.  The clip is templated over where a pair's
// boxes come from (`AlignedPairs`, `GatheredPairs`) and how its result is
// stored.  Outputs are indexed by pair, so the list's order does not
// matter.

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

__device__ __forceinline__ void rotation(float sx, float cx, float sy,
                                         float cy, float sz, float cz,
                                         float (&r)[3][3]) {
  r[0][0] = cz * cy;
  r[0][1] = cz * sy * sx - sz * cx;
  r[0][2] = cz * sy * cx + sz * sx;
  r[1][0] = sz * cy;
  r[1][1] = sz * sy * sx + cz * cx;
  r[1][2] = sz * sy * cx - cz * sx;
  r[2][0] = -sy;
  r[2][1] = cy * sx;
  r[2][2] = cy * cx;
}

// one range reduction for an angle's sine and cosine
__device__ __forceinline__ void load_frame(const float* b, Frame& fr) {
  float sn[3], cs[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) fr.f[k] = b[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) sincosf(fr.f[6 + k], &sn[k], &cs[k]);
  rotation(sn[0], cs[0], sn[1], cs[1], sn[2], cs[2], fr.r);
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

// ---- the separating-plane test -------------------------------------------
//
// A face ring of box 1 entering plane P of box 2 (pulled in by kShrink)
// holds box 1's corners and clamped convex combinations of them.  If all 8
// corners lie beyond P by more than kEps + kMargin, every ring vertex does
// too -- the crossing points' rounding, at coordinates of tens of metres,
// moves them by ~1e-5, and the plain version's sin/cos move the corners
// and planes by less -- so P keeps no vertex and crosses no edge, the ring
// leaves empty, and the 6 faces add exactly +0.0f, here and in the plain
// version alike.  The same holds for box 2's faces against box 1's planes
// pushed out.  A pair cleared both ways has volume (and IoU) exactly 0; a
// pair cleared one way clips only the other (adding +0.0f changes no sum).
constexpr float kMargin = 1e-3f;

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

// Whether box a's corners all lie beyond one of the planes pl of box b
// (normals b's axes) by more than kEps + kMargin, from a's centre m and
// its extents ext along b's axes (|n . (corner - m)| <= sum_j |n . a_j|
// h_j), with a slack of 1e-5 of the magnitudes involved: five times the
// rounding by which the computed corner-by-corner values can differ from
// these, so every pair this clears `separated` clears too, and the test's
// bits stay those of the plain version.  NaN or inf clears nothing.
__device__ __forceinline__ bool clears_by_extent(const float (&pl)[6][4],
                                                 const float (&m)[3],
                                                 const float (&ext)[3],
                                                 float mag) {
  bool any = false;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const float d = pl[k][0] * m[0] + pl[k][1] * m[1] + pl[k][2] * m[2] -
                    pl[k][3];
    const float slack = 1e-5f * (mag + fabsf(pl[k][3])) + 1e-6f;
    any = any || d - ext[k / 2] > kEps + kMargin + slack;
  }
  return any;
}

// The extent test of both directions: c1 for box 1's corners against pl2
// (box 2's planes), c2 for box 2's against pl1.
__device__ __forceinline__ void extent_test(const Frame& b1, const Frame& b2,
                                            const float (&pl1)[6][4],
                                            const float (&pl2)[6][4],
                                            bool& c1, bool& c2) {
  float h1[3], h2[3], m1[3], m2[3], e1[3], e2[3];
  float mag1 = 0.f, mag2 = 0.f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    h1[i] = fabsf(b1.f[3 + i]) / 2.f;
    h2[i] = fabsf(b2.f[3 + i]) / 2.f;
    m1[i] = b1.f[i] + b1.r[i][2] * b1.f[5] / 2.f;
    m2[i] = b2.f[i] + b2.r[i][2] * b2.f[5] / 2.f;
    mag1 += fabsf(m1[i]) + 2.f * h1[i];
    mag2 += fabsf(m2[i]) + 2.f * h2[i];
    e1[i] = 0.f;
    e2[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      // box 2's axis i . box 1's axis j
      const float c = fabsf(b2.r[0][i] * b1.r[0][j] +
                            b2.r[1][i] * b1.r[1][j] +
                            b2.r[2][i] * b1.r[2][j]);
      e1[i] += c * h1[j];
      e2[j] += c * h2[i];
    }
  }
  c1 = clears_by_extent(pl2, m1, e1, mag1);
  c2 = clears_by_extent(pl1, m2, e2, mag2);
}

// appends `item` to the list where `need`, through one atomic per warp;
// every lane of the warp calls it
__device__ __forceinline__ void append(bool need, unsigned item,
                                       int* __restrict__ count,
                                       unsigned* __restrict__ list) {
  const int lane = threadIdx.x & 31;
  const unsigned want = __ballot_sync(0xffffffffu, need);
  if (want != 0) {
    const int leader = __ffs(want) - 1;
    int base = 0;
    if (lane == leader) base = atomicAdd(count, __popc(want));
    base = __shfl_sync(0xffffffffu, base, leader);
    if (need) list[base + __popc(want & ((1u << lane) - 1u))] = item;
  }
}

// a table row's record: frame f[9], r[9], validity, pad, corners x[8],
// y[8], z[8], the 6 planes pushed out by kShrink, pad
constexpr int kRec = 72;
constexpr int kRecValid = 18;
constexpr int kRecCorners = 20;
constexpr int kRecPlanes = 44;

// K6/K7: the per-row work of every pair, once per row; thread 0 zeroes
// the list's count
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

// K6/K7, one thread per pair p: for each stream, IoU 0 where the id is out
// of range, the row invalid or the test clears both directions; every
// other (pair, stream) is listed as p << 3 | stream << 2 | (box 2's faces
// cleared) << 1 | (box 1's faces cleared).
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
    append(need, item, count, list);
  }
}

// stages rows [first, first + rows) of a (p, 9) float32 array in shared
// memory: a block's rows start at a multiple of 4,608 bytes, so 16-byte
// loads serve wherever the array's start is 16-byte aligned
__device__ __forceinline__ void stage_rows(const float* __restrict__ src,
                                           long long first, int rows,
                                           float* __restrict__ dst) {
  const float* s = src + first * 9;
  const int n = rows * 9;
  int done = 0;
  if ((reinterpret_cast<unsigned long long>(src) & 15ull) == 0) {
    const int quads = n / 4;
    for (int k = threadIdx.x; k < quads; k += kThreads) {
      reinterpret_cast<float4*>(dst)[k] =
          __ldg(reinterpret_cast<const float4*>(s) + k);
    }
    done = quads * 4;
  }
  for (int k = done + threadIdx.x; k < n; k += kThreads) dst[k] = __ldg(s + k);
}

// K5, one thread per pair p: volume 0 where the test clears both
// directions; every other pair is listed as p << 2 | (box 2's faces
// cleared) << 1 | (box 1's faces cleared).  At most 64 registers, so
// that 8 blocks share an SM and one block's row loads hide behind
// another's arithmetic.
__global__ void __launch_bounds__(kThreads, 8)
aligned_test_kernel(const float* __restrict__ boxes1,
                    const float* __restrict__ boxes2, float* __restrict__ out,
                    long long p, int* __restrict__ count,
                    unsigned* __restrict__ list) {
  __shared__ __align__(16) float rows[2][kThreads * 9];
  const long long first = static_cast<long long>(blockIdx.x) * kThreads;
  const int n = static_cast<int>(
      p - first < kThreads ? p - first : static_cast<long long>(kThreads));
  stage_rows(boxes1, first, n, rows[0]);
  stage_rows(boxes2, first, n, rows[1]);
  __syncthreads();
  bool need = false;
  unsigned item = 0;
  if (static_cast<int>(threadIdx.x) < n) {
    Frame b1, b2;
    load_frame(rows[0] + threadIdx.x * 9, b1);
    load_frame(rows[1] + threadIdx.x * 9, b2);
    float pl1[6][4], pl2[6][4];
    planes(b1, kShrink, pl1);
    planes(b2, -kShrink, pl2);
    // the extent test first; the corners only where it does not clear
    bool c1, c2;
    extent_test(b1, b2, pl1, pl2, c1, c2);
    float cx[8], cy[8], cz[8];
    if (!c1) {
#pragma unroll
      for (int k = 0; k < 8; ++k) corner(b1, k, cx[k], cy[k], cz[k]);
      c1 = separated(pl2, cx, cy, cz);
    }
    if (!c2) {
#pragma unroll
      for (int k = 0; k < 8; ++k) corner(b2, k, cx[k], cy[k], cz[k]);
      c2 = separated(pl1, cx, cy, cz);
    }
    const long long t = first + threadIdx.x;
    need = !(c1 && c2);
    item = static_cast<unsigned>(t) << 2 | (c2 ? 2u : 0u) | (c1 ? 1u : 0u);
    if (!need) out[t] = 0.f;
  }
  append(need, item, count, list);
}

// ---- the clip of the listed pairs, shared by K5, K6 and K7 ---------------

constexpr int kLanes = 12;                         // one per face
constexpr int kClipItems = 8;                      // pairs per block round
constexpr int kClipThreads = kLanes * kClipItems;  // 96: three full warps
// A thread's two ring buffers: plane p reads buffer p & 1 and writes the
// other, so buffer 0 holds the face's 4 corners and the rings leaving
// planes 1, 3, 5 (at most 8, 10, 12 vertices), buffer 1 those leaving
// planes 0, 2, 4 (at most 7, 9, 11): 23 slots, 27.6 KB of rings a block,
// so that 8 blocks fit on an SM.
constexpr int kRing = 12;
constexpr int kRingSlots = 2 * kRing - 1;
// vertex j, coordinate c of buffer b, in the thread's own column of the
// block's array
__device__ __forceinline__ int at(int b, int j, int c) {
  return ((b * kRing + j) * 3 + c) * kClipThreads;
}

// One Sutherland-Hodgman pass of plane P over the ring: buffer P & 1 in,
// the other buffer out.  Slot i keeps its vertex, then emits its edge's
// crossing point, each at the running position while that is below the
// cap.
template <int P>
__device__ __forceinline__ void clip_plane(float* ring, const float (&pl)[4],
                                           int& cnt) {
  constexpr int kIn = P & 1;
  constexpr int kOut = kIn ^ 1;
  constexpr int kCap = 7 + P;  // 7, 8, 9, 10, 11, 12
  int run = 0;
  float x = 0.f, y = 0.f, z = 0.f, s = 0.f;
  if (cnt > 0) {
    x = ring[at(kIn, 0, 0)];
    y = ring[at(kIn, 0, 1)];
    z = ring[at(kIn, 0, 2)];
    s = pl[0] * x + pl[1] * y + pl[2] * z - pl[3];
  }
#pragma unroll 1
  for (int i = 0; i < cnt; ++i) {
    const int j = i + 1 == cnt ? 0 : i + 1;
    const float xn = ring[at(kIn, j, 0)];
    const float yn = ring[at(kIn, j, 1)];
    const float zn = ring[at(kIn, j, 2)];
    const float sn = pl[0] * xn + pl[1] * yn + pl[2] * zn - pl[3];
    float denom = s - sn;
    denom = fabsf(denom) > kEps ? denom : kEps;
    // clamped to [0, 1]; NaN stays NaN, as torch.clamp and jnp.clip keep it
    float tt = s / denom;
    tt = tt < 0.f ? 0.f : tt;
    tt = tt > 1.f ? 1.f : tt;
    const bool inside = s <= kEps;
    if (inside && run < kCap) {
      ring[at(kOut, run, 0)] = x;
      ring[at(kOut, run, 1)] = y;
      ring[at(kOut, run, 2)] = z;
    }
    run += inside ? 1 : 0;
    const bool cross = inside != (sn <= kEps);
    if (cross && run < kCap) {
      ring[at(kOut, run, 0)] = x + tt * (xn - x);
      ring[at(kOut, run, 1)] = y + tt * (yn - y);
      ring[at(kOut, run, 2)] = z + tt * (zn - z);
    }
    run += cross ? 1 : 0;
    x = xn;
    y = yn;
    z = zn;
    s = sn;
  }
  cnt = min(run, kCap);
}

// the signed volume under face f of box a clipped by the half-spaces pl:
// the fan from vertex 0 of the clipped polygon
__device__ float face_volume(const Frame& a, int f, const float (&pl)[6][4],
                             float* ring) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float x, y, z;
    corner(a, face_corner(f, i), x, y, z);
    ring[at(0, i, 0)] = x;
    ring[at(0, i, 1)] = y;
    ring[at(0, i, 2)] = z;
  }
  int cnt = 4;
  clip_plane<0>(ring, pl[0], cnt);
  clip_plane<1>(ring, pl[1], cnt);
  clip_plane<2>(ring, pl[2], cnt);
  clip_plane<3>(ring, pl[3], cnt);
  clip_plane<4>(ring, pl[4], cnt);
  clip_plane<5>(ring, pl[5], cnt);
  // six passes leave the ring in buffer 0
  float total = 0.f;
  if (cnt > 2) {
    const float x0 = ring[at(0, 0, 0)];
    const float y0 = ring[at(0, 0, 1)];
    const float z0 = ring[at(0, 0, 2)];
    float xi = ring[at(0, 1, 0)];
    float yi = ring[at(0, 1, 1)];
    float zi = ring[at(0, 1, 2)];
#pragma unroll 1
    for (int i = 1; i + 1 < cnt; ++i) {
      const float x1 = ring[at(0, i + 1, 0)];
      const float y1 = ring[at(0, i + 1, 1)];
      const float z1 = ring[at(0, i + 1, 2)];
      const float crx = yi * z1 - zi * y1;
      const float cry = zi * x1 - xi * z1;
      const float crz = xi * y1 - yi * x1;
      const float contrib = x0 * crx + y0 * cry + z0 * crz;
      total = total + contrib / 6.f;
      xi = x1;
      yi = y1;
      zi = z1;
    }
  }
  return total;
}

// K5's pairs: rows t of boxes1 and boxes2 for item t << 2 | bits; the
// raw volume is stored
struct AlignedPairs {
  const float* b1;
  const float* b2;
  float* out;
  static constexpr bool kRowRotation = false;
  __device__ const float* row1(unsigned item) const {
    return b1 + static_cast<long long>(item >> 2) * 9;
  }
  __device__ const float* row2(unsigned item) const {
    return b2 + static_cast<long long>(item >> 2) * 9;
  }
  __device__ void store(unsigned item, float vol) const {
    out[item >> 2] = vol;
  }
};

// K6/K7's pairs: the record of table row ids[t] (its frame's rotation
// included) and row t of boxes2 for item t << 3 | stream << 2 | bits; the
// IoU, masked by the row's validity, is stored
struct GatheredPairs {
  const float* rec;
  const int* ids_a;
  const int* ids_b;
  const float* boxes2;
  float* out;
  long long p;
  static constexpr bool kRowRotation = true;
  __device__ const float* row1(unsigned item) const {
    const long long t = item >> 3;
    return rec + ((item >> 2) & 1u ? ids_b[t] : ids_a[t]) * kRec;
  }
  __device__ const float* row2(unsigned item) const {
    return boxes2 + static_cast<long long>(item >> 3) * 9;
  }
  __device__ void store(unsigned item, float vol) const {
    const float* r = row1(item);
    const float* b = row2(item);
    const float inter = fmaxf(vol, 0.f);
    const float vol1 = r[3] * r[4] * r[5];
    const float vol2 = b[3] * b[4] * b[5];
    const float uni = vol1 + vol2 - inter;
    const float iou = uni > kUnionEps ? inter / fmaxf(uni, kUnionEps) : 0.f;
    out[((item >> 2) & 1u) * p + (item >> 3)] = iou * r[kRecValid];
  }
};

// The listed pairs, kClipItems per block and round, on a grid of resident
// blocks: lane q of a pair's 12 clips face q of box 1 in box 2's planes
// pulled in (q < 6) or face q - 6 of box 2 in box 1's planes pushed out,
// unless the test cleared that direction.
template <class Src>
__global__ void __launch_bounds__(kClipThreads)
clip_kernel(Src src, const int* __restrict__ count,
            const unsigned* __restrict__ list) {
  __shared__ float ring[kRingSlots * 3 * kClipThreads];
  __shared__ float trig[2][kClipThreads];
  __shared__ float totals[kClipThreads];
  const int slot = threadIdx.x / kLanes;
  const int q = threadIdx.x - slot * kLanes;
  const int lane0 = slot * kLanes;
  const bool dir2 = q >= 6;
  const int a = dir2 ? q - 6 : q;  // this lane's face, and its angle
  const int n = *count;
#pragma unroll 1
  for (int first = blockIdx.x * kClipItems; first < n;
       first += gridDim.x * kClipItems) {
    const bool live = first + slot < n;
    const unsigned item = live ? list[first + slot] : 0u;
    Frame b1, b2;
    float sa = 0.f, ca = 1.f;
    if (live) {
      const float* r1 = src.row1(item);
      const float* r2 = src.row2(item);
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        b1.f[k] = __ldg(r1 + k);
        b2.f[k] = __ldg(r2 + k);
      }
      // lanes a and a + 6 take angle a of (box 1's rx, ry, rz, box 2's)
      float ang = b1.f[6];
#pragma unroll
      for (int k = 1; k < 6; ++k) {
        ang = a == k ? (k < 3 ? b1.f[6 + k] : b2.f[3 + k]) : ang;
      }
      sincosf(ang, &sa, &ca);
    }
    trig[0][threadIdx.x] = sa;
    trig[1][threadIdx.x] = ca;
    __syncthreads();
    float total = 0.f;
    if (live && !(item & (dir2 ? 2u : 1u))) {
      if constexpr (Src::kRowRotation) {
        const float* r1 = src.row1(item);
#pragma unroll
        for (int k = 0; k < 9; ++k) b1.r[k / 3][k % 3] = __ldg(r1 + 9 + k);
      } else {
        rotation(trig[0][lane0], trig[1][lane0], trig[0][lane0 + 1],
                 trig[1][lane0 + 1], trig[0][lane0 + 2], trig[1][lane0 + 2],
                 b1.r);
      }
      rotation(trig[0][lane0 + 3], trig[1][lane0 + 3], trig[0][lane0 + 4],
               trig[1][lane0 + 4], trig[0][lane0 + 5], trig[1][lane0 + 5],
               b2.r);
      // the box whose face this lane clips, and the box whose planes clip
      Frame own, other;
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        own.f[k] = dir2 ? b2.f[k] : b1.f[k];
        other.f[k] = dir2 ? b1.f[k] : b2.f[k];
        own.r[k / 3][k % 3] = dir2 ? b2.r[k / 3][k % 3] : b1.r[k / 3][k % 3];
        other.r[k / 3][k % 3] =
            dir2 ? b1.r[k / 3][k % 3] : b2.r[k / 3][k % 3];
      }
      float pl[6][4];
      planes(other, dir2 ? kShrink : -kShrink, pl);
      total = face_volume(own, a, pl, ring + threadIdx.x);
    }
    totals[threadIdx.x] = total;
    __syncthreads();
    if (live && q == 0) {
      // the 12 faces in order: box 1's, then box 2's
      float vol = 0.f;
#pragma unroll
      for (int k = 0; k < kLanes; ++k) vol = vol + totals[lane0 + k];
      src.store(item, vol);
    }
  }
}

// the clip of at most `most` listed items on as many blocks as fit on the
// card at once
template <class Src>
int launch_clip(const Src& src, long long most, const int* count,
                const unsigned* list, cudaStream_t s) {
  int dev = 0;
  int sms = 0;
  int per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, clip_kernel<Src>, kClipThreads, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rounds = (most + kClipItems - 1) / kClipItems;
  long long grid = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  grid = grid < rounds ? grid : rounds;
  clip_kernel<Src><<<static_cast<unsigned>(grid), kClipThreads, 0, s>>>(
      src, count, list);
  return static_cast<int>(cudaGetLastError());
}

// K6 (streams 1) and K7 (streams 2): the row records, the test, then the
// clips.
int launch_gathered(int streams, const void* table, int g, const void* ids_a,
                    const void* ids_b, const void* boxes2, void* out,
                    long long p, void* rec, void* work, void* stream) {
  if (p <= 0) return 0;
  // list items hold p << 3
  if (g <= 0 || p >= (1LL << 29)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* tb = static_cast<const float*>(table);
  const int* ia = static_cast<const int*>(ids_a);
  const int* ib = static_cast<const int*>(streams == 1 ? ids_a : ids_b);
  const float* b2 = static_cast<const float*>(boxes2);
  float* o = static_cast<float*>(out);
  float* rc = static_cast<float*>(rec);
  int* count = static_cast<int*>(work);
  unsigned* list = reinterpret_cast<unsigned*>(count + 1);
  row_records_kernel<<<(g + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      tb, g, rc, count);
  const unsigned blocks = static_cast<unsigned>((p + kThreads - 1) / kThreads);
  if (streams == 1) {
    separation_kernel<1><<<blocks, kThreads, 0, s>>>(rc, g, ia, ib, b2, o, p,
                                                     count, list);
  } else {
    separation_kernel<2><<<blocks, kThreads, 0, s>>>(rc, g, ia, ib, b2, o, p,
                                                     count, list);
  }
  return launch_clip(GatheredPairs{rc, ia, ib, b2, o, p}, streams * p, count,
                     list, s);
}

}  // namespace

// K6.  table: (g, 10) float32, 9 box fields and validity per row; ids:
// (p,) int32; boxes2: (p, 9) float32; out: (p,) float32; rec: (g, 72)
// float32 and work: (1 + p) int32 scratch; stream: cudaStream_t.  p <
// 2^29.  Returns cudaGetLastError() after the launches (0 on success).
extern "C" int iou_gathered(const void* table, int g, const void* ids,
                            const void* boxes2, void* out, long long p,
                            void* rec, void* work, void* stream) {
  return launch_gathered(1, table, g, ids, ids, boxes2, out, p, rec, work,
                         stream);
}

// K7.  As K6 with two id streams; out: (2, p) float32; work: (1 + 2p)
// int32.
extern "C" int iou_gathered_pair(const void* table, int g, const void* ids_a,
                                 const void* ids_b, const void* boxes2,
                                 void* out, long long p, void* rec,
                                 void* work, void* stream) {
  return launch_gathered(2, table, g, ids_a, ids_b, boxes2, out, p, rec,
                         work, stream);
}

// K5.  boxes1, boxes2: (p, 9) float32; out: (p,) float32 intersection
// volumes (not clamped at 0); work: (1 + p) int32 scratch, the list's
// count (zeroed here, on the stream) and its items; stream: cudaStream_t.
// p < 2^30.  Returns cudaGetLastError() after the launches (0 on success).
extern "C" int intersection_volume_aligned(const void* boxes1,
                                           const void* boxes2, void* out,
                                           long long p, void* work,
                                           void* stream) {
  if (p <= 0) return 0;
  // list items hold p << 2
  if (p >= (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b1 = static_cast<const float*>(boxes1);
  const float* b2 = static_cast<const float*>(boxes2);
  float* o = static_cast<float*>(out);
  int* count = static_cast<int*>(work);
  unsigned* list = reinterpret_cast<unsigned*>(count + 1);
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  aligned_test_kernel<<<static_cast<unsigned>((p + kThreads - 1) / kThreads),
                        kThreads, 0, s>>>(b1, b2, o, p, count, list);
  return launch_clip(AlignedPairs{b1, b2, o}, p, count, list, s);
}
