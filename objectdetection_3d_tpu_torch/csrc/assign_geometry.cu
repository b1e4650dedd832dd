// Target-assignment geometry of one GT chunk against the factored anchor
// grid (kernel K3) and the containment rescue pass (kernel K4) for Hopper,
// sm_90a.
//
// Replaces: objectdetection_3d_tpu/ops/assign_geometry.py
//   * chunk_geometry     (`_geometry_kernel`): per (GT, anchor) interval and
//     separating-axis geometry on the 6 face axes -- the slab-overlap IoU
//     upper bound, its ranking key, the closed-form containment IoU and
//     the SAT "may overlap" flag -- reduced over the chunk's GTs into the
//     per-anchor containment max / best GT, the overlap flag, the running
//     top-3 (key, GT id) slots, and the per-(GT, cell) containment maxima;
//   * containment_rescue (`_rescue_kernel`): a flag wherever some GT's
//     containment IoU reaches that GT's row max with rescue enabled.
//
// Bound on this card: bytes written.  At the flagship (16 GTs x 1.92 M
// anchors per chunk) K3 writes the 123 MB key tensor and 9 per-anchor
// arrays (69 MB) for some 128 float operations per (GT, anchor) pair; K4
// writes 7.7 MB, and once the pairs that cannot hit are skipped its
// operations are few (below).  Both are built with -fmad=false
// (bit-exactness), so every multiply-add is two instructions.
//
// K3's design: persistent blocks, as many as fit on the card at once, each
// of cells_per_block * M threads striding over groups of 2 *
// cells_per_block cells.  Thread t is combo t % M of two cells of a group,
// so its anchors n = cell * M + m (the flat cell-major order of the anchor
// grid; the TPU kernel's combo-major layout exists only for its lane
// width) are neighbours of the warp's other lanes, and the stores
// coalesce.
// - Hoisted tables: once per block, every value that depends on (GT,
//   combo) only -- the interval limits hg -+ hap and chalf -+ hgp, the
//   doubled half-extents, both volume ratios (the two divisions), the
//   smaller volume and the volume sum -- goes into a 28-float record per
//   (GT, combo) in shared memory (7 float4 loads at a stride of 112 bytes,
//   which 8 lanes of distinct combos read without bank conflicts), the
//   per-GT 2 hg and mask into one float4 that every lane reads at once.  A
//   thread loads a record once for both of its cells.  Once per group, the
//   cell centre on each unmasked GT's axes (`base`, which depends on (GT,
//   cell) only) goes into a (GT, cell) table.  A hoisted value is computed
//   with the same operations in the same order as the plain version
//   computes it per pair, so it is the same float.  Per pair there remain
//   the interval tests, the slab widths, the bound's division (skipped
//   where the intersection is +-0: 0 / denom is then the intersection
//   itself) and the square root of the axis distance; the top-3 merge
//   runs only for a key above the third slot (below it no slot changes).
// - Per-(GT, cell) containment maxima over the cell's M combos: each
//   positive IoU goes into its (GT, cell) slot in shared memory by an
//   integer atomicMax on its bits (the order of non-negative floats), and
//   the slots are written out after the group's barrier.  Exact where the
//   IoUs are +0 or positive: boxes with non-negative dims.
// - One barrier per group: the base tables and the maxima are double-
//   buffered, so a group's pairs run while the next group's base table is
//   filled, and its maxima are written out after the barrier.
// - Masked rows: a GT row whose mask is 0 skips the geometry (the branch
//   is uniform: every thread walks the same GT).  The plain version then
//   gives key = -1e9, maybe = false and containment IoU = ratio * 0 = +0,
//   provided the row's ratios are finite and not negative: true of padded
//   rows as chunk_tables builds them (zero boxes, or wrapped copies of real
//   GTs) and of any box with non-negative dims; non-finite GT boxes, and
//   boxes with negative dims, are out of scope.  The row still goes
//   through the top-3 merge with its id.  A chunk of masked rows only
//   (7 of the flagship's 8) writes those constants as a streaming fill
//   in 16-byte pieces, bound by bytes.
// Each thread walks the chunk's GTs in ascending id, so the containment
// max keeps the first achiever and the top-3 merge's strict `>` keeps the
// incumbent on ties, as in the TPU body.  The arithmetic is the plain
// version's (ops/assign_geometry.py) operation for operation, so the two
// agree bit for bit.
//
// K4's design.  Computed in full, the rescue costs 53 float operations
// per (GT, anchor) pair, 1.6 G per flagship chunk, nearly all on pairs
// that cannot hit.  The plain version's IoU of a pair is ratio_a * gmask
// where the anchor lies in the GT (in_a), ratio_b * gmask where the GT
// lies in the anchor (in_b), else 0 * gmask, and the ratios depend on
// (GT, combo) only.  So the hit folds into flags per (GT, combo): fa =
// (ratio_a * gmask reaches the row max, rescue allowed, > 0), fb the same
// with ratio_b, and the pair hits iff in_a ? fa : (in_b ? fb : false).
// in_a needs |x| <= hg - hap on the three GT axes, so where one of those
// limits is below 0 (or NaN) the anchor fits in the GT at no cell; the
// same for in_b and chalf - hgp.  Flags A = fa where the anchor can fit,
// B = fb where the GT can fit, T = the anchor can fit: the hit is (T &&
// in_a) ? A : (B && in_b).  A (GT, combo) with neither A nor B -- a
// masked row whatever its box, a row without rescue, a ratio below the
// row max, boxes that fit neither way -- never hits and is skipped
// exactly, for any input.  (One of ratio_a, ratio_b is >= 1 >= the row
// max, so the fits, not the ratios, are what prune a live row.)
// - Persistent blocks, as many as fit on the card at once; each computes
//   the flags and a record of the interval limits per (GT, combo) once,
//   with the plain version's operations (torch.clamp keeps NaN), and lists
//   the live pairs in ascending (GT, combo).  With no live pair (7 of the
//   flagship's 8 chunks) the chunk is a streaming fill of zeros in 16-byte
//   pieces, bound by bytes: decided on the card, so the caller reads
//   nothing back and launches the same way for every chunk.
// - Otherwise a block strides over groups of kCells4 cells, one cell per
//   thread.  Each thread computes its cell's centre on the axes of every
//   combo with a B pair once (its own column of a shared table), and walks
//   the live pairs GT by GT: the cell centre on the GT's axes (`base`)
//   once per (GT, cell) where a pair tests in_a, the three in_a tests
//   where T is set, and the three in_b tests only where B is set and in_a
//   is false.  Every thread of a warp walks the same pair, so the records
//   are broadcast reads.
// - The hits go as bytes into a double-buffered shared array of the
//   group's anchors; after the group's one barrier each thread stores four
//   anchors' flags as one 16-byte vector, coalesced, and clears them.
// Each hoisted value is the plain version's float: the same operations in
// the same order.  What is left per live pair is 9 to 12 operations, so
// the launch, the set-up and the 7.7 MB store bound it.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr float kTiebreakEps = 1e-6f;
constexpr int kMaxThreads = 256;
constexpr int kFtab = 17;  // u (9, row-major), hg (3), cg.u (3), volg, mask
constexpr int kRec = 7;    // float4 slots of a K3 (GT, combo) record
constexpr int kA = 2;      // anchors per K3 thread (one combo, two cells)

// ---- K3 ------------------------------------------------------------------

// Record fields (floats) of one (GT g, combo m) pair of K3.
enum : int {
  kCorr = 0,     // (3) combo offset on the GT axes
  kLoA = 3,      // (3) hg - hap: containment limit on the GT axes
  kHiA = 6,      // (3) hg + hap: separation limit on the GT axes
  kTwHap = 9,    // (3) 2 * hap
  kCgv = 12,     // (3) GT centre on the combo axes
  kLoB = 15,     // (3) chalf - hgp
  kHiB = 18,     // (3) chalf + hgp
  kTwHgp = 21,   // (3) 2 * hgp
  kRatioA = 24,  // cvol / max(volg, 1e-6)
  kRatioB = 25,  // volg / max(cvol, 1e-6)
  kVmin = 26,    // min(volg, cvol)
  kVsum = 27,    // volg + cvol
};

// Byte offsets of K3's shared memory: the (GT, combo) records at 0, then
// the per-GT (2 hg, mask), two (GT, cell) base tables of a group of kA *
// cpb cells and two of its (GT, cell) containment maxima (this group's
// and the next's), the GT ids and the per-GT table.
struct GeoLayout {
  size_t gq, base, rmax, ids, ft, total;
};

inline GeoLayout geo_layout(int gch, int m, int cpb) {
  GeoLayout l;
  l.gq = static_cast<size_t>(gch) * m * kRec * 16;
  l.base = l.gq + static_cast<size_t>(gch) * 16;
  l.rmax = l.base + 2 * static_cast<size_t>(gch) * kA * cpb * 16;
  l.ids = l.rmax + 2 * static_cast<size_t>(gch) * kA * cpb * 4;
  l.ft = l.ids + static_cast<size_t>(gch) * 4;
  l.total = l.ft + static_cast<size_t>(gch) * kFtab * 4;
  return l;
}

// fold (w, gw) into the running top-3; ties keep the incumbent
__device__ __forceinline__ void top3_merge(float (&v)[3], int (&a)[3],
                                           float w, int gw) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const bool better = w > v[k];
    const float nv = better ? w : v[k];
    const int na = better ? gw : a[k];
    w = better ? v[k] : w;
    gw = better ? a[k] : gw;
    v[k] = nv;
    a[k] = na;
  }
}

// p[0..count) = v, in 16-byte pieces between a 4-byte head and tail;
// thread `tid` of `nthreads`
__device__ __forceinline__ void fill(int* p, long long count, int v,
                                     long long tid, long long nthreads) {
  const long long head = min(
      count,
      static_cast<long long>((16 - (reinterpret_cast<uintptr_t>(p) & 15)) &
                             15) / 4);
  for (long long i = tid; i < head; i += nthreads) p[i] = v;
  int4* q = reinterpret_cast<int4*>(p + head);
  const long long n4 = (count - head) / 4;
  const int4 v4 = make_int4(v, v, v, v);
  for (long long i = tid; i < n4; i += nthreads) q[i] = v4;
  for (long long i = head + n4 * 4 + tid; i < count; i += nthreads) p[i] = v;
}

// outf: (4, n) cm, v1, v2, v3; outi: (5, n) cb, a1, a2, a3, mb;
// key: (gch, n); rmax: (gch, nc).  Thread t is combo t % m of cells
// t / m and t / m + cpb of each group of kA * cpb cells.  Three blocks of
// 256 threads fit an SM.
__global__ void __launch_bounds__(kMaxThreads, 3)
geometry_kernel(const float* __restrict__ ftab, const int* __restrict__ gid,
                const float* __restrict__ tabs,
                const float* __restrict__ combo,
                const float* __restrict__ cells, int gch, int m, int nc,
                int cpb, int g_sentinel, GeoLayout L,
                float* __restrict__ key, float* __restrict__ outf,
                int* __restrict__ outi, float* __restrict__ rmax) {
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  const float4* rec = smem4;
  float4* gq = reinterpret_cast<float4*>(smem + L.gq);
  float4* base = reinterpret_cast<float4*>(smem + L.base);
  int* rmax_s = reinterpret_cast<int*>(smem + L.rmax);
  int* ids = reinterpret_cast<int*>(smem + L.ids);
  float* ft = reinterpret_cast<float*>(smem + L.ft);
  const int threads = cpb * m;
  const int group = kA * cpb;
  const int t = threadIdx.x;

  for (int k = t; k < gch * kFtab; k += threads) ft[k] = ftab[k];
  for (int k = t; k < gch; k += threads) ids[k] = gid[k];
  for (int k = t; k < 2 * gch * kA * cpb; k += threads) rmax_s[k] = 0;
  __syncthreads();
  const long long n_all = static_cast<long long>(nc) * m;

  // a chunk of masked rows only: every output is the plain version's
  // constant, written at the card's streaming rate
  bool all_masked = true;
  for (int g = 0; g < gch; ++g) {
    all_masked = all_masked && ft[g * kFtab + 16] == 0.f;
  }
  if (all_masked) {
    float v[3] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
    int ai[3] = {g_sentinel, g_sentinel, g_sentinel};
    for (int g = 0; g < gch; ++g) {
      if (-1e9f > v[2]) top3_merge(v, ai, -1e9f, ids[g]);
    }
    const long long tid = static_cast<long long>(blockIdx.x) * threads + t;
    const long long nth = static_cast<long long>(gridDim.x) * threads;
    int* of = reinterpret_cast<int*>(outf);
    fill(reinterpret_cast<int*>(key), gch * n_all, __float_as_int(-1e9f),
         tid, nth);
    fill(of, n_all, __float_as_int(0.f), tid, nth);
    fill(outi, n_all, g_sentinel, tid, nth);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      fill(of + (k + 1) * n_all, n_all, __float_as_int(v[k]), tid, nth);
      fill(outi + (k + 1) * n_all, n_all, ai[k], tid, nth);
    }
    fill(outi + 4 * n_all, n_all, 0, tid, nth);
    fill(reinterpret_cast<int*>(rmax), static_cast<long long>(gch) * nc,
         __float_as_int(0.f), tid, nth);
    return;
  }
  // the (GT, combo) records and the per-GT values, once per block
  for (int e = t; e < gch * m; e += threads) {
    const int g = e / m;
    const int mi = e - g * m;
    const float* f = ft + g * kFtab;
    float* r = reinterpret_cast<float*>(smem) + e * kRec * 4;
    const float volg = f[15];
    const float cvol = combo[12 * m + mi];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float hg = f[9 + i];
      const float hap = tabs[(0 * gch * 3 + g * 3 + i) * m + mi];
      r[kCorr + i] = tabs[(2 * gch * 3 + g * 3 + i) * m + mi];
      r[kLoA + i] = hg - hap;
      r[kHiA + i] = hg + hap;
      r[kTwHap + i] = 2.f * hap;
      const float chalf = combo[(9 + i) * m + mi];
      const float hgp = tabs[(1 * gch * 3 + g * 3 + i) * m + mi];
      r[kCgv + i] = tabs[(3 * gch * 3 + g * 3 + i) * m + mi];
      r[kLoB + i] = chalf - hgp;
      r[kHiB + i] = chalf + hgp;
      r[kTwHgp + i] = 2.f * hgp;
    }
    r[kRatioA] = cvol / fmaxf(volg, 1e-6f);
    r[kRatioB] = volg / fmaxf(cvol, 1e-6f);
    r[kVmin] = fminf(volg, cvol);
    r[kVsum] = volg + cvol;
  }
  for (int g = t; g < gch; g += threads) {
    const float* f = ft + g * kFtab;
    gq[g] = make_float4(2.f * f[9], 2.f * f[10], 2.f * f[11], f[16]);
  }

  // this thread's combo: its axes' constants
  const int lc = t / m;
  const int mi = t - lc * m;
  float coffv[3], twc[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    coffv[j] = combo[(13 + j) * m + mi];
    twc[j] = 2.f * combo[(9 + j) * m + mi];
  }

  // the cell centres on each unmasked GT's axes, once per (GT, cell) of
  // the group at cell0, into base table `buf`
  auto fill_base = [&](int buf, int cell0) {
    float4* bt = base + buf * gch * group;
    for (int e = t; e < gch * group; e += threads) {
      const int g = e / group;
      const float* f = ft + g * kFtab;
      if (f[16] == 0.f) continue;
      const int cell = min(cell0 + e - g * group, nc - 1);
      const float c0 = cells[cell * 3];
      const float c1 = cells[cell * 3 + 1];
      const float c2 = cells[cell * 3 + 2];
      float b[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        b[i] = f[0 * 3 + i] * c0 + f[1 * 3 + i] * c1 + f[2 * 3 + i] * c2 -
               f[12 + i];
      }
      bt[e] = make_float4(b[0], b[1], b[2], 0.f);
    }
  };
  const int stride = gridDim.x * group;
  fill_base(0, blockIdx.x * group);
  __syncthreads();

  // one barrier per group: group r uses base and IoU buffers r % 2 while
  // the next group's base table is filled; its IoUs are reduced after the
  // barrier, before any thread writes that buffer again (group r + 2)
#pragma unroll 1
  for (int cell0 = blockIdx.x * group, buf = 0; cell0 < nc;
       cell0 += stride, buf ^= 1) {
    const float4* bt = base + buf * gch * group;
    int* rm = rmax_s + buf * gch * group;
    // a thread past the last cell computes the last cell's anchor again
    // and writes the same values there
    float* kp[kA];     // this anchor's key, advanced by one GT row per GT
    long long n[kA];
    float cov[kA][3];  // the cell centres on the combo's axes
    float cm[kA];
    int cb[kA];
    bool mb[kA];
    float v[kA][3];
    int ai[kA][3];
#pragma unroll
    for (int a = 0; a < kA; ++a) {
      const int cc = min(cell0 + a * cpb + lc, nc - 1);
      n[a] = static_cast<long long>(cc) * m + mi;
      kp[a] = key + n[a];
      const float c0 = cells[cc * 3];
      const float c1 = cells[cc * 3 + 1];
      const float c2 = cells[cc * 3 + 2];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        cov[a][j] = combo[(0 * 3 + j) * m + mi] * c0 +
                    combo[(1 * 3 + j) * m + mi] * c1 +
                    combo[(2 * 3 + j) * m + mi] * c2;
        v[a][j] = -CUDART_INF_F;
        ai[a][j] = g_sentinel;
      }
      cm[a] = 0.f;
      cb[a] = g_sentinel;
      mb[a] = false;
    }

#pragma unroll 1
    for (int g = 0; g < gch; ++g) {
      const int id = ids[g];
      const float4 q = gq[g];
      if (q.w == 0.f) {
        // masked row: the plain version's constants
#pragma unroll
        for (int a = 0; a < kA; ++a) {
          *kp[a] = -1e9f;
          kp[a] += n_all;
          if (-1e9f > v[a][2]) top3_merge(v[a], ai[a], -1e9f, id);
        }
        continue;
      }
      float r[kRec * 4];
      const float4* rp = rec + (g * m + mi) * kRec;
#pragma unroll
      for (int k = 0; k < kRec; ++k) {
        const float4 x = rp[k];
        r[4 * k] = x.x;
        r[4 * k + 1] = x.y;
        r[4 * k + 2] = x.z;
        r[4 * k + 3] = x.w;
      }
      const float twhg[3] = {q.x, q.y, q.z};
      const float gmask = q.w;
      // the anchors' geometry up to the bound's division, branch-free, so
      // that the two anchors' chains interleave
      float p_iou[kA], inter[kA], denom[kA], d2[kA];
      bool maybe[kA];
#pragma unroll
      for (int a = 0; a < kA; ++a) {
        const float4 bb = bt[g * group + a * cpb + lc];
        const float bs[3] = {bb.x, bb.y, bb.z};
        float pa = 0.f;
        bool in_a = true, sep_a = false;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const float aa = fabsf(bs[i] + r[kCorr + i]);
          in_a = in_a && (aa <= r[kLoA + i]);
          sep_a = sep_a || (aa > r[kHiA + i]);
          const float wa = fmaxf(
              fminf(fminf(r[kHiA + i] - aa, twhg[i]), r[kTwHap + i]), 0.f);
          pa = i == 0 ? wa : pa * wa;
          if (i == 0) d2[a] = aa * aa;
          if (i == 1) d2[a] = d2[a] + aa * aa;
        }
        float pb = 0.f;
        bool in_b = true, sep_b = false;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const float ab = fabsf(r[kCgv + j] - cov[a][j] - coffv[j]);
          in_b = in_b && (ab <= r[kLoB + j]);
          sep_b = sep_b || (ab > r[kHiB + j]);
          const float wb = fmaxf(
              fminf(fminf(r[kHiB + j] - ab, twc[j]), r[kTwHgp + j]), 0.f);
          pb = j == 0 ? wb : pb * wb;
        }
        p_iou[a] = (in_a ? r[kRatioA] : (in_b ? r[kRatioB] : 0.f)) * gmask;
        inter[a] = fminf(fminf(pa, pb), r[kVmin]);
        denom[a] = r[kVsum] - inter[a];
        maybe[a] = !(sep_a || sep_b) && gmask > 0.f;
      }
      float d_axis[kA];
#pragma unroll
      for (int a = 0; a < kA; ++a) d_axis[a] = sqrtf(d2[a]);
#pragma unroll
      for (int a = 0; a < kA; ++a) {
        float ub = 0.f;
        if (denom[a] > 1e-6f) {
          ub = inter[a] == 0.f ? inter[a]
                               : inter[a] / fmaxf(denom[a], 1e-6f);
        }
        const float p_key =
            gmask > 0.f ? ub - kTiebreakEps * d_axis[a] : -1e9f;
        *kp[a] = p_key;
        kp[a] += n_all;
        // the (GT, cell) maximum over combos: the IoUs are +0 or
        // positive (boxes with non-negative dims), so the largest float is
        // the largest int of the same bits
        if (p_iou[a] > 0.f) {
          atomicMax(rm + g * group + a * cpb + lc, __float_as_int(p_iou[a]));
        }
        const bool better = p_iou[a] > cm[a];
        cm[a] = better ? p_iou[a] : cm[a];
        cb[a] = better ? id : cb[a];
        mb[a] = mb[a] || maybe[a];
        // a key at or below the third slot changes no slot
        if (p_key > v[a][2]) top3_merge(v[a], ai[a], p_key, id);
      }
    }
#pragma unroll
    for (int a = 0; a < kA; ++a) {
      outf[0 * n_all + n[a]] = cm[a];
      outf[1 * n_all + n[a]] = v[a][0];
      outf[2 * n_all + n[a]] = v[a][1];
      outf[3 * n_all + n[a]] = v[a][2];
      outi[0 * n_all + n[a]] = cb[a];
      outi[1 * n_all + n[a]] = ai[a][0];
      outi[2 * n_all + n[a]] = ai[a][1];
      outi[3 * n_all + n[a]] = ai[a][2];
      outi[4 * n_all + n[a]] = mb[a] ? 1 : 0;
    }
    if (cell0 + stride < nc) fill_base(buf ^ 1, cell0 + stride);
    __syncthreads();
    // per-(GT, cell) containment maxima over the cell's M combos (+0 for a
    // masked row), each entry cleared for group r + 2 once read
    for (int e = t; e < gch * group; e += threads) {
      const int g = e / group;
      const int c = e - g * group;
      if (cell0 + c < nc) {
        rmax[static_cast<long long>(g) * nc + cell0 + c] =
            __int_as_float(rm[e]);
      }
      rm[e] = 0;
    }
  }
}

// ---- K4 ------------------------------------------------------------------

constexpr int kCells4 = kMaxThreads;  // cells per K4 group, one per thread

// torch.clamp(x, min=lo): NaN stays NaN (fmaxf would return lo)
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}

// Byte offsets of K4's shared memory: the (GT, combo) records at 0 (3
// float4: corr, hg - hap, cgv, chalf - hgp), then the per-thread cell
// centres on the combo axes (one column per thread and combo slot), two
// hit buffers of a group's anchors (one byte each), the per-GT table, the
// rescue thresholds, the combo table, the (GT, combo) flags, the list of
// live pairs, the combos' slots and the pair count.
struct ResLayout {
  size_t cov, hits, ft, rt, combo, flags, pairs, cslot, count, total;
};

inline ResLayout res_layout(int gch, int m) {
  const size_t gm = static_cast<size_t>(gch) * m;
  ResLayout l;
  l.cov = gm * 3 * 16;
  l.hits = l.cov + static_cast<size_t>(m) * 3 * kCells4 * 4;
  l.ft = l.hits + 2 * static_cast<size_t>(m) * kCells4;
  l.rt = l.ft + static_cast<size_t>(gch) * kFtab * 4;
  l.combo = l.rt + static_cast<size_t>(gch) * 2 * 4;
  l.flags = l.combo + 16 * static_cast<size_t>(m) * 4;
  l.pairs = l.flags + gm * 4;
  l.cslot = l.pairs + gm * 4;
  l.count = l.cslot + static_cast<size_t>(m) * 4;
  l.total = l.count + 4;
  return l;
}

// rthr: (gch, 2) row max and rescue flag per GT; out: (nc * m,) int32,
// 16-byte aligned.  Thread t owns cell t of each group of kCells4 cells in
// the pair pass and quads of the group's anchors in the store pass.
__global__ void __launch_bounds__(kMaxThreads)
rescue_kernel(const float* __restrict__ ftab, const float* __restrict__ rthr,
              const float* __restrict__ tabs,
              const float* __restrict__ combo,
              const float* __restrict__ cells, int gch, int m, int nc,
              ResLayout L, int* __restrict__ out) {
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  const float4* rec = smem4;
  float* cov = reinterpret_cast<float*>(smem + L.cov);
  unsigned char* hits = smem + L.hits;
  float* ft = reinterpret_cast<float*>(smem + L.ft);
  float* rt = reinterpret_cast<float*>(smem + L.rt);
  float* cb = reinterpret_cast<float*>(smem + L.combo);
  int* flags = reinterpret_cast<int*>(smem + L.flags);
  int* pairs = reinterpret_cast<int*>(smem + L.pairs);
  int* cslot = reinterpret_cast<int*>(smem + L.cslot);
  int* count = reinterpret_cast<int*>(smem + L.count);
  const int t = threadIdx.x;
  const int threads = blockDim.x;
  const int gm = gch * m;
  const long long n_all = static_cast<long long>(nc) * m;

  for (int k = t; k < gch * kFtab; k += threads) ft[k] = ftab[k];
  for (int k = t; k < gch * 2; k += threads) rt[k] = rthr[k];
  for (int k = t; k < 16 * m; k += threads) cb[k] = combo[k];
  for (int k = t; k < 2 * m * kCells4 / 4; k += threads) {
    reinterpret_cast<unsigned*>(hits)[k] = 0u;
  }
  __syncthreads();
  // the flags A, B, T of every (GT, combo) (the note at the top) and, where
  // fa or fb holds, its record
  for (int e = t; e < gm; e += threads) {
    const int g = e / m;
    const int mi = e - g * m;
    const float* f = ft + g * kFtab;
    const float volg = f[15];
    const float gmask = f[16];
    const float cvol = cb[12 * m + mi];
    const float row_max = rt[2 * g];
    const bool ok = rt[2 * g + 1] > 0.f;
    const float iou_a = cvol / clamp_min(volg, 1e-6f) * gmask;
    const float iou_b = volg / clamp_min(cvol, 1e-6f) * gmask;
    const bool fa = iou_a >= row_max && ok && iou_a > 0.f;
    const bool fb = iou_b >= row_max && ok && iou_b > 0.f;
    int fl = 0;
    if (fa || fb) {
      float r[12];
      bool fit_a = true, fit_b = true;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const int row = g * 3 + i;
        r[i] = tabs[(2 * gch * 3 + row) * m + mi];
        r[3 + i] = f[9 + i] - tabs[(0 * gch * 3 + row) * m + mi];
        r[6 + i] = tabs[(3 * gch * 3 + row) * m + mi];
        r[9 + i] = cb[(9 + i) * m + mi] - tabs[(1 * gch * 3 + row) * m + mi];
        fit_a = fit_a && r[3 + i] >= 0.f;
        fit_b = fit_b && r[9 + i] >= 0.f;
      }
      const bool live_a = fa && fit_a;
      const bool live_b = fb && fit_b;
      if (live_a || live_b) {
        fl = (live_a ? 1 : 0) | (live_b ? 2 : 0) | (fit_a ? 4 : 0);
      }
      float4* dst = smem4 + 3 * e;
      dst[0] = make_float4(r[0], r[1], r[2], r[3]);
      dst[1] = make_float4(r[4], r[5], r[6], r[7]);
      dst[2] = make_float4(r[8], r[9], r[10], r[11]);
    }
    flags[e] = fl;
  }
  __syncthreads();
  // warp 0: the live pairs in ascending (GT, combo), packed as g << 16 |
  // combo << 3 | T << 2 | B << 1 | A, and a slot of the per-thread
  // cell-centre table for every combo that some pair tests in_b on
  if (t < 32) {
    const unsigned below = (1u << t) - 1u;
    int np = 0;
    for (int e0 = 0; e0 < gm; e0 += 32) {
      const int e = e0 + t;
      const int fl = e < gm ? flags[e] : 0;
      const unsigned live = __ballot_sync(0xffffffffu, fl != 0);
      if (fl != 0) {
        const int g = e / m;
        pairs[np + __popc(live & below)] = g << 16 | (e - g * m) << 3 | fl;
      }
      np += __popc(live);
    }
    int nfb = 0;
    for (int m0 = 0; m0 < m; m0 += 32) {
      const int mi = m0 + t;
      bool fb = false;
      for (int g = 0; mi < m && g < gch; ++g) {
        fb = fb || (flags[g * m + mi] & 2) != 0;
      }
      const unsigned used = __ballot_sync(0xffffffffu, fb);
      if (mi < m) cslot[mi] = fb ? nfb + __popc(used & below) : -1;
      nfb += __popc(used);
    }
    if (t == 0) count[0] = np;
  }
  __syncthreads();
  const int np = count[0];

  if (np == 0) {
    // no live pair: every output is 0, written at the streaming rate
    fill(out, n_all, 0, static_cast<long long>(blockIdx.x) * threads + t,
         static_cast<long long>(gridDim.x) * threads);
    return;
  }
  // one barrier per group: group r marks its hits in buffer r % 2, which
  // the store pass of group r - 2 cleared before the barrier of group r - 1
  int buf = 0;
#pragma unroll 1
  for (int cell0 = blockIdx.x * kCells4; cell0 < nc;
       cell0 += gridDim.x * kCells4, buf ^= 1) {
    unsigned char* hb = hits + buf * m * kCells4;
    // a thread past the last cell tests the last cell again; its hits lie
    // beyond the output and are not stored
    const int cell = min(cell0 + t, nc - 1);
    const float c0 = cells[cell * 3];
    const float c1 = cells[cell * 3 + 1];
    const float c2 = cells[cell * 3 + 2];
    // the cell centre on the axes of every combo with a B pair, once per
    // thread, into this thread's column
    for (int mi = 0; mi < m; ++mi) {
      const int k = cslot[mi];
      if (k < 0) continue;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        cov[(k * 3 + j) * kCells4 + t] = cb[(0 * 3 + j) * m + mi] * c0 +
                                         cb[(1 * 3 + j) * m + mi] * c1 +
                                         cb[(2 * 3 + j) * m + mi] * c2;
      }
    }
    // the live pairs, GT by GT: the cell centre on the GT's axes (`base`)
    // once per (GT, cell) where some pair of the GT tests in_a, then the
    // interval tests
    int g_base = -1;
    float b0 = 0.f, b1 = 0.f, b2 = 0.f;
#pragma unroll 1
    for (int pi = 0; pi < np; ++pi) {
      const int w = pairs[pi];
      const int g = w >> 16;
      const int mi = (w >> 3) & 0x1fff;
      const float4* r = rec + 3 * (g * m + mi);
      const float4 r1 = r[1];
      bool in_a = false;
      if ((w & 4) != 0) {
        if (g != g_base) {
          const float* f = ft + g * kFtab;
          b0 = f[0] * c0 + f[3] * c1 + f[6] * c2 - f[12];
          b1 = f[1] * c0 + f[4] * c1 + f[7] * c2 - f[13];
          b2 = f[2] * c0 + f[5] * c1 + f[8] * c2 - f[14];
          g_base = g;
        }
        const float4 r0 = r[0];
        in_a = fabsf(b0 + r0.x) <= r0.w && fabsf(b1 + r0.y) <= r1.x &&
               fabsf(b2 + r0.z) <= r1.y;
      }
      bool hit = false;
      if (in_a) {
        hit = (w & 1) != 0;
      } else if ((w & 2) != 0) {
        const float4 r2 = r[2];
        const float* cv = cov + cslot[mi] * 3 * kCells4 + t;
        hit = fabsf(r1.z - cv[0] - cb[13 * m + mi]) <= r2.y &&
              fabsf(r1.w - cv[kCells4] - cb[14 * m + mi]) <= r2.z &&
              fabsf(r2.x - cv[2 * kCells4] - cb[15 * m + mi]) <= r2.w;
      }
      if (hit) hb[t * m + mi] = 1;
    }
    __syncthreads();
    // the group's flags out, four anchors (16 bytes) per thread, each word
    // cleared for group r + 2
    const long long n0 = static_cast<long long>(cell0) * m;
    unsigned* h32 = reinterpret_cast<unsigned*>(hb);
    for (int q = t; q < kCells4 * m / 4; q += threads) {
      const unsigned x = h32[q];
      h32[q] = 0u;
      const long long n = n0 + 4 * q;
      const int v[4] = {static_cast<int>(x & 0xff),
                        static_cast<int>((x >> 8) & 0xff),
                        static_cast<int>((x >> 16) & 0xff),
                        static_cast<int>(x >> 24)};
      if (n + 4 <= n_all) {
        *reinterpret_cast<int4*>(out + n) = make_int4(v[0], v[1], v[2], v[3]);
      } else {
        for (int k = 0; k < 4 && n + k < n_all; ++k) out[n + k] = v[k];
      }
    }
  }
}

// Checks the shapes, sets the kernel's shared memory above 48 KB; returns
// 0 or a CUDA error.
template <typename Kernel>
int set_smem(Kernel kernel, int gch, int m, int nc, size_t smem) {
  if (gch <= 0 || m <= 0 || m > kMaxThreads || nc <= 0 ||
      smem > 227 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {
    return static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem)));
  }
  return 0;
}

// Persistent blocks of `threads` threads: as many as fit on the card at
// once, at most one per group.  Returns 0 or a CUDA error.
template <typename Kernel>
int persistent_blocks(Kernel kernel, int threads, size_t smem, int groups,
                      int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  *blocks = groups < sms * per_sm ? groups : sms * per_sm;
  return 0;
}

}  // namespace

// K3.  ftab: (gch, 17) f32; gid: (gch,) int32; tabs: (4, gch*3, m) f32;
// combo: (16, m) f32; cells: (nc, 3) f32.  Outputs: key (gch, nc*m) f32;
// outf (4, nc*m) f32 = cm, v1, v2, v3; outi (5, nc*m) int32 = cb, a1, a2,
// a3, mb; rmax (gch, nc) f32.  Returns cudaGetLastError() after the launch.
extern "C" int chunk_geometry(const void* ftab, const void* gid,
                              const void* tabs, const void* combo,
                              const void* cells, int gch, int m, int nc,
                              int g_sentinel, void* key, void* outf,
                              void* outi, void* rmax, void* stream) {
  const int cpb = m > 0 ? kMaxThreads / m : 0;
  const GeoLayout L = geo_layout(gch, m, cpb);
  int err = set_smem(geometry_kernel, gch, m, nc, L.total);
  if (err != 0) return err;
  int blocks = 0;
  err = persistent_blocks(geometry_kernel, cpb * m, L.total,
                          (nc + kA * cpb - 1) / (kA * cpb), &blocks);
  if (err != 0) return err;
  geometry_kernel<<<blocks, cpb * m, L.total,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ftab), static_cast<const int*>(gid),
      static_cast<const float*>(tabs), static_cast<const float*>(combo),
      static_cast<const float*>(cells), gch, m, nc, cpb, g_sentinel, L,
      static_cast<float*>(key), static_cast<float*>(outf),
      static_cast<int*>(outi), static_cast<float*>(rmax));
  return static_cast<int>(cudaGetLastError());
}

// K4.  As K3's inputs with rthr: (gch, 2) f32 (row max, rescue flag);
// out: (nc*m,) int32, 16-byte aligned.
extern "C" int containment_rescue(const void* ftab, const void* rthr,
                                  const void* tabs, const void* combo,
                                  const void* cells, int gch, int m, int nc,
                                  void* out, void* stream) {
  if (gch >= (1 << 15) || (reinterpret_cast<uintptr_t>(out) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ResLayout L = res_layout(gch, m);
  int err = set_smem(rescue_kernel, gch, m, nc, L.total);
  if (err != 0) return err;
  int blocks = 0;
  err = persistent_blocks(rescue_kernel, kMaxThreads, L.total,
                          (nc + kCells4 - 1) / kCells4, &blocks);
  if (err != 0) return err;
  rescue_kernel<<<blocks, kMaxThreads, L.total,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ftab), static_cast<const float*>(rthr),
      static_cast<const float*>(tabs), static_cast<const float*>(combo),
      static_cast<const float*>(cells), gch, m, nc, L,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
