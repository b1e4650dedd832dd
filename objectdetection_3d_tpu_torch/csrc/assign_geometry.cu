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
// arrays (69 MB) for some 200 float operations per (GT, anchor) pair; K4
// writes 7.7 MB for about a third of that work.
//
// Design: one thread per anchor n = cell * M + m, the flat cell-major order
// of the anchor grid (the TPU kernel's combo-major layout exists only for
// its lane width).  The per-GT tables and the 16 x M combo table sit in
// shared memory.  Each thread walks the chunk's GTs in ascending id, so
// the containment max keeps the first achiever and the top-3 merge's
// strict `>` keeps the incumbent on ties, as in the TPU body.  The M
// anchors of a cell are neighbouring threads of one block, so the
// per-(GT, cell) maxima over combos are reduced through shared memory.
// The arithmetic is the plain version's (ops/assign_geometry.py) operation
// for operation, and the build passes -fmad=false, so the two agree bit
// for bit.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr float kTiebreakEps = 1e-6f;
constexpr int kMaxThreads = 256;
constexpr int kFtab = 17;  // u (9, row-major), hg (3), cg.u (3), volg, mask

// Shared tables of one launch.  tabs holds hap, hgp, corr and cgv, each
// (gch * 3, M): cross-projected anchor half-extents on the GT axes, GT
// half-extents on the combo axes, the combo offset on the GT axes and the
// GT centre on the combo axes.
struct Smem {
  float* ftab;   // (gch, 17)
  int* gid;      // (gch,)
  float* tabs;   // (4, gch * 3, M)
  float* combo;  // (16, M)
  float* iou;    // (gch, threads) containment IoUs, K3 only
};

__device__ Smem carve(float* base, int gch, int m, int threads,
                      bool with_iou) {
  Smem s;
  s.ftab = base;
  s.gid = reinterpret_cast<int*>(s.ftab + gch * kFtab);
  s.tabs = reinterpret_cast<float*>(s.gid + gch);
  s.combo = s.tabs + 4 * gch * 3 * m;
  s.iou = with_iou ? s.combo + 16 * m : nullptr;
  return s;
}

__device__ void load_tables(const Smem& s, const float* ftab, const int* gid,
                            const float* tabs, const float* combo, int gch,
                            int m) {
  for (int k = threadIdx.x; k < gch * kFtab; k += blockDim.x) {
    s.ftab[k] = ftab[k];
  }
  for (int k = threadIdx.x; k < gch; k += blockDim.x) {
    s.gid[k] = gid ? gid[k] : 0;
  }
  for (int k = threadIdx.x; k < 4 * gch * 3 * m; k += blockDim.x) {
    s.tabs[k] = tabs[k];
  }
  for (int k = threadIdx.x; k < 16 * m; k += blockDim.x) {
    s.combo[k] = combo[k];
  }
  __syncthreads();
}

// What one (GT, anchor) pair yields.
struct Pair {
  float iou;   // closed-form containment IoU, 0 unless one box holds the
               // other
  float key;   // ranking key: slab bound minus the axis-distance tiebreak
  bool maybe;  // not SAT-separated on the 6 face axes
};

// The anchor's frame: cell centre and combo m's constants.
struct Anchor {
  float cell[3];
  float cell_on_v[3];  // cell centre on the combo's axes
  float chalf[3];
  float coffv[3];      // combo offset on its own axes
  float cvol;
};

__device__ __forceinline__ Anchor load_anchor(const float* combo, int m,
                                              int mi, const float* cells,
                                              int cell) {
  Anchor a;
#pragma unroll
  for (int c = 0; c < 3; ++c) a.cell[c] = cells[cell * 3 + c];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    a.cell_on_v[j] = combo[(0 * 3 + j) * m + mi] * a.cell[0] +
                     combo[(1 * 3 + j) * m + mi] * a.cell[1] +
                     combo[(2 * 3 + j) * m + mi] * a.cell[2];
    a.chalf[j] = combo[(9 + j) * m + mi];
    a.coffv[j] = combo[(13 + j) * m + mi];
  }
  a.cvol = combo[12 * m + mi];
  return a;
}

// geometry of GT g against the anchor; `full` also computes the key and
// the SAT flag (K3), otherwise only the containment IoU (K4)
template <bool kFull>
__device__ __forceinline__ Pair pair_geometry(const Smem& s, int g, int gch,
                                              int m, int mi,
                                              const Anchor& a) {
  const float* ft = s.ftab + g * kFtab;
  const float* hap = s.tabs + (0 * gch * 3 + g * 3) * m;
  const float* hgp = s.tabs + (1 * gch * 3 + g * 3) * m;
  const float* corr = s.tabs + (2 * gch * 3 + g * 3) * m;
  const float* cgv = s.tabs + (3 * gch * 3 + g * 3) * m;
  const float volg = ft[15];
  const float gmask = ft[16];

  float pa = 0.f, d2 = 0.f;
  bool in_a = true, sep_a = false;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float hg = ft[9 + i];
    const float hap_i = hap[i * m + mi];
    const float base = ft[0 * 3 + i] * a.cell[0] +
                       ft[1 * 3 + i] * a.cell[1] +
                       ft[2 * 3 + i] * a.cell[2] - ft[12 + i];
    const float aa = fabsf(base + corr[i * m + mi]);
    in_a = in_a && (aa <= hg - hap_i);
    if (kFull) {
      sep_a = sep_a || (aa > hg + hap_i);
      const float wa = fmaxf(
          fminf(fminf(hg + hap_i - aa, 2.f * hg), 2.f * hap_i), 0.f);
      pa = i == 0 ? wa : pa * wa;
      if (i == 0) d2 = aa * aa;
      if (i == 1) d2 = d2 + aa * aa;
    }
  }
  float pb = 0.f;
  bool in_b = true, sep_b = false;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float hgp_j = hgp[j * m + mi];
    const float ab = fabsf(cgv[j * m + mi] - a.cell_on_v[j] - a.coffv[j]);
    in_b = in_b && (ab <= a.chalf[j] - hgp_j);
    if (kFull) {
      sep_b = sep_b || (ab > a.chalf[j] + hgp_j);
      const float wb = fmaxf(
          fminf(fminf(a.chalf[j] + hgp_j - ab, 2.f * a.chalf[j]),
                2.f * hgp_j),
          0.f);
      pb = j == 0 ? wb : pb * wb;
    }
  }
  const float ratio_a = a.cvol / fmaxf(volg, 1e-6f);
  const float ratio_b = volg / fmaxf(a.cvol, 1e-6f);
  Pair out;
  out.iou = (in_a ? ratio_a : (in_b ? ratio_b : 0.f)) * gmask;
  out.key = 0.f;
  out.maybe = false;
  if (kFull) {
    const float d_axis = sqrtf(d2);
    const float inter = fminf(fminf(pa, pb), fminf(volg, a.cvol));
    const float denom = volg + a.cvol - inter;
    const float ub = denom > 1e-6f ? inter / fmaxf(denom, 1e-6f) : 0.f;
    out.key = gmask > 0.f ? ub - kTiebreakEps * d_axis : -1e9f;
    out.maybe = !(sep_a || sep_b) && gmask > 0.f;
  }
  return out;
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

// outf: (4, n) cm, v1, v2, v3; outi: (5, n) cb, a1, a2, a3, mb;
// key: (gch, n); rmax: (gch, nc)
__global__ void __launch_bounds__(kMaxThreads)
geometry_kernel(const float* __restrict__ ftab, const int* __restrict__ gid,
                const float* __restrict__ tabs,
                const float* __restrict__ combo,
                const float* __restrict__ cells, int gch, int m, int nc,
                int cells_per_block, int g_sentinel,
                float* __restrict__ key, float* __restrict__ outf,
                int* __restrict__ outi, float* __restrict__ rmax) {
  extern __shared__ float smem_base[];
  const int threads = cells_per_block * m;
  const Smem s = carve(smem_base, gch, m, threads, true);
  load_tables(s, ftab, gid, tabs, combo, gch, m);

  const int t = threadIdx.x;
  const int cell0 = blockIdx.x * cells_per_block;
  const int cell = cell0 + t / m;
  const int mi = t % m;
  const bool live = cell < nc;
  const long long n_all = static_cast<long long>(nc) * m;
  const long long n = static_cast<long long>(cell) * m + mi;
  const Anchor a = load_anchor(s.combo, m, mi, cells, live ? cell : 0);

  float cm = 0.f;
  int cb = g_sentinel;
  bool mb = false;
  float v[3] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
  int ai[3] = {g_sentinel, g_sentinel, g_sentinel};
  for (int g = 0; g < gch; ++g) {
    const Pair p = pair_geometry<true>(s, g, gch, m, mi, a);
    const int id = s.gid[g];
    if (live) key[g * n_all + n] = p.key;
    s.iou[g * threads + t] = p.iou;
    const bool better = p.iou > cm;
    cm = better ? p.iou : cm;
    cb = better ? id : cb;
    mb = mb || p.maybe;
    top3_merge(v, ai, p.key, id);
  }
  if (live) {
    outf[0 * n_all + n] = cm;
    outf[1 * n_all + n] = v[0];
    outf[2 * n_all + n] = v[1];
    outf[3 * n_all + n] = v[2];
    outi[0 * n_all + n] = cb;
    outi[1 * n_all + n] = ai[0];
    outi[2 * n_all + n] = ai[1];
    outi[3 * n_all + n] = ai[2];
    outi[4 * n_all + n] = mb ? 1 : 0;
  }
  __syncthreads();
  // per-(GT, cell) containment maxima over the cell's M combos
  for (int e = t; e < gch * cells_per_block; e += threads) {
    const int g = e / cells_per_block;
    const int lc = e % cells_per_block;
    if (cell0 + lc >= nc) continue;
    const float* row = s.iou + g * threads + lc * m;
    float r = row[0];
    for (int k = 1; k < m; ++k) r = fmaxf(r, row[k]);
    rmax[static_cast<long long>(g) * nc + cell0 + lc] = r;
  }
}

// rthr: (gch, 2) row max and rescue flag per GT; out: (n,) int32
__global__ void __launch_bounds__(kMaxThreads)
rescue_kernel(const float* __restrict__ ftab, const float* __restrict__ rthr,
              const float* __restrict__ tabs,
              const float* __restrict__ combo,
              const float* __restrict__ cells, int gch, int m, int nc,
              int cells_per_block, int* __restrict__ out) {
  extern __shared__ float smem_base[];
  const int threads = cells_per_block * m;
  const Smem s = carve(smem_base, gch, m, threads, false);
  load_tables(s, ftab, nullptr, tabs, combo, gch, m);

  const int t = threadIdx.x;
  const int cell = blockIdx.x * cells_per_block + t / m;
  const int mi = t % m;
  if (cell >= nc) return;
  const Anchor a = load_anchor(s.combo, m, mi, cells, cell);
  bool hit = false;
  for (int g = 0; g < gch; ++g) {
    const Pair p = pair_geometry<false>(s, g, gch, m, mi, a);
    const float row_max = rthr[g * 2];
    const float ok = rthr[g * 2 + 1];
    hit = hit || (p.iou >= row_max && ok > 0.f && p.iou > 0.f);
  }
  out[static_cast<long long>(cell) * m + mi] = hit ? 1 : 0;
}

size_t smem_bytes(int gch, int m, int threads, bool with_iou) {
  size_t floats = static_cast<size_t>(gch) * kFtab + gch +
                  4 * static_cast<size_t>(gch) * 3 * m + 16 * m;
  if (with_iou) floats += static_cast<size_t>(gch) * threads;
  return floats * 4;
}

template <typename Kernel>
int prepare(Kernel kernel, int gch, int m, int nc, bool with_iou,
            int* cells_per_block, int* blocks, size_t* smem) {
  if (gch <= 0 || m <= 0 || m > kMaxThreads || nc <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *cells_per_block = kMaxThreads / m;
  *blocks = (nc + *cells_per_block - 1) / *cells_per_block;
  *smem = smem_bytes(gch, m, *cells_per_block * m, with_iou);
  if (*smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (*smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(*smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
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
  int cpb = 0, blocks = 0;
  size_t smem = 0;
  const int err = prepare(geometry_kernel, gch, m, nc, true, &cpb, &blocks,
                          &smem);
  if (err != 0) return err;
  geometry_kernel<<<blocks, cpb * m, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ftab), static_cast<const int*>(gid),
      static_cast<const float*>(tabs), static_cast<const float*>(combo),
      static_cast<const float*>(cells), gch, m, nc, cpb, g_sentinel,
      static_cast<float*>(key), static_cast<float*>(outf),
      static_cast<int*>(outi), static_cast<float*>(rmax));
  return static_cast<int>(cudaGetLastError());
}

// K4.  As K3's inputs with rthr: (gch, 2) f32 (row max, rescue flag);
// out: (nc*m,) int32.
extern "C" int containment_rescue(const void* ftab, const void* rthr,
                                  const void* tabs, const void* combo,
                                  const void* cells, int gch, int m, int nc,
                                  void* out, void* stream) {
  int cpb = 0, blocks = 0;
  size_t smem = 0;
  const int err = prepare(rescue_kernel, gch, m, nc, false, &cpb, &blocks,
                          &smem);
  if (err != 0) return err;
  rescue_kernel<<<blocks, cpb * m, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ftab), static_cast<const float*>(rthr),
      static_cast<const float*>(tabs), static_cast<const float*>(combo),
      static_cast<const float*>(cells), gch, m, nc, cpb,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
