// Designs of marching tetrahedra (mt_count / mt_emit) that the package does
// not ship, built beside the package's kernels for scripts/mt_variants.py
// to time against them on the card. Includes the package's source, so
// every design shares its tables, Slab, block_scan and arithmetic.
//
// A variant is five bits, each one change of the package's design over the
// previous one (one thread a cell in both passes, a cumulative sum between
// them, 64-bit cell arithmetic, the tables read from constant memory):
//   1 kInt32    32-bit cell arithmetic (else 64-bit division and modulo)
//   2 kTab      the tables in global memory (the count pass reads them
//               there, the emit pass copies them into shared memory) and
//               the tets' corners as compile-time constants so that a
//               cell's 8 values stay in registers (else constant memory,
//               the corners indexed at run time)
//   4 kFold     the scan folded into the kernels: mt_count's blocks
//               publish their sums and add them to the total, mt_emit's
//               blocks sum their predecessors' and scan their own counts
//               (else per-cell counts and the caller's cumulative sum)
//   8 kPerTri   one thread a triangle from descriptors in shared memory,
//               its corners re-read through the cache, stores staged and
//               coalesced (else one thread a cell writing its triangles
//               with scalar stores)
//  16 kCases    mt_count stores each cell's packed cases and count, and
//               mt_emit reads them in place of the 8 corners and the cases,
//               loading corners for live cells only
// 0 is the previous design, 31 the package's.
#include "../instantvnr_torch/csrc/isosurface.cu"

namespace {

// the previous design's tables in constant memory, copied from the
// package's once (init_constant_tables)
__constant__ signed char cTets[6][4];
__constant__ signed char cEdgePairs[6][2];
__constant__ signed char cCaseTris[6][16][2][3];

int init_constant_tables() {
  static int rc = -1;
  if (rc >= 0) return rc;
  signed char tets[6][4], pairs[6][2], tris[6][16][2][3];
  rc = cudaMemcpyFromSymbol(tets, kTets, sizeof(tets));
  if (!rc) rc = cudaMemcpyFromSymbol(pairs, kEdgePairs, sizeof(pairs));
  if (!rc) rc = cudaMemcpyFromSymbol(tris, kCaseTris, sizeof(tris));
  if (!rc) rc = cudaMemcpyToSymbol(cTets, tets, sizeof(tets));
  if (!rc) rc = cudaMemcpyToSymbol(cEdgePairs, pairs, sizeof(pairs));
  if (!rc) rc = cudaMemcpyToSymbol(cCaseTris, tris, sizeof(tris));
  return rc;
}

// a tet's triangle count for the count pass: the package's global table,
// or constant memory
template <bool kTab>
__device__ __forceinline__ int count_tris(int t, int cs) {
  if (kTab) return case_tris(t, cs);
  return (cCaseTris[t][cs][0][0] >= 0 ? 1 : 0) +
         (cCaseTris[t][cs][1][0] >= 0 ? 1 : 0);
}

// and for the emit pass: the shared-memory tables, or constant
// memory
template <bool kTab>
__device__ __forceinline__ int ntris(const Tables& tab, int t, int cs) {
  if (kTab) return tri_count(tab, t, cs);
  return count_tris<false>(t, cs);
}

template <bool kTab>
__device__ __forceinline__ int tri_edge(const Tables& tab, int t, int cs,
                                        int j, int v) {
  if (kTab) return tab.tris[t][cs][j][v];
  return cCaseTris[t][cs][j][v];
}

template <bool kTab>
__device__ __forceinline__ void edge_corners(const Tables& tab, int t, int e,
                                             int& ca, int& cb) {
  if (kTab) {
    ca = tab.tets[t][tab.pairs[e][0]];
    cb = tab.tets[t][tab.pairs[e][1]];
  } else {
    ca = cTets[t][cEdgePairs[e][0]];
    cb = cTets[t][cEdgePairs[e][1]];
  }
}

template <bool kInt32>
__device__ __forceinline__ void vcoords(const Slab& s, long long i, int& x,
                                        int& y, int& z) {
  if (kInt32) {
    cell_coords(s, static_cast<int>(i), x, y, z);
  } else {
    x = static_cast<int>(i % s.nx);
    y = static_cast<int>((i / s.nx) % s.ny);
    z = static_cast<int>(i / (static_cast<long long>(s.nx) * s.ny));
  }
}

// a cell's corners
template <bool kInt32>
__device__ __forceinline__ void load_corners(const Slab& s, long long i,
                                             float (&v)[8]) {
  int x, y, z;
  vcoords<kInt32>(s, i, x, y, z);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (kInt32) {
      v[k] = __ldg(s.grid + corner_index(s, x, y, z, k));
    } else {
      v[k] = __ldg(s.grid + (static_cast<long long>(z + (k >> 2)) * s.sy +
                             y + ((k >> 1) & 1)) * s.sx + x + (k & 1));
    }
  }
}

template <bool kInt32, bool kTab>
__device__ __forceinline__ int vcell(const Slab& s, long long i, float iso,
                                     float (&v)[8], uint32_t& cases) {
  load_corners<kInt32>(s, i, v);
  constexpr int kTetCorners[6][4] = {{0, 1, 3, 7}, {0, 1, 5, 7},
                                     {0, 2, 3, 7}, {0, 2, 6, 7},
                                     {0, 4, 5, 7}, {0, 4, 6, 7}};
  cases = 0;
  int count = 0;
#pragma unroll
  for (int t = 0; t < 6; ++t) {
    int cs = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = kTab ? kTetCorners[t][j] : cTets[t][j];
      cs |= (v[c] > iso ? 1 : 0) << j;
    }
    cases |= static_cast<uint32_t>(cs) << (4 * t);
    count += count_tris<kTab>(t, cs);
  }
  return count;
}

// one vertex on the tet's edge e of a cell: position and edge ids
template <bool kTab>
__device__ __forceinline__ void vertex(const Tables& tab, int t, int e,
                                       const float* cv, float iso,
                                       const float (&base)[3],
                                       const int (&ibase)[3], int sx,
                                       float* tp, int* ip) {
  int ca, cb;
  edge_corners<kTab>(tab, t, e, ca, cb);
  const float va = cv[ca], vb = cv[cb];
  const float denom = __fsub_rn(vb, va);
  float tt =
      fabsf(denom) > 1e-12f ? __fdiv_rn(__fsub_rn(iso, va), denom) : 0.5f;
  tt = tt < 0.0f ? 0.0f : (tt > 1.0f ? 1.0f : tt);
  const int oa[3] = {ca & 1, (ca >> 1) & 1, (ca >> 2) & 1};
  const int ob[3] = {cb & 1, (cb >> 1) & 1, (cb >> 2) & 1};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float pa = static_cast<float>(oa[a]);
    const float pb = static_cast<float>(ob[a]);
    tp[a] = __fadd_rn(__fadd_rn(base[a], pa),
                      __fmul_rn(tt, __fsub_rn(pb, pa)));
  }
  ip[0] = ibase[2] + oa[2];
  ip[1] = (ibase[1] + oa[1]) * sx + ibase[0] + oa[0];
  ip[2] = ibase[2] + ob[2];
  ip[3] = (ibase[1] + ob[1]) * sx + ibase[0] + ob[0];
}

template <bool kInt32, bool kTab, bool kFold, bool kCases>
__global__ void __launch_bounds__(kCells)
mtv_count_kernel(Slab s, float iso, int* __restrict__ counts,
                 long long* __restrict__ ws, uint32_t* __restrict__ cases) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kCells + threadIdx.x;
  int count = 0;
  if (i < s.n) {
    float v[8];
    uint32_t c;
    count = vcell<kInt32, kTab>(s, i, iso, v, c);
    if (kCases) cases[i] = c | static_cast<uint32_t>(count) << 24;
  }
  if (!kFold) {
    if (i < s.n) counts[i] = count;
    return;
  }
  publish(ws, block_sum(count));
}

// ends: the inclusive cumulative sum of the counts (kFold false) or
// mt_count's workspace (kFold true); cases: its packed cases (kCases)
template <bool kInt32, bool kTab, bool kFold, bool kPerTri, bool kCases>
__global__ void __launch_bounds__(kCells)
mtv_emit_kernel(Slab s, float iso, int z_offset,
                const long long* __restrict__ ends,
                const uint32_t* __restrict__ cases_in,
                float* __restrict__ tris, int* __restrict__ ids) {
  __shared__ Tables tab;
  __shared__ uint32_t cell_cases[kCells];
  __shared__ uint16_t desc[kPerTri ? kCells * 12 : 1];
  __shared__ float out_t[kPerTri ? kCells * 9 : 1];
  __shared__ int out_i[kPerTri ? kCells * 12 : 1];
  __shared__ long long block_out0;
  if (kFold && ends[1 + blockIdx.x] == 0) return;  // a block without any
  if (kTab && !kPerTri) {
    load_tables(tab);
    __syncthreads();
  }
  const int tid = threadIdx.x;
  const long long first = static_cast<long long>(blockIdx.x) * kCells;
  const long long i = first + tid;
  int count = 0;
  float v[8];
  uint32_t cases = 0;
  if (i < s.n) {
    if (kCases) {
      cases = cases_in[i];
      count = static_cast<int>(cases >> 24);
      cases &= 0xffffffu;
    } else {
      count = vcell<kInt32, kTab>(s, i, iso, v, cases);
    }
  }
  if (!kPerTri) {
    long long out;
    if (kFold) {
      int total;
      out = block_sum64(preceding_part(ends)) + block_scan(count, total);
    } else {
      if (count == 0) return;
      out = ends[i] - count;
    }
    if (count == 0) return;
    if (kCases) load_corners<kInt32>(s, i, v);
    int x, y, z;
    vcoords<kInt32>(s, i, x, y, z);
    const float base[3] = {static_cast<float>(x), static_cast<float>(y),
                           __fadd_rn(static_cast<float>(z),
                                     static_cast<float>(z_offset))};
    const int ibase[3] = {x, y, z + z_offset};
    for (int t = 0; t < 6; ++t) {
      const int cs = (cases >> (4 * t)) & 15;
      const int n_t = ntris<kTab>(tab, t, cs);
      for (int j = 0; j < n_t; ++j) {
        for (int vv = 0; vv < 3; ++vv)
          vertex<kTab>(tab, t, tri_edge<kTab>(tab, t, cs, j, vv), v, iso,
                       base, ibase, s.sx, tris + out * 9 + vv * 3,
                       ids + out * 12 + vv * 4);
        ++out;
      }
    }
    return;
  }
  cell_cases[tid] = cases;
  int total;
  int o = block_scan(count, total);
  if (total == 0) return;
  if (kTab) {
    load_tables(tab);
    __syncthreads();
  }
  if (!kFold && tid == 0) block_out0 = ends[i] - count;
  if (count) {
    for (int t = 0; t < 6; ++t) {
      const int n_t = ntris<kTab>(tab, t, (cases >> (4 * t)) & 15);
      for (int j = 0; j < n_t; ++j)
        desc[o++] = static_cast<uint16_t>(tid | t << 8 | j << 11);
    }
  }
  long long out0;
  if (kFold) {
    out0 = block_sum64(preceding_part(ends));  // (its sync orders desc)
  } else {
    __syncthreads();
    out0 = block_out0;
  }
  for (int r0 = 0; r0 < total; r0 += kCells) {
    const int m = min(kCells, total - r0);
    if (tid < m) {
      const int d = desc[r0 + tid];
      const int cl = d & 255, t = (d >> 8) & 7, j = d >> 11;
      float cv[8];
      load_corners<kInt32>(s, first + cl, cv);
      int x, y, z;
      vcoords<kInt32>(s, first + cl, x, y, z);
      const int cs = (cell_cases[cl] >> (4 * t)) & 15;
      const float base[3] = {static_cast<float>(x), static_cast<float>(y),
                             __fadd_rn(static_cast<float>(z),
                                       static_cast<float>(z_offset))};
      const int ibase[3] = {x, y, z + z_offset};
      for (int vv = 0; vv < 3; ++vv)
        vertex<kTab>(tab, t, tri_edge<kTab>(tab, t, cs, j, vv), cv, iso,
                     base, ibase, s.sx, out_t + tid * 9 + vv * 3,
                     out_i + tid * 12 + vv * 4);
    }
    __syncthreads();
    float* gt = tris + (out0 + r0) * 9;
    int* gi = ids + (out0 + r0) * 12;
    for (int e = tid; e < m * 9; e += kCells) gt[e] = out_t[e];
    for (int e = tid; e < m * 12; e += kCells) gi[e] = out_i[e];
    __syncthreads();
  }
}

template <int V>
void launch_count(unsigned blocks, cudaStream_t st, const Slab& s, float iso,
                  void* out, void* cases) {
  mtv_count_kernel<(V & 1) != 0, (V & 2) != 0, (V & 4) != 0, (V & 16) != 0>
      <<<blocks, kCells, 0, st>>>(s, iso, static_cast<int*>(out),
                                  static_cast<long long*>(out),
                                  static_cast<uint32_t*>(cases));
}

template <int V>
void launch_emit(unsigned blocks, cudaStream_t st, const Slab& s, float iso,
                 int z_offset, const void* ends, const void* cases,
                 void* tris, void* ids) {
  const long long* e = static_cast<const long long*>(ends);
  mtv_emit_kernel<(V & 1) != 0, (V & 2) != 0, (V & 4) != 0, (V & 8) != 0,
                  (V & 16) != 0><<<blocks, kCells, 0, st>>>(
      s, iso, z_offset, e, static_cast<const uint32_t*>(cases),
      static_cast<float*>(tris), static_cast<int*>(ids));
}

template <int V = 0>
int dispatch(int variant, bool count, unsigned blocks, cudaStream_t st,
             const Slab& s, float iso, int z_offset, const void* in,
             void* out, void* cases, void* tris, void* ids) {
  if constexpr (V < 32) {
    if (variant != V)
      return dispatch<V + 1>(variant, count, blocks, st, s, iso, z_offset, in,
                             out, cases, tris, ids);
    if (count)
      launch_count<V>(blocks, st, s, iso, out, cases);
    else
      launch_emit<V>(blocks, st, s, iso, z_offset, in, cases, tris, ids);
    return cudaGetLastError();
  } else {
    return cudaErrorInvalidValue;
  }
}

}  // namespace

// variant bit 4 (kFold): out is mt_count's workspace (int64 [1 + blocks],
// zero on entry); else int32 counts [cells]; cases: uint32
// [cells], written with bit 16 (kCases)
extern "C" int mt_variant_count(const void* grid, float iso, int sz, int sy,
                                int sx, void* out, void* cases, void* stream,
                                int variant) {
  if (sz < 2 || sy < 2 || sx < 2) return cudaSuccess;
  Slab s;
  if (!make_slab(grid, sz, sy, sx, s)) return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>((s.n + kCells - 1) / kCells);
  if (const int rc = init_constant_tables()) return rc;
  return dispatch(variant, true, blocks, static_cast<cudaStream_t>(stream),
                  s, iso, 0, nullptr, out, cases, nullptr, nullptr);
}

// ends: the workspace (kFold) or the inclusive int64 cumulative sum of the
// counts; cases: mt_variant_count's (kCases)
extern "C" int mt_variant_emit(const void* grid, float iso, int z_offset,
                               int sz, int sy, int sx, const void* ends,
                               void* cases, void* tris, void* ids,
                               void* stream, int variant) {
  if (sz < 2 || sy < 2 || sx < 2) return cudaSuccess;
  Slab s;
  if (!make_slab(grid, sz, sy, sx, s)) return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>((s.n + kCells - 1) / kCells);
  if (const int rc = init_constant_tables()) return rc;
  return dispatch(variant, false, blocks, static_cast<cudaStream_t>(stream),
                  s, iso, z_offset, ends, nullptr, cases, tris, ids);
}
