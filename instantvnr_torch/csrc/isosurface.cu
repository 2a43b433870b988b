// Marching tetrahedra for Hopper, sm_90a: count, then emit, one thread a
// cell of a z-slab.
//
// Replaces instantvnr_tpu/ops/isosurface.py::_extract_slab (:87-193), XLA
// code that writes every one of the [N, 6, 2] triangle slots of a slab
// with a validity mask, and the host's boolean compaction of those slots
// in _extract_loop (:243-246). In plain PyTorch the dense emission writes
// 84 bytes for each slot, live or not (~260 MB a 128^3 slab of 16
// planes); here only the live triangles are written:
//
//   mt_count  each cell's 8 corners, the 6 Kuhn tets' cases against the
//             isovalue, the cell's live-triangle count (<= 12) → int32 [n]
//   (cumsum)  the caller's inclusive prefix sum gives each cell its end
//   mt_emit   the cases again; each live triangle written at the cell's
//             offset in the plain version's order (tet, then triangle):
//             positions base + pa + t·(pb − pa), ids (gz_a, gyx_a, gz_b,
//             gyx_b) of the lattice edge each vertex lies on
//
// Exactness: t = (iso − va)/(vb − va) by IEEE division, 0.5 where
// |vb − va| <= 1e-12, clamped to [0, 1] as torch.clamp (a NaN stays NaN);
// every sum and product rounds on its own (-fmad=false, and __fadd_rn /
// __fmul_rn here): the positions equal the plain version's bit for bit,
// which the exact weld on edge keys relies on.
//
// Bound on an H100, by bytes: the slab read once (4 B a voxel) and each
// live triangle written once (84 B: 36 B of positions, 48 B of ids). The
// second read of the slab, the counts and their sums are costs of the
// two-pass design and are not in the bound. In each pass a cell's 8
// corners come from the cache of its neighbours' reads.
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;

// the Kuhn/Freudenthal tets as cube corners (bit 0 +x, bit 1 +y, bit 2 +z)
__constant__ signed char kTets[6][4] = {
    {0, 1, 3, 7}, {0, 1, 5, 7}, {0, 2, 3, 7},
    {0, 2, 6, 7}, {0, 4, 5, 7}, {0, 4, 6, 7}};

// a tet's 6 edges as local corner pairs
__constant__ signed char kEdgePairs[6][2] = {
    {0, 1}, {0, 2}, {0, 3}, {1, 2}, {1, 3}, {2, 3}};

// per tet, per case (bit i = local corner i inside), up to 2 triangles of
// edge ids, -1 unused; the mirrored tets (1, 2, 5) wind reversed: the
// ops/isosurface.py::_CASE_TRIS_PER_TET table
__constant__ signed char kCaseTris[6][16][2][3] = {
    {{{-1,-1,-1},{-1,-1,-1}}, {{0,1,2},{-1,-1,-1}}, {{0,4,3},{-1,-1,-1}}, {{1,2,4},{1,4,3}},
     {{1,3,5},{-1,-1,-1}}, {{0,3,5},{0,5,2}}, {{0,4,5},{0,5,1}}, {{2,4,5},{-1,-1,-1}},
     {{2,5,4},{-1,-1,-1}}, {{0,5,4},{0,1,5}}, {{0,2,5},{0,5,3}}, {{1,5,3},{-1,-1,-1}},
     {{1,4,2},{1,3,4}}, {{0,3,4},{-1,-1,-1}}, {{0,2,1},{-1,-1,-1}}, {{-1,-1,-1},{-1,-1,-1}}},
    {{{-1,-1,-1},{-1,-1,-1}}, {{2,1,0},{-1,-1,-1}}, {{3,4,0},{-1,-1,-1}}, {{4,2,1},{3,4,1}},
     {{5,3,1},{-1,-1,-1}}, {{5,3,0},{2,5,0}}, {{5,4,0},{1,5,0}}, {{5,4,2},{-1,-1,-1}},
     {{4,5,2},{-1,-1,-1}}, {{4,5,0},{5,1,0}}, {{5,2,0},{3,5,0}}, {{3,5,1},{-1,-1,-1}},
     {{2,4,1},{4,3,1}}, {{4,3,0},{-1,-1,-1}}, {{1,2,0},{-1,-1,-1}}, {{-1,-1,-1},{-1,-1,-1}}},
    {{{-1,-1,-1},{-1,-1,-1}}, {{2,1,0},{-1,-1,-1}}, {{3,4,0},{-1,-1,-1}}, {{4,2,1},{3,4,1}},
     {{5,3,1},{-1,-1,-1}}, {{5,3,0},{2,5,0}}, {{5,4,0},{1,5,0}}, {{5,4,2},{-1,-1,-1}},
     {{4,5,2},{-1,-1,-1}}, {{4,5,0},{5,1,0}}, {{5,2,0},{3,5,0}}, {{3,5,1},{-1,-1,-1}},
     {{2,4,1},{4,3,1}}, {{4,3,0},{-1,-1,-1}}, {{1,2,0},{-1,-1,-1}}, {{-1,-1,-1},{-1,-1,-1}}},
    {{{-1,-1,-1},{-1,-1,-1}}, {{0,1,2},{-1,-1,-1}}, {{0,4,3},{-1,-1,-1}}, {{1,2,4},{1,4,3}},
     {{1,3,5},{-1,-1,-1}}, {{0,3,5},{0,5,2}}, {{0,4,5},{0,5,1}}, {{2,4,5},{-1,-1,-1}},
     {{2,5,4},{-1,-1,-1}}, {{0,5,4},{0,1,5}}, {{0,2,5},{0,5,3}}, {{1,5,3},{-1,-1,-1}},
     {{1,4,2},{1,3,4}}, {{0,3,4},{-1,-1,-1}}, {{0,2,1},{-1,-1,-1}}, {{-1,-1,-1},{-1,-1,-1}}},
    {{{-1,-1,-1},{-1,-1,-1}}, {{0,1,2},{-1,-1,-1}}, {{0,4,3},{-1,-1,-1}}, {{1,2,4},{1,4,3}},
     {{1,3,5},{-1,-1,-1}}, {{0,3,5},{0,5,2}}, {{0,4,5},{0,5,1}}, {{2,4,5},{-1,-1,-1}},
     {{2,5,4},{-1,-1,-1}}, {{0,5,4},{0,1,5}}, {{0,2,5},{0,5,3}}, {{1,5,3},{-1,-1,-1}},
     {{1,4,2},{1,3,4}}, {{0,3,4},{-1,-1,-1}}, {{0,2,1},{-1,-1,-1}}, {{-1,-1,-1},{-1,-1,-1}}},
    {{{-1,-1,-1},{-1,-1,-1}}, {{2,1,0},{-1,-1,-1}}, {{3,4,0},{-1,-1,-1}}, {{4,2,1},{3,4,1}},
     {{5,3,1},{-1,-1,-1}}, {{5,3,0},{2,5,0}}, {{5,4,0},{1,5,0}}, {{5,4,2},{-1,-1,-1}},
     {{4,5,2},{-1,-1,-1}}, {{4,5,0},{5,1,0}}, {{5,2,0},{3,5,0}}, {{3,5,1},{-1,-1,-1}},
     {{2,4,1},{4,3,1}}, {{4,3,0},{-1,-1,-1}}, {{1,2,0},{-1,-1,-1}}, {{-1,-1,-1},{-1,-1,-1}}}};

struct Cell {
  int x, y, z;
  float v[8];  // corner c = dz*4 + dy*2 + dx
};

__device__ __forceinline__ Cell load_cell(const float* __restrict__ grid,
                                          long long i, int sy, int sx) {
  const int nx = sx - 1, ny = sy - 1;
  Cell c;
  c.x = static_cast<int>(i % nx);
  c.y = static_cast<int>((i / nx) % ny);
  c.z = static_cast<int>(i / (static_cast<long long>(nx) * ny));
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const long long idx =
        (static_cast<long long>(c.z + (k >> 2)) * sy + c.y + ((k >> 1) & 1)) *
            sx + c.x + (k & 1);
    c.v[k] = __ldg(grid + idx);
  }
  return c;
}

__device__ __forceinline__ int tet_case(const Cell& c, int t, float iso) {
  int cs = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) cs |= (c.v[kTets[t][j]] > iso ? 1 : 0) << j;
  return cs;
}

__device__ __forceinline__ int n_tris(int t, int cs) {
  return (kCaseTris[t][cs][0][0] >= 0 ? 1 : 0) +
         (kCaseTris[t][cs][1][0] >= 0 ? 1 : 0);
}

__global__ void __launch_bounds__(kBlock)
mt_count_kernel(const float* __restrict__ grid, float iso, int sy, int sx,
                long long n, int* __restrict__ counts) {
  const long long i = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= n) return;
  const Cell c = load_cell(grid, i, sy, sx);
  int count = 0;
#pragma unroll
  for (int t = 0; t < 6; ++t) count += n_tris(t, tet_case(c, t, iso));
  counts[i] = count;
}

__global__ void __launch_bounds__(kBlock)
mt_emit_kernel(const float* __restrict__ grid, float iso, int z_offset,
               int sy, int sx, long long n, const long long* __restrict__ ends,
               float* __restrict__ tris, int* __restrict__ ids) {
  const long long i = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= n) return;
  const Cell c = load_cell(grid, i, sy, sx);
  int cases[6];
  int count = 0;
#pragma unroll
  for (int t = 0; t < 6; ++t) {
    cases[t] = tet_case(c, t, iso);
    count += n_tris(t, cases[t]);
  }
  if (count == 0) return;
  long long out = ends[i] - count;
  const float base[3] = {static_cast<float>(c.x), static_cast<float>(c.y),
                         __fadd_rn(static_cast<float>(c.z),
                                   static_cast<float>(z_offset))};
  const int ibase[3] = {c.x, c.y, c.z + z_offset};
  for (int t = 0; t < 6; ++t) {
    const int cs = cases[t];
    for (int j = 0; j < 2; ++j) {
      if (kCaseTris[t][cs][j][0] < 0) continue;
      float* tp = tris + out * 9;
      int* ip = ids + out * 12;
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        const int e = kCaseTris[t][cs][j][v];
        const int ca = kTets[t][kEdgePairs[e][0]];
        const int cb = kTets[t][kEdgePairs[e][1]];
        const float va = c.v[ca], vb = c.v[cb];
        const float denom = __fsub_rn(vb, va);
        float tt = fabsf(denom) > 1e-12f
                       ? __fdiv_rn(__fsub_rn(iso, va), denom) : 0.5f;
        tt = tt < 0.0f ? 0.0f : (tt > 1.0f ? 1.0f : tt);
        const int oa[3] = {ca & 1, (ca >> 1) & 1, (ca >> 2) & 1};
        const int ob[3] = {cb & 1, (cb >> 1) & 1, (cb >> 2) & 1};
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float pa = static_cast<float>(oa[a]);
          const float pb = static_cast<float>(ob[a]);
          tp[v * 3 + a] = __fadd_rn(__fadd_rn(base[a], pa),
                                    __fmul_rn(tt, __fsub_rn(pb, pa)));
        }
        ip[v * 4 + 0] = ibase[2] + oa[2];
        ip[v * 4 + 1] = (ibase[1] + oa[1]) * sx + ibase[0] + oa[0];
        ip[v * 4 + 2] = ibase[2] + ob[2];
        ip[v * 4 + 3] = (ibase[1] + ob[1]) * sx + ibase[0] + ob[0];
      }
      ++out;
    }
  }
}

long long n_cells(int sz, int sy, int sx) {
  return static_cast<long long>(sz - 1) * (sy - 1) * (sx - 1);
}

}  // namespace

// grid: float32 [sz, sy, sx]; counts: int32 [(sz-1)(sy-1)(sx-1)], each
// cell's live-triangle count.
extern "C" int mt_count(const void* grid, float iso, int sz, int sy, int sx,
                        void* counts, void* stream) {
  if (sz < 2 || sy < 2 || sx < 2) return cudaSuccess;
  const long long n = n_cells(sz, sy, sx);
  const unsigned blocks = static_cast<unsigned>((n + kBlock - 1) / kBlock);
  mt_count_kernel<<<blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(grid), iso, sy, sx, n,
      static_cast<int*>(counts));
  return cudaGetLastError();
}

// ends: int64 [n], the inclusive prefix sum of mt_count's counts; tris:
// float32 [ends[n-1], 3, 3] voxel coords (x, y, z), z shifted by z_offset;
// ids: int32 [ends[n-1], 3, 4] (gz_a, gyx_a, gz_b, gyx_b) per vertex.
extern "C" int mt_emit(const void* grid, float iso, int z_offset, int sz,
                       int sy, int sx, const void* ends, void* tris, void* ids,
                       void* stream) {
  if (sz < 2 || sy < 2 || sx < 2) return cudaSuccess;
  const long long n = n_cells(sz, sy, sx);
  const unsigned blocks = static_cast<unsigned>((n + kBlock - 1) / kBlock);
  mt_emit_kernel<<<blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(grid), iso, z_offset, sy, sx, n,
      static_cast<const long long*>(ends), static_cast<float*>(tris),
      static_cast<int*>(ids));
  return cudaGetLastError();
}
