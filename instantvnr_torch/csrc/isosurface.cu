// Marching tetrahedra for Hopper, sm_90a: a count pass that also scans,
// and an emit pass that writes one triangle a thread, over a z-slab.
//
// Replaces instantvnr_tpu/ops/isosurface.py::_extract_slab (:87-193), XLA
// code that writes every one of the [N, 6, 2] triangle slots of a slab
// with a validity mask, and the host's boolean compaction of those slots
// in _extract_loop (:243-246). In plain PyTorch the dense emission writes
// 84 bytes for each slot, live or not (~260 MB a 128^3 slab of 16
// planes); here only the live triangles are written:
//
//   mt_count  a block of kCells cells: each cell's 8 corners, the 6 Kuhn
//             tets' cases against the isovalue and the cell's live-triangle
//             count (<= 12), stored packed a cell (4 bytes); the block's
//             sum, published and added to the slab's total
//   (host)    reads the total: the output's size
//   mt_emit   the same block of cells, if its published sum is not 0:
//             their packed cases, a block scan of their counts, a
//             descriptor (cell, tet, triangle) a live triangle in shared
//             memory, in the plain version's order, and the sum of the
//             blocks before; then one thread a triangle reads the 6
//             corners its vertices need and computes its positions base +
//             pa + t·(pb − pa) and ids (gz_a, gyx_a, gz_b, gyx_b) of the
//             lattice edge each vertex lies on into shared memory, and the
//             block writes its contiguous range of tris (36 B a triangle)
//             and ids (48 B) with consecutive lanes on consecutive words
//
// The design, against the previous one (one thread a cell in both passes,
// a cumulative sum between them, 64-bit cell arithmetic, the case tables
// in constant memory read at divergent addresses and a cell's corners
// indexed at run time, 21 scalar stores a triangle at a 36- and 48-byte
// stride from the cell's thread, mt_emit reloading every cell's corners):
// cell indices are 32-bit; the tables live in global memory (a warp's
// divergent reads are L1 hits, not serialized) and the tets' corners are
// compile-time constants, so a cell's values stay in registers; mt_emit
// copies the tables into shared memory in the blocks that have triangles,
// and the others return at once; the scan is folded into the two kernels
// (no block waits on another: each block of mt_emit with triangles sums
// its predecessors' published sums, consecutive lanes on consecutive
// sums); mt_emit reads each cell's packed cases and loads corners for live
// triangles only, its independent loads issued together; the stores are
// staged and coalesced. scripts/mt_variants.py times each change alone.
//
// Exactness: t = (iso − va)/(vb − va) by IEEE division, 0.5 where
// |vb − va| <= 1e-12, clamped to [0, 1] as torch.clamp (a NaN stays NaN);
// every sum and product rounds on its own (-fmad=false, and __fadd_rn /
// __fmul_rn here): the positions equal the plain version's bit for bit,
// which the exact weld on edge keys relies on.
//
// Bound on an H100, by bytes: the slab read once (4 B a voxel) and each
// live triangle written once (84 B: 36 B of positions, 48 B of ids). The
// packed cases, the corners mt_emit reads again and the blocks' sums are
// costs of the two-pass design and are not in the bound.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kCells = 256;  // cells (threads) a block
constexpr int kWarps = kCells / 32;

// the Kuhn/Freudenthal tets as cube corners (bit 0 +x, bit 1 +y, bit 2 +z)
__device__ const signed char kTets[6][4] = {
    {0, 1, 3, 7}, {0, 1, 5, 7}, {0, 2, 3, 7},
    {0, 2, 6, 7}, {0, 4, 5, 7}, {0, 4, 6, 7}};

// a tet's 6 edges as local corner pairs
__device__ const signed char kEdgePairs[6][2] = {
    {0, 1}, {0, 2}, {0, 3}, {1, 2}, {1, 3}, {2, 3}};

// per tet, per case (bit i = local corner i inside), up to 2 triangles of
// edge ids, -1 unused; the mirrored tets (1, 2, 5) wind reversed: the
// ops/isosurface.py::_CASE_TRIS_PER_TET table
__device__ const signed char kCaseTris[6][16][2][3] = {
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

// The tables in mt_emit's shared memory: a byte copy of the global ones,
// read at each thread's own case without bank conflicts that matter.
struct Tables {
  signed char tris[6][16][2][3];  // kCaseTris
  signed char tets[6][4];         // kTets
  signed char pairs[6][2];        // kEdgePairs
};

// each thread copies at most 3 bytes, its loads issued together
__device__ __forceinline__ void load_tables(Tables& tab) {
  constexpr int kT = sizeof(tab.tris), kC = sizeof(tab.tets);
  constexpr int kAll = sizeof(Tables);
  static_assert(kAll <= 3 * kCells, "3 bytes a thread copy the tables");
  signed char b[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const int k = threadIdx.x + q * kCells;
    b[q] = k < kT ? (&kCaseTris[0][0][0][0])[k]
           : k < kT + kC ? (&kTets[0][0])[k - kT]
           : k < kAll ? (&kEdgePairs[0][0])[k - kT - kC] : 0;
  }
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const int k = threadIdx.x + q * kCells;
    if (k < kAll) reinterpret_cast<signed char*>(&tab)[k] = b[q];
  }
}

__device__ __forceinline__ int tri_count(const Tables& tab, int t, int cs) {
  return (tab.tris[t][cs][0][0] >= 0 ? 1 : 0) +
         (tab.tris[t][cs][1][0] >= 0 ? 1 : 0);
}

struct Slab {
  const float* __restrict__ grid;
  int sy, sx, nx, ny, n;  // n cells of (sz-1)(sy-1)(sx-1)
};

// cell i's lattice coords by 32-bit unsigned division
__device__ __forceinline__ void cell_coords(const Slab& s, int i, int& x,
                                            int& y, int& z) {
  const unsigned q = static_cast<unsigned>(i) / static_cast<unsigned>(s.nx);
  x = i - static_cast<int>(q) * s.nx;
  z = static_cast<int>(q / static_cast<unsigned>(s.ny));
  y = static_cast<int>(q) - z * s.ny;
}

// the flat index of corner c (dz*4 + dy*2 + dx) of the cell at (x, y, z)
__device__ __forceinline__ int corner_index(const Slab& s, int x, int y,
                                            int z, int c) {
  return ((z + (c >> 2)) * s.sy + y + ((c >> 1) & 1)) * s.sx + x + (c & 1);
}

// a tet's live-triangle count in case cs, from the global table (the
// cases of a warp mostly agree, and the 576-byte table stays in L1)
__device__ __forceinline__ int case_tris(int t, int cs) {
  return (kCaseTris[t][cs][0][0] >= 0 ? 1 : 0) +
         (kCaseTris[t][cs][1][0] >= 0 ? 1 : 0);
}

// cell i's 6 tets' cases against iso, 4 bits a tet, and its live-triangle
// count at bits 24-27
__device__ __forceinline__ uint32_t cell_cases(const Slab& s, int i,
                                               float iso) {
  int x, y, z;
  cell_coords(s, i, x, y, z);
  float v[8];
#pragma unroll
  for (int c = 0; c < 8; ++c)
    v[c] = __ldg(s.grid + corner_index(s, x, y, z, c));
  // kTets as compile-time constants, so that the unrolled loops index v
  // by constants and v stays in registers (kTets would index it at run
  // time, through local memory)
  constexpr int kTetCorners[6][4] = {{0, 1, 3, 7}, {0, 1, 5, 7},
                                     {0, 2, 3, 7}, {0, 2, 6, 7},
                                     {0, 4, 5, 7}, {0, 4, 6, 7}};
  uint32_t cases = 0;
  int count = 0;
#pragma unroll
  for (int t = 0; t < 6; ++t) {
    int cs = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      cs |= (v[kTetCorners[t][j]] > iso ? 1 : 0) << j;
    cases |= static_cast<uint32_t>(cs) << (4 * t);
    count += case_tris(t, cs);
  }
  return cases | static_cast<uint32_t>(count) << 24;
}

// exclusive scan of `x` over the block; `total` gets the block's sum
__device__ __forceinline__ int block_scan(int x, int& total) {
  __shared__ int warp_sums[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int s = warp_sums[w];
    if (w < warp) before += s;
    total += s;
  }
  __syncthreads();  // warp_sums is reused by the next scan
  return before + inc - x;
}

// the block's sum of x, in every thread
__device__ __forceinline__ int block_sum(int x) {
  __shared__ int warp_sums[kWarps];
  const int w = __reduce_add_sync(0xffffffffu, x);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = w;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) total += warp_sums[k];
  return total;
}

// ws: [0] the slab's total (zero on entry), [1, 1 + blocks) each block's
// sum. mt_count's blocks publish their sums and add them to the total;
// mt_emit's blocks that have triangles sum their predecessors' (at most a
// few thousand, L2-resident, read by consecutive lanes), so no block waits
// for another.
__device__ __forceinline__ void publish(long long* ws, int sum) {
  if (threadIdx.x == 0) {
    ws[1 + blockIdx.x] = sum;
    if (sum)
      atomicAdd(reinterpret_cast<unsigned long long*>(ws),
                static_cast<unsigned long long>(sum));
  }
}

// this thread's part of the triangles of the blocks before this one:
// consecutive lanes on consecutive sums, the first 8 loads issued together
__device__ __forceinline__ long long preceding_part(const long long* ws) {
  const int nb = blockIdx.x;
  long long x = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int b = threadIdx.x + q * kCells;
    x += b < nb ? ws[1 + b] : 0;
  }
  for (int b = threadIdx.x + 8 * kCells; b < nb; b += kCells) x += ws[1 + b];
  return x;
}

// the block's sum of x, in every thread
__device__ __forceinline__ long long block_sum64(long long x) {
  __shared__ long long warp_sums[kWarps];
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(0xffffffffu, x, d);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = x;
  __syncthreads();
  long long total = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) total += warp_sums[k];
  return total;
}

__global__ void __launch_bounds__(kCells)
mt_count_kernel(Slab s, float iso, long long* __restrict__ ws,
                uint32_t* __restrict__ cases) {
  const int i = blockIdx.x * kCells + threadIdx.x;
  int count = 0;
  if (i < s.n) {
    const uint32_t c = cell_cases(s, i, iso);
    cases[i] = c;
    count = static_cast<int>(c >> 24);
  }
  publish(ws, block_sum(count));
}

__global__ void __launch_bounds__(kCells)
mt_emit_kernel(Slab s, float iso, int z_offset,
               const long long* __restrict__ ws,
               const uint32_t* __restrict__ cases, float* __restrict__ tris,
               int* __restrict__ ids) {
  __shared__ Tables tab;
  __shared__ uint32_t block_cases[kCells];
  __shared__ uint16_t desc[kCells * 12];  // cell | tet << 8 | tri << 11
  __shared__ float out_t[kCells * 9];     // one round's positions
  __shared__ int out_i[kCells * 12];      // and ids
  if (ws[1 + blockIdx.x] == 0) return;  // most blocks of a sparse surface
  const int tid = threadIdx.x;
  const int first = blockIdx.x * kCells;
  // three independent loads: the cells' cases, the tables, the sums of
  // the blocks before
  const uint32_t c = first + tid < s.n ? cases[first + tid] : 0;
  load_tables(tab);
  const long long before = preceding_part(ws);
  block_cases[tid] = c;
  int total;
  int o = block_scan(static_cast<int>(c >> 24), total);  // (syncs tab too)
  if (c >> 24) {
    for (int t = 0; t < 6; ++t) {
      const int n_t = tri_count(tab, t, (c >> (4 * t)) & 15);
      for (int j = 0; j < n_t; ++j)
        desc[o++] = static_cast<uint16_t>(tid | t << 8 | j << 11);
    }
  }
  const long long out0 = block_sum64(before);  // (its sync orders desc)
  for (int r0 = 0; r0 < total; r0 += kCells) {
    const int m = min(kCells, total - r0);
    if (tid < m) {
      const int d = desc[r0 + tid];
      const int cl = d & 255, t = (d >> 8) & 7, j = d >> 11;
      int x, y, z;
      cell_coords(s, first + cl, x, y, z);
      const int cs = (block_cases[cl] >> (4 * t)) & 15;
      const float base[3] = {static_cast<float>(x), static_cast<float>(y),
                             __fadd_rn(static_cast<float>(z),
                                       static_cast<float>(z_offset))};
      const int ibase[3] = {x, y, z + z_offset};
      float* tp = out_t + tid * 9;
      int* ip = out_i + tid * 12;
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        const int e = tab.tris[t][cs][j][v];
        const int ca = tab.tets[t][tab.pairs[e][0]];
        const int cb = tab.tets[t][tab.pairs[e][1]];
        const float va = __ldg(s.grid + corner_index(s, x, y, z, ca));
        const float vb = __ldg(s.grid + corner_index(s, x, y, z, cb));
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
        ip[v * 4 + 1] = (ibase[1] + oa[1]) * s.sx + ibase[0] + oa[0];
        ip[v * 4 + 2] = ibase[2] + ob[2];
        ip[v * 4 + 3] = (ibase[1] + ob[1]) * s.sx + ibase[0] + ob[0];
      }
    }
    __syncthreads();
    // the round's triangles are rows out0 + r0 .. + m of tris and ids
    float* gt = tris + (out0 + r0) * 9;
    int* gi = ids + (out0 + r0) * 12;
    for (int e = tid; e < m * 9; e += kCells) gt[e] = out_t[e];
    for (int e = tid; e < m * 12; e += kCells) gi[e] = out_i[e];
    __syncthreads();  // the next round reuses the staging
  }
}

// a slab's voxels and the triangles of its cells (<= 12 each) fit an int
bool make_slab(const void* grid, int sz, int sy, int sx, Slab& s) {
  if (static_cast<long long>(sz) * sy * sx > 0x7fffffffLL ||
      12LL * (sz - 1) * (sy - 1) * (sx - 1) > 0x7fffffffLL)
    return false;
  s = {static_cast<const float*>(grid), sy, sx, sx - 1, sy - 1,
       (sz - 1) * (sy - 1) * (sx - 1)};
  return true;
}

}  // namespace

// grid: float32 [sz, sy, sx] (at most 2^31 − 1 voxels, and 12 · cells at
// most 2^31 − 1: the most triangles the cells can hold); ws: int64 [1 +
// blocks], blocks = ceil(cells / 256), zero on entry; cases: int32 [cells].
// Writes ws[0], the slab's live-triangle count, ws[1 + b], block b's, and
// each cell's packed cases and count.
extern "C" int mt_count(const void* grid, float iso, int sz, int sy, int sx,
                        void* ws, void* cases, void* stream) {
  if (sz < 2 || sy < 2 || sx < 2) return cudaSuccess;
  Slab s;
  if (!make_slab(grid, sz, sy, sx, s)) return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>((s.n + kCells - 1) / kCells);
  mt_count_kernel<<<blocks, kCells, 0, static_cast<cudaStream_t>(stream)>>>(
      s, iso, static_cast<long long*>(ws), static_cast<uint32_t*>(cases));
  return cudaGetLastError();
}

// ws, cases: mt_count's; tris: float32 [ws[1], 3, 3] voxel coords (x, y,
// z), z shifted by z_offset; ids: int32 [ws[1], 3, 4] (gz_a, gyx_a, gz_b,
// gyx_b) per vertex; in the plain version's order (cell, tet, triangle).
extern "C" int mt_emit(const void* grid, float iso, int z_offset, int sz,
                       int sy, int sx, const void* ws, const void* cases,
                       void* tris, void* ids, void* stream) {
  if (sz < 2 || sy < 2 || sx < 2) return cudaSuccess;
  Slab s;
  if (!make_slab(grid, sz, sy, sx, s)) return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>((s.n + kCells - 1) / kCells);
  mt_emit_kernel<<<blocks, kCells, 0, static_cast<cudaStream_t>(stream)>>>(
      s, iso, z_offset, static_cast<const long long*>(ws),
      static_cast<const uint32_t*>(cases), static_cast<float*>(tris),
      static_cast<int*>(ids));
  return cudaGetLastError();
}
