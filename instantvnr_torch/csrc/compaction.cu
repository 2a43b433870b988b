// Ray compaction for Hopper, sm_90a: a stable partition of a prefix of
// per-ray rows by a live flag (compact_rows), and the slot → pixel scatter
// that undoes it at the end of a frame (scatter_rows).
//
// Replaces instantvnr_tpu/render/compaction.py::_compact_body (:168-211),
// _count_active (:589) and _unpermute (:816), which the JAX package leaves
// to XLA: a cumsum of the live flags, one iota scatter for the order, and
// every per-ray leaf packed into one f32 [m, C] row-gather (a v5e gather
// costs the same whatever the row width). Here each leaf moves in its own
// type (1, 4 or 12 bytes a row), so nothing is packed and no m ≤ 2^24
// limit applies.
//
// compact_rows, three launches: (1) each block of kTile rows counts its
// live rows; (2) one block scans the block counts (exclusive) and writes
// the total, which is the live count the caller reads; (3) each block
// re-reads its flags as kItems sub-tiles of kThreads consecutive rows
// (thread t owns row t of each: neighbouring lanes read and write
// neighbouring rows), scans each sub-tile across its threads in turn, and
// each thread moves its own rows: a live row to its rank among the live
// rows, a dead row to total + its rank among the dead rows. So live rows keep their order at the front and
// dead rows theirs behind them: JAX's `where(active, cumsum(live) - 1,
// n_live + cumsum(1 - live) - 1)`. Rows are written to a second set of
// buffers (a permutation in place would read rows another thread has
// already overwritten); with copy_back, a fourth launch copies every
// leaf's m rows back (one block row a leaf, 4-byte words where the width
// allows), so the caller's buffers keep their addresses and a captured
// CUDA graph that reads them stays valid. order (optional)
// receives the source row of every destination: the compacted wavefront
// uses it, with the positions as the one leaf, to select the valid sample
// slots of a superstep on the device.
//
// Bound on an H100 (3.35 TB/s): bytes. The function reads the flags and
// each leaf's m rows once and writes them once: at m = 2^18 and the
// wavefront's 14 leaves (97 bytes a row) about 51 MB, 15 us. The copy back
// moves the rows a second time; the counts and the scan are a few KB.
//
// scatter_rows: one thread a row, row i of every leaf to row perm[i] of
// its output. perm is a permutation, so every output row is written once.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
constexpr int kScanThreads = 1024;
constexpr int kMaxLeaves = 16;

struct Leaves {
  const unsigned char* src[kMaxLeaves];
  unsigned char* dst[kMaxLeaves];
  int bytes[kMaxLeaves];
  int n;
};

// One row of `bytes` bytes: as 32-bit words where the width allows (every
// leaf of a tensor of 4-byte elements: rows start 4-byte aligned), else
// byte by byte (the bool flags).
__device__ __forceinline__ void move_row(const unsigned char* src,
                                         unsigned char* dst, long long from,
                                         long long to, int bytes) {
  if ((bytes & 3) == 0) {
    const uint32_t* s = reinterpret_cast<const uint32_t*>(src + from * bytes);
    uint32_t* d = reinterpret_cast<uint32_t*>(dst + to * bytes);
    for (int w = 0; w < bytes / 4; ++w) d[w] = s[w];
  } else {
    for (int b = 0; b < bytes; ++b) dst[to * bytes + b] = src[from * bytes + b];
  }
}

__device__ __forceinline__ int warp_inclusive(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// Exclusive scan of one int a thread across the block; *total gets the
// block's sum. `warp_sums` holds blockDim.x / 32 ints.
__device__ __forceinline__ int block_exclusive(int v, int* warp_sums,
                                               int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int inc = warp_inclusive(v);
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < n_warps ? warp_sums[lane] : 0;
    const int wi = warp_inclusive(w);
    if (lane < n_warps) warp_sums[lane] = wi - w;
    if (lane == 31) warp_sums[n_warps] = wi;
  }
  __syncthreads();
  const int out = warp_sums[warp] + inc - v;
  *total = warp_sums[n_warps];
  __syncthreads();
  return out;
}

// The flags of thread t's rows tile0 + i·kThreads + t; → how many are set.
__device__ __forceinline__ int load_flags(const bool* active, long long m,
                                          long long tile0, bool (&f)[kItems]) {
  int c = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long row = tile0 + i * kThreads + threadIdx.x;
    f[i] = row < m ? active[row] : false;
    c += f[i];
  }
  return c;
}

__global__ void __launch_bounds__(kThreads)
count_kernel(const bool* __restrict__ active, long long m,
             int* __restrict__ block_counts) {
  __shared__ int warp_sums[kThreads / 32 + 1];
  bool f[kItems];
  int total;
  block_exclusive(load_flags(active, m,
                             static_cast<long long>(blockIdx.x) * kTile, f),
                  warp_sums, &total);
  if (threadIdx.x == 0) block_counts[blockIdx.x] = total;
}

// One block: block_offsets[b] = Σ_{b' < b} block_counts[b'], and the total
// into ws_total and count.
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const int* __restrict__ block_counts, int n_blocks,
            int* __restrict__ block_offsets, int* __restrict__ ws_total,
            int* __restrict__ count) {
  __shared__ int warp_sums[kScanThreads / 32 + 1];
  const int per = (n_blocks + kScanThreads - 1) / kScanThreads;
  const int b0 = threadIdx.x * per;
  int s = 0;
  for (int b = b0; b < b0 + per && b < n_blocks; ++b) s += block_counts[b];
  int total;
  int run = block_exclusive(s, warp_sums, &total);
  for (int b = b0; b < b0 + per && b < n_blocks; ++b) {
    block_offsets[b] = run;
    run += block_counts[b];
  }
  if (threadIdx.x == 0) {
    *ws_total = total;
    if (count != nullptr) *count = total;
  }
}

__global__ void __launch_bounds__(kThreads)
partition_kernel(const bool* __restrict__ active, long long m,
                 const int* __restrict__ block_offsets,
                 const int* __restrict__ ws_total, Leaves leaves,
                 int* __restrict__ order) {
  __shared__ int warp_sums[kThreads / 32 + 1];
  bool f[kItems];
  const long long tile0 = static_cast<long long>(blockIdx.x) * kTile;
  load_flags(active, m, tile0, f);
  const long long n_live = *ws_total;
  long long tile_live = block_offsets[blockIdx.x];  // live rows before
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    int sub_total;
    const long long live = tile_live + block_exclusive(f[i], warp_sums,
                                                       &sub_total);
    tile_live += sub_total;
    const long long row = tile0 + i * kThreads + threadIdx.x;
    if (row >= m) continue;
    const long long dest = f[i] ? live : n_live + (row - live);
    for (int l = 0; l < leaves.n; ++l)
      move_row(leaves.src[l], leaves.dst[l], row, dest, leaves.bytes[l]);
    if (order != nullptr) order[dest] = static_cast<int>(row);
  }
}

// Every leaf's m rows from dst back to src: blockIdx.y is the leaf, the
// blocks of a row stride over its words.
__global__ void __launch_bounds__(kThreads)
copy_back_kernel(long long m, Leaves leaves) {
  const int l = blockIdx.y;
  const long long n_bytes = m * leaves.bytes[l];
  const long long start = static_cast<long long>(blockIdx.x) * kThreads +
                          threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  if ((leaves.bytes[l] & 3) == 0) {
    const uint32_t* s = reinterpret_cast<const uint32_t*>(leaves.dst[l]);
    uint32_t* d = reinterpret_cast<uint32_t*>(
        const_cast<unsigned char*>(leaves.src[l]));
    for (long long w = start; w < n_bytes / 4; w += stride) d[w] = s[w];
  } else {
    unsigned char* d = const_cast<unsigned char*>(leaves.src[l]);
    for (long long b = start; b < n_bytes; b += stride) d[b] = leaves.dst[l][b];
  }
}

__global__ void __launch_bounds__(kThreads)
scatter_kernel(const int* __restrict__ perm, long long m, Leaves leaves) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= m) return;
  const long long to = perm[i];
  for (int l = 0; l < leaves.n; ++l)
    move_row(leaves.src[l], leaves.dst[l], i, to, leaves.bytes[l]);
}

bool make_leaves(int n, const void* src, const void* dst, const void* bytes,
                 Leaves* lv) {
  if (n < 0 || n > kMaxLeaves) return false;
  const uint64_t* s = static_cast<const uint64_t*>(src);
  const uint64_t* d = static_cast<const uint64_t*>(dst);
  const int* b = static_cast<const int*>(bytes);
  lv->n = n;
  for (int l = 0; l < n; ++l) {
    lv->src[l] = reinterpret_cast<const unsigned char*>(s[l]);
    lv->dst[l] = reinterpret_cast<unsigned char*>(d[l]);
    lv->bytes[l] = b[l];
    if (b[l] <= 0) return false;
  }
  return true;
}

}  // namespace

// active: bool [m]; src, dst: host uint64 [n_leaves] device addresses of
// each leaf's m rows (dst a second buffer of the same shape); row_bytes:
// host int32 [n_leaves]; copy_back: copy dst's rows back into src after the
// partition; order: null or int32 [m], the source row of every
// destination; count: null or int32 [1], the live count; ws: int32
// workspace of 2 · ceil(m / 1024) + 1.
extern "C" int compact_rows(const void* active, long long m, int n_leaves,
                            const void* src, const void* dst,
                            const void* row_bytes, int copy_back, void* order,
                            void* count, void* ws, void* stream) {
  Leaves lv;
  if (!make_leaves(n_leaves, src, dst, row_bytes, &lv))
    return cudaErrorInvalidValue;
  if (m <= 0) return cudaSuccess;
  if (m > 0x7fffffffLL) return cudaErrorInvalidValue;  // int32 order/count
  const auto s = static_cast<cudaStream_t>(stream);
  const long long nb = (m + kTile - 1) / kTile;
  int* counts = static_cast<int*>(ws);
  int* offsets = counts + nb;
  int* total = offsets + nb;
  const bool* a = static_cast<const bool*>(active);
  count_kernel<<<static_cast<unsigned>(nb), kThreads, 0, s>>>(a, m, counts);
  scan_kernel<<<1, kScanThreads, 0, s>>>(counts, static_cast<int>(nb),
                                         offsets, total,
                                         static_cast<int*>(count));
  partition_kernel<<<static_cast<unsigned>(nb), kThreads, 0, s>>>(
      a, m, offsets, total, lv, static_cast<int*>(order));
  if (copy_back && lv.n > 0) {
    // about 4 words a thread for the widest leaf
    long long widest = 0;
    for (int l = 0; l < lv.n; ++l)
      widest = widest > m * lv.bytes[l] ? widest : m * lv.bytes[l];
    const long long bx = (widest / 16 + kThreads - 1) / kThreads;
    const dim3 grid(static_cast<unsigned>(bx < 1 ? 1 : bx),
                    static_cast<unsigned>(lv.n));
    copy_back_kernel<<<grid, kThreads, 0, s>>>(m, lv);
  }
  return cudaGetLastError();
}

// perm: int32 [m], a permutation of [0, m); src, dst, row_bytes as for
// compact_rows (dst rows indexed by perm). Row i of each leaf goes to row
// perm[i].
extern "C" int scatter_rows(const void* perm, long long m, int n_leaves,
                            const void* src, const void* dst,
                            const void* row_bytes, void* stream) {
  Leaves lv;
  if (!make_leaves(n_leaves, src, dst, row_bytes, &lv))
    return cudaErrorInvalidValue;
  if (m <= 0) return cudaSuccess;
  const auto s = static_cast<cudaStream_t>(stream);
  scatter_kernel<<<static_cast<unsigned>((m + kThreads - 1) / kThreads),
                   kThreads, 0, s>>>(static_cast<const int*>(perm), m, lv);
  return cudaGetLastError();
}
