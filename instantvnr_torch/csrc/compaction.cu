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
// What bounds them on an H100 is bytes (3.35 TB/s): compact_rows reads the
// flags and each leaf's m rows once and writes them once (at m = 2^18 and
// the wavefront's 14 leaves, 93 bytes a row, 49 MB, 15 us). The scratch
// set is only a workspace, but the copy back reads and writes the leaves a
// second time (98 MB, 29 us as the launches move them). Moving rows one
// thread a row in 4-byte words leaves a warp's live and dead lanes writing
// two runs of partly written 32-byte sectors for every leaf. So both
// kernels stage a tile of rows in shared memory and write whole runs with
// 16-byte stores. What held the first staged design back (measured with
// scripts/compaction_variants.py) was not the loads but the work a tile
// spends between them and its stores: a second pass over shared memory to
// put the rows in order, and runs stored one after another by the whole
// block, most of its threads idle on a short run. This design moves each
// row once, from global memory to its place, and stores runs a warp each.
//
// compact_rows, two launches and a third with copy_back:
// (1) compact_count_kernel: each warp counts the live flags of one tile of
//     T rows (16-byte loads) into tile_counts; each block (8 tiles) sums
//     its tiles into group_sums. Nothing in the workspace carries over
//     between launches, so a replayed CUDA graph starts clean.
// (2) compact_partition_kernel, a block a tile of T = 256·R rows, thread t
//     owning rows r·256 + t: warp ballots rank the rows (live rows first in
//     row order, then the dead ones), and the block reduces the live rows
//     before its tile and in all from the count pass's sums (the scan
//     folded in: a block reads under m / 2048 group sums and at most 7 tile
//     counts). A dead row's destination is n_live + its dead rank, so the
//     total is needed before any dead row can be placed: one count pass
//     over the 1-byte flags (256 KB at 2^18) gives it, where a single-pass
//     look-back would know only the live rows before a tile. Each thread
//     then copies its rows of every leaf straight into their places in the
//     tile's two staged runs (4-byte cp.async: a warp's lanes read 32
//     neighbouring rows, and all of a tile's copies fly at once), each run
//     staged at the alignment mod 16 of its destination; one warp a run
//     then stores it as 16-byte words (ragged bytes only at its two ends).
//     order, when asked for, is one more output leaf whose rows are the
//     source row indices; block 0 writes the count. R is the largest of 8,
//     4, 2, 1 whose staging (T bytes a row, 32 a leaf) fits kStageBytes:
//     the wavefront's 93-byte rows take R = 2 (four blocks an SM), the
//     select form's 12-byte rows with their order R = 8.
// (3) compact_copy_back_kernel: every leaf's m rows from dst back into src
//     in one launch (blockIdx.y the leaf), 16-byte words, four a thread in
//     flight. Rows are written to a second set of buffers because a block
//     cannot overwrite rows another block has yet to read; the copy back
//     keeps the caller's buffers at their addresses, which captured CUDA
//     graphs read.
//
// scatter_rows, two launches: scatter_invert_kernel writes the inverse
// permutation (inv[perm[i]] = i, 4 bytes a row), then scatter_gather_kernel
// gives each block T consecutive output rows: each thread gathers its rows'
// words from src[inv[j]] into shared memory (4-byte cp.async, all leaves in
// flight), and the tile leaves as 16-byte stores. The reads are the
// scattered side; on a frame's slot → pixel permutation (a few interleaved
// increasing runs) neighbouring output rows read neighbouring source rows.
// A block's staging is held to kGatherBytes (512 rows of the wavefront's
// five outputs), so that enough blocks fit on each SM for a random
// permutation's scattered reads.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLeaves = 16;
constexpr int kCountWarps = kThreads / 32;  // tiles a count block counts
// shared memory a block of the partition or the gather stages at most,
// unless R = 1 needs more (scripts/compaction_variants.py times the others)
constexpr int kStageBytes = 48 * 1024;
constexpr int kGatherBytes = 24 * 1024;

struct Leaves {
  const unsigned char* src[kMaxLeaves];
  unsigned char* dst[kMaxLeaves];
  int bytes[kMaxLeaves];
  int n;
};

// Byte offsets into a block's dynamic shared memory of each leaf's staged
// rows (out[n] is the order's).
struct Stage {
  int out[kMaxLeaves + 1];
};

__device__ __forceinline__ unsigned char* stage_base() {
  extern __shared__ __align__(16) unsigned char stage[];
  return stage;
}

// 4 bytes from global to shared memory, asynchronously (cp.async).
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

// Shared memory [s, s + n) to global [g, g + n), s ≡ g (mod 16), by the
// `stride` threads numbered `i` (a block's or a warp's): bytes up to g's
// first 16-byte boundary, whole 16-byte words, the bytes after.
__device__ __forceinline__ void store_run(const unsigned char* s,
                                          unsigned char* g, int n, int i,
                                          int stride) {
  int head = static_cast<int>((16 - (reinterpret_cast<uintptr_t>(g) & 15)) &
                              15);
  head = head < n ? head : n;
  const int words = (n - head) >> 4;
  const uint4* s4 = reinterpret_cast<const uint4*>(s + head);
  uint4* g4 = reinterpret_cast<uint4*>(g + head);
  for (int w = i; w < words; w += stride) g4[w] = s4[w];
  if (i < head) g[i] = s[i];
  const int tail = head + words * 16 + (i - 16);
  if (i >= 16 && i < 32 && tail < n) g[tail] = s[tail];
}

// Where a leaf's two runs of a tile sit in its staging and in global
// memory: the live run at stage + live_at_s, global live_at; the dead run
// at stage + dead_at_s, global dead_at; each staged at its destination's
// alignment mod 16.
struct Runs {
  unsigned char* live_at;
  unsigned char* dead_at;
  int live_at_s, dead_at_s;
};

__device__ __forceinline__ Runs runs_of(unsigned char* dst, int bytes,
                                        long long live_before,
                                        long long dead_before,
                                        long long n_live, int tile_live) {
  Runs r;
  r.live_at = dst + live_before * bytes;
  r.dead_at = dst + (n_live + dead_before) * bytes;
  r.live_at_s = static_cast<int>(reinterpret_cast<uintptr_t>(r.live_at) & 15);
  const int end = r.live_at_s + tile_live * bytes;
  r.dead_at_s = end + ((static_cast<int>(
                            reinterpret_cast<uintptr_t>(r.dead_at) & 15) -
                        end) & 15);
  return r;
}

// One row of `bytes` bytes from global to shared memory: 4-byte
// asynchronous copies where `words` (the row's width and both ends 4-byte
// aligned), else bytes.
__device__ __forceinline__ void copy_row_async(const unsigned char* from,
                                               unsigned char* to, int bytes,
                                               bool words) {
  if (!words) {
    for (int b = 0; b < bytes; ++b) to[b] = from[b];
    return;
  }
  switch (bytes) {
    case 4: cp_async4(to, from); break;
    case 12:
      cp_async4(to, from);
      cp_async4(to + 4, from + 4);
      cp_async4(to + 8, from + 8);
      break;
    default:
      for (int w = 0; w < bytes; w += 4) cp_async4(to + w, from + w);
  }
}

// The nonzero bytes of a word (a flag is live where its byte is not 0, as
// the partition reads it).
__device__ __forceinline__ int nonzero_bytes(uint32_t w) {
  w |= w >> 4;
  w |= w >> 2;
  w |= w >> 1;
  return __popc(w & 0x01010101u);
}

template <int R>
__global__ void __launch_bounds__(kThreads)
compact_count_kernel(const bool* __restrict__ active, long long m,
                     int* __restrict__ tile_counts,
                     int* __restrict__ group_sums) {
  constexpr int T = kThreads * R;
  __shared__ int warp_counts[kCountWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long tile = static_cast<long long>(blockIdx.x) * kCountWarps +
                         warp;
  const long long row0 = tile * T;
  int c = 0;
  if (row0 < m) {
    const int rows = static_cast<int>(m - row0 < T ? m - row0 : T);
    const unsigned char* a = reinterpret_cast<const unsigned char*>(active) +
                             row0;
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(a) & 15) == 0) {
      done = rows & ~15;
      for (int i = lane * 16; i < done; i += 32 * 16) {
        const uint4 v = *reinterpret_cast<const uint4*>(a + i);
        c += nonzero_bytes(v.x) + nonzero_bytes(v.y) + nonzero_bytes(v.z) +
             nonzero_bytes(v.w);
      }
    }
    for (int i = done + lane; i < rows; i += 32) c += a[i] != 0;
  }
  c = warp_sum(c);
  if (lane == 0) {
    warp_counts[warp] = c;
    if (row0 < m) tile_counts[tile] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < kCountWarps; ++w) s += warp_counts[w];
    group_sums[blockIdx.x] = s;
  }
}

template <int R>
__global__ void __launch_bounds__(kThreads)
compact_partition_kernel(const bool* __restrict__ active, long long m,
                         const int* __restrict__ tile_counts,
                         const int* __restrict__ group_sums, int n_groups,
                         Leaves lv, Stage st, int* __restrict__ order,
                         int* __restrict__ count) {
  constexpr int T = kThreads * R;
  constexpr int kWarps = kThreads / 32;
  unsigned char* stage = stage_base();
  __shared__ int counts[R][kWarps];  // live rows of each warp's 32 rows
  __shared__ int sums[2][kWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long tile0 = static_cast<long long>(blockIdx.x) * T;
  const int rows = static_cast<int>(m - tile0 < T ? m - tile0 : T);
  const unsigned char* flag_bytes =
      reinterpret_cast<const unsigned char*>(active);
  const int n_out = lv.n + (order != nullptr);

  // the flags of my rows r·kThreads + t, and each warp's live rows
  unsigned live_mask[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = r * kThreads + t;
    live_mask[r] = __ballot_sync(
        0xffffffffu, row < rows && flag_bytes[tile0 + row] != 0);
    if (lane == 0) counts[r][warp] = __popc(live_mask[r]);
  }
  // live rows before this tile (the groups before its group, then the
  // tiles of its group before it) and in all
  const int g = blockIdx.x / kCountWarps;
  int before = 0, total = 0;
  for (int i = t; i < n_groups; i += kThreads) {
    const int s = group_sums[i];
    total += s;
    if (i < g) before += s;
  }
  if (t < static_cast<int>(blockIdx.x) - g * kCountWarps)
    before += tile_counts[g * kCountWarps + t];
  before = warp_sum(before);
  total = warp_sum(total);
  if (lane == 0) {
    sums[0][warp] = before;
    sums[1][warp] = total;
  }
  __syncthreads();
  long long live_before = 0, n_live = 0;
  int tile_live = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    live_before += sums[0][w];
    n_live += sums[1][w];
  }
  // each of my rows' place in the tile's order: live rows first, in row
  // order (sub-tile r, warp, lane), then the dead rows
  int slot[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    int before_me = 0;
    for (int w = 0; w < kWarps; ++w) before_me += w < warp ? counts[r][w] : 0;
    const int live = tile_live + before_me +
                     __popc(live_mask[r] & ((1u << lane) - 1));
    const bool is_live = (live_mask[r] >> lane) & 1;
    slot[r] = is_live ? live : r * kThreads + t - live;  // dead: a rank
    for (int w = 0; w < kWarps; ++w) tile_live += counts[r][w];
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (!((live_mask[r] >> lane) & 1)) slot[r] += tile_live;
  if (count != nullptr && blockIdx.x == 0 && t == 0)
    *count = static_cast<int>(n_live);
  const long long dead_before = tile0 - live_before;

  // every leaf's rows (and the order's) straight into their places in the
  // tile's staged runs: 4-byte asynchronous copies, or bytes
  for (int l = 0; l < n_out; ++l) {
    const bool is_order = l == lv.n;
    const int bytes = is_order ? 4 : lv.bytes[l];
    const Runs ru = runs_of(
        is_order ? reinterpret_cast<unsigned char*>(order) : lv.dst[l],
        bytes, live_before, dead_before, n_live, tile_live);
    unsigned char* out = stage + st.out[l];
    const unsigned char* src = is_order ? nullptr : lv.src[l] + tile0 * bytes;
    const bool words = ((bytes | ru.live_at_s | ru.dead_at_s |
                         reinterpret_cast<uintptr_t>(src)) & 3) == 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = r * kThreads + t, s = slot[r];
      if (row >= rows) continue;
      unsigned char* to = out + (s < tile_live
                                     ? ru.live_at_s + s * bytes
                                     : ru.dead_at_s + (s - tile_live) * bytes);
      if (is_order)
        *reinterpret_cast<int*>(to) = static_cast<int>(tile0 + row);
      else
        copy_row_async(src + static_cast<long long>(row) * bytes, to, bytes,
                       words);
    }
  }
  cp_async_wait_all();
  __syncthreads();
  // each run a warp's: warp w stores runs w, w + kWarps, ... (run 2l is
  // leaf l's live run, 2l + 1 its dead run)
  for (int k = warp; k < 2 * n_out; k += kWarps) {
    const int l = k >> 1;
    const bool dead = k & 1, is_order = l == lv.n;
    const int bytes = is_order ? 4 : lv.bytes[l];
    unsigned char* dst = is_order ? reinterpret_cast<unsigned char*>(order)
                                  : lv.dst[l];
    const Runs ru = runs_of(dst, bytes, live_before, dead_before, n_live,
                            tile_live);
    store_run(stage + st.out[l] + (dead ? ru.dead_at_s : ru.live_at_s),
              dead ? ru.dead_at : ru.live_at,
              (dead ? rows - tile_live : tile_live) * bytes, lane, 32);
  }
}

constexpr int kCopyWords = 4;  // 16-byte words a thread of the copy back

// Every leaf's m rows from dst back to src: blockIdx.y is the leaf, each
// block kThreads · kCopyWords consecutive 16-byte words of it.
__global__ void __launch_bounds__(kThreads)
compact_copy_back_kernel(long long m, Leaves lv) {
  const int l = blockIdx.y;
  const long long n = m * lv.bytes[l];
  const unsigned char* s = lv.dst[l];
  unsigned char* d = const_cast<unsigned char*>(lv.src[l]);
  const long long w0 = static_cast<long long>(blockIdx.x) * kThreads *
                       kCopyWords + threadIdx.x;
  if (((reinterpret_cast<uintptr_t>(s) | reinterpret_cast<uintptr_t>(d)) &
       15) == 0) {
    const long long nw = n >> 4;
    const uint4* s4 = reinterpret_cast<const uint4*>(s);
    uint4* d4 = reinterpret_cast<uint4*>(d);
    uint4 v[kCopyWords];
#pragma unroll
    for (int k = 0; k < kCopyWords; ++k) {
      const long long w = w0 + k * kThreads;
      if (w < nw) v[k] = s4[w];
    }
#pragma unroll
    for (int k = 0; k < kCopyWords; ++k) {
      const long long w = w0 + k * kThreads;
      if (w < nw) d4[w] = v[k];
    }
    if (blockIdx.x == 0 && threadIdx.x < 16 && nw * 16 + threadIdx.x < n)
      d[nw * 16 + threadIdx.x] = s[nw * 16 + threadIdx.x];
  } else {
#pragma unroll
    for (int k = 0; k < kCopyWords; ++k) {
      const long long w = w0 + k * kThreads;
      for (long long b = w * 16; b < w * 16 + 16 && b < n; ++b) d[b] = s[b];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
scatter_invert_kernel(const int* __restrict__ perm, long long m,
                      int* __restrict__ inv) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= m) return;
  const int p = perm[i];
  if (p >= 0 && p < m) inv[p] = static_cast<int>(i);
}

template <int R>
__global__ void __launch_bounds__(kThreads)
scatter_gather_kernel(const int* __restrict__ inv, long long m, Leaves lv,
                      Stage st) {
  constexpr int T = kThreads * R;
  unsigned char* stage = stage_base();
  const int t = threadIdx.x;
  const long long j0 = static_cast<long long>(blockIdx.x) * T;
  const int rows = static_cast<int>(m - j0 < T ? m - j0 : T);
  int from[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = r * kThreads + t;
    from[r] = j < rows ? inv[j0 + j] : -1;
    if (from[r] >= m) from[r] = -1;
  }
  for (int l = 0; l < lv.n; ++l) {
    const int bytes = lv.bytes[l];
    unsigned char* to = lv.dst[l] + j0 * bytes;
    unsigned char* s = stage + st.out[l] +
                       (reinterpret_cast<uintptr_t>(to) & 15);
    const unsigned char* src = lv.src[l];
    const bool words = ((bytes | reinterpret_cast<uintptr_t>(src) |
                         reinterpret_cast<uintptr_t>(s)) & 3) == 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (from[r] < 0) continue;
      const unsigned char* row = src + static_cast<long long>(from[r]) * bytes;
      unsigned char* at = s + (r * kThreads + t) * bytes;
      copy_row_async(row, at, bytes, words);
    }
  }
  cp_async_wait_all();
  __syncthreads();
  for (int l = 0; l < lv.n; ++l) {
    const int bytes = lv.bytes[l];
    unsigned char* to = lv.dst[l] + j0 * bytes;
    store_run(stage + st.out[l] + (reinterpret_cast<uintptr_t>(to) & 15), to,
              rows * bytes, t, kThreads);
  }
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

// The largest R of 8, 4, 2, 1 whose staging (per_row bytes a row of a
// tile of 256·R rows, and per_tile bytes) fits `budget`; 1 if none does.
int pick_rows(long long per_row, long long per_tile, long long budget) {
  for (int r = 8; r > 1; r >>= 1)
    if (kThreads * r * per_row + per_tile <= budget) return r;
  return 1;
}

// A block's staging with tiles of T rows, T·b + 32 bytes a leaf (and the
// order's) → its bytes.
int plan_stage(const Leaves& lv, int T, bool with_order, Stage* st) {
  int off = 0;
  for (int l = 0; l < lv.n + with_order; ++l) {
    st->out[l] = off;
    off += T * (l < lv.n ? lv.bytes[l] : 4) + 32;
  }
  return off;
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int R>
cudaError_t launch_compaction(const bool* a, long long m, const Leaves& lv,
                              bool copy_back, int* order, int* count,
                              int* ws, cudaStream_t s) {
  constexpr int T = kThreads * R;
  Stage st;
  const int smem = plan_stage(lv, T, order != nullptr, &st);
  const long long nb = (m + T - 1) / T;
  const long long ng = (nb + kCountWarps - 1) / kCountWarps;
  int* tile_counts = ws;
  int* group_sums = ws + nb;
  compact_count_kernel<R><<<static_cast<unsigned>(ng), kThreads, 0, s>>>(
      a, m, tile_counts, group_sums);
  const cudaError_t e = allow_smem(compact_partition_kernel<R>, smem);
  if (e != cudaSuccess) return e;
  compact_partition_kernel<R><<<static_cast<unsigned>(nb), kThreads, smem,
                                s>>>(a, m, tile_counts, group_sums,
                                     static_cast<int>(ng), lv, st, order,
                                     count);
  if (copy_back && lv.n > 0) {
    long long widest = 0;
    for (int l = 0; l < lv.n; ++l)
      widest = widest > m * lv.bytes[l] ? widest : m * lv.bytes[l];
    const long long per_block = 16LL * kThreads * kCopyWords;
    const dim3 grid(
        static_cast<unsigned>((widest + per_block - 1) / per_block),
        static_cast<unsigned>(lv.n));
    compact_copy_back_kernel<<<grid, kThreads, 0, s>>>(m, lv);
  }
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_scatter(const int* perm, long long m, const Leaves& lv,
                           int* inv, cudaStream_t s) {
  constexpr int T = kThreads * R;
  Stage st;
  const int smem = plan_stage(lv, T, false, &st);
  scatter_invert_kernel<<<
      static_cast<unsigned>((m + kThreads - 1) / kThreads), kThreads, 0,
      s>>>(perm, m, inv);
  cudaError_t e = allow_smem(scatter_gather_kernel<R>, smem);
  if (e != cudaSuccess) return e;
  scatter_gather_kernel<R><<<static_cast<unsigned>((m + T - 1) / T),
                             kThreads, smem, s>>>(inv, m, lv, st);
  return cudaGetLastError();
}

}  // namespace

// active: bool [m]; src, dst: host uint64 [n_leaves] device addresses of
// each leaf's m rows (dst a second buffer of the same shape); row_bytes:
// host int32 [n_leaves]; copy_back: copy dst's rows back into src after the
// partition; order: null or int32 [m], the source row of every
// destination; count: null or int32 [1], the live count; ws: int32
// workspace of nb + ceil(nb / 8) with nb = ceil(m / 256).
extern "C" int compact_rows(const void* active, long long m, int n_leaves,
                            const void* src, const void* dst,
                            const void* row_bytes, int copy_back, void* order,
                            void* count, void* ws, void* stream) {
  Leaves lv;
  if (!make_leaves(n_leaves, src, dst, row_bytes, &lv))
    return cudaErrorInvalidValue;
  if (m <= 0) return cudaSuccess;
  if (m > 0x7fffffffLL) return cudaErrorInvalidValue;  // int32 order/count
  long long per_row = order != nullptr ? 4 : 0;
  for (int l = 0; l < lv.n; ++l) per_row += lv.bytes[l];
  const int R = pick_rows(per_row, 32LL * (lv.n + 1), kStageBytes);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool* a = static_cast<const bool*>(active);
  int* o = static_cast<int*>(order);
  int* c = static_cast<int*>(count);
  int* w = static_cast<int*>(ws);
  switch (R) {
    case 8: return launch_compaction<8>(a, m, lv, copy_back, o, c, w, s);
    case 4: return launch_compaction<4>(a, m, lv, copy_back, o, c, w, s);
    case 2: return launch_compaction<2>(a, m, lv, copy_back, o, c, w, s);
    default: return launch_compaction<1>(a, m, lv, copy_back, o, c, w, s);
  }
}

// perm: int32 [m], a permutation of [0, m); src, dst, row_bytes as for
// compact_rows (dst rows indexed by perm); ws: int32 [m] workspace (the
// inverse permutation). Row i of each leaf goes to row perm[i].
extern "C" int scatter_rows(const void* perm, long long m, int n_leaves,
                            const void* src, const void* dst,
                            const void* row_bytes, void* ws, void* stream) {
  Leaves lv;
  if (!make_leaves(n_leaves, src, dst, row_bytes, &lv))
    return cudaErrorInvalidValue;
  if (m <= 0) return cudaSuccess;
  if (m > 0x7fffffffLL) return cudaErrorInvalidValue;  // int32 inverse
  long long per_row = 0;
  for (int l = 0; l < lv.n; ++l) per_row += lv.bytes[l];
  const int R = pick_rows(per_row, 32LL * lv.n, kGatherBytes);
  const auto s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(perm);
  int* inv = static_cast<int*>(ws);
  switch (R) {
    case 8: return launch_scatter<8>(p, m, lv, inv, s);
    case 4: return launch_scatter<4>(p, m, lv, inv, s);
    case 2: return launch_scatter<2>(p, m, lv, inv, s);
    default: return launch_scatter<1>(p, m, lv, inv, s);
  }
}
