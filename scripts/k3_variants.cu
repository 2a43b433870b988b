// Designs of the hash-grid forward gather (K3) that the package does not
// ship, built beside the package's kernel for scripts/k3_variants.py to time
// against it on the card. Includes the package's source, so every design
// shares its level_cell, corner_weight, load_row, rounding and store_row.
//
// k3_variant_kernel<kLevelMajor, kNewInt, kStore> switches the changes one
// at a time:
// - kLevelMajor: tcnn's mapping, lanes over 32 consecutive samples of one
//   level (a block covers 32·G samples and all L levels as L·G warp tasks),
//   the block's coords loaded once into shared memory; else one lane per
//   (sample, level), lanes numbered sample · L + level (the previous and the
//   package's mapping);
// - kNewInt: 32-bit lane arithmetic and the package's exact wrap without
//   division (corner_index); else a 64-bit division of the lane index and
//   a runtime % per corner (the previous design's);
// - kStore: kScalar, F scalar stores a lane (the previous design's);
//   kVector, 16-byte vector stores a lane (the package's); kStaged, the
//   block's output tile staged in shared memory (rows padded by 16 bytes
//   against bank conflicts) and written out as 16-byte vectors.
// <false, false, kScalar> is the previous design as it was, <false, true,
// kVector> the package's, <true, true, kStaged> tcnn's level-major design.
//
// The gather floor: each lane only loads its 8 rows from precomputed
// indices and sums them, the access pattern's own cost on this card, the
// L2's sector traffic included. k3_floor_kernel in the level-major mapping
// with the staged output (idx [L, 8, n] int32, coalesced across the
// lanes); k3_floor_rows_kernel in the package's (idx [n, L, 8], each lane's
// 8 indices as two 16-byte loads) with vector stores.
#include "../instantvnr_torch/csrc/hash_encode.cu"

namespace {

// the previous design's index: a runtime % per corner
__device__ __forceinline__ uint32_t corner_index_mod(const Cell& c,
                                                     int corner,
                                                     const Levels& lv, int l) {
  const uint32_t x = c.pos[0] + (corner & 1);
  const uint32_t y = c.pos[1] + ((corner >> 1) & 1);
  const uint32_t z = c.pos[2] + ((corner >> 2) & 1);
  uint32_t idx;
  if ((lv.dense_mask >> l) & 1u) {
    const uint32_t r = lv.res[l];
    idx = x + y * r + z * (r * r);
  } else {
    idx = x ^ (y * 2654435761u) ^ (z * 805459861u);
  }
  return idx % lv.size[l] + lv.offset[l];
}

template <typename T, int F, bool kBf16, bool kNewInt>
__device__ __forceinline__ void encode_variant(const T* __restrict__ table,
                                               const float* p,
                                               const Levels& lv, int l,
                                               float (&acc)[F]) {
  const Cell c = level_cell(p, lv.scale[l]);
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    const uint32_t idx = kNewInt ? corner_index(c, corner, lv, l)
                                 : corner_index_mod(c, corner, lv, l);
    const float w = to_compute<kBf16>(corner_weight(c, corner));
    float row[F];
    load_row<F>(table + static_cast<size_t>(idx) * F, row);
#pragma unroll
    for (int f = 0; f < F; ++f) {
      acc[f] += to_compute<kBf16>(to_compute<kBf16>(row[f]) * w);
    }
  }
}

// the previous design's stores: F scalar stores of Out
template <int F>
__device__ __forceinline__ void store_scalar(float* dst, const float (&v)[F]) {
#pragma unroll
  for (int f = 0; f < F; ++f) dst[f] = v[f];
}

template <int F>
__device__ __forceinline__ void store_scalar(uint16_t* dst,
                                             const float (&v)[F]) {
#pragma unroll
  for (int f = 0; f < F; ++f) {
    dst[f] = __bfloat16_as_ushort(__float2bfloat16_rn(v[f]));
  }
}

// n_bytes contiguous bytes of shared memory → global: 16-byte vectors, then
// the tail in units of Out (both ends 16-byte aligned but the tail's)
template <typename Out>
__device__ __forceinline__ void copy_out(const char* src, char* dst,
                                         int n_bytes) {
  const int n16 = n_bytes / 16;
  for (int e = threadIdx.x; e < n16; e += kThreads) {
    reinterpret_cast<uint4*>(dst)[e] = reinterpret_cast<const uint4*>(src)[e];
  }
  const int unit = sizeof(Out);
  for (int e = n16 * 16 / unit + threadIdx.x; e < n_bytes / unit;
       e += kThreads) {
    reinterpret_cast<Out*>(dst)[e] = reinterpret_cast<const Out*>(src)[e];
  }
}

// The level-major designs' output tile in shared memory: rows of L·F
// values of type Out, each row padded by 16 bytes when its bytes are a
// multiple of 16 (a lane's row store then starts 4 banks after its
// neighbour's)
struct Tile {
  int row_bytes, pitch;
};

__host__ __device__ __forceinline__ Tile make_tile(int n_levels, int F,
                                                   int out_size) {
  Tile t;
  t.row_bytes = n_levels * F * out_size;
  t.pitch = t.row_bytes % 16 == 0 ? t.row_bytes + 16 : t.row_bytes;
  return t;
}

// samples a level-major block covers: 32·G, G groups so that the L·G warp
// tasks keep the block's kThreads / 32 warps busy
__host__ __device__ __forceinline__ int block_samples(int n_levels) {
  const int warps = kThreads / 32;
  return 32 * ((warps + n_levels - 1) / n_levels);
}

// The block's n_rows staged rows → out rows [b0, b0 + n_rows): 16-byte
// vectors when a row's bytes are a multiple of 16, else units of Out
template <typename Out>
__device__ __forceinline__ void write_tile(const char* s_tile, const Tile& t,
                                           Out* __restrict__ out, long long b0,
                                           int n_rows) {
  char* dst = reinterpret_cast<char*>(out) + b0 * t.row_bytes;
  if (t.row_bytes % 16 == 0) {
    const int per_row = t.row_bytes / 16;
    for (int e = threadIdx.x; e < n_rows * per_row; e += kThreads) {
      const int r = e / per_row;
      const int q = e - r * per_row;
      reinterpret_cast<uint4*>(dst)[e] =
          *reinterpret_cast<const uint4*>(s_tile + r * t.pitch + q * 16);
    }
  } else {
    copy_out<Out>(s_tile, dst, n_rows * t.row_bytes);
  }
}

enum Store { kScalar, kVector, kStaged };

template <int F, Store kStore, typename Out>
__device__ __forceinline__ void store_lane(Out* dst, const float (&v)[F]) {
  if constexpr (kStore == kScalar) {
    store_scalar<F>(dst, v);
  } else {
    store_row<F>(dst, v);
  }
}

template <typename T, typename Out, int F, bool kBf16, bool kLevelMajor,
          bool kNewInt, Store kStore>
__global__ void __launch_bounds__(kThreads)
k3_variant_kernel(const T* __restrict__ table,
                  const float* __restrict__ coords, Out* __restrict__ out,
                  long long n, int n_levels, Levels lv) {
  extern __shared__ __align__(16) char smem[];
  if constexpr (kLevelMajor) {
    const int n_samples = block_samples(n_levels);
    const Tile tile = make_tile(n_levels, F, sizeof(Out));
    float* s_coords = reinterpret_cast<float*>(smem);
    char* s_tile = smem + n_samples * 3 * sizeof(float);
    const long long b0 = static_cast<long long>(blockIdx.x) * n_samples;
    const int n_rows = n - b0 < n_samples ? static_cast<int>(n - b0)
                                          : n_samples;
    for (int e = threadIdx.x; e < n_rows * 3; e += kThreads) {
      s_coords[e] = coords[b0 * 3 + e];
    }
    __syncthreads();
    const int lane = threadIdx.x & 31;
    const int n_tasks = n_levels * (n_samples / 32);
    for (int task = threadIdx.x >> 5; task < n_tasks;
         task += kThreads / 32) {
      const int l = task % n_levels;
      const int s = (task / n_levels) * 32 + lane;
      if (s >= n_rows) continue;
      float acc[F];
      encode_variant<T, F, kBf16, kNewInt>(table, s_coords + 3 * s, lv, l,
                                           acc);
      if constexpr (kStore == kStaged) {
        store_row<F>(reinterpret_cast<Out*>(s_tile + s * tile.pitch) + l * F,
                     acc);
      } else {
        store_lane<F, kStore>(out + ((b0 + s) * n_levels + l) * F, acc);
      }
    }
    if constexpr (kStore == kStaged) {
      __syncthreads();
      write_tile(s_tile, tile, out, b0, n_rows);
    }
  } else {
    const long long total = n * n_levels;
    const long long t0 = static_cast<long long>(blockIdx.x) * kThreads;
    const long long t = t0 + threadIdx.x;
    if (t < total) {
      long long b;
      int l;
      if constexpr (kNewInt) {
        const uint32_t t32 = static_cast<uint32_t>(t);
        const uint32_t b32 = t32 / static_cast<uint32_t>(n_levels);
        b = b32;
        l = static_cast<int>(t32 - b32 * static_cast<uint32_t>(n_levels));
      } else {
        b = t / n_levels;
        l = static_cast<int>(t - b * n_levels);
      }
      float acc[F];
      encode_variant<T, F, kBf16, kNewInt>(table, coords + 3 * b, lv, l,
                                           acc);
      if constexpr (kStore == kStaged) {
        store_row<F>(reinterpret_cast<Out*>(smem) + threadIdx.x * F, acc);
      } else {
        store_lane<F, kStore>(out + t * F, acc);
      }
    }
    if constexpr (kStore == kStaged) {
      __syncthreads();
      const long long rows = total - t0 < kThreads ? total - t0 : kThreads;
      copy_out<Out>(smem, reinterpret_cast<char*>(out + t0 * F),
                    static_cast<int>(rows * F * sizeof(Out)));
    }
  }
}

// The gather floor in the package's mapping: one lane per (sample,
// level) loads its 8 indices (idx [n·L, 8] int32) as two 16-byte vectors,
// its 8 rows, sums them and stores its F values with vector stores
template <typename T, typename Out, int F, bool kBf16>
__global__ void __launch_bounds__(kThreads)
k3_floor_rows_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                     Out* __restrict__ out, long long n, int n_levels) {
  const uint32_t t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n * n_levels) return;
  const int4 i0 = __ldg(reinterpret_cast<const int4*>(idx) + 2 * t);
  const int4 i1 = __ldg(reinterpret_cast<const int4*>(idx) + 2 * t + 1);
  const int rows[8] = {i0.x, i0.y, i0.z, i0.w, i1.x, i1.y, i1.z, i1.w};
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    float row[F];
    load_row<F>(table + static_cast<size_t>(static_cast<uint32_t>(
                            rows[corner])) * F, row);
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] += to_compute<kBf16>(row[f]);
  }
  store_row<F>(out + static_cast<size_t>(t) * F, acc);
}

template <typename T, typename Out, int F, bool kBf16>
__global__ void __launch_bounds__(kThreads)
k3_floor_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                Out* __restrict__ out, long long n, int n_levels) {
  extern __shared__ __align__(16) char smem[];
  const int n_samples = block_samples(n_levels);
  const Tile tile = make_tile(n_levels, F, sizeof(Out));
  char* s_tile = smem;
  const long long b0 = static_cast<long long>(blockIdx.x) * n_samples;
  const int n_rows = n - b0 < n_samples ? static_cast<int>(n - b0)
                                        : n_samples;
  const int lane = threadIdx.x & 31;
  const int n_tasks = n_levels * (n_samples / 32);
  for (int task = threadIdx.x >> 5; task < n_tasks; task += kThreads / 32) {
    const int l = task % n_levels;
    const int s = (task / n_levels) * 32 + lane;
    if (s >= n_rows) continue;
    float acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = 0.0f;
#pragma unroll
    for (int corner = 0; corner < 8; ++corner) {
      const uint32_t i = static_cast<uint32_t>(
          __ldg(idx + (static_cast<long long>(l) * 8 + corner) * n + b0 + s));
      float row[F];
      load_row<F>(table + static_cast<size_t>(i) * F, row);
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] += to_compute<kBf16>(row[f]);
    }
    store_row<F>(reinterpret_cast<Out*>(s_tile + s * tile.pitch) + l * F,
                 acc);
  }
  __syncthreads();
  write_tile(s_tile, tile, out, b0, n_rows);
}

template <typename T, typename Out, bool kBf16, bool kLevelMajor,
          bool kNewInt, Store kStore>
cudaError_t run_variant(const void* table, const float* coords, void* out,
                        long long n, int n_levels, const Levels& lv,
                        cudaStream_t s) {
  constexpr int F = 8;
  unsigned blocks;
  size_t bytes;
  if (kLevelMajor) {
    const int n_samples = block_samples(n_levels);
    blocks = static_cast<unsigned>((n + n_samples - 1) / n_samples);
    bytes = n_samples * (3 * sizeof(float) +
                         make_tile(n_levels, F, sizeof(Out)).pitch);
  } else {
    blocks = blocks_for(n, n_levels);
    bytes = kStore == kStaged ? kThreads * F * sizeof(Out) : 0;
  }
  k3_variant_kernel<T, Out, F, kBf16, kLevelMajor, kNewInt, kStore>
      <<<blocks, kThreads, bytes, s>>>(static_cast<const T*>(table), coords,
                                       static_cast<Out*>(out), n, n_levels,
                                       lv);
  return cudaGetLastError();
}

template <typename T, typename Out, bool kBf16>
cudaError_t run_typed(int variant, const void* table, const float* coords,
                      void* out, long long n, int n_levels, const Levels& lv,
                      cudaStream_t s) {
  switch (variant) {
    case 0:  // the previous design
      return run_variant<T, Out, kBf16, false, false, kScalar>(
          table, coords, out, n, n_levels, lv, s);
    case 1:  // + the integer fixes alone
      return run_variant<T, Out, kBf16, false, true, kScalar>(
          table, coords, out, n, n_levels, lv, s);
    case 2:  // + vector stores alone
      return run_variant<T, Out, kBf16, false, false, kVector>(
          table, coords, out, n, n_levels, lv, s);
    case 3:  // + the staged output alone
      return run_variant<T, Out, kBf16, false, false, kStaged>(
          table, coords, out, n, n_levels, lv, s);
    case 4:  // + level-major lanes alone
      return run_variant<T, Out, kBf16, true, false, kScalar>(
          table, coords, out, n, n_levels, lv, s);
    case 5:  // tcnn's level-major design: all three of its changes
      return run_variant<T, Out, kBf16, true, true, kStaged>(
          table, coords, out, n, n_levels, lv, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// hash_encode_forward's arguments (F = 8 only) and the variant (0-5)
extern "C" int k3_variant_forward(const void* table, const void* coords,
                                  void* out, long long n, int n_levels,
                                  int n_features, const void* scales,
                                  const void* levels, int table_bf16,
                                  int out_bf16, int variant, void* stream) {
  Levels lv;
  if (!make_levels(n_levels, scales, levels, &lv) || n_features != 8)
    return cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  const float* c = static_cast<const float*>(coords);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table_bf16 && out_bf16)
    return run_typed<uint16_t, uint16_t, true>(variant, table, c, out, n,
                                               n_levels, lv, s);
  if (out_bf16)
    return run_typed<float, uint16_t, true>(variant, table, c, out, n,
                                            n_levels, lv, s);
  if (!table_bf16)
    return run_typed<float, float, false>(variant, table, c, out, n,
                                          n_levels, lv, s);
  return cudaErrorInvalidValue;
}

// table [T, 8] (f32, or bf16 if table_bf16); idx [L, 8, n] int32 rows
// (mapping 0: the package's) or [n, L, 8] (mapping 1: the previous
// design's); out [n, L·8] in the compute type (bf16 if out_bf16, else f32):
// the sums of each (sample, level)'s 8 rows
extern "C" int k3_gather_floor(const void* table, const void* idx, void* out,
                               long long n, int n_levels, int table_bf16,
                               int out_bf16, int mapping, void* stream) {
  if (n_levels <= 0 || n_levels > kMaxLevels) return cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  constexpr int F = 8;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mapping == 1) {
    if (!out_bf16) return cudaErrorInvalidValue;
    const unsigned blocks = blocks_for(n, n_levels);
    const int* ix = static_cast<const int*>(idx);
    if (table_bf16) {
      k3_floor_rows_kernel<uint16_t, uint16_t, F, true>
          <<<blocks, kThreads, 0, s>>>(static_cast<const uint16_t*>(table),
                                       ix, static_cast<uint16_t*>(out), n,
                                       n_levels);
    } else {
      k3_floor_rows_kernel<float, uint16_t, F, true>
          <<<blocks, kThreads, 0, s>>>(static_cast<const float*>(table), ix,
                                       static_cast<uint16_t*>(out), n,
                                       n_levels);
    }
    return cudaGetLastError();
  }
  const int n_samples = block_samples(n_levels);
  const unsigned blocks = static_cast<unsigned>((n + n_samples - 1) /
                                                n_samples);
  const int* ix = static_cast<const int*>(idx);
  if (out_bf16) {
    const size_t bytes = n_samples * make_tile(n_levels, F, 2).pitch;
    if (table_bf16) {
      k3_floor_kernel<uint16_t, uint16_t, F, true><<<blocks, kThreads, bytes,
                                                     s>>>(
          static_cast<const uint16_t*>(table), ix, static_cast<uint16_t*>(out),
          n, n_levels);
    } else {
      k3_floor_kernel<float, uint16_t, F, true><<<blocks, kThreads, bytes,
                                                  s>>>(
          static_cast<const float*>(table), ix, static_cast<uint16_t*>(out), n,
          n_levels);
    }
  } else {
    if (table_bf16) return cudaErrorInvalidValue;
    const size_t bytes = n_samples * make_tile(n_levels, F, 4).pitch;
    k3_floor_kernel<float, float, F, false><<<blocks, kThreads, bytes, s>>>(
        static_cast<const float*>(table), ix, static_cast<float*>(out), n,
        n_levels);
  }
  return cudaGetLastError();
}
