// Multi-resolution hash-grid encoding for Hopper, sm_90a: forward gather,
// backward scatter and the coordinates' gradient (tiny-cuda-nn's
// GridEncoding, its kernel_grid and kernel_grid_backward, and
// kernel_grid_backward_input).
//
// Replaces no TPU kernel: the JAX package computes the encoding in XLA
// (instantvnr_tpu/ops/hash_encoding.py::hash_encode, a gather whose autodiff
// is a scatter-add in the table and a gather-and-dot in the coords), since
// Mosaic has no gather or scatter. The first two are the training step's
// own kernels; the third serves a frame differentiated in its rays.
//
// Per level each lane computes tcnn's position x = p·scale + 0.5,
// cell = floor(x), w = x − cell, then for each of the 8 corners (x fastest)
// the dense stride index (levels with res³ ≤ size) or the prime-XOR hash
// (x·1) ⊻ (y·2654435761) ⊻ (z·805459861), both in uint32, then wrapped to
// the level's size + the level's offset: the plain version's arithmetic
// (ops/hash_encoding.py::corner_indices_and_weights) step for step. The
// wrap is exact and costs no division where it can: a mask where the size
// is a power of two (every hashed level), else a compare and a % only for
// an index past the end (a dense level's corner on the upper face).
//
// The paired layout (EncodingConfig.hash_variant = "paired"; plain version
// ops/hash_encoding.py::paired_corner_indices_and_weights) changes only a
// hashed level's corner address and weight (`paired_corner`): corner 2·j +
// half is entry offset + 2·row_j + half, its two halves adjacent, weight
// w12·(1 − f_a or f_a). Both kernels take it as the template flag kPaired
// beside kBf16; dense levels keep tcnn's stride addressing. The backward's
// two corners of a pair-row then land in the same 64 bytes: half the rows a
// hashed level touches, the same number of atomics.
//
// Forward (K3): one lane per (sample, level), lanes numbered sample · L +
// level in 32-bit arithmetic, so a warp covers 32 consecutive output rows of
// F features. Each lane gathers its 8 rows of F features with vector loads
// (an f32 row of F = 8 is one 32-byte sector) from an f32 or a bf16 table;
// each product row·w is rounded to the compute type, the 8 are summed in
// float32 in corner order and the sum is rounded to the compute type, as
// the plain version's PyTorch ops round. The lane stores its F values with
// 16-byte vector stores, so a warp instruction writes whole sectors. Bound
// on an H100: bytes, each distinct table row once, the coords and the
// features. What costs is the gather: 8 scattered rows a (sample, level),
// one 32-byte L2 sector each (134 MB of f32 rows at the reference 8 × 8
// layout and B = 65,536). scripts/k3_variants.py times this design against
// the previous one (64-bit lane division, a % per corner, scalar stores),
// tcnn's level-major mapping with the output staged in shared memory, and
// the gather alone from precomputed indices; this design was the fastest
// of them at every input measured (PERF.md §6).
//
// Backward: the cotangent row times each corner's weight, rounded to the
// compute type, is added in float32 into a zeroed float32 gradient table
// (the plain version's index_add_). Bound on an H100: bytes, the coords,
// the cotangent, the zeroed table and each distinct row once. What costs
// is the L2's reductions: one warp instruction of scalar atomicAdds, one a
// lane over 32 unrelated rows, is 32 sector operations for 128 bytes. So
// the scatter maps lanes to (row, feature group) instead: a first phase
// computes each (sample, level)'s cell, 8 corner indices and weights once,
// one lane each; a second hands them by shuffle to the lanes that write
// that pair's rows, 2 adjacent lanes a row of F = 8 (one 32-byte sector),
// each with one 16-byte vector reduction (atomicAdd on float4, sm_90, its
// result unused). A warp instruction then writes 16 whole sectors: an
// F = 8 row is one sector operation, where scalar atomics take 8. Float
// atomics make the order of the sum vary from run to run, so this kernel
// is held to a tolerance, not bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kThreads = 256;

// per-level layout, passed by value
struct Levels {
  float scale[kMaxLevels];
  uint32_t res[kMaxLevels];
  uint32_t size[kMaxLevels];
  uint32_t offset[kMaxLevels];
  uint32_t dense_mask;  // bit l set: level l indexes densely
  uint32_t pow2_mask;   // bit l set: size[l] is a power of two
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool kBf16>
__device__ __forceinline__ float to_compute(float v) {
  return kBf16 ? round_bf16(v) : v;
}

__device__ __forceinline__ float bf16_bits(uint32_t u16) {
  return __uint_as_float(u16 << 16);
}

// F consecutive values (one table row or one cotangent row) → floats
template <int F>
__device__ __forceinline__ void load_row(const float* __restrict__ src,
                                         float (&v)[F]) {
  if constexpr (F % 4 == 0) {
#pragma unroll
    for (int q = 0; q < F / 4; ++q) {
      const float4 u = __ldg(reinterpret_cast<const float4*>(src) + q);
      v[4 * q] = u.x;
      v[4 * q + 1] = u.y;
      v[4 * q + 2] = u.z;
      v[4 * q + 3] = u.w;
    }
  } else if constexpr (F == 2) {
    const float2 u = __ldg(reinterpret_cast<const float2*>(src));
    v[0] = u.x;
    v[1] = u.y;
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f) v[f] = __ldg(src + f);
  }
}

template <int F>
__device__ __forceinline__ void load_row(const uint16_t* __restrict__ src,
                                         float (&v)[F]) {
  if constexpr (F % 8 == 0) {
#pragma unroll
    for (int q = 0; q < F / 8; ++q) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(src) + q);
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        v[8 * q + 2 * c] = bf16_bits(w[c] & 0xffffu);
        v[8 * q + 2 * c + 1] = bf16_bits(w[c] >> 16);
      }
    }
  } else if constexpr (F == 4) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(src));
    v[0] = bf16_bits(u.x & 0xffffu);
    v[1] = bf16_bits(u.x >> 16);
    v[2] = bf16_bits(u.y & 0xffffu);
    v[3] = bf16_bits(u.y >> 16);
  } else if constexpr (F == 2) {
    const uint32_t u = __ldg(reinterpret_cast<const unsigned int*>(src));
    v[0] = bf16_bits(u & 0xffffu);
    v[1] = bf16_bits(u >> 16);
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f) v[f] = bf16_bits(__ldg(src + f));
  }
}

// a sample's cell at one level: the min corner and the fractions
struct Cell {
  uint32_t pos[3];
  float frac[3];
};

// p: the sample's 3 coords
__device__ __forceinline__ Cell level_cell(const float* p, float scale) {
  Cell c;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    // two roundings, x = p·scale then + 0.5, as in the plain version
    const float x = p[a] * scale + 0.5f;
    const float cell = floorf(x);
    c.frac[a] = x - cell;
    c.pos[a] = static_cast<uint32_t>(static_cast<long long>(cell));
  }
  return c;
}

// idx % size, exactly: a mask for a power of two, else a % only past the end
__device__ __forceinline__ uint32_t wrap(uint32_t idx, const Levels& lv,
                                         int l) {
  const uint32_t size = lv.size[l];
  if ((lv.pow2_mask >> l) & 1u) return idx & (size - 1u);
  return idx < size ? idx : idx % size;
}

__device__ __forceinline__ uint32_t corner_index(const Cell& c, int corner,
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
  return wrap(idx, lv, l) + lv.offset[l];
}

__device__ __forceinline__ float corner_weight(const Cell& c, int corner) {
  const float wx = (corner & 1) ? c.frac[0] : 1.0f - c.frac[0];
  const float wy = ((corner >> 1) & 1) ? c.frac[1] : 1.0f - c.frac[1];
  const float wz = ((corner >> 2) & 1) ? c.frac[2] : 1.0f - c.frac[2];
  return wx * wy * wz;
}

// The paired layout's hashed-level corner (ops/hash_encoding.py::
// _paired_level_rows): corner = 2·j + half, j the pair-row of the other two
// axes' corner (p1, p2) = (j & 1, j >> 1) and half the corner along the
// level's pairing axis a = l mod 3. The row hashes the CELL's coordinate
// along a, row = (cell_a ⊻ p1·2654435761 ⊻ p2·805459861) mod (size/2), and
// the entry is offset + 2·row + half, weight (w_p1·w_p2)·(1 − f_a or f_a).
__device__ __forceinline__ void paired_corner(const Cell& c, int corner,
                                              const Levels& lv, int l,
                                              uint32_t* idx, float* w) {
  const int a = l % 3;
  const int o1 = a == 2 ? 0 : a + 1;
  const int o2 = a == 0 ? 2 : a - 1;
  const int j = corner >> 1;
  const int half = corner & 1;
  const uint32_t p1 = c.pos[o1] + (j & 1);
  const uint32_t p2 = c.pos[o2] + (j >> 1);
  const uint32_t h = c.pos[a] ^ (p1 * 2654435761u) ^ (p2 * 805459861u);
  const uint32_t rows = lv.size[l] >> 1;
  const uint32_t row = ((lv.pow2_mask >> l) & 1u) ? (h & (rows - 1u))
                                                  : h % rows;
  *idx = lv.offset[l] + 2u * row + static_cast<uint32_t>(half);
  const float w1 = (j & 1) ? c.frac[o1] : 1.0f - c.frac[o1];
  const float w2 = (j >> 1) ? c.frac[o2] : 1.0f - c.frac[o2];
  *w = (w1 * w2) * (half ? c.frac[a] : 1.0f - c.frac[a]);
}

// A corner's entry and weight: tcnn's layout, or with kPaired the paired
// layout on hashed levels (dense levels address alike in both)
template <bool kPaired>
__device__ __forceinline__ void level_corner(const Cell& c, int corner,
                                             const Levels& lv, int l,
                                             uint32_t* idx, float* w) {
  if (kPaired && !((lv.dense_mask >> l) & 1u)) {
    paired_corner(c, corner, lv, l, idx, w);
  } else {
    *idx = corner_index(c, corner, lv, l);
    *w = corner_weight(c, corner);
  }
}

// One (sample, level)'s F features: the 8 corners' rows gathered, each
// row·w rounded to the compute type and summed in float32 in corner order
template <typename T, int F, bool kBf16, bool kPaired = false>
__device__ __forceinline__ void encode_level(const T* __restrict__ table,
                                             const float* p, const Levels& lv,
                                             int l, float (&acc)[F]) {
  const Cell c = level_cell(p, lv.scale[l]);
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    uint32_t idx;
    float w;
    level_corner<kPaired>(c, corner, lv, l, &idx, &w);
    w = to_compute<kBf16>(w);
    float row[F];
    load_row<F>(table + static_cast<size_t>(idx) * F, row);
#pragma unroll
    for (int f = 0; f < F; ++f) {
      acc[f] += to_compute<kBf16>(to_compute<kBf16>(row[f]) * w);
    }
  }
}

// F values → Out (float, or bf16 bits) at dst, aligned to F·sizeof(Out)
template <int F>
__device__ __forceinline__ void store_row(float* dst, const float (&v)[F]) {
  if constexpr (F % 4 == 0) {
#pragma unroll
    for (int q = 0; q < F / 4; ++q) {
      reinterpret_cast<float4*>(dst)[q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    }
  } else if constexpr (F == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  } else {
    dst[0] = v[0];
  }
}

__device__ __forceinline__ uint32_t bf16_pair(float a, float b) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(a))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(b)))
          << 16);
}

template <int F>
__device__ __forceinline__ void store_row(uint16_t* dst,
                                          const float (&v)[F]) {
  if constexpr (F % 8 == 0) {
#pragma unroll
    for (int q = 0; q < F / 8; ++q) {
      reinterpret_cast<uint4*>(dst)[q] = make_uint4(
          bf16_pair(v[8 * q], v[8 * q + 1]), bf16_pair(v[8 * q + 2],
                                                       v[8 * q + 3]),
          bf16_pair(v[8 * q + 4], v[8 * q + 5]),
          bf16_pair(v[8 * q + 6], v[8 * q + 7]));
    }
  } else if constexpr (F == 4) {
    *reinterpret_cast<uint2*>(dst) =
        make_uint2(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]));
  } else if constexpr (F == 2) {
    *reinterpret_cast<uint32_t*>(dst) = bf16_pair(v[0], v[1]);
  } else {
    dst[0] = __bfloat16_as_ushort(__float2bfloat16_rn(v[0]));
  }
}

// Out: float, or uint16_t holding bf16 bits (the bf16 compute type)
template <typename T, typename Out, int F, bool kBf16, bool kPaired = false>
__global__ void __launch_bounds__(kThreads)
hash_encode_forward_kernel(const T* __restrict__ table,
                           const float* __restrict__ coords,
                           Out* __restrict__ out, uint32_t total,
                           int n_levels, Levels lv,
                           const int* __restrict__ count, long long offset) {
  const uint32_t t = blockIdx.x * kThreads + threadIdx.x;
  if (count != nullptr) {
    // the device-side count form (the compacted wavefront's valid slots):
    // only the samples [offset, offset + n) below *count; lanes past them
    // exit at once
    const long long live = static_cast<long long>(*count) - offset;
    const long long lanes = live < 0 ? 0 : live * n_levels;
    if (lanes < static_cast<long long>(total))
      total = static_cast<uint32_t>(lanes);
  }
  if (t >= total) return;
  const uint32_t b = t / static_cast<uint32_t>(n_levels);
  const int l = static_cast<int>(t - b * static_cast<uint32_t>(n_levels));
  float acc[F];
  encode_level<T, F, kBf16, kPaired>(table, coords + 3 * static_cast<size_t>(b),
                                     lv, l, acc);
  // output row t of [B·L, F] == features [b, l·F .. l·F+F)
  store_row<F>(out + static_cast<size_t>(t) * F, acc);
}

// One 16-, 8- or 4-byte float32 atomic add into global memory, its result
// unused: V values at dst, which is V·4-byte aligned. The vector forms are
// Hopper's (sm_90).
template <int V>
__device__ __forceinline__ void red_add(float* dst, const float (&v)[V]) {
  if constexpr (V == 4) {
    atomicAdd(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2],
                                                          v[3]));
  } else if constexpr (V == 2) {
    atomicAdd(reinterpret_cast<float2*>(dst), make_float2(v[0], v[1]));
  } else {
    atomicAdd(dst, v[0]);
  }
}

template <typename G, int F, bool kBf16, bool kPaired = false>
__global__ void __launch_bounds__(kThreads)
hash_encode_backward_kernel(const float* __restrict__ coords,
                            const G* __restrict__ g, float* __restrict__ grad,
                            long long n, int n_levels, Levels lv) {
  // lanes a row: a row of F = 8 f32 is one 32-byte sector, written as two
  // adjacent 16-byte atomics; a shorter row takes one lane
  constexpr int kG = F == 8 ? 2 : 1;
  constexpr int kV = F / kG;     // features a lane adds per row
  constexpr int kS = 32 / kG;    // rows per warp instruction
  const long long total = n * n_levels;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  // phase 1, one lane per (sample, level): its cell, corners and weights
  uint32_t idx[8];
  float w[8];
  if (t < total) {
    const long long b = t / n_levels;
    const int l = static_cast<int>(t - b * n_levels);
    const Cell c = level_cell(coords + 3 * b, lv.scale[l]);
#pragma unroll
    for (int corner = 0; corner < 8; ++corner) {
      level_corner<kPaired>(c, corner, lv, l, &idx[corner], &w[corner]);
      w[corner] = to_compute<kBf16>(w[corner]);
    }
  } else {
#pragma unroll
    for (int corner = 0; corner < 8; ++corner) {
      idx[corner] = 0;
      w[corner] = 0.0f;
    }
  }
  // phase 2, lanes by (row, feature group): each warp instruction adds kS
  // whole rows, kG adjacent lanes a row, so every sector it touches is
  // written whole. Lane (slot, h) adds features [h·kV, h·kV + kV) of the
  // rows of (sample, level) src = grp·kS + slot of this warp; the corners
  // and weights come from that lane by shuffle.
  const int lane = threadIdx.x & 31;
  const int h = lane % kG;
  const long long warp_t = t - lane;
#pragma unroll
  for (int grp = 0; grp < kG; ++grp) {
    const int src = grp * kS + lane / kG;
    const long long ts = warp_t + src;
    const bool ok = ts < total;
    float gv[kV];
    if (ok) {
      load_row<kV>(g + ts * F + h * kV, gv);
    } else {
#pragma unroll
      for (int q = 0; q < kV; ++q) gv[q] = 0.0f;
    }
#pragma unroll
    for (int corner = 0; corner < 8; ++corner) {
      uint32_t row = idx[corner];
      float wc = w[corner];
      if constexpr (kG > 1) {
        row = __shfl_sync(0xffffffffu, row, src);
        wc = __shfl_sync(0xffffffffu, wc, src);
      }
      float add[kV];
#pragma unroll
      for (int q = 0; q < kV; ++q) add[q] = to_compute<kBf16>(gv[q] * wc);
      if (ok) red_add<kV>(grad + static_cast<long long>(row) * F + h * kV, add);
    }
  }
}

// A table row as the coordinates' backward reads it: from global memory
// through the read-only cache (the package's kernel), or from elsewhere
// (scripts/coords_variants.cu serves coarse dense levels from shared
// memory)
template <typename T, int F>
struct GlobalRows {
  const T* __restrict__ table;
  __device__ __forceinline__ void operator()(uint32_t idx,
                                             float (&row)[F]) const {
    load_row<F>(table + static_cast<size_t>(idx) * F, row);
  }
};

// One (sample, level)'s term of the coordinates' gradient, added into
// acc[3]: per corner in order, the row rounded to the compute type dotted
// with the cotangent row gv in float32 in feature order, times the three
// weight derivatives; then times scale_l.
template <int F, bool kBf16, bool kPaired, class Rows>
__device__ __forceinline__ void coords_level_term(const Rows& rows,
                                                  const float* p,
                                                  const float (&gv)[F],
                                                  const Levels& lv, int l,
                                                  float (&acc)[3]) {
  const Cell c = level_cell(p, lv.scale[l]);
  // the corner's bit along axis k is bit (k − a) mod 3: tcnn's x, y, z
  // (a = 0), or a paired level's half along its pairing axis a = l mod 3
  // and pair-row bits along the two after it (paired_corner)
  const int a = kPaired && !((lv.dense_mask >> l) & 1u) ? l % 3 : 0;
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    uint32_t idx;
    float w_unused;
    level_corner<kPaired>(c, corner, lv, l, &idx, &w_unused);
    float row[F];
    rows(idx, row);
    float dw = 0.0f;
#pragma unroll
    for (int f = 0; f < F; ++f) dw += to_compute<kBf16>(row[f]) * gv[f];
    bool up[3];
    float w[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      up[k] = (corner >> ((k - a + 3) % 3)) & 1;
      w[k] = up[k] ? c.frac[k] : 1.0f - c.frac[k];
    }
    const float d[3] = {w[1] * w[2], w[0] * w[2], w[0] * w[1]};
#pragma unroll
    for (int k = 0; k < 3; ++k) acc[k] += dw * (up[k] ? d[k] : -d[k]);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) acc[k] *= lv.scale[l];
}

// Coordinates' backward (hash_encode_coords_backward; plain version
// ops/hash_encoding.py::_plain_coords_backward): grad_p[a] = Σ_l scale_l ·
// Σ_c ±Π_{b≠a} w_c,b · ⟨g_l, T[idx_c]⟩, + where corner c lies on the upper
// side of axis a. K3's lane map, one lane per (sample, level), with the
// levels padded to Lp = 2^lp_log2 ≥ L lanes so that a sample's lanes are
// one aligned group of a warp (4 samples a warp at L = 8): lane t is sample
// t / Lp, level t mod Lp, and a padding level adds 0. Each lane takes its
// cell, then per corner K3's address and vector row load; the row, rounded
// to the compute type, is dotted with the lane's cotangent row in float32
// in feature order, and the dot times the three weight derivatives is
// summed over the corners in order, then times scale_l. The Lp lanes of a
// sample then reduce by shuffles within their group, in a fixed order (no
// atomics: the same bits on every run), and the group's first lane stores
// the sample's 3 floats. A lane past the last sample adds 0 but takes part
// in the shuffles. Bound on an H100: bytes, each distinct table row once,
// the coords, the cotangent and the gradient.
template <typename T, typename G, int F, bool kBf16, bool kPaired>
__global__ void __launch_bounds__(kThreads)
hash_encode_coords_backward_kernel(const T* __restrict__ table,
                                   const float* __restrict__ coords,
                                   const G* __restrict__ g,
                                   float* __restrict__ grad, long long n,
                                   int n_levels, int lp_log2, Levels lv) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const int lp = 1 << lp_log2;
  const long long b = t >> lp_log2;
  const int l = static_cast<int>(t & (lp - 1));
  float acc[3] = {0.0f, 0.0f, 0.0f};
  if (b < n && l < n_levels) {
    float gv[F];
    load_row<F>(g + (b * n_levels + l) * F, gv);
    coords_level_term<F, kBf16, kPaired>(GlobalRows<T, F>{table},
                                         coords + 3 * b, gv, lv, l, acc);
  }
  for (int off = lp >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
      acc[k] += __shfl_down_sync(0xffffffffu, acc[k], off, lp);
  }
  if (l == 0 && b < n) {
#pragma unroll
    for (int k = 0; k < 3; ++k) grad[3 * b + k] = acc[k];
  }
}

bool make_levels(int n_levels, const void* scales, const void* levels,
                 Levels* lv) {
  if (n_levels <= 0 || n_levels > kMaxLevels) return false;
  const float* s = static_cast<const float*>(scales);
  const int* p = static_cast<const int*>(levels);
  lv->dense_mask = 0;
  lv->pow2_mask = 0;
  for (int l = 0; l < n_levels; ++l) {
    lv->scale[l] = s[l];
    lv->res[l] = static_cast<uint32_t>(p[4 * l]);
    lv->size[l] = static_cast<uint32_t>(p[4 * l + 1]);
    lv->offset[l] = static_cast<uint32_t>(p[4 * l + 2]);
    if (p[4 * l + 3]) lv->dense_mask |= 1u << l;
    if (lv->size[l] == 0) return false;
    if ((lv->size[l] & (lv->size[l] - 1u)) == 0) lv->pow2_mask |= 1u << l;
  }
  return true;
}

unsigned blocks_for(long long n, int n_levels) {
  return static_cast<unsigned>((n * n_levels + kThreads - 1) / kThreads);
}

template <typename T, typename Out, int F, bool kBf16, bool kPaired>
cudaError_t forward_launch(const void* table, const float* coords, void* out,
                           long long n, int n_levels, const Levels& lv,
                           const int* count, long long offset,
                           cudaStream_t s) {
  hash_encode_forward_kernel<T, Out, F, kBf16, kPaired>
      <<<blocks_for(n, n_levels), kThreads, 0, s>>>(
          static_cast<const T*>(table), coords, static_cast<Out*>(out),
          static_cast<uint32_t>(n * n_levels), n_levels, lv, count, offset);
  return cudaGetLastError();
}

template <typename T, int F, bool kPaired>
cudaError_t forward_typed(const void* table, const float* coords, void* out,
                          long long n, int n_levels, const Levels& lv,
                          int out_bf16, const int* count, long long offset,
                          cudaStream_t s) {
  return out_bf16
             ? forward_launch<T, uint16_t, F, true, kPaired>(
                   table, coords, out, n, n_levels, lv, count, offset, s)
             : forward_launch<T, float, F, false, kPaired>(
                   table, coords, out, n, n_levels, lv, count, offset, s);
}

template <int F, bool kPaired>
cudaError_t forward_p(const void* table, const float* coords, void* out,
                      long long n, int n_levels, const Levels& lv,
                      int table_bf16, int out_bf16, const int* count,
                      long long offset, cudaStream_t s) {
  return table_bf16
             ? forward_typed<uint16_t, F, kPaired>(table, coords, out, n,
                                                   n_levels, lv, out_bf16,
                                                   count, offset, s)
             : forward_typed<float, F, kPaired>(table, coords, out, n,
                                                n_levels, lv, out_bf16, count,
                                                offset, s);
}

template <int F>
cudaError_t forward_f(const void* table, const float* coords, void* out,
                      long long n, int n_levels, const Levels& lv,
                      int table_bf16, int out_bf16, int paired,
                      const int* count, long long offset, cudaStream_t s) {
  return paired ? forward_p<F, true>(table, coords, out, n, n_levels, lv,
                                     table_bf16, out_bf16, count, offset, s)
                : forward_p<F, false>(table, coords, out, n, n_levels, lv,
                                      table_bf16, out_bf16, count, offset, s);
}

template <int F, bool kPaired>
cudaError_t backward_p(const float* coords, const void* g, float* grad,
                       long long n, int n_levels, const Levels& lv,
                       int g_bf16, cudaStream_t s) {
  if (g_bf16) {
    hash_encode_backward_kernel<uint16_t, F, true, kPaired>
        <<<blocks_for(n, n_levels), kThreads, 0, s>>>(
            coords, static_cast<const uint16_t*>(g), grad, n, n_levels, lv);
  } else {
    hash_encode_backward_kernel<float, F, false, kPaired>
        <<<blocks_for(n, n_levels), kThreads, 0, s>>>(
            coords, static_cast<const float*>(g), grad, n, n_levels, lv);
  }
  return cudaGetLastError();
}

template <int F>
cudaError_t backward_f(const float* coords, const void* g, float* grad,
                       long long n, int n_levels, const Levels& lv,
                       int g_bf16, int paired, cudaStream_t s) {
  return paired ? backward_p<F, true>(coords, g, grad, n, n_levels, lv,
                                      g_bf16, s)
                : backward_p<F, false>(coords, g, grad, n, n_levels, lv,
                                       g_bf16, s);
}

template <typename T, int F, bool kPaired>
cudaError_t coords_backward_t(const void* table, const float* coords,
                              const void* g, float* grad, long long n,
                              int n_levels, int lp_log2, const Levels& lv,
                              int g_bf16, cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>(
      ((n << lp_log2) + kThreads - 1) / kThreads);
  if (g_bf16) {
    hash_encode_coords_backward_kernel<T, uint16_t, F, true, kPaired>
        <<<blocks, kThreads, 0, s>>>(
            static_cast<const T*>(table), coords,
            static_cast<const uint16_t*>(g), grad, n, n_levels, lp_log2, lv);
  } else {
    hash_encode_coords_backward_kernel<T, float, F, false, kPaired>
        <<<blocks, kThreads, 0, s>>>(
            static_cast<const T*>(table), coords,
            static_cast<const float*>(g), grad, n, n_levels, lp_log2, lv);
  }
  return cudaGetLastError();
}

template <int F>
cudaError_t coords_backward_f(const void* table, const float* coords,
                              const void* g, float* grad, long long n,
                              int n_levels, int lp_log2, const Levels& lv,
                              int table_bf16, int g_bf16, int paired,
                              cudaStream_t s) {
  if (table_bf16) {
    return paired ? coords_backward_t<uint16_t, F, true>(
                        table, coords, g, grad, n, n_levels, lp_log2, lv,
                        g_bf16, s)
                  : coords_backward_t<uint16_t, F, false>(
                        table, coords, g, grad, n, n_levels, lp_log2, lv,
                        g_bf16, s);
  }
  return paired ? coords_backward_t<float, F, true>(table, coords, g, grad, n,
                                                    n_levels, lp_log2, lv,
                                                    g_bf16, s)
                : coords_backward_t<float, F, false>(table, coords, g, grad,
                                                     n, n_levels, lp_log2, lv,
                                                     g_bf16, s);
}

}  // namespace

// table [T, F] (f32, or bf16 if table_bf16), 16-byte aligned; coords [n, 3]
// f32; out [n, L·F] in the compute type (bf16 if out_bf16, else f32).
// scales: host float [L]; levels: host int [L][4] = (res, size, offset,
// dense). F is 1, 2, 4 or 8; L ≤ 32; n·L < 2^31. paired: the paired
// layout's hashed levels (each hashed level's size even).
// count: null, or an int32 on the device: then only the samples i <
// *count - offset are encoded, and the rows of out past them are left as
// they were (the launch is sized for n either way).
extern "C" int hash_encode_forward(const void* table, const void* coords,
                                   void* out, long long n, int n_levels,
                                   int n_features, const void* scales,
                                   const void* levels, int table_bf16,
                                   int out_bf16, int paired,
                                   const void* count, long long offset,
                                   void* stream) {
  Levels lv;
  if (!make_levels(n_levels, scales, levels, &lv)) return cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  // the lanes are numbered in 32 bits
  if (n * n_levels > 0x7fffffffLL) return cudaErrorInvalidValue;
  const float* c = static_cast<const float*>(coords);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* cnt = static_cast<const int*>(count);
  switch (n_features) {
    case 1:
      return forward_f<1>(table, c, out, n, n_levels, lv, table_bf16, out_bf16,
                          paired, cnt, offset, s);
    case 2:
      return forward_f<2>(table, c, out, n, n_levels, lv, table_bf16, out_bf16,
                          paired, cnt, offset, s);
    case 4:
      return forward_f<4>(table, c, out, n, n_levels, lv, table_bf16, out_bf16,
                          paired, cnt, offset, s);
    case 8:
      return forward_f<8>(table, c, out, n, n_levels, lv, table_bf16, out_bf16,
                          paired, cnt, offset, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// grad [T, F] f32, zeroed by the caller, accumulates the table gradient of
// the cotangent g [n, L·F] (bf16 if g_bf16, which is also the compute type,
// else f32). The other arguments as for hash_encode_forward.
extern "C" int hash_encode_backward(const void* coords, const void* g,
                                    void* grad, long long n, int n_levels,
                                    int n_features, const void* scales,
                                    const void* levels, int g_bf16,
                                    int paired, void* stream) {
  Levels lv;
  if (!make_levels(n_levels, scales, levels, &lv)) return cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  const float* c = static_cast<const float*>(coords);
  float* gr = static_cast<float*>(grad);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_features) {
    case 1:
      return backward_f<1>(c, g, gr, n, n_levels, lv, g_bf16, paired, s);
    case 2:
      return backward_f<2>(c, g, gr, n, n_levels, lv, g_bf16, paired, s);
    case 4:
      return backward_f<4>(c, g, gr, n, n_levels, lv, g_bf16, paired, s);
    case 8:
      return backward_f<8>(c, g, gr, n, n_levels, lv, g_bf16, paired, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// grad_coords [n, 3] f32 receives the coordinates' gradient of the
// cotangent g [n, L·F] (bf16 if g_bf16, which is also the compute type:
// the table's rows are rounded to it; else f32) through the table [T, F]
// (f32, or bf16 if table_bf16); every row of it is written. The other
// arguments as for hash_encode_forward; g 16-byte aligned as the table.
extern "C" int hash_encode_coords_backward(
    const void* table, const void* coords, const void* g, void* grad_coords,
    long long n, int n_levels, int n_features, const void* scales,
    const void* levels, int table_bf16, int g_bf16, int paired,
    void* stream) {
  Levels lv;
  if (!make_levels(n_levels, scales, levels, &lv)) return cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  int lp_log2 = 0;
  while ((1 << lp_log2) < n_levels) ++lp_log2;  // L ≤ 32: a warp at most
  if ((n << lp_log2) / kThreads > 0x7fffffffLL) return cudaErrorInvalidValue;
  const float* c = static_cast<const float*>(coords);
  float* gr = static_cast<float*>(grad_coords);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_features) {
    case 1:
      return coords_backward_f<1>(table, c, g, gr, n, n_levels, lp_log2, lv,
                                  table_bf16, g_bf16, paired, s);
    case 2:
      return coords_backward_f<2>(table, c, g, gr, n, n_levels, lp_log2, lv,
                                  table_bf16, g_bf16, paired, s);
    case 4:
      return coords_backward_f<4>(table, c, g, gr, n, n_levels, lp_log2, lv,
                                  table_bf16, g_bf16, paired, s);
    case 8:
      return coords_backward_f<8>(table, c, g, gr, n, n_levels, lp_log2, lv,
                                  table_bf16, g_bf16, paired, s);
    default:
      return cudaErrorInvalidValue;
  }
}
