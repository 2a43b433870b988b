// Multi-resolution hash-grid encoding for Hopper, sm_90a: forward gather and
// backward scatter (tiny-cuda-nn's GridEncoding).
//
// Replaces no TPU kernel: the JAX package computes the encoding in XLA
// (instantvnr_tpu/ops/hash_encoding.py::hash_encode, a gather whose autodiff
// is a scatter-add), since Mosaic has no gather or scatter. These are the
// training step's own kernels.
//
// One thread per (sample, level), thread index = sample · L + level, so a
// warp covers few samples and all their levels and writes consecutive
// output rows. Per level the thread computes tcnn's position
// x = p·scale + 0.5, cell = floor(x), w = x − cell, then for each of the 8
// corners (x fastest) the dense stride index (levels with res³ ≤ size) or
// the prime-XOR hash (x·1) ⊻ (y·2654435761) ⊻ (z·805459861), both in
// uint32, then % size + the level's offset: the plain version's arithmetic
// (ops/hash_encoding.py::corner_indices_and_weights) step for step.
//
// Forward: the 8 rows of F features are gathered with vector loads (an f32
// row of F = 8 is one 32-byte sector) from an f32 or a bf16 table; each
// product row·w is rounded to the compute type, the 8 are summed in float32
// and the sum is rounded to the compute type, as the plain version's
// PyTorch ops round. Bound on an H100: bytes, the 8 gathered rows per
// sample and level (at the reference 8 × 8 layout and B = 65,536, 134 MB of
// f32 rows).
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

__device__ __forceinline__ Cell level_cell(const float* __restrict__ coords,
                                           long long b, float scale) {
  Cell c;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    // two roundings, x = p·scale then + 0.5, as in the plain version
    const float x = coords[3 * b + a] * scale + 0.5f;
    const float cell = floorf(x);
    c.frac[a] = x - cell;
    c.pos[a] = static_cast<uint32_t>(static_cast<long long>(cell));
  }
  return c;
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
  return idx % lv.size[l] + lv.offset[l];
}

__device__ __forceinline__ float corner_weight(const Cell& c, int corner) {
  const float wx = (corner & 1) ? c.frac[0] : 1.0f - c.frac[0];
  const float wy = ((corner >> 1) & 1) ? c.frac[1] : 1.0f - c.frac[1];
  const float wz = ((corner >> 2) & 1) ? c.frac[2] : 1.0f - c.frac[2];
  return wx * wy * wz;
}

template <typename T, int F, bool kBf16>
__global__ void __launch_bounds__(kThreads)
hash_encode_forward_kernel(const T* __restrict__ table,
                           const float* __restrict__ coords,
                           void* __restrict__ out, long long n, int n_levels,
                           Levels lv) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (t >= n * n_levels) return;
  const long long b = t / n_levels;
  const int l = static_cast<int>(t - b * n_levels);
  const Cell c = level_cell(coords, b, lv.scale[l]);
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    const uint32_t idx = corner_index(c, corner, lv, l);
    const float w = to_compute<kBf16>(corner_weight(c, corner));
    float row[F];
    load_row<F>(table + static_cast<long long>(idx) * F, row);
#pragma unroll
    for (int f = 0; f < F; ++f) {
      acc[f] += to_compute<kBf16>(to_compute<kBf16>(row[f]) * w);
    }
  }
  // output row t of [B·L, F] == features [b, l·F .. l·F+F)
  if constexpr (kBf16) {
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out) + t * F;
#pragma unroll
    for (int f = 0; f < F; ++f) o[f] = __float2bfloat16_rn(acc[f]);
  } else {
    float* o = static_cast<float*>(out) + t * F;
#pragma unroll
    for (int f = 0; f < F; ++f) o[f] = acc[f];
  }
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

template <typename G, int F, bool kBf16>
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
    const Cell c = level_cell(coords, b, lv.scale[l]);
#pragma unroll
    for (int corner = 0; corner < 8; ++corner) {
      idx[corner] = corner_index(c, corner, lv, l);
      w[corner] = to_compute<kBf16>(corner_weight(c, corner));
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

bool make_levels(int n_levels, const void* scales, const void* levels,
                 Levels* lv) {
  if (n_levels <= 0 || n_levels > kMaxLevels) return false;
  const float* s = static_cast<const float*>(scales);
  const int* p = static_cast<const int*>(levels);
  lv->dense_mask = 0;
  for (int l = 0; l < n_levels; ++l) {
    lv->scale[l] = s[l];
    lv->res[l] = static_cast<uint32_t>(p[4 * l]);
    lv->size[l] = static_cast<uint32_t>(p[4 * l + 1]);
    lv->offset[l] = static_cast<uint32_t>(p[4 * l + 2]);
    if (p[4 * l + 3]) lv->dense_mask |= 1u << l;
  }
  return true;
}

unsigned blocks_for(long long n, int n_levels) {
  return static_cast<unsigned>((n * n_levels + kThreads - 1) / kThreads);
}

template <typename T, int F>
cudaError_t forward_typed(const void* table, const float* coords, void* out,
                          long long n, int n_levels, const Levels& lv,
                          int out_bf16, cudaStream_t s) {
  const T* tab = static_cast<const T*>(table);
  if (out_bf16) {
    hash_encode_forward_kernel<T, F, true>
        <<<blocks_for(n, n_levels), kThreads, 0, s>>>(tab, coords, out, n,
                                                      n_levels, lv);
  } else {
    hash_encode_forward_kernel<T, F, false>
        <<<blocks_for(n, n_levels), kThreads, 0, s>>>(tab, coords, out, n,
                                                      n_levels, lv);
  }
  return cudaGetLastError();
}

template <int F>
cudaError_t forward_f(const void* table, const float* coords, void* out,
                      long long n, int n_levels, const Levels& lv,
                      int table_bf16, int out_bf16, cudaStream_t s) {
  return table_bf16
             ? forward_typed<uint16_t, F>(table, coords, out, n, n_levels, lv,
                                          out_bf16, s)
             : forward_typed<float, F>(table, coords, out, n, n_levels, lv,
                                       out_bf16, s);
}

template <int F>
cudaError_t backward_f(const float* coords, const void* g, float* grad,
                       long long n, int n_levels, const Levels& lv,
                       int g_bf16, cudaStream_t s) {
  if (g_bf16) {
    hash_encode_backward_kernel<uint16_t, F, true>
        <<<blocks_for(n, n_levels), kThreads, 0, s>>>(
            coords, static_cast<const uint16_t*>(g), grad, n, n_levels, lv);
  } else {
    hash_encode_backward_kernel<float, F, false>
        <<<blocks_for(n, n_levels), kThreads, 0, s>>>(
            coords, static_cast<const float*>(g), grad, n, n_levels, lv);
  }
  return cudaGetLastError();
}

}  // namespace

// table [T, F] (f32, or bf16 if table_bf16), 16-byte aligned; coords [n, 3]
// f32; out [n, L·F] in the compute type (bf16 if out_bf16, else f32).
// scales: host float [L]; levels: host int [L][4] = (res, size, offset,
// dense). F is 1, 2, 4 or 8; L ≤ 32.
extern "C" int hash_encode_forward(const void* table, const void* coords,
                                   void* out, long long n, int n_levels,
                                   int n_features, const void* scales,
                                   const void* levels, int table_bf16,
                                   int out_bf16, void* stream) {
  Levels lv;
  if (!make_levels(n_levels, scales, levels, &lv)) return cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  const float* c = static_cast<const float*>(coords);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_features) {
    case 1:
      return forward_f<1>(table, c, out, n, n_levels, lv, table_bf16, out_bf16,
                          s);
    case 2:
      return forward_f<2>(table, c, out, n, n_levels, lv, table_bf16, out_bf16,
                          s);
    case 4:
      return forward_f<4>(table, c, out, n, n_levels, lv, table_bf16, out_bf16,
                          s);
    case 8:
      return forward_f<8>(table, c, out, n, n_levels, lv, table_bf16, out_bf16,
                          s);
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
                                    void* stream) {
  Levels lv;
  if (!make_levels(n_levels, scales, levels, &lv)) return cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  const float* c = static_cast<const float*>(coords);
  float* gr = static_cast<float*>(grad);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_features) {
    case 1:
      return backward_f<1>(c, g, gr, n, n_levels, lv, g_bf16, s);
    case 2:
      return backward_f<2>(c, g, gr, n, n_levels, lv, g_bf16, s);
    case 4:
      return backward_f<4>(c, g, gr, n, n_levels, lv, g_bf16, s);
    case 8:
      return backward_f<8>(c, g, gr, n, n_levels, lv, g_bf16, s);
    default:
      return cudaErrorInvalidValue;
  }
}
