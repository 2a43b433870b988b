// Designs of the hash encoding's coordinate backward
// (hash_encode_coords_backward) that the package does not ship, built
// beside the package's kernel for scripts/coords_variants.py to time
// against it on the card. Includes the package's source, so every design
// shares its coords_level_term (one (sample, level)'s term, operation for
// operation), level_corner, load_row and rounding, and sums a sample's
// levels in the package's shuffle-tree order: each design's output equals
// the package kernel's bit for bit.
//
// coords_variant(..., variant) launches, for F = 8 and an f32 table:
//   1 level_major   a warp takes 32 consecutive samples on one level (a
//                   block of 8 warps: 32 samples, warp w levels w, w + 8,
//                   ...), so a coarse level's rows are shared within a
//                   warp instruction; the (sample, level) terms staged in
//                   shared memory [Lp][32][3], then the first warp sums
//                   each sample's terms in the package's tree order
//   2 smem_dense    1, persistent blocks (as many as fit on the card), the
//                   dense levels whose rows fit in 96 KB copied once a
//                   block into shared memory (bf16 rows in bf16 compute,
//                   where the kernel rounds them to bf16 anyway) and
//                   served from there: at the 2^19 schema level 0
//                   (16³ rows)
//   3 two_a_lane    the package's lane map, one lane per (sample pair,
//                   level): each lane's two samples' 16 corner rows are
//                   loaded before either is used, for more loads in flight
#include "../instantvnr_torch/csrc/hash_encode.cu"

#include <type_traits>

namespace {

constexpr int kVF = 8;  // features a row
constexpr int kLmWarps = 8;
constexpr int kLmThreads = 32 * kLmWarps;
constexpr int kSmemRowsBytes = 96 * 1024;

// sum each of the block's 32 samples' Lp staged terms (part [Lp][32][3])
// in the package's shuffle-tree order and store them; run by warp 0
__device__ __forceinline__ void sum_levels_and_store(float* part, int lane,
                                                     int lp, long long b,
                                                     long long n,
                                                     float* __restrict__ grad) {
  for (int off = lp >> 1; off > 0; off >>= 1) {
    for (int l = 0; l < off; ++l) {
#pragma unroll
      for (int k = 0; k < 3; ++k)
        part[(l * 32 + lane) * 3 + k] += part[((l + off) * 32 + lane) * 3 + k];
    }
  }
  if (b < n) {
#pragma unroll
    for (int k = 0; k < 3; ++k) grad[3 * b + k] = part[lane * 3 + k];
  }
}

template <typename G, bool kBf16, bool kPaired, class Rows>
__device__ __forceinline__ void stage_term(const Rows& rows,
                                           const float* __restrict__ coords,
                                           const G* __restrict__ g,
                                           long long n, int n_levels,
                                           const Levels& lv, long long b,
                                           int l, int lane, float* part) {
  float acc[3] = {0.0f, 0.0f, 0.0f};
  if (b < n && l < n_levels) {
    float gv[kVF];
    load_row<kVF>(g + (b * n_levels + l) * kVF, gv);
    coords_level_term<kVF, kBf16, kPaired>(rows, coords + 3 * b, gv, lv, l,
                                           acc);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) part[(l * 32 + lane) * 3 + k] = acc[k];
}

template <typename G, bool kBf16, bool kPaired>
__global__ void __launch_bounds__(kLmThreads)
coords_v_level_major_kernel(const float* __restrict__ table,
                            const float* __restrict__ coords,
                            const G* __restrict__ g,
                            float* __restrict__ grad, long long n,
                            int n_levels, int lp_log2, Levels lv) {
  extern __shared__ float4 smem[];
  float* part = reinterpret_cast<float*>(smem);
  const int lp = 1 << lp_log2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long b = static_cast<long long>(blockIdx.x) * 32 + lane;
  for (int l = warp; l < lp; l += kLmWarps)
    stage_term<G, kBf16, kPaired>(GlobalRows<float, kVF>{table}, coords, g,
                                  n, n_levels, lv, b, l, lane, part);
  __syncthreads();
  if (warp == 0) sum_levels_and_store(part, lane, lp, b, n, grad);
}

// rows of the levels in `first`..`first + count` held in shared memory
template <typename S>
struct SharedRows {
  const S* rows;
  uint32_t first;
  __device__ __forceinline__ void operator()(uint32_t idx,
                                             float (&row)[kVF]) const {
    const S* r = rows + static_cast<size_t>(idx - first) * kVF;
#pragma unroll
    for (int f = 0; f < kVF; ++f) {
      if constexpr (std::is_same_v<S, float>) {
        row[f] = r[f];
      } else {
        row[f] = bf16_bits(r[f]);
      }
    }
  }
};

template <typename G, bool kBf16, bool kPaired>
__global__ void __launch_bounds__(kLmThreads)
coords_v_smem_dense_kernel(const float* __restrict__ table,
                           const float* __restrict__ coords,
                           const G* __restrict__ g,
                           float* __restrict__ grad, long long n,
                           int n_levels, int lp_log2, Levels lv,
                           uint32_t smem_levels, uint32_t first,
                           uint32_t n_rows) {
  using S = std::conditional_t<kBf16, uint16_t, float>;
  extern __shared__ float4 smem[];
  const int lp = 1 << lp_log2;
  float* part = reinterpret_cast<float*>(smem);
  S* rows = reinterpret_cast<S*>(part + lp * 32 * 3);
  for (uint32_t i = threadIdx.x; i < n_rows * kVF; i += kLmThreads) {
    const float v = __ldg(table + static_cast<size_t>(first) * kVF + i);
    if constexpr (kBf16) {
      rows[i] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
    } else {
      rows[i] = v;
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (long long b0 = static_cast<long long>(blockIdx.x) * 32; b0 < n;
       b0 += static_cast<long long>(gridDim.x) * 32) {
    const long long b = b0 + lane;
    for (int l = warp; l < lp; l += kLmWarps) {
      if ((smem_levels >> l) & 1u) {
        stage_term<G, kBf16, kPaired>(SharedRows<S>{rows, first}, coords, g,
                                      n, n_levels, lv, b, l, lane, part);
      } else {
        stage_term<G, kBf16, kPaired>(GlobalRows<float, kVF>{table}, coords,
                                      g, n, n_levels, lv, b, l, lane, part);
      }
    }
    __syncthreads();
    if (warp == 0) sum_levels_and_store(part, lane, lp, b, n, grad);
    __syncthreads();  // the next group reuses part
  }
}

// two samples' terms on one level, their 16 corner rows loaded before
// either sample's arithmetic; each sample's operations are
// coords_level_term's in its order
template <typename G, bool kBf16, bool kPaired>
__device__ __forceinline__ void two_terms(const float* __restrict__ table,
                                          const float* __restrict__ coords,
                                          const G* __restrict__ g,
                                          int n_levels, const Levels& lv,
                                          const long long (&b)[2], int l,
                                          float (&acc)[2][3]) {
  Cell c[2];
  float gv[2][kVF];
  int a = kPaired && !((lv.dense_mask >> l) & 1u) ? l % 3 : 0;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    c[s] = level_cell(coords + 3 * b[s], lv.scale[l]);
    load_row<kVF>(g + (b[s] * n_levels + l) * kVF, gv[s]);
  }
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    float row[2][kVF];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      uint32_t idx;
      float w_unused;
      level_corner<kPaired>(c[s], corner, lv, l, &idx, &w_unused);
      load_row<kVF>(table + static_cast<size_t>(idx) * kVF, row[s]);
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      float dw = 0.0f;
#pragma unroll
      for (int f = 0; f < kVF; ++f)
        dw += to_compute<kBf16>(row[s][f]) * gv[s][f];
      bool up[3];
      float w[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        up[k] = (corner >> ((k - a + 3) % 3)) & 1;
        w[k] = up[k] ? c[s].frac[k] : 1.0f - c[s].frac[k];
      }
      const float d[3] = {w[1] * w[2], w[0] * w[2], w[0] * w[1]};
#pragma unroll
      for (int k = 0; k < 3; ++k) acc[s][k] += dw * (up[k] ? d[k] : -d[k]);
    }
  }
#pragma unroll
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int k = 0; k < 3; ++k) acc[s][k] *= lv.scale[l];
  }
}

template <typename G, bool kBf16, bool kPaired>
__global__ void __launch_bounds__(kThreads)
coords_v_two_kernel(const float* __restrict__ table,
                    const float* __restrict__ coords,
                    const G* __restrict__ g, float* __restrict__ grad,
                    long long n, int n_levels, int lp_log2, Levels lv) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const int lp = 1 << lp_log2;
  const long long q = t >> lp_log2;
  const int l = static_cast<int>(t & (lp - 1));
  // a pair's second sample past the end repeats the first, unstored
  const long long b[2] = {2 * q, 2 * q + 1 < n ? 2 * q + 1 : 2 * q};
  float acc[2][3] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
  if (b[0] < n && l < n_levels)
    two_terms<G, kBf16, kPaired>(table, coords, g, n_levels, lv, b, l, acc);
  for (int off = lp >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
#pragma unroll
      for (int k = 0; k < 3; ++k)
        acc[s][k] += __shfl_down_sync(0xffffffffu, acc[s][k], off, lp);
    }
  }
  if (l == 0) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (2 * q + s < n) {
#pragma unroll
        for (int k = 0; k < 3; ++k) grad[3 * (2 * q + s) + k] = acc[s][k];
      }
    }
  }
}

template <typename G, bool kBf16, bool kPaired>
int launch_variant(const float* table, const float* coords, const void* gp,
                   float* grad, long long n, int n_levels, int lp_log2,
                   const Levels& lv, int variant, cudaStream_t s) {
  const G* g = static_cast<const G*>(gp);
  const int lp = 1 << lp_log2;
  const int part_bytes = lp * 32 * 3 * static_cast<int>(sizeof(float));
  if (variant == 1) {
    coords_v_level_major_kernel<G, kBf16, kPaired>
        <<<static_cast<unsigned>((n + 31) / 32), kLmThreads, part_bytes,
           s>>>(table, coords, g, grad, n, n_levels, lp_log2, lv);
  } else if (variant == 2) {
    // the dense levels, from level 0 on, whose rows fit
    using S = std::conditional_t<kBf16, uint16_t, float>;
    uint32_t mask = 0, first = lv.offset[0], rows = 0;
    for (int l = 0; l < n_levels && ((lv.dense_mask >> l) & 1u); ++l) {
      if ((rows + lv.size[l]) * kVF * sizeof(S) > kSmemRowsBytes) break;
      if (lv.offset[l] != first + rows) break;
      rows += lv.size[l];
      mask |= 1u << l;
    }
    const int bytes = part_bytes + static_cast<int>(rows * kVF * sizeof(S));
    auto kernel = coords_v_smem_dense_kernel<G, kBf16, kPaired>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         bytes);
    int per_sm = 0, sms = 0, dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                  kLmThreads, bytes);
    const long long groups = (n + 31) / 32;
    const long long want = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
    kernel<<<static_cast<unsigned>(groups < want ? groups : want),
             kLmThreads, bytes, s>>>(table, coords, g, grad, n, n_levels,
                                     lp_log2, lv, mask, first, rows);
  } else if (variant == 3) {
    const long long lanes = ((n + 1) / 2) << lp_log2;
    coords_v_two_kernel<G, kBf16, kPaired>
        <<<static_cast<unsigned>((lanes + kThreads - 1) / kThreads),
           kThreads, 0, s>>>(table, coords, g, grad, n, n_levels, lp_log2,
                             lv);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// The package's hash_encode_coords_backward contract for F = 8 and an f32
// table, through design `variant` (1-3 above).
extern "C" int coords_variant(const void* table, const void* coords,
                              const void* g, void* grad_coords, long long n,
                              int n_levels, const void* scales,
                              const void* levels, int g_bf16, int paired,
                              int variant, void* stream) {
  Levels lv;
  if (!make_levels(n_levels, scales, levels, &lv)) return cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  int lp_log2 = 0;
  while ((1 << lp_log2) < n_levels) ++lp_log2;
  const float* t = static_cast<const float*>(table);
  const float* c = static_cast<const float*>(coords);
  float* gr = static_cast<float*>(grad_coords);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_bf16) {
    return paired ? launch_variant<uint16_t, true, true>(
                        t, c, g, gr, n, n_levels, lp_log2, lv, variant, s)
                  : launch_variant<uint16_t, true, false>(
                        t, c, g, gr, n, n_levels, lp_log2, lv, variant, s);
  }
  return paired ? launch_variant<float, false, true>(t, c, g, gr, n, n_levels,
                                                     lp_log2, lv, variant, s)
                : launch_variant<float, false, false>(t, c, g, gr, n,
                                                      n_levels, lp_log2, lv,
                                                      variant, s);
}
