// Designs of the hash-grid backward scatter (K4) that the package does not
// ship, built beside the package's kernel for scripts/k4_variants.py to time
// against it on the card. Includes the package's source, so every design
// shares its level_cell, corner_index, corner_weight, rounding and
// red_add.
//
// variant 0, "scalar": the package's previous design, one lane per
//   (sample, level), lanes numbered sample · L + level, F scalar atomicAdds
//   per corner.
// variant 1, "pair_v4": the same lanes, each corner row added with 16-byte
//   vector reductions (two per F = 8 row) by the one lane.
// The package's kernel (hash_encode_backward) maps lanes to (row, feature
// group) instead: two adjacent lanes per F = 8 row.
#include "../instantvnr_torch/csrc/hash_encode.cu"

namespace {

template <typename G, int F, bool kBf16, bool kVector>
__global__ void __launch_bounds__(kThreads)
k4_per_pair_kernel(const float* __restrict__ coords, const G* __restrict__ g,
                   float* __restrict__ grad, long long n, int n_levels,
                   Levels lv) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (t >= n * n_levels) return;
  const long long b = t / n_levels;
  const int l = static_cast<int>(t - b * n_levels);
  const Cell c = level_cell(coords, b, lv.scale[l]);
  float gv[F];
  load_row<F>(g + t * F, gv);
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    const uint32_t idx = corner_index(c, corner, lv, l);
    const float w = to_compute<kBf16>(corner_weight(c, corner));
    float* dst = grad + static_cast<long long>(idx) * F;
    float add[F];
#pragma unroll
    for (int f = 0; f < F; ++f) add[f] = to_compute<kBf16>(gv[f] * w);
    if constexpr (kVector && F % 4 == 0) {
#pragma unroll
      for (int q = 0; q < F / 4; ++q) {
        const float v4[4] = {add[4 * q], add[4 * q + 1], add[4 * q + 2],
                             add[4 * q + 3]};
        red_add<4>(dst + 4 * q, v4);
      }
    } else {
#pragma unroll
      for (int f = 0; f < F; ++f) atomicAdd(dst + f, add[f]);
    }
  }
}

template <bool kVector>
cudaError_t run_f8(const float* c, const void* g, float* gr, long long n,
                   int n_levels, const Levels& lv, int g_bf16,
                   cudaStream_t s) {
  if (g_bf16) {
    k4_per_pair_kernel<uint16_t, 8, true, kVector>
        <<<blocks_for(n, n_levels), kThreads, 0, s>>>(
            c, static_cast<const uint16_t*>(g), gr, n, n_levels, lv);
  } else {
    k4_per_pair_kernel<float, 8, false, kVector>
        <<<blocks_for(n, n_levels), kThreads, 0, s>>>(
            c, static_cast<const float*>(g), gr, n, n_levels, lv);
  }
  return cudaGetLastError();
}

}  // namespace

// hash_encode_backward's arguments (F = 8 only) and the variant (0, 1)
extern "C" int k4_variant_backward(const void* coords, const void* g,
                                   void* grad, long long n, int n_levels,
                                   int n_features, const void* scales,
                                   const void* levels, int g_bf16,
                                   int variant, void* stream) {
  Levels lv;
  if (!make_levels(n_levels, scales, levels, &lv) || n_features != 8)
    return cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  const float* c = static_cast<const float*>(coords);
  float* gr = static_cast<float*>(grad);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0:
      return run_f8<false>(c, g, gr, n, n_levels, lv, g_bf16, s);
    case 1:
      return run_f8<true>(c, g, gr, n, n_levels, lv, g_bf16, s);
    default:
      return cudaErrorInvalidValue;
  }
}
