// First-hit isosurface sweep for Hopper, sm_90a: the whole slab sweep of
// one frame as one kernel.
//
// Replaces the TPU kernel instantvnr_tpu/ops/pallas/iso_sweep.py
// (iso_sweep / _kernel, pallas_call :99). On the TPU the slab axis was a
// sequential grid dimension with a 10-plane state resident in VMEM and each
// slab resampled by two banded matmuls on the MXU. Here each thread owns
// one pixel of the intermediate image and walks the D slabs in order, its
// state in registers for the whole sweep (found, hit_z, hit_g[3], prev_v,
// prev_ok, prev_g[3]). A block is a 32 x 8 pixel tile, one warp a row, as
// in the compositor template (slab_composite.cu).
//
// Per slab a pixel reads its row and column pairs (slab_common.cuh:
// load_pair) and resamples the 4 fields (value + world gradient) with
// resample_banded: 2 x 2 texels a field through the read-only path, from
// the L2-resident [D, 4, ay, ax] stack (33.5 MB at 128^3). No shared
// memory, no barrier. Then the TPU kernel's crossing test (:58-78) formula
// for formula: a sign change of value - iso between the previous and this
// slab, on a pixel covered at both, first time only, with the crossing
// depth and gradient lerped between the two slabs. iso is an argument, so
// an isovalue edit rebuilds nothing.
//
// Three skips, none of which changes a bit of found, hit_z or hit_g (the
// only planes written): a pixel that has found its hit (newly is 0 from
// then on, so the lerps add 0 to finite values), a warp whose 32 pixels
// have all found one or lie outside the frame (a warp vote), and a pixel
// the slab does not cover (covy x covx = 0; the row's covy is uniform
// across the warp). An uncovered slab still sets prev_ok = 0, and prev_v
// and prev_g to 0, so the next slab's test sees newly = 0 there, as the
// TPU kernel's does.
//
// Bound on an H100 at 512^2 x 128 slabs of a 128^3 volume: each input and
// output once, the fields (33.5 MB), the pairs (2 x [128, 512] int32 +
// 2 x [128, 512, 2] float32, 1.6 MB), covy and covx (0.5 MB) and the 5
// output planes (5.2 MB): about 41 MB, 12 us at 3.35 TB/s, against the
// operations of the live pixel-slabs (chip_smoke.py counts both). The
// previous design resampled with dense [128, 512, 128] matrix stacks
// (67 MB more, a 33 us bound) and 42.9 GFLOP of products, through shared
// memory with a barrier every chunk.
#include "slab_common.cuh"

namespace {

using namespace slab;

constexpr int kBX = 32;  // pixels of a block along a row: one warp
constexpr int kBY = 8;   // rows of a block, one warp each
constexpr int kNF = 4;   // fields per slab: value + world gradient

__global__ void __launch_bounds__(kBX * kBY)
iso_sweep_kernel(const float* __restrict__ fields,
                 const int* __restrict__ jy, const float* __restrict__ wy,
                 const int* __restrict__ jx, const float* __restrict__ wx,
                 const float* __restrict__ covy,
                 const float* __restrict__ covx, float iso,
                 float* __restrict__ out, int D, int ay, int ax, int hi,
                 int wi) {
  const int col = blockIdx.x * kBX + threadIdx.x;
  const int row = blockIdx.y * kBY + threadIdx.y;
  const bool inside = row < hi && col < wi;
  float found = 0.0f, hit_z = 0.0f, hit_g[3] = {0.0f, 0.0f, 0.0f};
  float prev_v = 0.0f, prev_ok = 0.0f, prev_g[3] = {0.0f, 0.0f, 0.0f};
  const size_t slab_sz = static_cast<size_t>(ay) * ax;
  for (int k = 0; k < D; ++k) {
    const bool live = inside && found == 0.0f;
    // uniform across the warp, so every lane reaches every vote
    if (!__any_sync(0xffffffffu, live)) break;
    if (!live) continue;
    const float cov = __ldg(covy + static_cast<size_t>(k) * hi + row) *
                      __ldg(covx + static_cast<size_t>(k) * wi + col);
    if (cov == 0.0f) {
      prev_v = 0.0f;
      prev_ok = 0.0f;
#pragma unroll
      for (int c = 0; c < 3; ++c) prev_g[c] = 0.0f;
      continue;
    }
    const Pair py = load_pair(jy, wy, static_cast<size_t>(k) * hi + row, ay);
    const Pair px = load_pair(jx, wx, static_cast<size_t>(k) * wi + col, ax);
    float v[kNF];
#pragma unroll
    for (int c = 0; c < kNF; ++c) {
      v[c] = resample_banded(
          fields + (static_cast<size_t>(k) * kNF + c) * slab_sz, ax, py, px);
    }
    const float val = v[0];
    const float denom = val - prev_v;
    float frac = fabsf(denom) > 1e-12f ? (iso - prev_v) / denom : 0.5f;
    frac = fminf(fmaxf(frac, 0.0f), 1.0f);
    const float sign = (prev_v - iso) * (val - iso) <= 0.0f ? 1.0f : 0.0f;
    const float newly = prev_ok * cov * sign * (1.0f - found);
    const float z_cross = (static_cast<float>(k) - 0.5f) + frac;
    hit_z = hit_z + newly * (z_cross - hit_z);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float g_cross = prev_g[c] + frac * (v[1 + c] - prev_g[c]);
      hit_g[c] = hit_g[c] + newly * (g_cross - hit_g[c]);
    }
    found = fmaxf(found, newly);
    prev_v = val;
    prev_ok = cov;
#pragma unroll
    for (int c = 0; c < 3; ++c) prev_g[c] = v[1 + c];
  }
  if (!inside) return;
  const size_t plane = static_cast<size_t>(hi) * wi;
  float* o = out + static_cast<size_t>(row) * wi + col;
  o[0] = found;
  o[plane] = hit_z;
#pragma unroll
  for (int c = 0; c < 3; ++c) o[(2 + c) * plane] = hit_g[c];
}

}  // namespace

// fields [D, 4, ay, ax] (value + world gradient); jy [D, hi], jx [D, wi]
// int32 and wy [D, hi, 2], wx [D, wi, 2]: the per-row pairs of the
// interpolation matrices (row i of slab k samples rows jy and
// min(jy + 1, ay - 1), and likewise columns); covy [D, hi], covx [D, wi];
// out [5, hi, wi] = found, hit_z, hit_g[3]. float32 but the indices.
extern "C" int iso_sweep_forward(const void* fields, const void* jy,
                                 const void* wy, const void* jx,
                                 const void* wx, const void* covy,
                                 const void* covx, float iso, void* out,
                                 int D, int ay, int ax, int hi, int wi,
                                 void* stream) {
  if (hi <= 0 || wi <= 0) return cudaSuccess;
  if (D < 0 || ay < 1 || ax < 1) return cudaErrorInvalidValue;
  const auto f = [](const void* q) { return static_cast<const float*>(q); };
  const auto i = [](const void* q) { return static_cast<const int*>(q); };
  const dim3 grid((wi + kBX - 1) / kBX, (hi + kBY - 1) / kBY);
  iso_sweep_kernel<<<grid, dim3(kBX, kBY), 0,
                     static_cast<cudaStream_t>(stream)>>>(
      f(fields), i(jy), f(wy), i(jx), f(wx), f(covy), f(covx), iso,
      static_cast<float*>(out), D, ay, ax, hi, wi);
  return cudaGetLastError();
}
