// First-hit isosurface sweep for Hopper, sm_90a: the whole slab sweep of
// one frame as one kernel.
//
// Replaces the TPU kernel instantvnr_tpu/ops/pallas/iso_sweep.py
// (iso_sweep / _kernel). It uses the tiling and the in-order slab loop of
// the slab compositors (slab_common.cuh): each block owns a kTH x kTW tile
// of the intermediate image and walks the D slabs itself. The 10-plane
// state of the TPU kernel (found, hit_z, hit_g[3], prev_v, prev_ok,
// prev_g[3]) stays in registers for the whole sweep, 40 floats a thread
// (4 pixels), and is written to out [10, hi, wi] once at the end. Per slab
// the block resamples the 4 fields (value + world gradient) with My's rows
// and Mx's column chunks staged once, then applies the TPU kernel's
// crossing test (:58-78) exactly: a sign change of value − iso between the
// previous and this slab, on a pixel covered at both, first time only,
// with the crossing depth and gradient lerped between the two slabs. iso
// is an argument, so an isovalue edit rebuilds nothing.
//
// Bound on an H100 at 512^2 x 128 slabs of a 128^3 volume: 112 MB of
// inputs and outputs (fields [128, 4, 128, 128], the two interpolation
// stacks [128, 512, 128] of 33.6 MB each, 10 output planes), about 33 us at
// 3.35 TB/s. The dense resample this version runs is 42.9 GFLOP; a banded
// resample (each row of My and Mx has at most 2 nonzeros) is the later
// optimisation.
#include "slab_common.cuh"

namespace {

using namespace slab;

__global__ void __launch_bounds__(kTW)
iso_sweep_kernel(const float* __restrict__ fields,
                 const float* __restrict__ my, const float* __restrict__ mx,
                 const float* __restrict__ covy,
                 const float* __restrict__ covx, float iso,
                 float* __restrict__ out, int D, int ay, int ax, int hi,
                 int wi, int ka) {
  constexpr int kNF = 4;
  extern __shared__ __align__(16) float smem[];
  const Layout L = layout(ay, ax, ka, kNF, 0);

  const int col = blockIdx.x * kTW + threadIdx.x;
  const int row0 = blockIdx.y * kTH;
  float found[kTH], hit_z[kTH], hit_g[3][kTH];
  float prev_v[kTH], prev_ok[kTH], prev_g[3][kTH];
#pragma unroll
  for (int r = 0; r < kTH; ++r) {
    found[r] = hit_z[r] = prev_v[r] = prev_ok[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) hit_g[c][r] = prev_g[c][r] = 0.0f;
  }

  const size_t slab_sz = static_cast<size_t>(ay) * ax;
  for (int k = 0; k < D; ++k) {
    const float* src[kNF];
#pragma unroll
    for (int c = 0; c < kNF; ++c) src[c] = fields + (k * kNF + c) * slab_sz;
    float v[kNF][kTH];
    resample<kNF>(src, my + static_cast<size_t>(k) * hi * ay,
                  mx + static_cast<size_t>(k) * wi * ax, smem + L.my,
                  smem + L.tmp, smem + L.slab, smem + L.mx, ay, ax, hi, wi,
                  ka, row0, blockIdx.x * kTW, v);

    const float cov_x = col < wi ? covx[static_cast<size_t>(k) * wi + col]
                                 : 0.0f;
    const float z_prev = static_cast<float>(k) - 0.5f;  // z_{k-1} = k - 0.5
#pragma unroll
    for (int r = 0; r < kTH; ++r) {
      const int row = row0 + r;
      const float cov_y =
          row < hi ? covy[static_cast<size_t>(k) * hi + row] : 0.0f;
      const float cov = cov_y * cov_x;
      const float val = v[0][r];
      const float denom = val - prev_v[r];
      float frac = fabsf(denom) > 1e-12f ? (iso - prev_v[r]) / denom : 0.5f;
      frac = fminf(fmaxf(frac, 0.0f), 1.0f);
      const float sign =
          (prev_v[r] - iso) * (val - iso) <= 0.0f ? 1.0f : 0.0f;
      const float newly = prev_ok[r] * cov * sign * (1.0f - found[r]);
      const float z_cross = z_prev + frac;
      hit_z[r] = hit_z[r] + newly * (z_cross - hit_z[r]);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float g_cross =
            prev_g[c][r] + frac * (v[1 + c][r] - prev_g[c][r]);
        hit_g[c][r] = hit_g[c][r] + newly * (g_cross - hit_g[c][r]);
      }
      found[r] = fmaxf(found[r], newly);
      prev_v[r] = val;
      prev_ok[r] = cov;
#pragma unroll
      for (int c = 0; c < 3; ++c) prev_g[c][r] = v[1 + c][r];
    }
  }

  if (col >= wi) return;
  const size_t plane = static_cast<size_t>(hi) * wi;
#pragma unroll
  for (int r = 0; r < kTH; ++r) {
    const int row = row0 + r;
    if (row >= hi) continue;
    float* o = out + static_cast<size_t>(row) * wi + col;
    o[0] = found[r];
    o[plane] = hit_z[r];
#pragma unroll
    for (int c = 0; c < 3; ++c) o[(2 + c) * plane] = hit_g[c][r];
    o[5 * plane] = prev_v[r];
    o[6 * plane] = prev_ok[r];
#pragma unroll
    for (int c = 0; c < 3; ++c) o[(7 + c) * plane] = prev_g[c][r];
  }
}

}  // namespace

// fields [D, 4, ay, ax] (value + world gradient), my [D, hi, ay],
// mx [D, wi, ax], covy [D, hi], covx [D, wi]; out [10, hi, wi] = found,
// hit_z, hit_g[3], prev_v, prev_ok, prev_g[3]. All float32.
extern "C" int iso_sweep_forward(const void* fields, const void* my,
                                 const void* mx, const void* covy,
                                 const void* covx, float iso, void* out,
                                 int D, int ay, int ax, int hi, int wi,
                                 void* stream) {
  if (hi <= 0 || wi <= 0) return cudaSuccess;
  if (D < 0 || ay <= 0 || ax <= 0) return cudaErrorInvalidValue;
  const int ka = chunk_rows(ay, ax);
  const Layout L = layout(ay, ax, ka, 4, 0);
  const size_t bytes = sizeof(float) * static_cast<size_t>(L.total);
  cudaError_t err = cudaFuncSetAttribute(
      iso_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((wi + kTW - 1) / kTW, (hi + kTH - 1) / kTH);
  iso_sweep_kernel<<<grid, kTW, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(fields), static_cast<const float*>(my),
      static_cast<const float*>(mx), static_cast<const float*>(covy),
      static_cast<const float*>(covx), iso, static_cast<float*>(out), D, ay,
      ax, hi, wi, ka);
  return cudaGetLastError();
}
