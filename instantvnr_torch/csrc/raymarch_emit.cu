// The wavefront's emission phase for Hopper, sm_90a: per ray, K sample
// slots of macrocell DDA with empty-space skipping and quantized adaptive
// steps.
//
// Replaces instantvnr_tpu/render/raymarch.py::_emit_samples (:214), which
// the JAX package leaves to XLA as a fori_loop inside a scan. In plain
// PyTorch the same scan is K slots x (max_skips probe bodies of ~25
// elementwise operations + the emit): about 1,700 launches a superstep at
// K = max_skips = 8, so a frame would be bound by launches on the host.
// Here one thread owns one ray and runs the whole scan in registers: per
// probe it computes the cell past t, gathers that macrocell's max opacity
// (mz*my*mx floats, 8 KB at 128^3, cache-resident), and either jumps past
// an empty cell or sets up the cell's quantized step; then it emits one
// interval [t_x, t_y) and its validity a slot.
//
// Exactness: every operation is the plain version's (render/raymarch.py::
// _emit_samples) in its order, with IEEE division, floorf and no FMA
// (-fmad=false, ops/cuda_lib.py), so the outputs equal it bit for bit. The
// plain version runs all max_skips bodies masked; this kernel stops a
// slot's skip loop at the first body that changes nothing (need_new false
// or t past t_far: every later body sees the same state) or that enters a
// cell (a later body could only re-enter it from the same t with the same
// values).
//
// Bound on an H100 at R = 2^18 rays, K = 8: reads org, dirn, t_far, t,
// t_cell_end, ss (40 B a ray, the macrocell grid once) and writes t, t_cell
// end, ss, t_x, t_y (4 B each a slot) and valid (1 B a slot): about 30 MB,
// 9 us at 3.35 TB/s; the operations of the probes the data needs (about 45
// each) on the float32 pipes are of the same order (chip_smoke.py counts
// both). The per-ray slot writes are strided by K floats across a warp; the
// L2 merges them into whole sectors.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kEps = 1e-6f;
constexpr float kProbeEps = 1e-3f;
constexpr float kCell = 16.0f;  // MACROCELL_SIZE voxels
constexpr int kBlock = 256;

// The ray's exit t of `cell` along one axis: +inf where the direction is 0
// (inf or NaN there drops out of the min, as in _cell_exit_t).
__device__ __forceinline__ float exit_axis(float o, float d, int c) {
  const float step_pos = d > 0.0f ? 1.0f : 0.0f;
  const float boundary = (static_cast<float>(c) + step_pos) * kCell;
  const float t = (boundary - o) / d;
  return isfinite(t) ? t : INFINITY;
}

__device__ __forceinline__ int clamp_cell(int c, int m) {
  return c < 0 ? 0 : (c > m - 1 ? m - 1 : c);
}

__global__ void __launch_bounds__(kBlock)
raymarch_emit_kernel(const float* __restrict__ org,
                     const float* __restrict__ dirn,
                     const float* __restrict__ t_far_in,
                     const float* __restrict__ t_in,
                     const float* __restrict__ tce_in,
                     const float* __restrict__ ss_in,
                     const float* __restrict__ max_opacity, int mx, int my,
                     int mz, float base_step, float rate_scale,
                     long long n_rays, int K, int max_skips,
                     float* __restrict__ t_out, float* __restrict__ tce_out,
                     float* __restrict__ ss_out, float* __restrict__ t_x,
                     float* __restrict__ t_y, uint8_t* __restrict__ valid) {
  const long long r =
      static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (r >= n_rays) return;
  const float o[3] = {org[3 * r], org[3 * r + 1], org[3 * r + 2]};
  const float d[3] = {dirn[3 * r], dirn[3 * r + 1], dirn[3 * r + 2]};
  const float t_far = t_far_in[r];
  float t = t_in[r];
  float tce = tce_in[r];
  float ss = ss_in[r];
  const long long row = r * K;
  for (int k = 0; k < K; ++k) {
    for (int s = 0; s < max_skips; ++s) {
      const bool need_new = t >= tce - kEps;
      const bool in_range = t < t_far;
      if (!(need_new && in_range)) break;
      // probe the cell just past the current position
      const float tp = t + kProbeEps;
      int cell[3];
      float t_exit = INFINITY;
      for (int a = 0; a < 3; ++a) {
        const float p = o[a] + tp * d[a];
        cell[a] = static_cast<int>(floorf(p / kCell));
        t_exit = fminf(t_exit, exit_axis(o[a], d[a], cell[a]));
      }
      t_exit = fmaxf(t_exit, tp);
      const int flat =
          (clamp_cell(cell[2], mz) * my + clamp_cell(cell[1], my)) * mx +
          clamp_cell(cell[0], mx);
      const float occ = __ldg(max_opacity + flat);
      if (occ <= kEps) {  // empty: jump to its exit
        t = t_exit;
        continue;
      }
      // occupied: the cell interval clamped at the march end, stepped at
      // adaptiveSamplingRate (raytracing.h:188-194) quantized so the
      // interval divides evenly (method_raymarching.cu:263-267)
      const float t_exit_c = fminf(t_exit, t_far);
      const float rr = fabsf(fminf(fmaxf(occ, 0.1f), 1.0f) - 1.0f);
      const float step = fmaxf(base_step + rate_scale * rr * rr, base_step);
      const float span = t_exit_c - t;
      const int n = static_cast<int>(floorf(span / step)) + 1;
      ss = span / fmaxf(static_cast<float>(n), 1.0f);
      tce = t_exit_c;
      break;
    }
    const float ty = fminf(t + ss, tce);
    const bool v = (ty > t + kEps) && (t < t_far) && (tce > t);
    t_x[row + k] = t;
    t_y[row + k] = ty;
    valid[row + k] = v ? 1 : 0;
    if (v) t = ty;
  }
  t_out[r] = t;
  tce_out[r] = tce;
  ss_out[r] = ss;
}

}  // namespace

// org, dirn: float [R, 3]; t_far, t, t_cell_end, ss: float [R];
// max_opacity: float [mz, my, mx]; base_step = 1 / sampling_rate and
// rate_scale = 15 * base_step, each rounded to float once on the host (as
// the plain version's Python scalars are). Writes the carried t,
// t_cell_end, ss [R] and t_x, t_y float [R, K], valid uint8 [R, K].
extern "C" int raymarch_emit(const void* org, const void* dirn,
                             const void* t_far, const void* t,
                             const void* t_cell_end, const void* ss,
                             const void* max_opacity, int mx, int my, int mz,
                             float base_step, float rate_scale,
                             long long n_rays, int n_iters, int max_skips,
                             void* t_out, void* tce_out, void* ss_out,
                             void* t_x, void* t_y, void* valid,
                             void* stream) {
  if (n_rays <= 0) return cudaSuccess;
  if (mx < 1 || my < 1 || mz < 1 || n_iters < 1 || max_skips < 0)
    return cudaErrorInvalidValue;
  const auto f = [](const void* q) { return static_cast<const float*>(q); };
  const auto w = [](void* q) { return static_cast<float*>(q); };
  const long long blocks = (n_rays + kBlock - 1) / kBlock;
  raymarch_emit_kernel<<<static_cast<unsigned>(blocks), kBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      f(org), f(dirn), f(t_far), f(t), f(t_cell_end), f(ss), f(max_opacity),
      mx, my, mz, base_step, rate_scale, n_rays, n_iters, max_skips,
      w(t_out), w(tce_out), w(ss_out), w(t_x), w(t_y),
      static_cast<uint8_t*>(valid));
  return cudaGetLastError();
}
