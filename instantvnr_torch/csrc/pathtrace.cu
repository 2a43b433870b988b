// One delta-tracking event of the volumetric path tracer for Hopper,
// sm_90a: pt_track (the event up to its volume sample) and pt_resolve
// (from the sample on), one thread a ray each.
//
// Replaces instantvnr_tpu/render/pathtrace.py::_pt_event (:236-397), which
// the JAX package leaves to XLA inside a while_loop. In plain PyTorch one
// event is ~100 small elementwise launches over every ray (the tau advance
// over cell_skips cells, the final cell, the transfer function's control
// chain, the event handling and the segment restart), and a 512^2 frame
// runs up to max_events = 512 events: tens of thousands of launches a
// frame, bound by the host. Here the caller launches per event one draw of
// the uniforms, pt_track, the volume sample (a brick_sample launch, or the
// hash grid K3 and the fused MLP K1 for the network) and pt_resolve.
//
// Exactness: every operation is the plain version's (ops/pathtrace.py::
// pt_track_reference, pt_resolve_reference) in its order, IEEE division,
// floorf and no FMA (-fmad=false, ops/cuda_lib.py). The macrocell DDA
// decides by comparisons, so one ulp would move a ray to another cell; the
// transcendentals (log1pf for a fresh tau, sinf and cosf for a scatter
// direction) are the CUDA math library's, as in PyTorch's own kernels.
//
// Bound on an H100 at R = 2^18 rays: pt_track reads 36 B a ray (org, dirn,
// t, t_far, tau) and writes 26 B (new t, tau, majorant, two flags, the
// object-space position); pt_resolve reads ~110 B (the state, the track's
// outputs, the sample, six uniforms) and writes ~66 B. Together ~62 MB an
// event, 19 us at 3.35 TB/s; the operations (a probe ~60, the control
// chain ~20 a segment) are under that on the float32 pipes. The ray-major
// [R, 3] rows are strided across a warp; the L2 merges them into sectors.
#include <cuda_runtime.h>

#include <cstdint>

#include "slab_common.cuh"

namespace {

constexpr float kEps = 1e-6f;
constexpr float kProbeEps = 1e-3f;
constexpr float kCell = 16.0f;  // MACROCELL_SIZE voxels
constexpr int kRussianRoulette = 4;
constexpr float kPhase = 0.6f;
constexpr float kTwoPi = 6.283185307179586f;  // float32(2 pi), as PyTorch
constexpr int kBlock = 256;

__device__ __forceinline__ int clamp_cell(int c, int m) {
  return c < 0 ? 0 : (c > m - 1 ? m - 1 : c);
}

// The ray's exit t of `cell` along one axis: +inf where the direction is 0
// (render/raymarch.py::_cell_exit_t).
__device__ __forceinline__ float exit_axis(float o, float d, int c) {
  const float step_pos = d > 0.0f ? 1.0f : 0.0f;
  const float boundary = (static_cast<float>(c) + step_pos) * kCell;
  const float t = (boundary - o) / d;
  return isfinite(t) ? t : INFINITY;
}

struct Probe {
  float majorant, t1;
};

// The cell just past t: its majorant and the exit t clamped to
// [t + kProbeEps, t_far].
__device__ __forceinline__ Probe probe(const float (&o)[3],
                                       const float (&d)[3], float t,
                                       float t_far,
                                       const float* __restrict__ occ, int mx,
                                       int my, int mz, float density_scale) {
  const float tp = t + kProbeEps;
  int cell[3];
  float t_exit = INFINITY;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float p = o[a] + tp * d[a];
    cell[a] = static_cast<int>(floorf(p / kCell));
    t_exit = fminf(t_exit, exit_axis(o[a], d[a], cell[a]));
  }
  const int flat =
      (clamp_cell(cell[2], mz) * my + clamp_cell(cell[1], my)) * mx +
      clamp_cell(cell[0], mx);
  Probe pr;
  pr.majorant = __ldg(occ + flat) * density_scale;
  pr.t1 = fminf(fmaxf(t_exit, tp), t_far);
  return pr;
}

__global__ void __launch_bounds__(kBlock)
pt_track_kernel(const float* __restrict__ org, const float* __restrict__ dirn,
                const float* __restrict__ t_in,
                const float* __restrict__ t_far_in,
                const float* __restrict__ tau_in,
                const float* __restrict__ occ, int mx, int my, int mz,
                float dx, float dy, float dz, float density_scale,
                int cell_skips, long long n_rays, float* __restrict__ new_t,
                float* __restrict__ new_tau, float* __restrict__ majorant,
                uint8_t* __restrict__ crosses_out,
                uint8_t* __restrict__ exited_out,
                float* __restrict__ pos_obj) {
  const long long r =
      static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (r >= n_rays) return;
  const float o[3] = {org[3 * r], org[3 * r + 1], org[3 * r + 2]};
  const float d[3] = {dirn[3 * r], dirn[3 * r + 1], dirn[3 * r + 2]};
  const float t_far = t_far_in[r];
  float t = t_in[r];
  float tau = tau_in[r];
  // crossings whose tau budget survives consume no draw and no sample
  for (int s = 0; s < cell_skips; ++s) {
    const Probe pr = probe(o, d, t, t_far, occ, mx, my, mz, density_scale);
    const float dtau = (pr.t1 - t) * pr.majorant;
    if (tau > dtau && t < t_far - kEps) {
      t = pr.t1;
      tau = tau - dtau;
    }
  }
  const Probe pr = probe(o, d, t, t_far, occ, mx, my, mz, density_scale);
  const float dtau = (pr.t1 - t) * pr.majorant;
  const bool crosses = tau > dtau;
  const float t_coll = t + tau / fmaxf(pr.majorant, kEps);
  const float nt = crosses ? pr.t1 : t_coll;
  new_t[r] = nt;
  new_tau[r] = crosses ? tau - dtau : tau;
  majorant[r] = pr.majorant;
  crosses_out[r] = crosses ? 1 : 0;
  exited_out[r] = (crosses && nt >= t_far - kEps) ? 1 : 0;
  const float dims[3] = {dx, dy, dz};
#pragma unroll
  for (int a = 0; a < 3; ++a)
    pos_obj[3 * r + a] =
        fminf(fmaxf((o[a] + nt * d[a]) / dims[a], 0.0f), 1.0f);
}

// ray_box_intersect's far t where the ray hits the box, clamped at 0;
// 0 on a miss (ops/pathtrace.py::restart_segment, utils/math.py). A NaN
// slab (the origin on a plane of a parallel axis) counts as inside.
__device__ __forceinline__ float restart_segment(const float (&o)[3],
                                                 const float (&d)[3],
                                                 const float* lo,
                                                 const float* hi) {
  float near = -INFINITY, far = INFINITY;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float inv = 1.0f / d[a];
    const float l = (lo[a] - o[a]) * inv;
    const float h = (hi[a] - o[a]) * inv;
    float n_a = -INFINITY, f_a = INFINITY;
    if (!isnan(l) && !isnan(h)) {
      n_a = fminf(l, h);
      f_a = fmaxf(l, h);
    }
    near = fmaxf(near, n_a);
    far = fminf(far, f_a);
  }
  const float t0 = fmaxf(near, 0.0f);
  return t0 < far ? fmaxf(far, 0.0f) : 0.0f;
}

__global__ void __launch_bounds__(kBlock)
pt_resolve_kernel(
    const float* __restrict__ org, const float* __restrict__ dirn,
    const float* __restrict__ t_far_in, const float* __restrict__ thr_in,
    const float* __restrict__ rad_in, const int* __restrict__ si_in,
    const uint8_t* __restrict__ shadow_in,
    const uint8_t* __restrict__ active_in,
    const float* __restrict__ new_t_in, const float* __restrict__ new_tau_in,
    const float* __restrict__ majorant_in,
    const uint8_t* __restrict__ crosses_in,
    const uint8_t* __restrict__ exited_in,
    const float* __restrict__ values, const float* __restrict__ u,
    const float* __restrict__ ctrl, int kc, const float* __restrict__ lut,
    int n_lut, const float* __restrict__ consts, float density_scale,
    float light_ambient, long long n_rays, float* __restrict__ org_out,
    float* __restrict__ dir_out, float* __restrict__ t_out,
    float* __restrict__ tfar_out, float* __restrict__ tau_out,
    float* __restrict__ thr_out, float* __restrict__ rad_out,
    int* __restrict__ si_out, uint8_t* __restrict__ shadow_out,
    uint8_t* __restrict__ active_out) {
  extern __shared__ float s_tf[];
  const slab::TransferFn tf = slab::stage_tf(s_tf, ctrl, kc, lut, n_lut,
                                             threadIdx.x, kBlock);
  __syncthreads();
  const long long r =
      static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (r >= n_rays) return;
  const float* light_v = consts;
  const float* light_rgb = consts + 3;
  const float* s_inv = consts + 6;
  const float* box_lo = consts + 9;
  const float* box_hi = consts + 12;

  float o[3], d[3], thr[3], rad[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    o[a] = org[3 * r + a];
    d[a] = dirn[3 * r + a];
    thr[a] = thr_in[3 * r + a];
    rad[a] = rad_in[3 * r + a];
  }
  int si = si_in[r];
  const bool shadow = shadow_in[r] != 0;
  const bool act = active_in[r] != 0;
  const float nt = new_t_in[r];
  float tau = new_tau_in[r];
  const float maj = majorant_in[r];
  const bool candidate = crosses_in[r] == 0;
  const bool exited = exited_in[r] != 0;
  const size_t R = static_cast<size_t>(n_rays);
  const float u_accept = u[r], u_tau = u[R + r], u_s0 = u[2 * R + r],
              u_s1 = u[3 * R + r], u_rr = u[4 * R + r], u_tau2 = u[5 * R + r];

  float pos[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) pos[a] = o[a] + nt * d[a];
  float rgba[4];
  slab::classify(tf, values[r], rgba);
  const bool real =
      candidate && (u_accept * fmaxf(maj, kEps) < rgba[3] * density_scale);
  if (candidate && !real) tau = -log1pf(-u_tau);  // null collision

  // (1) a shadow ray resolved (exit: add light), then a uniform-sphere
  //     scatter direction
  const bool shadow_done = act && shadow && (exited || real);
  if (shadow_done && exited) {
#pragma unroll
    for (int a = 0; a < 3; ++a) rad[a] = rad[a] + thr[a] * light_rgb[a];
  }
  float dn[3] = {d[0], d[1], d[2]};
  bool shadow_new = shadow;
  if (shadow_done) {
    const float phi = kTwoPi * u_s0;
    const float cos_t = 1.0f - 2.0f * u_s1;
    const float sin_t = 2.0f * sqrtf(fmaxf(u_s1 * (1.0f - u_s1), 0.0f));
    dn[0] = (cosf(phi) * sin_t) * s_inv[0];
    dn[1] = (sinf(phi) * sin_t) * s_inv[1];
    dn[2] = cos_t * s_inv[2];
    shadow_new = false;
  }
  // (2) a scatter/primary ray escaped: ambient light (not primaries)
  const bool escape = act && !shadow && exited;
  if (escape && si > 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) rad[a] = rad[a] + thr[a] * light_ambient;
  }
  bool terminate = escape;
  // (3) a real collision: russian roulette, the phase, a shadow ray
  bool hit = act && !shadow && real;
  const float rr_q =
      fminf(fmaxf(fmaxf(fmaxf(thr[0], thr[1]), thr[2]), 1e-6f), 0.95f);
  const bool late = hit && si > kRussianRoulette;
  const bool rr_kill = late && u_rr > rr_q;
  if (late && !rr_kill) {
#pragma unroll
    for (int a = 0; a < 3; ++a) thr[a] = thr[a] / rr_q;
  }
  terminate = terminate || rr_kill;
  hit = hit && !rr_kill;
  if (hit) {
    si = si + 1;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      o[a] = pos[a];
      thr[a] = (thr[a] * kPhase) * rgba[a];
      dn[a] = light_v[a];
    }
    shadow_new = true;
  }
  float t = nt, t_far = t_far_in[r];
  if (shadow_done || hit) {  // the segment restarts
    t_far = restart_segment(o, dn, box_lo, box_hi);
    t = 0.0f;
    tau = -log1pf(-u_tau2);
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    org_out[3 * r + a] = o[a];
    dir_out[3 * r + a] = dn[a];
    thr_out[3 * r + a] = thr[a];
    rad_out[3 * r + a] = rad[a];
  }
  t_out[r] = t;
  tfar_out[r] = t_far;
  tau_out[r] = tau;
  si_out[r] = si;
  shadow_out[r] = shadow_new ? 1 : 0;
  active_out[r] = (act && !terminate) ? 1 : 0;
}

}  // namespace

// org, dirn: float [R, 3] voxel space; t, t_far, tau: float [R];
// max_opacity: float [mz, my, mx]; (dx, dy, dz) the volume's dims. Writes
// new_t, new_tau, majorant float [R], crosses, exited uint8 [R] and pos_obj
// float [R, 3].
extern "C" int pt_track(const void* org, const void* dirn, const void* t,
                        const void* t_far, const void* tau,
                        const void* max_opacity, int mx, int my, int mz,
                        float dx, float dy, float dz, float density_scale,
                        int cell_skips, long long n_rays, void* new_t,
                        void* new_tau, void* majorant, void* crosses,
                        void* exited, void* pos_obj, void* stream) {
  if (n_rays <= 0) return cudaSuccess;
  if (mx < 1 || my < 1 || mz < 1 || cell_skips < 0)
    return cudaErrorInvalidValue;
  const auto f = [](const void* q) { return static_cast<const float*>(q); };
  const auto w = [](void* q) { return static_cast<float*>(q); };
  const unsigned blocks =
      static_cast<unsigned>((n_rays + kBlock - 1) / kBlock);
  pt_track_kernel<<<blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      f(org), f(dirn), f(t), f(t_far), f(tau), f(max_opacity), mx, my, mz, dx,
      dy, dz, density_scale, cell_skips, n_rays, w(new_t), w(new_tau),
      w(majorant), static_cast<uint8_t*>(crosses),
      static_cast<uint8_t*>(exited), w(pos_obj));
  return cudaGetLastError();
}

// The event's state (org, dirn [R, 3], t_far [R], throughput, radiance
// [R, 3], scatter_index int32 [R], shadow, active uint8 [R]), pt_track's
// outputs, the sample values [R], the uniforms u [6, R], the transfer
// function (ctrl [kc, 8], or the rgba lut [n_lut, 4] when n_lut > 0),
// consts [15] (light_v, light_rgb, s_inv, box_lo, box_hi) → the next
// state, in the same layout.
extern "C" int pt_resolve(
    const void* org, const void* dirn, const void* t_far,
    const void* throughput, const void* radiance, const void* scatter_index,
    const void* shadow, const void* active, const void* new_t,
    const void* new_tau, const void* majorant, const void* crosses,
    const void* exited, const void* values, const void* u, const void* ctrl,
    int kc, const void* lut, int n_lut, const void* consts,
    float density_scale, float light_ambient, long long n_rays, void* org_out,
    void* dir_out, void* t_out, void* tfar_out, void* tau_out, void* thr_out,
    void* rad_out, void* si_out, void* shadow_out, void* active_out,
    void* stream) {
  if (n_rays <= 0) return cudaSuccess;
  if (kc < 2 || n_lut < 0 || n_lut == 1) return cudaErrorInvalidValue;
  const auto f = [](const void* q) { return static_cast<const float*>(q); };
  const auto w = [](void* q) { return static_cast<float*>(q); };
  const auto b = [](const void* q) { return static_cast<const uint8_t*>(q); };
  const size_t smem = sizeof(float) * (n_lut > 0 ? 4 * n_lut : 8 * kc);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const unsigned blocks =
      static_cast<unsigned>((n_rays + kBlock - 1) / kBlock);
  pt_resolve_kernel<<<blocks, kBlock, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      f(org), f(dirn), f(t_far), f(throughput), f(radiance),
      static_cast<const int*>(scatter_index), b(shadow), b(active), f(new_t),
      f(new_tau), f(majorant), b(crosses), b(exited), f(values), f(u),
      f(ctrl), kc, f(lut), n_lut, f(consts), density_scale, light_ambient,
      n_rays, w(org_out), w(dir_out), w(t_out), w(tfar_out), w(tau_out),
      w(thr_out), w(rad_out), static_cast<int*>(si_out),
      static_cast<uint8_t*>(shadow_out), static_cast<uint8_t*>(active_out));
  return cudaGetLastError();
}
