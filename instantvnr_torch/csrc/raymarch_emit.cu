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
// both).
//
// The memory path. A ray's slots are a row of K values in t_x, t_y and
// valid [R, K]; one thread a ray storing slot k across a warp would write
// 32 rows at a stride of K values, a partial 32-byte sector a lane, so
// each sector reaches the L2 K times (3·K sector writes a ray). Instead a
// block of kRays rays stages up to kMaxChunk slots of its rays in shared
// memory (slot-major, padded: the compute phase writes without bank
// conflicts) and then stores its [rays, slots] tile of each output
// cooperatively: where the tile is all K slots it is one contiguous range,
// written with 16-byte vector stores; past kMaxChunk slots it is a row
// segment a ray, written by consecutive lanes. Any K >= 1 runs in the
// kernel: the staging holds at most kMaxChunk slots (37 KB), and larger K
// loops over chunks. Index arithmetic is 32-bit within a block.
// scripts/emit_variants.py times this against the previous design (one
// scalar store a slot) and each change alone.
//
// The backward (raymarch_emit_backward) replaces JAX's autodiff of the same
// scan (XLA's transpose of its fori_loop and scan); its plain version is
// autograd of _emit_samples (render/raymarch.py::_plain_emit_backward).
// The gradient of t_x, t_y and the carried (t, t_cell_end, ss) with
// respect to the ray's ten inputs (org, dirn, t_far, t, t_cell_end, ss) is
// piecewise: the scan's branches (skip or enter, valid, the axis of the
// min, a slot's early stop) pick which cell exits and quantized steps the
// outputs are. So one thread a ray re-runs the forward's arithmetic with
// its carried values as Dual numbers, forward mode: 30 floats of
// derivatives in registers beside the values (every frame that reaches
// this backward differentiates in all ten inputs: the state derives from
// t_near, itself from the rays), and at each interval adds ḡ_tx·∂t_x +
// ḡ_ty·∂t_y into a ten-float sum. probe_cells and emit_interval are
// templates over the carried type, shared with the forward, so every
// branch is the forward's and the plain version's. The derivatives follow
// autograd's rules for the plain version: torch.minimum / maximum split a
// tie half and half, amin splits evenly among tied axes, where passes to
// the side it selects, floor, the quantized step's count and the adaptive
// rate carry none, and an axis whose quotient is not finite carries 0. No
// tape and no atomics (a reverse-mode design would store a slot's probes
// or re-run them backward); the ten inputs make forward mode cheap.
//
// What sets its time is the instructions its warps run, not memory: a
// warp runs a slot's probe body while any of its rays probes, so a probe's
// derivative arithmetic is paid about once a slot a warp. That arithmetic
// is kept lean: only the axis at the min carries an exit derivative (two
// entries), a division's derivative is one rounded reciprocal and
// products, and the cotangent sums are FMAs; the value chain stays
// unfused, bit for bit the forward's.
// More lanes a ray (each re-running the value chain for its share of the
// directions) and cotangent rows staged in shared memory were slower
// (scripts/emit_backward_variants.py): the duplicated value chains add
// instructions, and staging adds registers and a barrier for reads the
// L1 already serves. Bound on an H100: bytes, 40 B a ray in, 12 B of state
// cotangents, 8 B a slot of interval cotangents, 40 B a ray out, the
// macrocell grid once (about 41 MB, 12 us at R = 2^18, K = 8); at the 128²
// differentiable frame's R = 16,384, K = 4 about 2 MB, where a launch's
// latency dominates.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kEps = 1e-6f;
constexpr float kProbeEps = 1e-3f;
constexpr float kCell = 16.0f;  // MACROCELL_SIZE voxels
constexpr int kRays = 128;      // rays (threads) a block
constexpr int kMaxChunk = 32;   // slots staged in shared memory at once
constexpr int kPitch = kRays + 1;

// A ray's carried quantities (t, t_cell_end, ss) are of type V: float in
// the forward, Dual in the backward (the value and its derivatives with
// respect to the ray's ten inputs). probe_cells and emit_interval are
// written once over V, so the backward re-runs the forward's own value
// arithmetic, operation for operation, and takes every branch it takes.
constexpr int kIn = 10;  // org[3], dirn[3], t_far, t, t_cell_end, ss
constexpr int kOrgIn = 0, kDirIn = 3, kTFarIn = 6, kTIn = 7, kTceIn = 8,
              kSsIn = 9;

struct Dual {
  float v;
  float d[kIn];
};

__device__ __forceinline__ float value(float x) { return x; }
__device__ __forceinline__ float value(const Dual& x) { return x.v; }

// an input of the same type as `like`: its value, and in the backward the
// unit derivative at direction `in`
__device__ __forceinline__ float seed(float, float v, int) { return v; }
__device__ __forceinline__ Dual seed(const Dual&, float v, int in) {
  Dual r;
  r.v = v;
#pragma unroll
  for (int i = 0; i < kIn; ++i) r.d[i] = i == in ? 1.0f : 0.0f;
  return r;
}

__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ Dual add(const Dual& a, float b) {
  Dual r = a;
  r.v = a.v + b;
  return r;
}
__device__ __forceinline__ Dual add(const Dual& a, const Dual& b) {
  Dual r;
  r.v = a.v + b.v;
#pragma unroll
  for (int i = 0; i < kIn; ++i) r.d[i] = a.d[i] + b.d[i];
  return r;
}

__device__ __forceinline__ float sub(float a, float b) { return a - b; }
__device__ __forceinline__ Dual sub(const Dual& a, const Dual& b) {
  Dual r;
  r.v = a.v - b.v;
#pragma unroll
  for (int i = 0; i < kIn; ++i) r.d[i] = a.d[i] - b.d[i];
  return r;
}

// a / c for a constant c (no derivative: the quantized step's count); the
// derivatives scale by one rounded reciprocal
__device__ __forceinline__ float div(float a, float c) { return a / c; }
__device__ __forceinline__ Dual div(const Dual& a, float c) {
  Dual r;
  r.v = a.v / c;
  const float inv = __frcp_rn(c);
#pragma unroll
  for (int i = 0; i < kIn; ++i) r.d[i] = a.d[i] * inv;
  return r;
}

// torch.minimum / torch.maximum: the value of fminf / fmaxf, and at a tie
// half the derivative to each side, as autograd splits it
__device__ __forceinline__ float vmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }

__device__ __forceinline__ Dual pick(const Dual& a, const Dual& b, float v) {
  Dual r;
  r.v = v;
  if (a.v == b.v) {
#pragma unroll
    for (int i = 0; i < kIn; ++i) r.d[i] = 0.5f * a.d[i] + 0.5f * b.d[i];
  } else {
    const bool take_a = a.v == v;
#pragma unroll
    for (int i = 0; i < kIn; ++i) r.d[i] = take_a ? a.d[i] : b.d[i];
  }
  return r;
}
__device__ __forceinline__ Dual vmin(const Dual& a, const Dual& b) {
  return pick(a, b, fminf(a.v, b.v));
}
__device__ __forceinline__ Dual vmax(const Dual& a, const Dual& b) {
  return pick(a, b, fmaxf(a.v, b.v));
}

// The ray's exit t of `cell` along one axis: +inf where the quotient is
// not finite (a zero direction component, or an overflow), which drops out
// of the min, as in _cell_exit_t.
__device__ __forceinline__ float exit_axis(float o, float d, int c) {
  const float step_pos = d > 0.0f ? 1.0f : 0.0f;
  const float boundary = (static_cast<float>(c) + step_pos) * kCell;
  const float t = (boundary - o) / d;
  return isfinite(t) ? t : INFINITY;
}

// A ray's marching state, carried in registers across its slots.
template <class V>
struct RayT {
  float o[3], d[3];
  float t_far;
  V t, tce, ss;
};
using Ray = RayT<float>;

// The cell's exit t: t_min, the min of the axes' exits e (_cell_exit_t's
// amin). In the backward only the axes at the min carry a derivative, and
// only in their own origin and direction component (t = (b − o) / d:
// ∂t/∂o = −1/d, ∂t/∂d = −t/d, from one rounded reciprocal); autograd's
// amin splits it evenly among tied axes, and an axis whose quotient is not
// finite carries 0 (the plain version's double where, utils/math.py::
// axis_quotient).
__device__ __forceinline__ float cell_exit(const Ray&, const float (&)[3],
                                           float t_min) {
  return t_min;
}
__device__ __forceinline__ Dual cell_exit(const RayT<Dual>& ray,
                                          const float (&e)[3], float t_min) {
  Dual r;
  r.v = t_min;
#pragma unroll
  for (int i = 0; i < kIn; ++i) r.d[i] = 0.0f;
  if (!isfinite(r.v)) return r;
  const int ties = (e[0] == r.v) + (e[1] == r.v) + (e[2] == r.v);
  const float share = ties == 1 ? 1.0f : (ties == 2 ? 0.5f : 1.0f / 3.0f);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    if (e[a] != r.v) continue;
    const float inv = __frcp_rn(ray.d[a]);
    r.d[kOrgIn + a] = -inv * share;
    r.d[kDirIn + a] = -(e[a] * inv) * share;
  }
  return r;
}

__device__ __forceinline__ int clamp_cell(int c, int m) {
  return c < 0 ? 0 : (c > m - 1 ? m - 1 : c);
}

// The macrocell grid's max opacity through the read-only data cache.
struct LdgOccupancy {
  const float* __restrict__ p;
  __device__ __forceinline__ float operator()(int i) const {
    return __ldg(p + i);
  }
};

struct Grid {
  int mx, my, mz;
  float base_step, rate_scale;
  int max_skips;
  int sps;  // samples a slot (RaymarchSettings.samples_per_slot)
};

// A slot's probes: up to max_skips cells past empty space, or into the
// next occupied cell.
template <class V, class Occupancy>
__device__ __forceinline__ void probe_cells(RayT<V>& ray,
                                            const Occupancy& occ_at,
                                            const Grid& g) {
  for (int s = 0; s < g.max_skips; ++s) {
    const bool need_new = value(ray.t) >= value(ray.tce) - kEps;
    const bool in_range = value(ray.t) < ray.t_far;
    if (!(need_new && in_range)) break;
    // probe the cell just past the current position
    const V tp = add(ray.t, kProbeEps);
    int cell[3];
    float e[3];
    float t_min = INFINITY;
    for (int a = 0; a < 3; ++a) {
      const float p = ray.o[a] + value(tp) * ray.d[a];
      cell[a] = static_cast<int>(floorf(p / kCell));
      e[a] = exit_axis(ray.o[a], ray.d[a], cell[a]);
      t_min = fminf(t_min, e[a]);
    }
    const V t_exit = vmax(cell_exit(ray, e, t_min), tp);
    const int flat =
        (clamp_cell(cell[2], g.mz) * g.my + clamp_cell(cell[1], g.my)) *
            g.mx +
        clamp_cell(cell[0], g.mx);
    const float occ = occ_at(flat);
    if (occ <= kEps) {  // empty: jump to its exit
      ray.t = t_exit;
      continue;
    }
    // occupied: the cell interval clamped at the march end, stepped at
    // adaptiveSamplingRate (raytracing.h:188-194) quantized so the
    // interval divides evenly (method_raymarching.cu:263-267); the rate
    // and the count carry no derivative
    const V t_exit_c = vmin(t_exit, seed(ray.t, ray.t_far, kTFarIn));
    const float rr = fabsf(fminf(fmaxf(occ, 0.1f), 1.0f) - 1.0f);
    const float step =
        fmaxf(g.base_step + g.rate_scale * rr * rr, g.base_step);
    const V span = sub(t_exit_c, ray.t);
    const int n = static_cast<int>(floorf(value(span) / step)) + 1;
    ray.ss = div(span, fmaxf(static_cast<float>(n), 1.0f));
    ray.tce = t_exit_c;
    break;
  }
}

// One emitted interval [tx, ty) of the current cell; advances the ray and
// returns its validity.
template <class V>
__device__ __forceinline__ bool emit_interval(RayT<V>& ray, V& tx, V& ty) {
  tx = ray.t;
  ty = vmin(add(ray.t, ray.ss), ray.tce);
  const bool v = (value(ty) > value(ray.t) + kEps) &&
                 (value(ray.t) < ray.t_far) && (value(ray.tce) > value(ray.t));
  if (v) ray.t = ty;
  return v;
}

// The staged slots of a block: slot-major [chunk][kPitch], so that the
// compute phase (one slot of every ray at a time) writes without bank
// conflicts.
struct Stage {
  float* tx;
  float* ty;
  uint8_t* v;
  __device__ __forceinline__ int at(int ray, int slot) const {
    return slot * kPitch + ray;
  }
};

__device__ __forceinline__ Stage stage_of(void* smem, int chunk) {
  float* f = static_cast<float*>(smem);
  return {f, f + chunk * kPitch,
          reinterpret_cast<uint8_t*>(f + 2 * chunk * kPitch)};
}

// Store the staged tile [nr rays, nc slots] at (first ray r0, slot k0) of
// the [R, K] outputs. When the tile is all K slots it is the contiguous
// range from r0·K: with `vec`, 16-byte stores (4 floats, 16 valid bytes)
// and the ragged end one by one; otherwise consecutive threads store
// consecutive elements of the tile, row segment by row segment.
__device__ __forceinline__ void store_tile(const Stage& st, int nr, int nc,
                                           int K, long long r0, int k0,
                                           bool vec, float* __restrict__ t_x,
                                           float* __restrict__ t_y,
                                           uint8_t* __restrict__ valid) {
  const int n = nr * nc;
  const int tid = threadIdx.x;
  if (nc == K && vec) {
    float* gx = t_x + r0 * K;
    float* gy = t_y + r0 * K;
    uint8_t* gv = valid + r0 * K;
    for (int e = 4 * tid; e + 4 <= n; e += 4 * kRays) {
      int r = e / nc, j = e - r * nc;
      float4 a, b;
      float* pa = &a.x;
      float* pb = &b.x;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        pa[q] = st.tx[st.at(r, j)];
        pb[q] = st.ty[st.at(r, j)];
        if (++j == nc) j = 0, ++r;
      }
      *reinterpret_cast<float4*>(gx + e) = a;
      *reinterpret_cast<float4*>(gy + e) = b;
    }
    for (int e = 16 * tid; e + 16 <= n; e += 16 * kRays) {
      int r = e / nc, j = e - r * nc;
      uint32_t w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t word = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          word |= static_cast<uint32_t>(st.v[st.at(r, j)]) << (8 * b);
          if (++j == nc) j = 0, ++r;
        }
        w[q] = word;
      }
      *reinterpret_cast<uint4*>(gv + e) = make_uint4(w[0], w[1], w[2], w[3]);
    }
    // the ragged end: floats past the last whole 4, bytes past the last 16
    for (int e = (n & ~3) + tid; e < n; e += kRays) {
      const int r = e / nc, j = e - r * nc;
      gx[e] = st.tx[st.at(r, j)];
      gy[e] = st.ty[st.at(r, j)];
    }
    for (int e = (n & ~15) + tid; e < n; e += kRays) {
      const int r = e / nc, j = e - r * nc;
      gv[e] = st.v[st.at(r, j)];
    }
    return;
  }
  for (int e = tid; e < n; e += kRays) {
    const int r = e / nc, j = e - r * nc;
    const long long o = (r0 + r) * K + k0 + j;
    t_x[o] = st.tx[st.at(r, j)];
    t_y[o] = st.ty[st.at(r, j)];
    valid[o] = st.v[st.at(r, j)];
  }
}

__global__ void __launch_bounds__(kRays)
raymarch_emit_kernel(const float* __restrict__ org,
                     const float* __restrict__ dirn,
                     const float* __restrict__ t_far_in,
                     const float* __restrict__ t_in,
                     const float* __restrict__ tce_in,
                     const float* __restrict__ ss_in,
                     const float* __restrict__ max_opacity, Grid g,
                     int n_rays, int K, int chunk, bool vec,
                     float* __restrict__ t_out, float* __restrict__ tce_out,
                     float* __restrict__ ss_out, float* __restrict__ t_x,
                     float* __restrict__ t_y, uint8_t* __restrict__ valid) {
  extern __shared__ float4 smem[];
  const Stage st = stage_of(smem, chunk);
  const int tid = threadIdx.x;
  const long long r0 = static_cast<long long>(blockIdx.x) * kRays;
  const int nr = min(kRays, static_cast<int>(n_rays - r0));
  const bool live = tid < nr;
  const int r = static_cast<int>(r0) + tid;
  Ray ray;
  if (live) {
    for (int a = 0; a < 3; ++a) {
      ray.o[a] = org[3 * r + a];
      ray.d[a] = dirn[3 * r + a];
    }
    ray.t_far = t_far_in[r];
    ray.t = t_in[r];
    ray.tce = tce_in[r];
    ray.ss = ss_in[r];
  }
  const LdgOccupancy occ{max_opacity};
  for (int k0 = 0; k0 < K; k0 += chunk) {
    const int nc = min(chunk, K - k0);
    if (live) {
      for (int j = 0; j < nc; ++j) {
        float tx, ty;
        // a slot probes once, then emits its sps samples from the cell
        if ((k0 + j) % g.sps == 0) probe_cells(ray, occ, g);
        const bool v = emit_interval(ray, tx, ty);
        st.tx[st.at(tid, j)] = tx;
        st.ty[st.at(tid, j)] = ty;
        st.v[st.at(tid, j)] = v ? 1 : 0;
      }
    }
    __syncthreads();
    store_tile(st, nr, nc, K, r0, k0, vec, t_x, t_y, valid);
    __syncthreads();  // the next chunk reuses the stage
  }
  if (live) {
    t_out[r] = ray.t;
    tce_out[r] = ray.tce;
    ss_out[r] = ray.ss;
  }
}

// The emission's backward: one thread a ray re-runs the forward scan over
// Dual state (the same branches, bit for bit the same values), adds each
// interval's cotangents times its derivatives into the ray's ten-float
// gradient, then the final state's, and stores it. No tape, no atomics,
// nothing shared between rays: the same bits on every run. A null
// cotangent counts as zero; a null gradient output is not written.
struct EmitCotangents {
  const float* t;
  const float* tce;
  const float* ss;
  const float* tx;  // [R, K]
  const float* ty;  // [R, K]
};

struct EmitGradients {
  float* org;  // [R, 3]
  float* dirn;  // [R, 3]
  float* t_far;
  float* t;
  float* tce;
  float* ss;
};

__device__ __forceinline__ float load_or_zero(const float* p, long long i) {
  return p ? __ldg(p + i) : 0.0f;
}

__device__ __forceinline__ void add_scaled(float (&acc)[kIn], float g,
                                           const Dual& x) {
#pragma unroll
  for (int i = 0; i < kIn; ++i) acc[i] = __fmaf_rn(g, x.d[i], acc[i]);
}

__global__ void __launch_bounds__(kRays)
raymarch_emit_backward_kernel(const float* __restrict__ org,
                              const float* __restrict__ dirn,
                              const float* __restrict__ t_far_in,
                              const float* __restrict__ t_in,
                              const float* __restrict__ tce_in,
                              const float* __restrict__ ss_in,
                              const float* __restrict__ max_opacity, Grid g,
                              int n_rays, int K, EmitCotangents ct,
                              EmitGradients out) {
  const int r = blockIdx.x * kRays + threadIdx.x;
  if (r >= n_rays) return;
  RayT<Dual> ray;
  for (int a = 0; a < 3; ++a) {
    ray.o[a] = org[3 * r + a];
    ray.d[a] = dirn[3 * r + a];
  }
  ray.t_far = t_far_in[r];
  ray.t = seed(ray.t, t_in[r], kTIn);
  ray.tce = seed(ray.t, tce_in[r], kTceIn);
  ray.ss = seed(ray.t, ss_in[r], kSsIn);
  const LdgOccupancy occ{max_opacity};
  float acc[kIn];
#pragma unroll
  for (int i = 0; i < kIn; ++i) acc[i] = 0.0f;
  const long long row = static_cast<long long>(r) * K;
  for (int k = 0; k < K; ++k) {
    if (k % g.sps == 0) probe_cells(ray, occ, g);
    Dual tx, ty;
    emit_interval(ray, tx, ty);
    add_scaled(acc, load_or_zero(ct.tx, row + k), tx);
    add_scaled(acc, load_or_zero(ct.ty, row + k), ty);
  }
  add_scaled(acc, load_or_zero(ct.t, r), ray.t);
  add_scaled(acc, load_or_zero(ct.tce, r), ray.tce);
  add_scaled(acc, load_or_zero(ct.ss, r), ray.ss);
  for (int a = 0; a < 3; ++a) {
    if (out.org) out.org[3 * r + a] = acc[kOrgIn + a];
    if (out.dirn) out.dirn[3 * r + a] = acc[kDirIn + a];
  }
  if (out.t_far) out.t_far[r] = acc[kTFarIn];
  if (out.t) out.t[r] = acc[kTIn];
  if (out.tce) out.tce[r] = acc[kTceIn];
  if (out.ss) out.ss[r] = acc[kSsIn];
}

__host__ __device__ constexpr int stage_bytes(int chunk) {
  return chunk * kPitch * (2 * static_cast<int>(sizeof(float)) + 1);
}

}  // namespace

// org, dirn: float [R, 3]; t_far, t, t_cell_end, ss: float [R];
// max_opacity: float [mz, my, mx]; base_step = 1 / sampling_rate and
// rate_scale = 15 * base_step, each rounded to float once on the host (as
// the plain version's Python scalars are). Writes the carried t,
// t_cell_end, ss [R] and t_x, t_y float [R, K], valid uint8 [R, K], K =
// n_iters · samples_per_slot: each of the n_iters slots probes, then emits
// samples_per_slot intervals from its cell.
extern "C" int raymarch_emit(const void* org, const void* dirn,
                             const void* t_far, const void* t,
                             const void* t_cell_end, const void* ss,
                             const void* max_opacity, int mx, int my, int mz,
                             float base_step, float rate_scale,
                             long long n_rays, int n_iters, int max_skips,
                             int samples_per_slot, void* t_out, void* tce_out, void* ss_out,
                             void* t_x, void* t_y, void* valid,
                             void* stream) {
  if (n_rays <= 0) return cudaSuccess;
  if (mx < 1 || my < 1 || mz < 1 || n_iters < 1 || max_skips < 0 ||
      samples_per_slot < 1 || n_rays > 0x7fffffffLL / 3)
    return cudaErrorInvalidValue;
  const int k = n_iters * samples_per_slot;
  const auto f = [](const void* q) { return static_cast<const float*>(q); };
  const auto w = [](void* q) { return static_cast<float*>(q); };
  const auto aligned = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  const int chunk = k < kMaxChunk ? k : kMaxChunk;
  const bool vec = aligned(t_x) && aligned(t_y) && aligned(valid);
  const long long blocks = (n_rays + kRays - 1) / kRays;
  const Grid g{mx, my, mz, base_step, rate_scale, max_skips,
               samples_per_slot};
  raymarch_emit_kernel<<<static_cast<unsigned>(blocks), kRays,
                         stage_bytes(chunk),
                         static_cast<cudaStream_t>(stream)>>>(
      f(org), f(dirn), f(t_far), f(t), f(t_cell_end), f(ss), f(max_opacity),
      g, static_cast<int>(n_rays), k, chunk, vec, w(t_out), w(tce_out),
      w(ss_out), w(t_x), w(t_y), static_cast<uint8_t*>(valid));
  return cudaGetLastError();
}

// The vector-Jacobian product of raymarch_emit with respect to org, dirn
// [R, 3], t_far, t, t_cell_end and ss [R]: the inputs and scalars as for
// raymarch_emit; the cotangents g_t, g_tce, g_ss [R] and g_tx, g_ty [R, K]
// (K = n_iters · samples_per_slot), each float32 or null (zero); the
// gradients d_org, d_dirn [R, 3] and d_t_far, d_t, d_tce, d_ss [R], each
// float32 or null (not computed).
extern "C" int raymarch_emit_backward(
    const void* org, const void* dirn, const void* t_far, const void* t,
    const void* t_cell_end, const void* ss, const void* max_opacity, int mx,
    int my, int mz, float base_step, float rate_scale, long long n_rays,
    int n_iters, int max_skips, int samples_per_slot, const void* g_t,
    const void* g_tce, const void* g_ss, const void* g_tx, const void* g_ty,
    void* d_org, void* d_dirn, void* d_t_far, void* d_t, void* d_tce,
    void* d_ss, void* stream) {
  if (n_rays <= 0) return cudaSuccess;
  if (mx < 1 || my < 1 || mz < 1 || n_iters < 1 || max_skips < 0 ||
      samples_per_slot < 1 || n_rays > 0x7fffffffLL / 3)
    return cudaErrorInvalidValue;
  const auto f = [](const void* q) { return static_cast<const float*>(q); };
  const auto w = [](void* q) { return static_cast<float*>(q); };
  const Grid g{mx, my, mz, base_step, rate_scale, max_skips,
               samples_per_slot};
  const EmitCotangents ct{f(g_t), f(g_tce), f(g_ss), f(g_tx), f(g_ty)};
  const EmitGradients out{w(d_org), w(d_dirn), w(d_t_far),
                          w(d_t),   w(d_tce),  w(d_ss)};
  const long long blocks = (n_rays + kRays - 1) / kRays;
  raymarch_emit_backward_kernel<<<static_cast<unsigned>(blocks), kRays, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      f(org), f(dirn), f(t_far), f(t), f(t_cell_end), f(ss), f(max_opacity),
      g, static_cast<int>(n_rays), n_iters * samples_per_slot, ct, out);
  return cudaGetLastError();
}
