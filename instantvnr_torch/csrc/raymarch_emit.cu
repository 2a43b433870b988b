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
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kEps = 1e-6f;
constexpr float kProbeEps = 1e-3f;
constexpr float kCell = 16.0f;  // MACROCELL_SIZE voxels
constexpr int kRays = 128;      // rays (threads) a block
constexpr int kMaxChunk = 32;   // slots staged in shared memory at once
constexpr int kPitch = kRays + 1;

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

// A ray's marching state, carried in registers across its slots.
struct Ray {
  float o[3], d[3];
  float t_far, t, tce, ss;
};

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
template <class Occupancy>
__device__ __forceinline__ void probe_cells(Ray& ray, const Occupancy& occ_at,
                                            const Grid& g) {
  for (int s = 0; s < g.max_skips; ++s) {
    const bool need_new = ray.t >= ray.tce - kEps;
    const bool in_range = ray.t < ray.t_far;
    if (!(need_new && in_range)) break;
    // probe the cell just past the current position
    const float tp = ray.t + kProbeEps;
    int cell[3];
    float t_exit = INFINITY;
    for (int a = 0; a < 3; ++a) {
      const float p = ray.o[a] + tp * ray.d[a];
      cell[a] = static_cast<int>(floorf(p / kCell));
      t_exit = fminf(t_exit, exit_axis(ray.o[a], ray.d[a], cell[a]));
    }
    t_exit = fmaxf(t_exit, tp);
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
    // interval divides evenly (method_raymarching.cu:263-267)
    const float t_exit_c = fminf(t_exit, ray.t_far);
    const float rr = fabsf(fminf(fmaxf(occ, 0.1f), 1.0f) - 1.0f);
    const float step =
        fmaxf(g.base_step + g.rate_scale * rr * rr, g.base_step);
    const float span = t_exit_c - ray.t;
    const int n = static_cast<int>(floorf(span / step)) + 1;
    ray.ss = span / fmaxf(static_cast<float>(n), 1.0f);
    ray.tce = t_exit_c;
    break;
  }
}

// One emitted interval [tx, ty) of the current cell and its validity;
// advances the ray.
__device__ __forceinline__ void emit_interval(Ray& ray, float& tx, float& ty,
                                              bool& v) {
  tx = ray.t;
  ty = fminf(ray.t + ray.ss, ray.tce);
  v = (ty > ray.t + kEps) && (ray.t < ray.t_far) && (ray.tce > ray.t);
  if (v) ray.t = ty;
}

// One slot of one sample: its probes, then its interval.
template <class Occupancy>
__device__ __forceinline__ void emit_slot(Ray& ray, const Occupancy& occ_at,
                                          const Grid& g, float& tx, float& ty,
                                          bool& v) {
  probe_cells(ray, occ_at, g);
  emit_interval(ray, tx, ty, v);
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
        bool v;
        // a slot probes once, then emits its sps samples from the cell
        if ((k0 + j) % g.sps == 0) probe_cells(ray, occ, g);
        emit_interval(ray, tx, ty, v);
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
