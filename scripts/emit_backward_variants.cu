// Designs of the emission's backward (raymarch_emit_backward) that the
// package does not ship, built beside the package's kernel for
// scripts/emit_backward_variants.py to time against it on the card.
// Includes the package's source, so every design but the first shares its
// probe_cells and emit_interval (the scan's value arithmetic, bit for bit
// the forward's and the plain version's).
//
// emit_backward_variant(<raymarch_emit_backward's arguments>, variant):
//   0 previous        the first design as it was: one thread a ray, blocks
//                     of 128, Dual numbers of all ten directions through
//                     every operation (each axis's exit a full Dual, an
//                     IEEE division a derivative), cotangents read a slot
//                     at a time at a stride of K values across a warp
//   1 previous_fma    0 with __fmaf_rn in its derivative sums
//   2 previous_staged 0 with the block's cotangent tiles staged in shared
//                     memory (stage_tile)
//   3 lean            one lane a ray, the package's derivative arithmetic:
//                     only the exit axes at the min carry a derivative,
//                     one rounded reciprocal in place of each division,
//                     FMA in the sums (the package's kernel, written over
//                     the lane type below)
//   4 lean_staged     3 with the staged cotangent tiles
//   5 lanes2          two lanes a ray, five directions each
//   6 lanes2_staged
//   7 lanes5          five lanes a ray (blocks of 160), two directions each
//   8 lanes5_staged
//   9 lanes10_staged  ten lanes a ray (blocks of 160), one direction each
//  10 lean_staged_64  4 in blocks of 64
//  11 lean_staged_8   4 with __launch_bounds__(128, 8): at most 64
//                     registers
//  12 lanes2_staged_256  6 in blocks of 256
//  13 lean_64         3 in blocks of 64
//  14 lean_256        3 in blocks of 256
//  15 lean_6          3 with __launch_bounds__(128, 6): at most 80
//                     registers
//  16 lean_7          3 with __launch_bounds__(128, 7): at most 72
#include "../instantvnr_torch/csrc/raymarch_emit.cu"

namespace {

// Stage the block's [nr rays, nc slots] tile at (first ray r0, slot k0) of
// a cotangent [R, K] in shared memory, slot-major [nc][pitch] (the compute
// phase reads one slot of every ray at a time without bank conflicts).
// Where the tile is all K slots it is one contiguous range from r0·K: with
// `vec`, 16-byte loads and the ragged end one by one; otherwise
// consecutive threads load consecutive elements of the tile.
template <int kThreads>
__device__ __forceinline__ void stage_tile(const float* __restrict__ src,
                                           float* __restrict__ dst,
                                           int pitch, int nr, int nc, int K,
                                           long long r0, int k0, bool vec) {
  const int n = nr * nc;
  const int tid = threadIdx.x;
  if (nc == K && vec) {
    const float* s = src + r0 * K;
    for (int e = 4 * tid; e + 4 <= n; e += 4 * kThreads) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(s + e));
      const float* px = &x.x;
      int r = e / nc, j = e - r * nc;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        dst[j * pitch + r] = px[q];
        if (++j == nc) j = 0, ++r;
      }
    }
    for (int e = (n & ~3) + tid; e < n; e += kThreads) {
      const int r = e / nc, j = e - r * nc;
      dst[j * pitch + r] = __ldg(s + e);
    }
    return;
  }
  for (int e = tid; e < n; e += kThreads) {
    const int r = e / nc, j = e - r * nc;
    dst[j * pitch + r] = __ldg(src + (r0 + r) * K + k0 + j);
  }
}

namespace prev {

// The first design's dual number: the value and its derivatives in all ten
// directions.
struct Dual10 {
  float v;
  float d[kIn];
};

struct PrevRay {
  float o[3], d[3];
  float t_far;
  Dual10 t, tce, ss;
};

__device__ __forceinline__ Dual10 seed10(float v, int in) {
  Dual10 r;
  r.v = v;
#pragma unroll
  for (int i = 0; i < kIn; ++i) r.d[i] = i == in ? 1.0f : 0.0f;
  return r;
}

__device__ __forceinline__ Dual10 add(const Dual10& a, float b) {
  Dual10 r = a;
  r.v = a.v + b;
  return r;
}
__device__ __forceinline__ Dual10 add(const Dual10& a, const Dual10& b) {
  Dual10 r;
  r.v = a.v + b.v;
#pragma unroll
  for (int i = 0; i < kIn; ++i) r.d[i] = a.d[i] + b.d[i];
  return r;
}
__device__ __forceinline__ Dual10 sub(const Dual10& a, const Dual10& b) {
  Dual10 r;
  r.v = a.v - b.v;
#pragma unroll
  for (int i = 0; i < kIn; ++i) r.d[i] = a.d[i] - b.d[i];
  return r;
}
__device__ __forceinline__ Dual10 div(const Dual10& a, float c) {
  Dual10 r;
  r.v = a.v / c;
#pragma unroll
  for (int i = 0; i < kIn; ++i) r.d[i] = a.d[i] / c;
  return r;
}
__device__ __forceinline__ Dual10 pick(const Dual10& a, const Dual10& b,
                                       float v) {
  Dual10 r;
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
__device__ __forceinline__ Dual10 vmin(const Dual10& a, const Dual10& b) {
  return pick(a, b, fminf(a.v, b.v));
}
__device__ __forceinline__ Dual10 vmax(const Dual10& a, const Dual10& b) {
  return pick(a, b, fmaxf(a.v, b.v));
}

__device__ __forceinline__ Dual10 exit_axis10(float o, float d, int c,
                                              int a) {
  const float step_pos = d > 0.0f ? 1.0f : 0.0f;
  const float boundary = (static_cast<float>(c) + step_pos) * kCell;
  const float t = (boundary - o) / d;
  const bool finite = isfinite(t);
  Dual10 r = seed10(finite ? t : INFINITY, -1);
  if (finite) {
    r.d[kOrgIn + a] = -1.0f / d;
    r.d[kDirIn + a] = -(t / d);
  }
  return r;
}

__device__ __forceinline__ Dual10 amin3(const Dual10 (&e)[3]) {
  Dual10 r;
  r.v = fminf(fminf(fminf(INFINITY, e[0].v), e[1].v), e[2].v);
  int ties = 0;
#pragma unroll
  for (int i = 0; i < kIn; ++i) r.d[i] = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    if (e[a].v == r.v) {
      ++ties;
#pragma unroll
      for (int i = 0; i < kIn; ++i) r.d[i] += e[a].d[i];
    }
  }
  if (ties > 1) {
#pragma unroll
    for (int i = 0; i < kIn; ++i) r.d[i] /= static_cast<float>(ties);
  }
  return r;
}

__device__ __forceinline__ void probe_cells(PrevRay& ray,
                                            const LdgOccupancy& occ_at,
                                            const Grid& g) {
  for (int s = 0; s < g.max_skips; ++s) {
    const bool need_new = ray.t.v >= ray.tce.v - kEps;
    const bool in_range = ray.t.v < ray.t_far;
    if (!(need_new && in_range)) break;
    const Dual10 tp = add(ray.t, kProbeEps);
    int cell[3];
    Dual10 t_ax[3];
    for (int a = 0; a < 3; ++a) {
      const float p = ray.o[a] + tp.v * ray.d[a];
      cell[a] = static_cast<int>(floorf(p / kCell));
      t_ax[a] = exit_axis10(ray.o[a], ray.d[a], cell[a], a);
    }
    const Dual10 t_exit = vmax(amin3(t_ax), tp);
    const int flat =
        (clamp_cell(cell[2], g.mz) * g.my + clamp_cell(cell[1], g.my)) *
            g.mx +
        clamp_cell(cell[0], g.mx);
    const float occ = occ_at(flat);
    if (occ <= kEps) {
      ray.t = t_exit;
      continue;
    }
    const Dual10 t_exit_c = vmin(t_exit, seed10(ray.t_far, kTFarIn));
    const float rr = fabsf(fminf(fmaxf(occ, 0.1f), 1.0f) - 1.0f);
    const float step =
        fmaxf(g.base_step + g.rate_scale * rr * rr, g.base_step);
    const Dual10 span = sub(t_exit_c, ray.t);
    const int n = static_cast<int>(floorf(span.v / step)) + 1;
    ray.ss = div(span, fmaxf(static_cast<float>(n), 1.0f));
    ray.tce = t_exit_c;
    break;
  }
}

__device__ __forceinline__ void emit_interval(PrevRay& ray, Dual10& tx,
                                              Dual10& ty) {
  tx = ray.t;
  ty = vmin(add(ray.t, ray.ss), ray.tce);
  const bool v = (ty.v > ray.t.v + kEps) && (ray.t.v < ray.t_far) &&
                 (ray.tce.v > ray.t.v);
  if (v) ray.t = ty;
}

template <bool kFma>
__device__ __forceinline__ void add_scaled(float (&acc)[kIn], float g,
                                           const Dual10& x) {
#pragma unroll
  for (int i = 0; i < kIn; ++i)
    acc[i] = kFma ? __fmaf_rn(g, x.d[i], acc[i]) : acc[i] + g * x.d[i];
}

constexpr int kPrevThreads = 128;

template <bool kFma, bool kStage>
__global__ void __launch_bounds__(kPrevThreads)
prev_backward_kernel(const float* __restrict__ org,
                     const float* __restrict__ dirn,
                     const float* __restrict__ t_far_in,
                     const float* __restrict__ t_in,
                     const float* __restrict__ tce_in,
                     const float* __restrict__ ss_in,
                     const float* __restrict__ max_opacity, Grid g,
                     int n_rays, int K, int chunk, bool vec,
                     EmitCotangents ct, EmitGradients out) {
  constexpr int kTilePitch = kPrevThreads + 1;
  extern __shared__ float4 smem[];
  float* const st_x = reinterpret_cast<float*>(smem);
  float* const st_y = st_x + chunk * kTilePitch;
  const int tid = threadIdx.x;
  const long long r0 = static_cast<long long>(blockIdx.x) * kPrevThreads;
  const int nr = min(kPrevThreads, static_cast<int>(n_rays - r0));
  const bool live = tid < nr;
  const int r = static_cast<int>(r0) + tid;
  PrevRay ray;
  if (live) {
    for (int a = 0; a < 3; ++a) {
      ray.o[a] = org[3 * r + a];
      ray.d[a] = dirn[3 * r + a];
    }
    ray.t_far = t_far_in[r];
    ray.t = seed10(t_in[r], kTIn);
    ray.tce = seed10(tce_in[r], kTceIn);
    ray.ss = seed10(ss_in[r], kSsIn);
  }
  const LdgOccupancy occ{max_opacity};
  float acc[kIn];
#pragma unroll
  for (int i = 0; i < kIn; ++i) acc[i] = 0.0f;
  const long long row = static_cast<long long>(r) * K;
  for (int k0 = 0; k0 < K; k0 += chunk) {
    const int nc = min(chunk, K - k0);
    if (kStage) {
      if (ct.tx)
        stage_tile<kPrevThreads>(ct.tx, st_x, kTilePitch, nr, nc, K, r0, k0,
                                 vec);
      if (ct.ty)
        stage_tile<kPrevThreads>(ct.ty, st_y, kTilePitch, nr, nc, K, r0, k0,
                                 vec);
      __syncthreads();
    }
    if (live) {
      for (int j = 0; j < nc; ++j) {
        const int k = k0 + j;
        if (k % g.sps == 0) probe_cells(ray, occ, g);
        Dual10 tx, ty;
        emit_interval(ray, tx, ty);
        float gx, gy;
        if (kStage) {
          gx = ct.tx ? st_x[j * kTilePitch + tid] : 0.0f;
          gy = ct.ty ? st_y[j * kTilePitch + tid] : 0.0f;
        } else {
          gx = load_or_zero(ct.tx, row + k);
          gy = load_or_zero(ct.ty, row + k);
        }
        add_scaled<kFma>(acc, gx, tx);
        add_scaled<kFma>(acc, gy, ty);
      }
    }
    if (kStage) __syncthreads();
  }
  if (!live) return;
  add_scaled<kFma>(acc, load_or_zero(ct.t, r), ray.t);
  add_scaled<kFma>(acc, load_or_zero(ct.tce, r), ray.tce);
  add_scaled<kFma>(acc, load_or_zero(ct.ss, r), ray.ss);
  for (int a = 0; a < 3; ++a) {
    if (out.org) out.org[3 * r + a] = acc[kOrgIn + a];
    if (out.dirn) out.dirn[3 * r + a] = acc[kDirIn + a];
  }
  if (out.t_far) out.t_far[r] = acc[kTFarIn];
  if (out.t) out.t[r] = acc[kTIn];
  if (out.tce) out.tce[r] = acc[kTceIn];
  if (out.ss) out.ss[r] = acc[kSsIn];
}

template <bool kFma, bool kStage>
cudaError_t launch_prev(const float* org, const float* dirn,
                        const float* t_far, const float* t, const float* tce,
                        const float* ss, const float* max_opacity,
                        const Grid& g, int n_rays, int K,
                        const EmitCotangents& ct, const EmitGradients& out,
                        cudaStream_t stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int chunk = K < kMaxChunk ? K : kMaxChunk;
  const int smem = kStage ? 2 * chunk * (kPrevThreads + 1) * 4 : 0;
  const long long blocks = (n_rays + kPrevThreads - 1) / kPrevThreads;
  prev_backward_kernel<kFma, kStage>
      <<<static_cast<unsigned>(blocks), kPrevThreads, smem, stream>>>(
          org, dirn, t_far, t, tce, ss, max_opacity, g, n_rays, K, chunk,
          aligned(ct.tx) && aligned(ct.ty), ct, out);
  return cudaGetLastError();
}

}  // namespace prev

namespace lanes {

// A lane's share of a ray's derivatives: G lanes a ray (adjacent threads),
// N = ceil(10 / G) directions a lane, from direction base() on (past the
// tenth, padding). The value chain is the same in every lane of a group, so
// the group takes the same branches; each lane stores its own share.
template <int G>
struct LaneDual {
  static constexpr int N = (kIn + G - 1) / G;
  float v;
  float d[N];
};

template <int G>
__device__ __forceinline__ int base() {
  return static_cast<int>(threadIdx.x % G) * LaneDual<G>::N;
}

template <int G>
__device__ __forceinline__ float value(const LaneDual<G>& x) {
  return x.v;
}
template <int G>
__device__ __forceinline__ LaneDual<G> seed(const LaneDual<G>&, float v,
                                            int in) {
  LaneDual<G> r;
  r.v = v;
#pragma unroll
  for (int i = 0; i < LaneDual<G>::N; ++i)
    r.d[i] = base<G>() + i == in ? 1.0f : 0.0f;
  return r;
}
template <int G>
__device__ __forceinline__ LaneDual<G> add(const LaneDual<G>& a, float b) {
  LaneDual<G> r = a;
  r.v = a.v + b;
  return r;
}
template <int G>
__device__ __forceinline__ LaneDual<G> add(const LaneDual<G>& a,
                                           const LaneDual<G>& b) {
  LaneDual<G> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int i = 0; i < LaneDual<G>::N; ++i) r.d[i] = a.d[i] + b.d[i];
  return r;
}
template <int G>
__device__ __forceinline__ LaneDual<G> sub(const LaneDual<G>& a,
                                           const LaneDual<G>& b) {
  LaneDual<G> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int i = 0; i < LaneDual<G>::N; ++i) r.d[i] = a.d[i] - b.d[i];
  return r;
}
template <int G>
__device__ __forceinline__ LaneDual<G> div(const LaneDual<G>& a, float c) {
  LaneDual<G> r;
  r.v = a.v / c;
  const float inv = __frcp_rn(c);
#pragma unroll
  for (int i = 0; i < LaneDual<G>::N; ++i) r.d[i] = a.d[i] * inv;
  return r;
}
template <int G>
__device__ __forceinline__ LaneDual<G> pick(const LaneDual<G>& a,
                                            const LaneDual<G>& b, float v) {
  LaneDual<G> r;
  r.v = v;
  if (a.v == b.v) {
#pragma unroll
    for (int i = 0; i < LaneDual<G>::N; ++i)
      r.d[i] = 0.5f * a.d[i] + 0.5f * b.d[i];
  } else {
    const bool take_a = a.v == v;
#pragma unroll
    for (int i = 0; i < LaneDual<G>::N; ++i) r.d[i] = take_a ? a.d[i] : b.d[i];
  }
  return r;
}
template <int G>
__device__ __forceinline__ LaneDual<G> vmin(const LaneDual<G>& a,
                                            const LaneDual<G>& b) {
  return pick(a, b, fminf(a.v, b.v));
}
template <int G>
__device__ __forceinline__ LaneDual<G> vmax(const LaneDual<G>& a,
                                            const LaneDual<G>& b) {
  return pick(a, b, fmaxf(a.v, b.v));
}
template <int G>
__device__ __forceinline__ LaneDual<G> cell_exit(
    const RayT<LaneDual<G>>& ray, const float (&e)[3], float t_min) {
  LaneDual<G> r;
  r.v = t_min;
#pragma unroll
  for (int i = 0; i < LaneDual<G>::N; ++i) r.d[i] = 0.0f;
  if (!isfinite(r.v)) return r;
  const int ties = (e[0] == r.v) + (e[1] == r.v) + (e[2] == r.v);
  const float share = ties == 1 ? 1.0f : (ties == 2 ? 0.5f : 1.0f / 3.0f);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    if (e[a] != r.v) continue;
    const float inv = __frcp_rn(ray.d[a]);
    const float d_o = -inv * share;
    const float d_d = -(e[a] * inv) * share;
#pragma unroll
    for (int i = 0; i < LaneDual<G>::N; ++i) {
      const int in = base<G>() + i;
      if (in == kOrgIn + a) r.d[i] = d_o;
      if (in == kDirIn + a) r.d[i] = d_d;
    }
  }
  return r;
}

template <int G>
__device__ __forceinline__ void add_scaled(float (&acc)[LaneDual<G>::N],
                                           float g, const LaneDual<G>& x) {
#pragma unroll
  for (int i = 0; i < LaneDual<G>::N; ++i)
    acc[i] = __fmaf_rn(g, x.d[i], acc[i]);
}

// ray r's gradient in direction `in` (a padding direction past the tenth
// is dropped)
__device__ __forceinline__ void store_gradient(const EmitGradients& out,
                                               int r, int in, float v) {
  float* p = in < 3 ? out.org
             : in < 6 ? out.dirn
             : in == kTFarIn ? out.t_far
             : in == kTIn ? out.t
             : in == kTceIn ? out.tce
             : in == kSsIn ? out.ss
                           : nullptr;
  if (p) p[in < 6 ? 3 * r + in % 3 : r] = v;
}

// G lanes a ray in blocks of kThreads; with kStage the block's cotangent
// rows of t_x and t_y are staged in shared memory, chunk slots at a time.
template <int G, int kThreads, int kMinBlocks, bool kStage>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
lanes_backward_kernel(const float* __restrict__ org,
                      const float* __restrict__ dirn,
                      const float* __restrict__ t_far_in,
                      const float* __restrict__ t_in,
                      const float* __restrict__ tce_in,
                      const float* __restrict__ ss_in,
                      const float* __restrict__ max_opacity, Grid g,
                      int n_rays, int K, int chunk, bool vec,
                      EmitCotangents ct, EmitGradients out) {
  constexpr int N = LaneDual<G>::N;
  constexpr int kBlockRays = kThreads / G;
  constexpr int kTilePitch = kBlockRays + 1;
  static_assert(kThreads % G == 0 && kBlockRays % 4 == 0,
                "a block holds whole groups of a multiple of 4 rays");
  extern __shared__ float4 smem[];
  float* const st_x = reinterpret_cast<float*>(smem);
  float* const st_y = st_x + chunk * kTilePitch;
  const int tid = threadIdx.x;
  const int q = tid / G;  // the lane's ray within the block
  const long long r0 = static_cast<long long>(blockIdx.x) * kBlockRays;
  const int nr = min(kBlockRays, static_cast<int>(n_rays - r0));
  const bool live = q < nr;
  const int r = static_cast<int>(r0) + q;
  RayT<LaneDual<G>> ray;
  float acc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.0f;
  if (live) {
    for (int a = 0; a < 3; ++a) {
      ray.o[a] = org[3 * r + a];
      ray.d[a] = dirn[3 * r + a];
    }
    ray.t_far = t_far_in[r];
    ray.t = seed(ray.t, t_in[r], kTIn);
    ray.tce = seed(ray.t, tce_in[r], kTceIn);
    ray.ss = seed(ray.t, ss_in[r], kSsIn);
  }
  const LdgOccupancy occ{max_opacity};
  const long long row = static_cast<long long>(r) * K;
  for (int k0 = 0; k0 < K; k0 += chunk) {
    const int nc = min(chunk, K - k0);
    if (kStage) {
      if (ct.tx)
        stage_tile<kThreads>(ct.tx, st_x, kTilePitch, nr, nc, K, r0, k0, vec);
      if (ct.ty)
        stage_tile<kThreads>(ct.ty, st_y, kTilePitch, nr, nc, K, r0, k0, vec);
      __syncthreads();
    }
    if (live) {
      for (int j = 0; j < nc; ++j) {
        const int k = k0 + j;
        if (k % g.sps == 0) probe_cells(ray, occ, g);
        LaneDual<G> tx, ty;
        emit_interval(ray, tx, ty);
        float gx, gy;
        if (kStage) {
          gx = ct.tx ? st_x[j * kTilePitch + q] : 0.0f;
          gy = ct.ty ? st_y[j * kTilePitch + q] : 0.0f;
        } else {
          gx = load_or_zero(ct.tx, row + k);
          gy = load_or_zero(ct.ty, row + k);
        }
        add_scaled(acc, gx, tx);
        add_scaled(acc, gy, ty);
      }
    }
    if (kStage) __syncthreads();  // the next chunk reuses the stage
  }
  if (!live) return;
  add_scaled(acc, load_or_zero(ct.t, r), ray.t);
  add_scaled(acc, load_or_zero(ct.tce, r), ray.tce);
  add_scaled(acc, load_or_zero(ct.ss, r), ray.ss);
#pragma unroll
  for (int i = 0; i < N; ++i) store_gradient(out, r, base<G>() + i, acc[i]);
}

template <int G, int kThreads, int kMinBlocks, bool kStage>
cudaError_t launch(const float* org, const float* dirn, const float* t_far,
                   const float* t, const float* tce, const float* ss,
                   const float* max_opacity, const Grid& g, int n_rays,
                   int K, const EmitCotangents& ct, const EmitGradients& out,
                   cudaStream_t stream) {
  constexpr int kBlockRays = kThreads / G;
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int chunk = K < kMaxChunk ? K : kMaxChunk;
  const int smem = kStage ? 2 * chunk * (kBlockRays + 1) * 4 : 0;
  const long long blocks = (n_rays + kBlockRays - 1) / kBlockRays;
  lanes_backward_kernel<G, kThreads, kMinBlocks, kStage>
      <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
          org, dirn, t_far, t, tce, ss, max_opacity, g, n_rays, K, chunk,
          aligned(ct.tx) && aligned(ct.ty), ct, out);
  return cudaGetLastError();
}

}  // namespace lanes

}  // namespace

extern "C" int emit_backward_variant(
    const void* org, const void* dirn, const void* t_far, const void* t,
    const void* t_cell_end, const void* ss, const void* max_opacity, int mx,
    int my, int mz, float base_step, float rate_scale, long long n_rays,
    int n_iters, int max_skips, int samples_per_slot, const void* g_t,
    const void* g_tce, const void* g_ss, const void* g_tx, const void* g_ty,
    void* d_org, void* d_dirn, void* d_t_far, void* d_t, void* d_tce,
    void* d_ss, void* stream, int variant) {
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
  const int n = static_cast<int>(n_rays);
  const int k = n_iters * samples_per_slot;
  const auto s = static_cast<cudaStream_t>(stream);
#define ARGS                                                             \
  f(org), f(dirn), f(t_far), f(t), f(t_cell_end), f(ss), f(max_opacity), \
      g, n, k, ct, out, s
  switch (variant) {
    case 0: return prev::launch_prev<false, false>(ARGS);
    case 1: return prev::launch_prev<true, false>(ARGS);
    case 2: return prev::launch_prev<false, true>(ARGS);
    case 3: return lanes::launch<1, 128, 1, false>(ARGS);
    case 4: return lanes::launch<1, 128, 1, true>(ARGS);
    case 5: return lanes::launch<2, 128, 1, false>(ARGS);
    case 6: return lanes::launch<2, 128, 1, true>(ARGS);
    case 7: return lanes::launch<5, 160, 1, false>(ARGS);
    case 8: return lanes::launch<5, 160, 1, true>(ARGS);
    case 9: return lanes::launch<10, 160, 1, true>(ARGS);
    case 10: return lanes::launch<1, 64, 1, true>(ARGS);
    case 11: return lanes::launch<1, 128, 8, true>(ARGS);
    case 12: return lanes::launch<2, 256, 1, true>(ARGS);
    case 13: return lanes::launch<1, 64, 1, false>(ARGS);
    case 14: return lanes::launch<1, 256, 1, false>(ARGS);
    case 15: return lanes::launch<1, 128, 6, false>(ARGS);
    case 16: return lanes::launch<1, 128, 7, false>(ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef ARGS
}
