// Designs of the wavefront's emission (raymarch_emit) that the package does
// not ship, built beside the package's kernel for scripts/emit_variants.py
// to time against it on the card. Includes the package's source, so every
// design shares its probe_cells and emit_interval (the scan's arithmetic,
// bit for bit the plain version's), Stage and store_tile.
//
// emit_variant(..., variant) launches:
//   0 previous           the design before this one as it was: one thread a
//                        ray, block of 256, 64-bit ray index, each slot's
//                        t_x, t_y and valid stored at once (a stride of K
//                        values across a warp)
//   1 int32_only         the same with 32-bit index arithmetic
//   2 staged_scalar      the package's kernel with its vector stores off:
//                        slots staged in shared memory, the tile stored by
//                        consecutive lanes one value at a time
//   3 staged_vector      the package's kernel as it ships (16-byte stores)
//   4 staged_smem_rays   3, org and dirn loaded through shared memory (the
//                        block's [rays, 3] rows read as one contiguous range)
//   5 staged_smem_occ    3, the macrocell grid copied into shared memory
//                        (where it fits in 16 KB) in place of __ldg
//   6 per_ray_vector     one thread a ray holding its K slots in registers,
//                        each output row written with 16-byte stores (K = 8
//                        or 16 only: two or four float4 a row)
#include "../instantvnr_torch/csrc/raymarch_emit.cu"

namespace {

constexpr int kPrevBlock = 256;

// One slot of one sample: its probes, then its interval.
template <class Occupancy>
__device__ __forceinline__ void emit_slot(Ray& ray, const Occupancy& occ_at,
                                          const Grid& g, float& tx, float& ty,
                                          bool& v) {
  probe_cells(ray, occ_at, g);
  v = emit_interval(ray, tx, ty);
}

// The previous design, as it was.
__global__ void __launch_bounds__(kPrevBlock)
emit_prev_kernel(const float* __restrict__ org,
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
      static_cast<long long>(blockIdx.x) * kPrevBlock + threadIdx.x;
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
      const float tp = t + kProbeEps;
      int cell[3];
      float t_exit = INFINITY;
      for (int a = 0; a < 3; ++a) {
        const float p = o[a] + tp * d[a];
        cell[a] = static_cast<int>(floorf(p / kCell));
        t_exit = fminf(t_exit, exit_axis<float>(o[a], d[a], cell[a], a));
      }
      t_exit = fmaxf(t_exit, tp);
      const int flat =
          (clamp_cell(cell[2], mz) * my + clamp_cell(cell[1], my)) * mx +
          clamp_cell(cell[0], mx);
      const float occ = __ldg(max_opacity + flat);
      if (occ <= kEps) {
        t = t_exit;
        continue;
      }
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

__device__ __forceinline__ void load_ray(Ray& ray, const float* org,
                                         const float* dirn, const float* tf,
                                         const float* t, const float* tce,
                                         const float* ss, int r) {
  for (int a = 0; a < 3; ++a) {
    ray.o[a] = org[3 * r + a];
    ray.d[a] = dirn[3 * r + a];
  }
  ray.t_far = tf[r];
  ray.t = t[r];
  ray.tce = tce[r];
  ray.ss = ss[r];
}

// 1: the previous design with 32-bit index arithmetic
__global__ void __launch_bounds__(kPrevBlock)
emit_int32_kernel(const float* __restrict__ org,
                  const float* __restrict__ dirn,
                  const float* __restrict__ t_far_in,
                  const float* __restrict__ t_in,
                  const float* __restrict__ tce_in,
                  const float* __restrict__ ss_in,
                  const float* __restrict__ max_opacity, Grid g, int n_rays,
                  int K, float* __restrict__ t_out,
                  float* __restrict__ tce_out, float* __restrict__ ss_out,
                  float* __restrict__ t_x, float* __restrict__ t_y,
                  uint8_t* __restrict__ valid) {
  const int r = blockIdx.x * kPrevBlock + threadIdx.x;
  if (r >= n_rays) return;
  Ray ray;
  load_ray(ray, org, dirn, t_far_in, t_in, tce_in, ss_in, r);
  const LdgOccupancy occ{max_opacity};
  const int row = r * K;
  for (int k = 0; k < K; ++k) {
    float tx, ty;
    bool v;
    emit_slot(ray, occ, g, tx, ty, v);
    t_x[row + k] = tx;
    t_y[row + k] = ty;
    valid[row + k] = v ? 1 : 0;
  }
  t_out[r] = ray.t;
  tce_out[r] = ray.tce;
  ss_out[r] = ray.ss;
}

// the macrocell grid from shared memory
struct SmemOccupancy {
  const float* p;
  __device__ __forceinline__ float operator()(int i) const { return p[i]; }
};

constexpr int kOccSmemMax = 4096;  // floats: 16 KB

// 4, 5: the package's kernel with org/dirn through shared memory, or the
// macrocell grid in shared memory
template <bool kSmemRays, bool kSmemOcc>
__global__ void __launch_bounds__(kRays)
emit_staged_kernel(const float* __restrict__ org,
                   const float* __restrict__ dirn,
                   const float* __restrict__ t_far_in,
                   const float* __restrict__ t_in,
                   const float* __restrict__ tce_in,
                   const float* __restrict__ ss_in,
                   const float* __restrict__ max_opacity, Grid g, int n_rays,
                   int K, int chunk, float* __restrict__ t_out,
                   float* __restrict__ tce_out, float* __restrict__ ss_out,
                   float* __restrict__ t_x, float* __restrict__ t_y,
                   uint8_t* __restrict__ valid) {
  extern __shared__ float4 smem[];
  const Stage st = stage_of(smem, chunk);
  float* extra = reinterpret_cast<float*>(smem) +
                 (stage_bytes(chunk) + 15) / 16 * 4;
  const int tid = threadIdx.x;
  const long long r0 = static_cast<long long>(blockIdx.x) * kRays;
  const int nr = min(kRays, static_cast<int>(n_rays - r0));
  const bool live = tid < nr;
  const int r = static_cast<int>(r0) + tid;
  Ray ray;
  if (kSmemRays) {
    float* rays = extra;  // [2][kRays * 3]
    for (int e = tid; e < 3 * nr; e += kRays) {
      rays[e] = org[3 * r0 + e];
      rays[3 * kRays + e] = dirn[3 * r0 + e];
    }
    __syncthreads();
    if (live) {
      for (int a = 0; a < 3; ++a) {
        ray.o[a] = rays[3 * tid + a];
        ray.d[a] = rays[3 * kRays + 3 * tid + a];
      }
      ray.t_far = t_far_in[r];
      ray.t = t_in[r];
      ray.tce = tce_in[r];
      ray.ss = ss_in[r];
    }
  } else if (live) {
    load_ray(ray, org, dirn, t_far_in, t_in, tce_in, ss_in, r);
  }
  const int n_occ = g.mx * g.my * g.mz;
  const bool occ_in_smem = kSmemOcc && n_occ <= kOccSmemMax;
  if (occ_in_smem) {
    for (int e = tid; e < n_occ; e += kRays) extra[e] = __ldg(max_opacity + e);
    __syncthreads();
  }
  for (int k0 = 0; k0 < K; k0 += chunk) {
    const int nc = min(chunk, K - k0);
    if (live) {
      for (int j = 0; j < nc; ++j) {
        float tx, ty;
        bool v;
        if (occ_in_smem)
          emit_slot(ray, SmemOccupancy{extra}, g, tx, ty, v);
        else
          emit_slot(ray, LdgOccupancy{max_opacity}, g, tx, ty, v);
        st.tx[st.at(tid, j)] = tx;
        st.ty[st.at(tid, j)] = ty;
        st.v[st.at(tid, j)] = v ? 1 : 0;
      }
    }
    __syncthreads();
    store_tile(st, nr, nc, K, r0, k0, true, t_x, t_y, valid);
    __syncthreads();
  }
  if (live) {
    t_out[r] = ray.t;
    tce_out[r] = ray.tce;
    ss_out[r] = ray.ss;
  }
}

// 6: one thread a ray, its K = KT slots in registers, each row stored as
// KT / 4 float4 and one KT-byte vector of valid
template <int KT>
__global__ void __launch_bounds__(kPrevBlock)
emit_perray_kernel(const float* __restrict__ org,
                   const float* __restrict__ dirn,
                   const float* __restrict__ t_far_in,
                   const float* __restrict__ t_in,
                   const float* __restrict__ tce_in,
                   const float* __restrict__ ss_in,
                   const float* __restrict__ max_opacity, Grid g, int n_rays,
                   float* __restrict__ t_out, float* __restrict__ tce_out,
                   float* __restrict__ ss_out, float* __restrict__ t_x,
                   float* __restrict__ t_y, uint8_t* __restrict__ valid) {
  const int r = blockIdx.x * kPrevBlock + threadIdx.x;
  if (r >= n_rays) return;
  Ray ray;
  load_ray(ray, org, dirn, t_far_in, t_in, tce_in, ss_in, r);
  const LdgOccupancy occ{max_opacity};
  float tx[KT], ty[KT];
  uint32_t vw[KT / 4];
#pragma unroll
  for (int q = 0; q < KT / 4; ++q) vw[q] = 0;
#pragma unroll
  for (int k = 0; k < KT; ++k) {
    bool v;
    emit_slot(ray, occ, g, tx[k], ty[k], v);
    vw[k / 4] |= static_cast<uint32_t>(v ? 1 : 0) << (8 * (k % 4));
  }
  float4* gx = reinterpret_cast<float4*>(t_x + static_cast<long long>(r) * KT);
  float4* gy = reinterpret_cast<float4*>(t_y + static_cast<long long>(r) * KT);
#pragma unroll
  for (int q = 0; q < KT / 4; ++q) {
    gx[q] = make_float4(tx[4 * q], tx[4 * q + 1], tx[4 * q + 2],
                        tx[4 * q + 3]);
    gy[q] = make_float4(ty[4 * q], ty[4 * q + 1], ty[4 * q + 2],
                        ty[4 * q + 3]);
  }
  uint8_t* gv = valid + static_cast<long long>(r) * KT;
  if (KT == 8) {
    *reinterpret_cast<uint2*>(gv) = make_uint2(vw[0], vw[1 % (KT / 4)]);
  } else {
#pragma unroll
    for (int q = 0; q < KT / 16; ++q)
      reinterpret_cast<uint4*>(gv)[q] =
          make_uint4(vw[4 * q], vw[4 * q + 1], vw[4 * q + 2], vw[4 * q + 3]);
  }
  t_out[r] = ray.t;
  tce_out[r] = ray.tce;
  ss_out[r] = ray.ss;
}

}  // namespace

// raymarch_emit's arguments, then the variant (0-6, above).
extern "C" int emit_variant(const void* org, const void* dirn,
                            const void* t_far, const void* t,
                            const void* t_cell_end, const void* ss,
                            const void* max_opacity, int mx, int my, int mz,
                            float base_step, float rate_scale,
                            long long n_rays, int K, int max_skips,
                            int samples_per_slot, void* t_out, void* tce_out, void* ss_out,
                            void* t_x, void* t_y, void* valid, void* stream,
                            int variant) {
  if (n_rays <= 0) return cudaSuccess;
  if (mx < 1 || my < 1 || mz < 1 || K < 1 || max_skips < 0 ||
      samples_per_slot != 1 || n_rays > 0x7fffffffLL / 3)
    return cudaErrorInvalidValue;
  const auto f = [](const void* q) { return static_cast<const float*>(q); };
  const auto w = [](void* q) { return static_cast<float*>(q); };
  auto* v8 = static_cast<uint8_t*>(valid);
  const auto s = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(n_rays);
  const Grid g{mx, my, mz, base_step, rate_scale, max_skips, 1};
  const unsigned prev_blocks = (n + kPrevBlock - 1) / kPrevBlock;
  const unsigned blocks = (n + kRays - 1) / kRays;
  const int chunk = K < kMaxChunk ? K : kMaxChunk;
  const int stage = (stage_bytes(chunk) + 15) / 16 * 16;
  switch (variant) {
    case 0:
      emit_prev_kernel<<<prev_blocks, kPrevBlock, 0, s>>>(
          f(org), f(dirn), f(t_far), f(t), f(t_cell_end), f(ss),
          f(max_opacity), mx, my, mz, base_step, rate_scale, n_rays, K,
          max_skips, w(t_out), w(tce_out), w(ss_out), w(t_x), w(t_y), v8);
      break;
    case 1:
      emit_int32_kernel<<<prev_blocks, kPrevBlock, 0, s>>>(
          f(org), f(dirn), f(t_far), f(t), f(t_cell_end), f(ss),
          f(max_opacity), g, n, K, w(t_out), w(tce_out), w(ss_out), w(t_x),
          w(t_y), v8);
      break;
    case 2:
    case 3:
      raymarch_emit_kernel<<<blocks, kRays, stage_bytes(chunk), s>>>(
          f(org), f(dirn), f(t_far), f(t), f(t_cell_end), f(ss),
          f(max_opacity), g, n, K, chunk, variant == 3, w(t_out), w(tce_out),
          w(ss_out), w(t_x), w(t_y), v8);
      break;
    case 4:
      emit_staged_kernel<true, false>
          <<<blocks, kRays, stage + 6 * kRays * 4, s>>>(
              f(org), f(dirn), f(t_far), f(t), f(t_cell_end), f(ss),
              f(max_opacity), g, n, K, chunk, w(t_out), w(tce_out),
              w(ss_out), w(t_x), w(t_y), v8);
      break;
    case 5: {
      const int n_occ = mx * my * mz;
      const int occ = n_occ <= kOccSmemMax ? n_occ * 4 : 0;
      emit_staged_kernel<false, true><<<blocks, kRays, stage + occ, s>>>(
          f(org), f(dirn), f(t_far), f(t), f(t_cell_end), f(ss),
          f(max_opacity), g, n, K, chunk, w(t_out), w(tce_out), w(ss_out),
          w(t_x), w(t_y), v8);
      break;
    }
    case 6:
      if (K == 8) {
        emit_perray_kernel<8><<<prev_blocks, kPrevBlock, 0, s>>>(
            f(org), f(dirn), f(t_far), f(t), f(t_cell_end), f(ss),
            f(max_opacity), g, n, w(t_out), w(tce_out), w(ss_out), w(t_x),
            w(t_y), v8);
      } else if (K == 16) {
        emit_perray_kernel<16><<<prev_blocks, kPrevBlock, 0, s>>>(
            f(org), f(dirn), f(t_far), f(t), f(t_cell_end), f(ss),
            f(max_opacity), g, n, w(t_out), w(tce_out), w(ss_out), w(t_x),
            w(t_y), v8);
      } else {
        return cudaErrorInvalidValue;
      }
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
