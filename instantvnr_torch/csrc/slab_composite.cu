// Slab compositors for Hopper, sm_90a: the whole front-to-back slab loop of
// one frame as one kernel, plain, with gradient shading and/or with
// shadow-volume modulation.
//
// Replaces the TPU kernels of instantvnr_tpu/ops/pallas/slab_composite.py:
// composite_slabs (_kernel, _classify, _blend) through
// slab_composite_forward, composite_slabs_ext (_kernel_ext) through
// slab_composite_ext_forward. Both launch one kernel template, whose
// <kShade, kShadow> flags switch the extension's work on; <false, false> is
// the plain compositor. On the TPU the slab axis was a sequential grid
// dimension with the carry resident in VMEM; here each thread owns one
// pixel of the intermediate image, walks the D slabs in order and keeps its
// premultiplied rgb and transmittance carry in registers. A block is a
// 32 x 8 pixel tile, one warp a row (1024 blocks at 512^2), so every SM
// holds several.
//
// Per slab a pixel resamples its fields through the per-row pairs
// (slab_common.cuh: resample_banded): 2 x 2 texels a field, read through
// the read-only path, of the value, with shading its 3 world-gradient
// components, with shadows the shadow-transmittance slab (nf = 1..5
// fields). The fields (at most 42 MB at 128^3 and 5 fields) stay in the
// 50 MB L2. Nothing is staged per slab, so the kernel's only barrier
// publishes the transfer function in shared memory. Two skips, both exact
// (the blend would leave the carry bit for bit as it is): a pixel that a
// slab does not cover (covy x covx = 0: alpha x 0 = 0 and rgb is finite),
// and a warp whose pixels have all terminated or lie outside the frame
// (a warp vote; transmittance never rises again).
//
// Then, per pixel, exactly the TPU kernels' formulas (_kernel_ext
// :140-191): classify the value (control-point telescoping form, or the
// dense LUT for transfer functions of more than 64 segments); shade with
// the scivis model + headlight 50/50 mix from the pixel's world position
// (x_src per column, y_src per row, zw per slab, mapped to world axes
// through perm) and the world normal -g / scale, then lerp by
// shading_scale; scale rgb by amb + (1-amb) clip(shadow, 0, 1); then
// correct opacity 1-(1-a)^corr, mask by coverage x early termination and
// blend front to back. Every product is written out and the library builds
// with -fmad=false, so sqrtf and powf see the operands of the plain PyTorch
// version.
//
// Bound on an H100 at 512^2 x 128 slabs of a 128^3 volume: each input once,
// the volume (8.4 MB), the pairs (2 x [128, 512] int32 + [128, 512, 2]
// float32, 1.6 MB), coverage, corr and the 4 output planes, about 15.5 MB
// plain, 41 MB with shading (4 fields), 49 MB with shading and shadows,
// against the operations of the live pixel-slabs (chip_smoke.py counts
// both).
#include "slab_common.cuh"

namespace {

using namespace slab;

// [0] shadow_ambient, [1] shading_scale, [2:5] light (normalized, flipped
// against the view), [5:8] eye (voxel space, world axis order), [8:11]
// voxel→world scale; perm maps permuted axis i to world component perm[i]
struct Shading {
  float amb, s, light[3], eye[3], scale[3];
  int perm[3];
};

// world component c of the sample at permuted position (xs, ys, zk)
__device__ __forceinline__ float world(const Shading& sh, int c, float xs,
                                       float ys, float zk) {
  return sh.perm[0] == c ? xs : (sh.perm[1] == c ? ys : zk);
}

// scivis + simple headlight (_shade_scivis, raytracing.h:215-246) in the
// TPU kernel's form, then the shading_scale lerp; rgb updated in place
__device__ __forceinline__ void shade(const Shading& sh, float (&rgb)[3],
                                      float gx, float gy, float gz, float xs,
                                      float ys, float zk) {
  const float g[3] = {gx, gy, gz};
  float view[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    view[c] = (world(sh, c, xs, ys, zk) - sh.eye[c]) * sh.scale[c];
  }
  const float vn = sqrtf(view[0] * view[0] + view[1] * view[1] +
                         view[2] * view[2]);
  const float vd = fmaxf(vn, 1e-9f);
  float normal[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    view[c] = view[c] / vd;
    normal[c] = -g[c] / sh.scale[c];
  }
  const float nn = normal[0] * normal[0] + normal[1] * normal[1] +
                   normal[2] * normal[2];
  const bool has_n = nn > 1e-6f;
  const float nd = sqrtf(fmaxf(nn, 1e-20f));
  float n[3], h[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    n[c] = normal[c] / nd;
    h[c] = sh.light[c] - view[c];
  }
  const float cos_nl = fmaxf(
      n[0] * sh.light[0] + n[1] * sh.light[1] + n[2] * sh.light[2], 0.0f);
  const float hn = sqrtf(h[0] * h[0] + h[1] * h[1] + h[2] * h[2]);
  const float hd = fmaxf(hn, 1e-20f);
#pragma unroll
  for (int c = 0; c < 3; ++c) h[c] = h[c] / hd;
  const float cos_nh = fmaxf(n[0] * h[0] + n[1] * h[1] + n[2] * h[2], 0.0f);
  const float spec = 0.4f * powf(cos_nh, 40.0f);
  const float lit = cos_nl > 0.0f ? 1.0f : 0.0f;
  const float cos_vn = fabsf(view[0] * n[0] + view[1] * n[1] +
                             view[2] * n[2]);
  const float simple_w = has_n ? 0.2f + 0.8f * cos_vn : 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float scivis =
        has_n ? 0.6f * rgb[c] + lit * (0.9f * cos_nl * rgb[c] + spec) : 0.0f;
    const float sh_c = 0.5f * rgb[c] * simple_w + 0.5f * scivis;
    rgb[c] = sh.s * sh_c + (1.0f - sh.s) * rgb[c];
  }
}

constexpr int kBX = 32;  // pixels of a block along a row: one warp
constexpr int kBY = 8;   // rows of a block, one warp each

// The pointers that only the extension reads (shadow, x_src, y_src, zw,
// misc) may be null when its flag is off.
template <bool kShade, bool kShadow>
__global__ void __launch_bounds__(kBX * kBY)
slab_composite_kernel(const float* __restrict__ fields,
                      const float* __restrict__ shadow,
                      const int* __restrict__ jy,
                      const float* __restrict__ wy,
                      const int* __restrict__ jx,
                      const float* __restrict__ wx,
                      const float* __restrict__ covy,
                      const float* __restrict__ covx,
                      const float* __restrict__ corr,
                      const float* __restrict__ x_src,
                      const float* __restrict__ y_src,
                      const float* __restrict__ zw,
                      const float* __restrict__ ctrl, int kc,
                      const float* __restrict__ lut, int n_lut,
                      const float* __restrict__ misc, int p0, int p1, int p2,
                      float* __restrict__ out, int D, int ay, int ax, int hi,
                      int wi, float term_thresh) {
  constexpr int kC = kShade ? 4 : 1;          // fields per slab in `fields`
  constexpr int kNF = kC + (kShadow ? 1 : 0);  // fields resampled per slab
  extern __shared__ __align__(16) float s_tf[];
  const TransferFn tf = stage_tf(s_tf, ctrl, kc, lut, n_lut,
                                 threadIdx.y * kBX + threadIdx.x, kBX * kBY);
  Shading sh{};
  if constexpr (kShade || kShadow) {
    sh.amb = misc[0];
    sh.s = misc[1];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      sh.light[c] = misc[2 + c];
      sh.eye[c] = misc[5 + c];
      sh.scale[c] = misc[8 + c];
    }
    sh.perm[0] = p0;
    sh.perm[1] = p1;
    sh.perm[2] = p2;
  }
  __syncthreads();  // the TF is staged: the kernel's only barrier

  const int col = blockIdx.x * kBX + threadIdx.x;
  const int row = blockIdx.y * kBY + threadIdx.y;
  const bool inside = row < hi && col < wi;
  const size_t p = static_cast<size_t>(row) * wi + col;
  const float corr_px = inside ? corr[p] : 0.0f;
  Carry px{0.0f, 0.0f, 0.0f, 1.0f};
  bool live = inside;
  const size_t slab_sz = static_cast<size_t>(ay) * ax;
  for (int k = 0; k < D; ++k) {
    // uniform across the warp, so every lane reaches every vote
    if (!__any_sync(0xffffffffu, live)) break;
    if (!live) continue;
    const float cov = __ldg(covy + static_cast<size_t>(k) * hi + row) *
                      __ldg(covx + static_cast<size_t>(k) * wi + col);
    if (cov == 0.0f) continue;
    const Pair py = load_pair(jy, wy, static_cast<size_t>(k) * hi + row, ay);
    const Pair pxx = load_pair(jx, wx, static_cast<size_t>(k) * wi + col, ax);
    float v[kNF];
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      v[c] = resample_banded(
          fields + (static_cast<size_t>(k) * kC + c) * slab_sz, ax, py, pxx);
    }
    if constexpr (kShadow) {
      v[kNF - 1] = resample_banded(shadow + static_cast<size_t>(k) * slab_sz,
                                   ax, py, pxx);
    }
    float rgba[4];
    classify(tf, v[0], rgba);
    float rgb[3] = {rgba[0], rgba[1], rgba[2]};
    if constexpr (kShade) {
      shade(sh, rgb, v[1], v[2], v[3],
            __ldg(x_src + static_cast<size_t>(k) * wi + col),
            __ldg(y_src + static_cast<size_t>(k) * hi + row), __ldg(zw + k));
    }
    if constexpr (kShadow) {
      const float f =
          sh.amb + (1.0f - sh.amb) * fminf(fmaxf(v[kNF - 1], 0.0f), 1.0f);
#pragma unroll
      for (int c = 0; c < 3; ++c) rgb[c] = rgb[c] * f;
    }
    blend(px, rgb, rgba[3], corr_px, cov, term_thresh);
    live = px.trans > term_thresh;
  }
  if (inside) store_carry(out, px, p, static_cast<size_t>(hi) * wi);
}

template <bool kShade, bool kShadow>
int launch(const void* fields, const void* shadow, const void* jy,
           const void* wy, const void* jx, const void* wx, const void* covy,
           const void* covx, const void* corr, const void* x_src,
           const void* y_src, const void* zw, const void* ctrl, int kc,
           const void* lut, int n_lut, const void* misc, int p0, int p1,
           int p2, void* out, int D, int ay, int ax, int hi, int wi,
           float term_thresh, void* stream) {
  if (hi <= 0 || wi <= 0) return cudaSuccess;
  if (D < 0 || ay < 2 || ax < 2 || kc < 1 || (lut != nullptr && n_lut < 2))
    return cudaErrorInvalidValue;
  if (lut == nullptr) n_lut = 0;
  const size_t bytes =
      sizeof(float) * static_cast<size_t>(round4(n_lut > 0 ? n_lut * 4
                                                           : kc * 8));
  cudaError_t err = cudaFuncSetAttribute(
      slab_composite_kernel<kShade, kShadow>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const auto f = [](const void* q) { return static_cast<const float*>(q); };
  const auto i = [](const void* q) { return static_cast<const int*>(q); };
  const dim3 grid((wi + kBX - 1) / kBX, (hi + kBY - 1) / kBY);
  slab_composite_kernel<kShade, kShadow>
      <<<grid, dim3(kBX, kBY), bytes, static_cast<cudaStream_t>(stream)>>>(
          f(fields), f(shadow), i(jy), f(wy), i(jx), f(wx), f(covy),
          f(covx), f(corr), f(x_src), f(y_src), f(zw), f(ctrl), kc, f(lut),
          n_lut, f(misc), p0, p1, p2, static_cast<float*>(out), D, ay, ax, hi,
          wi, term_thresh);
  return cudaGetLastError();
}

}  // namespace

// vol [D, ay, ax]; jy [D, hi], jx [D, wi] int32 and wy [D, hi, 2],
// wx [D, wi, 2]: the per-row pairs of the interpolation matrices (row i of
// slab k samples rows jy, jy + 1 of the slab, ay >= 2, and likewise
// columns); covy [D, hi], covx [D, wi], corr [hi, wi], ctrl [kc, 8] (rows
// x, r, g, b, a, lo, hi, 0), lut [n_lut, 4] rgba or null (n_lut = 0:
// control-point form); out [4, hi, wi] = premultiplied rgb +
// transmittance. float32 but the indices.
extern "C" int slab_composite_forward(const void* vol, const void* jy,
                                      const void* wy, const void* jx,
                                      const void* wx, const void* covy,
                                      const void* covx, const void* corr,
                                      const void* ctrl, int kc,
                                      const void* lut, int n_lut, void* out,
                                      int D, int ay, int ax, int hi, int wi,
                                      float term_thresh, void* stream) {
  return launch<false, false>(vol, nullptr, jy, wy, jx, wx, covy, covx, corr,
                              nullptr, nullptr, nullptr, ctrl, kc, lut, n_lut,
                              nullptr, 0, 1, 2, out, D, ay, ax, hi, wi,
                              term_thresh, stream);
}

// fields [D, C, ay, ax] with C = 4 (value + world gradient: shaded) or 1,
// shadow [D, ay, ax] or null, the pairs jy, wy, jx, wx as above,
// covy [D, hi], covx [D, wi], corr [hi, wi], x_src [D, wi], y_src [D, hi],
// zw [D], ctrl [kc, 8], lut [n_lut, 4] or null, misc [11] (layout above),
// perm (p0, p1, p2); out [4, hi, wi] = premultiplied rgb + transmittance.
// float32 but the indices. C = 1 without a shadow volume is refused: that
// is slab_composite_forward.
extern "C" int slab_composite_ext_forward(
    const void* fields, int C, const void* shadow, const void* jy,
    const void* wy, const void* jx, const void* wx, const void* covy,
    const void* covx, const void* corr, const void* x_src, const void* y_src,
    const void* zw, const void* ctrl, int kc, const void* lut, int n_lut,
    const void* misc, int p0, int p1, int p2, void* out, int D, int ay,
    int ax, int hi, int wi, float term_thresh, void* stream) {
  if (p0 + p1 + p2 != 3 || p0 == p1 || p1 == p2 || p0 == p2 || p0 < 0 ||
      p1 < 0 || p2 < 0)
    return cudaErrorInvalidValue;
  const auto run = C == 4 && shadow != nullptr ? launch<true, true>
                   : C == 4                    ? launch<true, false>
                   : C == 1 && shadow != nullptr ? launch<false, true>
                                                 : nullptr;
  if (run == nullptr) return cudaErrorInvalidValue;
  return run(fields, shadow, jy, wy, jx, wx, covy, covx, corr, x_src, y_src,
             zw, ctrl, kc, lut, n_lut, misc, p0, p1, p2, out, D, ay, ax, hi,
             wi, term_thresh, stream);
}
