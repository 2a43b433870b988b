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
// dimension with the carry resident in VMEM; here each block owns a
// kTH x kTW tile of the intermediate image, loops over the D slabs in order
// and keeps the premultiplied rgb and transmittance carry of its pixels in
// registers. Per slab it stages My's rows and Mx's column chunks once and
// resamples all of the slab's fields with them (slab_common.cuh: resample):
// the value, with shading its 3 world-gradient components, with shadows the
// shadow-transmittance slab (nf = 1..5 fields). Each field streams through
// shared memory in row chunks, so shared memory holds one tmp of
// nf x ax x kTH floats (40 KB at nf = 5, ax = 512) and does not grow with
// the volume otherwise.
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
// Bound on an H100 at 512^2 x 128 slabs of a 128^3 volume: 81 MB of inputs
// and outputs plain, 107 MB with shading (fields [128, 4, 128, 128], the
// two interpolation stacks [128, 512, 128] of 33.6 MB each), 115 MB with
// shading and shadows: about 24-34 us at 3.35 TB/s. The dense resample this
// version runs is 10.7 GFLOP per field (42.9 at 4 fields); each row of My
// and Mx has at most 2 nonzeros, so a banded resample (per-row index/weight
// pairs) is the later optimisation, worth 4x as much with shading.
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

// The pointers that only the extension reads (shadow, x_src, y_src, zw,
// misc) may be null when its flag is off.
template <bool kShade, bool kShadow>
__global__ void __launch_bounds__(kTW)
slab_composite_kernel(const float* __restrict__ fields,
                      const float* __restrict__ shadow,
                      const float* __restrict__ my,
                      const float* __restrict__ mx,
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
                      int wi, int ka, float term_thresh) {
  constexpr int kC = kShade ? 4 : 1;          // fields per slab in `fields`
  constexpr int kNF = kC + (kShadow ? 1 : 0);  // fields resampled per slab
  extern __shared__ __align__(16) float smem[];
  const Layout L = layout(ay, ax, ka, kNF, n_lut > 0 ? n_lut * 4 : kc * 8);
  const TransferFn tf = stage_tf(smem + L.tf, ctrl, kc, lut, n_lut);
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

  const int col = blockIdx.x * kTW + threadIdx.x;
  const int row0 = blockIdx.y * kTH;
  Carry px[kTH];
  float corr_px[kTH];
#pragma unroll
  for (int r = 0; r < kTH; ++r) {
    px[r] = Carry{0.0f, 0.0f, 0.0f, 1.0f};
    const int row = row0 + r;
    corr_px[r] = (row < hi && col < wi) ? corr[row * wi + col] : 0.0f;
  }

  const size_t slab_sz = static_cast<size_t>(ay) * ax;
  for (int k = 0; k < D; ++k) {
    const float* src[kNF];
#pragma unroll
    for (int c = 0; c < kC; ++c) src[c] = fields + (k * kC + c) * slab_sz;
    if constexpr (kShadow) src[kNF - 1] = shadow + k * slab_sz;
    float v[kNF][kTH];
    resample<kNF>(src, my + static_cast<size_t>(k) * hi * ay,
                  mx + static_cast<size_t>(k) * wi * ax, smem + L.my,
                  smem + L.tmp, smem + L.slab, smem + L.mx, ay, ax, hi, wi,
                  ka, row0, blockIdx.x * kTW, v);

    const float cov_x = col < wi ? covx[static_cast<size_t>(k) * wi + col]
                                 : 0.0f;
    float xs = 0.0f, zk = 0.0f;
    if constexpr (kShade) {
      xs = col < wi ? x_src[static_cast<size_t>(k) * wi + col] : 0.0f;
      zk = zw[k];
    }
#pragma unroll
    for (int r = 0; r < kTH; ++r) {
      const int row = row0 + r;
      const float cov_y =
          row < hi ? covy[static_cast<size_t>(k) * hi + row] : 0.0f;
      float rgba[4];
      classify(tf, v[0][r], rgba);
      float rgb[3] = {rgba[0], rgba[1], rgba[2]};
      if constexpr (kShade) {
        const float ys =
            row < hi ? y_src[static_cast<size_t>(k) * hi + row] : 0.0f;
        shade(sh, rgb, v[1][r], v[2][r], v[3][r], xs, ys, zk);
      }
      if constexpr (kShadow) {
        const float f = sh.amb + (1.0f - sh.amb) *
                                     fminf(fmaxf(v[kNF - 1][r], 0.0f), 1.0f);
#pragma unroll
        for (int c = 0; c < 3; ++c) rgb[c] = rgb[c] * f;
      }
      blend(px[r], rgb, rgba[3], corr_px[r], cov_y * cov_x, term_thresh);
    }
  }
  store_carry(out, px, row0, col, hi, wi);
}

template <bool kShade, bool kShadow>
int launch(const void* fields, const void* shadow, const void* my,
           const void* mx, const void* covy, const void* covx,
           const void* corr, const void* x_src, const void* y_src,
           const void* zw, const void* ctrl, int kc, const void* lut,
           int n_lut, const void* misc, int p0, int p1, int p2, void* out,
           int D, int ay, int ax, int hi, int wi, float term_thresh,
           void* stream) {
  if (hi <= 0 || wi <= 0) return cudaSuccess;
  if (D < 0 || ay <= 0 || ax <= 0 || kc < 1 || (lut != nullptr && n_lut < 2))
    return cudaErrorInvalidValue;
  if (lut == nullptr) n_lut = 0;
  constexpr int kNF = (kShade ? 4 : 1) + (kShadow ? 1 : 0);
  const int ka = chunk_rows(ay, ax);
  const Layout L = layout(ay, ax, ka, kNF, n_lut > 0 ? n_lut * 4 : kc * 8);
  const size_t bytes = sizeof(float) * static_cast<size_t>(L.total);
  cudaError_t err = cudaFuncSetAttribute(
      slab_composite_kernel<kShade, kShadow>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const dim3 grid((wi + kTW - 1) / kTW, (hi + kTH - 1) / kTH);
  slab_composite_kernel<kShade, kShadow>
      <<<grid, kTW, bytes, static_cast<cudaStream_t>(stream)>>>(
          f(fields), f(shadow), f(my), f(mx), f(covy), f(covx), f(corr),
          f(x_src), f(y_src), f(zw), f(ctrl), kc, f(lut), n_lut, f(misc), p0,
          p1, p2, static_cast<float*>(out), D, ay, ax, hi, wi, ka,
          term_thresh);
  return cudaGetLastError();
}

}  // namespace

// vol [D, ay, ax], my [D, hi, ay], mx [D, wi, ax], covy [D, hi],
// covx [D, wi], corr [hi, wi], ctrl [kc, 8] (rows x, r, g, b, a, lo, hi, 0),
// lut [n_lut, 4] rgba or null (n_lut = 0: control-point form);
// out [4, hi, wi] = premultiplied rgb + transmittance. All float32.
extern "C" int slab_composite_forward(const void* vol, const void* my,
                                      const void* mx, const void* covy,
                                      const void* covx, const void* corr,
                                      const void* ctrl, int kc,
                                      const void* lut, int n_lut, void* out,
                                      int D, int ay, int ax, int hi, int wi,
                                      float term_thresh, void* stream) {
  return launch<false, false>(vol, nullptr, my, mx, covy, covx, corr, nullptr,
                              nullptr, nullptr, ctrl, kc, lut, n_lut, nullptr,
                              0, 1, 2, out, D, ay, ax, hi, wi, term_thresh,
                              stream);
}

// fields [D, C, ay, ax] with C = 4 (value + world gradient: shaded) or 1,
// shadow [D, ay, ax] or null, my [D, hi, ay], mx [D, wi, ax], covy [D, hi],
// covx [D, wi], corr [hi, wi], x_src [D, wi], y_src [D, hi], zw [D],
// ctrl [kc, 8], lut [n_lut, 4] or null, misc [11] (layout above),
// perm (p0, p1, p2); out [4, hi, wi] = premultiplied rgb + transmittance.
// All float32. C = 1 without a shadow volume is refused: that is
// slab_composite_forward.
extern "C" int slab_composite_ext_forward(
    const void* fields, int C, const void* shadow, const void* my,
    const void* mx, const void* covy, const void* covx, const void* corr,
    const void* x_src, const void* y_src, const void* zw, const void* ctrl,
    int kc, const void* lut, int n_lut, const void* misc, int p0, int p1,
    int p2, void* out, int D, int ay, int ax, int hi, int wi,
    float term_thresh, void* stream) {
  if (p0 + p1 + p2 != 3 || p0 == p1 || p1 == p2 || p0 == p2 || p0 < 0 ||
      p1 < 0 || p2 < 0)
    return cudaErrorInvalidValue;
  const auto run = C == 4 && shadow != nullptr ? launch<true, true>
                   : C == 4                    ? launch<true, false>
                   : C == 1 && shadow != nullptr ? launch<false, true>
                                                 : nullptr;
  if (run == nullptr) return cudaErrorInvalidValue;
  return run(fields, shadow, my, mx, covy, covx, corr, x_src, y_src, zw, ctrl,
             kc, lut, n_lut, misc, p0, p1, p2, out, D, ay, ax, hi, wi,
             term_thresh, stream);
}
