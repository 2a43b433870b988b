// Pieces shared by the slab kernels (slab_composite.cu, iso_sweep.cu): the
// banded resample of a slab's fields, transfer-function classification and
// the front-to-back blend.
//
// The banded resample (resample_banded): a row of the per-slab
// interpolation matrices My [hi, ay] and Mx [wi, ax] has at most two
// nonzeros, at columns j0 and j1 = min(j0 + 1, n - 1) (render/slabmarch.py::
// _interp_pairs; j1 = j0 only on a one-voxel axis, where the second weight
// is 0), so a pixel reads its 2 x 2 source texels and sums
//   tmp_c = wy0 s[jy][c] + wy1 s[jy1][c]   (c = jx, jx1)
//   v     = wx0 tmp_jx + wx1 tmp_jx1
// the nonzero terms of the dense product in its order (-fmad=false keeps
// each product and sum an IEEE operation, as in the plain PyTorch version,
// ops/slab_composite.py::resample_pairs). No shared memory, no barrier.
#pragma once

#include <cuda_runtime.h>

namespace slab {

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// One row's (or column's) pair: the first source index j0, clamped into
// [0, max(n - 2, 0)] so that a bad index cannot read outside the slab, the
// second j1 = min(j0 + 1, n - 1), and the weights of j0 and j1. j0 [.]
// int32, w [., 2] float32 (8-byte aligned).
struct Pair {
  int j, j1;
  float w0, w1;
};

__device__ __forceinline__ Pair load_pair(const int* __restrict__ j0,
                                          const float* __restrict__ w,
                                          size_t i, int n) {
  Pair p;
  p.j = min(max(__ldg(j0 + i), 0), max(n - 2, 0));
  p.j1 = min(p.j + 1, n - 1);
  const float2 ww = __ldg(reinterpret_cast<const float2*>(w) + i);
  p.w0 = ww.x;
  p.w1 = ww.y;
  return p;
}

// The banded resample of the slab s [ay, ax] at one pixel (header note)
__device__ __forceinline__ float resample_banded(const float* __restrict__ s,
                                                 int ax, const Pair& py,
                                                 const Pair& px) {
  const float* r0 = s + static_cast<size_t>(py.j) * ax;
  const float* r1 = s + static_cast<size_t>(py.j1) * ax;
  const float t0 = py.w0 * __ldg(r0 + px.j) + py.w1 * __ldg(r1 + px.j);
  const float t1 = py.w0 * __ldg(r0 + px.j1) + py.w1 * __ldg(r1 + px.j1);
  return px.w0 * t0 + px.w1 * t1;
}

// A transfer function staged in shared memory: control rows [kc][8]
// (x, r, g, b, a, range_lo, range_hi, 0), or the dense rgba LUT [n_lut][4]
// when n_lut > 0 (transfer functions of more than 64 segments).
struct TransferFn {
  const float* s_tf;
  int kc, n_lut;
  float lo, hi, den;
};

// Thread tid of n_threads copies its share of the TF into s_tf; the
// caller's barrier publishes it.
__device__ __forceinline__ TransferFn stage_tf(
    float* s_tf, const float* __restrict__ ctrl, int kc,
    const float* __restrict__ lut, int n_lut, int tid, int n_threads) {
  const bool use_lut = n_lut > 0;
  const int n_tf = use_lut ? n_lut * 4 : kc * 8;
  const float* src = use_lut ? lut : ctrl;
  for (int e = tid; e < n_tf; e += n_threads) s_tf[e] = src[e];
  TransferFn tf;
  tf.s_tf = s_tf;
  tf.kc = kc;
  tf.n_lut = n_lut;
  tf.lo = ctrl[5];
  tf.hi = ctrl[6];
  tf.den = fmaxf(tf.hi - tf.lo, 1e-20f);
  return tf;
}

// value → rgba: the control-point telescoping form of the TPU kernel's
// _classify (slab_composite.py:68), or the LUT's nodal lerp (utils/tfn.py
// classify)
__device__ __forceinline__ void classify(const TransferFn& tf,
                                         float value, float (&rgba)[4]) {
  const float vn = (fminf(fmaxf(value, tf.lo), tf.hi) - tf.lo) / tf.den;
  if (tf.n_lut > 0) {
    const float x = vn * static_cast<float>(tf.n_lut - 1);
    const int i0 = min(max(static_cast<int>(floorf(x)), 0), tf.n_lut - 2);
    const float frac = x - static_cast<float>(i0);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float a0 = tf.s_tf[i0 * 4 + c];
      const float a1 = tf.s_tf[(i0 + 1) * 4 + c];
      rgba[c] = a0 + (a1 - a0) * frac;
    }
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) rgba[c] = tf.s_tf[1 + c];
    for (int i = 0; i < tf.kc - 1; ++i) {
      const float* p0 = tf.s_tf + i * 8;
      const float* p1 = p0 + 8;
      const float denom = fmaxf(p1[0] - p0[0], 1e-12f);
      const float tt = fminf(fmaxf((vn - p0[0]) / denom, 0.0f), 1.0f);
#pragma unroll
      for (int c = 0; c < 4; ++c) rgba[c] += tt * (p1[1 + c] - p0[1 + c]);
    }
  }
}

// Per-pixel carry of the compositors: premultiplied rgb + transmittance.
struct Carry {
  float r, g, b, trans;
};

// Opacity correction 1-(1-a)^corr, coverage x early-termination mask and
// front-to-back blend, exactly as the TPU kernel's _blend
// (slab_composite.py:84).
__device__ __forceinline__ void blend(Carry& px, const float (&rgb)[3],
                                      float a, float corr, float cov,
                                      float term_thresh) {
  float alpha = 1.0f - powf(fmaxf(1.0f - a, 0.0f), corr);
  const float mask = cov * (px.trans > term_thresh ? 1.0f : 0.0f);
  alpha = alpha * mask;
  const float w = px.trans * alpha;
  px.r += w * rgb[0];
  px.g += w * rgb[1];
  px.b += w * rgb[2];
  px.trans = px.trans * (1.0f - alpha);
}

// out [4, hi, wi]: premultiplied rgb + transmittance of pixel p = row·wi +
// col of a frame of hi·wi pixels
__device__ __forceinline__ void store_carry(float* __restrict__ out,
                                            const Carry& px, size_t p,
                                            size_t plane) {
  out[p] = px.r;
  out[plane + p] = px.g;
  out[2 * plane + p] = px.b;
  out[3 * plane + p] = px.trans;
}

}  // namespace slab
